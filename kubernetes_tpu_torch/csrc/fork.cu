// K30 fork_masks and K31 fork_add_rows: the counterfactual snapshot forks.
//
// Replaces (JAX package): whatif/fork.py apply_fork (:73-129), vmapped over K
// stacked fork payloads by whatif/engine.py (:370-390).  A fork is a COPY of
// the live snapshot with a hypothetical change applied; nothing is written
// back.  Both kernels write K forked copies, one per payload, in one launch.
//
// K30 fork_masks (apply_fork minus the node-add, fork.py:92-129): one grid
// over every output tile of every fork, each output element written exactly
// once by the block that owns its tile:
//   - a node tile (NODE_TILE nodes) owns its rows of node_valid, requested,
//     non_zero_requested and claim_allocated;
//   - a pod tile (POD_TILE pods) its piece of pod_valid;
//   - an affinity tile (AFF_TILE cells) its piece of aff_counts.
// A block first issues the loads of its tile's first 16-byte vectors (their
// base: the live array, shared by the K forks — forks 2..K read it from L2
// — or, for the node arrays of a fork set that adds nodes, K31's per-fork
// output), then reads its fork's payload once and stages in shared memory
// the entries that land in its tile: each warp compacts its entries by
// ballot into its own SEG slots (no shared counter, so no barrier before),
// a victim with its pod_request / pod_non_zero rows gathered from global
// memory and its claim chips.  After ONE barrier each thread applies the
// staged entries to its vectors in registers and stores them:
//   - node-remove: node_valid[k, del] = false (a scatter-max of "ok");
//   - victim-mask: pod_valid[k, pod] = false, the victim's request and
//     non-zero request subtracted from its host's requested /
//     non_zero_requested rows, its claim chips from claim_allocated;
//   - affinity mask: 1.0 subtracted from aff_counts[k, group, value] per
//     contribution.
// Rows clip to the array as the reference's jnp.clip does; an entry whose
// row is < 0 (a pad) writes nothing.  The reference's duplicates are kept:
// pod_valid is a scatter-max, so a duplicate victim masks once, while the
// resource deltas are scatter-adds, so a duplicate subtracts twice — integer
// sums, exact in any order.  aff_counts is float32 holding integer counts:
// subtracting 1.0 per contribution is exact in any order while the counts
// stay below 2^24.  No global atomics, no second launch.  Where more of a
// fork's entries land in one tile than a warp's SEG slots hold (a payload
// far larger than the engine's), that tile walks the fork's payload in
// global memory for each of its elements instead: any size stays right.
// Vectors where every base, output and fork stride is 16-byte aligned, else
// single elements (and single elements for a tile's tail).
//
// K31 fork_add_rows (the node-add activation, fork.py:82-91): each fork's
// captured template rows written into its own [K, N, ...] copy of the twenty
// node arrays (a table of (source, destination, payload, row bytes), as K16
// has).  Each block owns ROWS_PER_BLOCK consecutive rows of one fork: it
// marks in shared memory which of the fork's REAL adds (ok = true) writes
// each of its rows, then copies every array's row from the payload or from
// the live source.  A pad (ok = false) writes nothing, so a real add always
// wins over a pad at the same row.  (The reference rewrites a pad's row with
// the row's current values inside the same scatter, and XLA:CPU's last
// write wins: pads placed after a real add at row 0 undo it — see ROADMAP
// Queue C.  Here the add wins, as the reference's docstring promises.)  Two
// real adds of one fork at one row carry the same node's values, so which
// one a block keeps does not matter.
//
// Bound: bytes (each output written once, its base read once, the payload
// and the victims' pod rows read once).  K30 on the engine's payloads (a few
// dozen entries a fork) is latency: a block's critical path is the payload
// read, the victims' row gather and one barrier before its stores.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_ARRAYS 24
#define ROWS_PER_BLOCK 64
#define THREADS 256

// ------------------------------------------------------------------------ K30

#define MASK_WARPS (THREADS / 32)
#define NODE_TILE 128            // nodes a node tile
#define POD_TILE (THREADS * 16)  // pods a pod tile: a 16-byte vector of bools a thread
#define AFF_TILE (THREADS * 4)   // cells an affinity tile: a float4 a thread
#define SEG 32                   // entries of a group a warp stages for its tile

// which arrays move in 16-byte vectors
#define VEC_NV 1u
#define VEC_REQ 2u
#define VEC_NZ 4u
#define VEC_CLAIM 8u
#define VEC_PV 16u
#define VEC_AFF 32u

struct MaskArgs {
  int N, P, R, G, D, V, A, DD, node_per_fork;
  int tiles_n, tiles_p;  // the grid's node tiles, then its pod tiles, then its affinity tiles
  unsigned vec;
  const uint8_t* nv_in;
  const int32_t* req_in;
  const int32_t* nz_in;
  const int32_t* claim_in;
  const uint8_t* pv_in;
  const float* aff_in;
  const int32_t* pod_request;   // [P, R]
  const int32_t* pod_non_zero;  // [P, 2]
  const int32_t* vic_pod;       // [K, V]
  const int32_t* vic_node;      // [K, V]
  const int32_t* vic_chips;     // [K, V] or null (no claim plane)
  const int32_t* aff_rows;      // [K, A]
  const int32_t* aff_vals;      // [K, A]
  const int32_t* del_rows;      // [K, DD]
  uint8_t* nv;                  // [K, N]
  uint8_t* pv;                  // [K, P]
  int32_t* req;                 // [K, N, R]
  int32_t* nz;                  // [K, N, 2]
  float* aff;                   // [K, G, D]
  int32_t* claim;               // [K, N] or null
};

__device__ __forceinline__ int clip(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// v − x in two's complement (the reference's int32 scatter-add wraps)
__device__ __forceinline__ int32_t sub(int32_t v, int32_t x) {
  return (int32_t)((uint32_t)v - (uint32_t)x);
}

// one array's piece of a tile: `count` elements from src to dst, moved in
// units — 16-byte vectors where `vec`, then single elements
template <typename T>
struct Seg {
  const T* src;
  T* dst;
  int count;
  bool vec;
  static constexpr int PV = 16 / sizeof(T);
  __device__ int full() const { return vec ? count / PV : 0; }
  __device__ int units() const { return full() + (count - full() * PV); }
  __device__ int first(int u) const { return u < full() ? u * PV : full() * PV + (u - full()); }
  __device__ int len(int u) const { return u < full() ? PV : 1; }
};

template <typename T>
union Unit {
  uint4 v;
  T e[16 / sizeof(T)];
};

template <typename T>
__device__ __forceinline__ void load_unit(const Seg<T>& s, int u, Unit<T>& x) {
  if (u < s.full())
    x.v = __ldg(reinterpret_cast<const uint4*>(s.src) + u);
  else
    x.e[0] = s.src[s.first(u)];
}

template <typename T>
__device__ __forceinline__ void store_unit(const Seg<T>& s, int u, const Unit<T>& x) {
  if (u < s.full())
    reinterpret_cast<uint4*>(s.dst)[u] = x.v;
  else
    s.dst[s.first(u)] = x.e[0];
}

template <typename T>
__device__ __forceinline__ void prefetch(const Seg<T>& s, Unit<T>& first) {
  if ((int)threadIdx.x < s.units()) load_unit(s, threadIdx.x, first);
}

// every unit of the thread: the first from registers (loaded before the
// barrier), the rest loaded here; apply(unit, its first element, its
// element count), then one store
template <typename T, typename F>
__device__ __forceinline__ void finish(const Seg<T>& s, const Unit<T>& first, F apply) {
  const int n = s.units();
#pragma unroll 1
  for (int u = threadIdx.x; u < n; u += blockDim.x) {
    Unit<T> x;
    if (u == (int)threadIdx.x)
      x = first;
    else
      load_unit(s, u, x);
    apply(x, s.first(u), s.len(u));
    store_unit(s, u, x);
  }
}

// a warp's slot for its lane's entry (−1: the entry stays out, or the warp's
// SEG slots are full); `count` the warp's entries in the tile so far
__device__ __forceinline__ int warp_slot(bool in, int* count) {
  const unsigned m = __ballot_sync(0xffffffffu, in);
  const int lane = threadIdx.x & 31;
  const int pos = *count + __popc(m & ((1u << lane) - 1u));
  *count += __popc(m);
  return in && pos < SEG ? pos : -1;
}

// f(slot) for every staged entry, the warps' slots in turn
template <typename F>
__device__ __forceinline__ void each_staged(const int* s_cnt, F f) {
#pragma unroll 1
  for (int w = 0; w < MASK_WARPS; ++w) {
    const int n = min(s_cnt[w], SEG);
#pragma unroll 1
    for (int j = 0; j < n; ++j) f(w * SEG + j);
  }
}

// (any entry landed, a warp ran past its slots)
__device__ __forceinline__ void landed(const int* s_cnt, bool* any, bool* over) {
  int n = 0;
  bool o = false;
  for (int w = 0; w < MASK_WARPS; ++w) {
    n |= s_cnt[w];
    o |= s_cnt[w] > SEG;
  }
  *any = n != 0;
  *over = o;
}

// the unit's element at local index `at` cleared
template <typename T>
__device__ __forceinline__ void clear_at(Unit<T>& x, int e0, int m, int at) {
#pragma unroll
  for (int e = 0; e < Seg<T>::PV; ++e)
    if (e < m && e0 + e == at) x.e[e] = (T)0;
}

// the unit's elements of row `at` (w elements a row) less `vals[0..w)`
__device__ __forceinline__ void sub_row(Unit<int32_t>& x, int e0, int m, int at, int w,
                                        const int32_t* vals) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = e0 + e - at * w;
    if (e < m && i >= 0 && i < w) x.e[e] = sub(x.e[e], vals[i]);
  }
}

// dynamic shared memory: [SLOTS] victims' local rows, chips, removes' local
// rows, [SLOTS, 2] non-zero rows, [SLOTS, R] request rows
#define SLOTS (MASK_WARPS * SEG)

__device__ void node_tile(const MaskArgs& a, int k, int t, int32_t* sm) {
  __shared__ int s_vcnt[MASK_WARPS], s_dcnt[MASK_WARPS];
  int32_t* s_at = sm;
  int32_t* s_chips = s_at + SLOTS;
  int32_t* s_del = s_chips + SLOTS;
  int32_t* s_nz = s_del + SLOTS;
  int32_t* s_req = s_nz + 2 * SLOTS;
  const int R = a.R, N = a.N, P = a.P;
  const int n0 = t * NODE_TILE, tn = min(NODE_TILE, N - n0);
  const size_t src = a.node_per_fork ? (size_t)k * N + n0 : (size_t)n0;
  const size_t dst = (size_t)k * N + n0;
  const Seg<uint8_t> s_nv{a.nv_in + src, a.nv + dst, tn, (a.vec & VEC_NV) != 0};
  const Seg<int32_t> s_rq{a.req_in + src * R, a.req + dst * R, tn * R, (a.vec & VEC_REQ) != 0};
  const Seg<int32_t> s_nzs{a.nz_in + src * 2, a.nz + dst * 2, tn * 2, (a.vec & VEC_NZ) != 0};
  const bool chips = a.claim != nullptr;
  const Seg<int32_t> s_cl{chips ? a.claim_in + src : nullptr, chips ? a.claim + dst : nullptr,
                          chips ? tn : 0, (a.vec & VEC_CLAIM) != 0};
  Unit<uint8_t> u_nv;
  Unit<int32_t> u_rq, u_nz, u_cl;
  prefetch(s_nv, u_nv);
  prefetch(s_rq, u_rq);
  prefetch(s_nzs, u_nz);
  prefetch(s_cl, u_cl);

  // --- the fork's victims and removes that land in this tile, staged ------
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t* vp = a.vic_pod + (size_t)k * a.V;
  const int32_t* vn = a.vic_node + (size_t)k * a.V;
  const int32_t* vc = chips ? a.vic_chips + (size_t)k * a.V : nullptr;
  const int32_t* dr = a.del_rows + (size_t)k * a.DD;
  int vcount = 0, dcount = 0;
#pragma unroll 1
  for (int base = warp * 32; base < max(a.V, a.DD); base += THREADS) {
    // both groups' entries loaded together; the removes staged before the
    // victims' rows are gathered (one round trip, then the gather)
    const int i = base + lane;
    int prow = -1, nrow = 0, ch = 0, row = -1;
    if (i < a.V) {
      prow = __ldg(vp + i);
      nrow = __ldg(vn + i);
      if (chips) ch = __ldg(vc + i);
    }
    if (i < a.DD) row = __ldg(dr + i);
    if (base < a.DD) {
      const int at = clip(row, N - 1);
      const int slot = warp_slot(row >= 0 && at >= n0 && at < n0 + tn, &dcount);
      if (slot >= 0) s_del[warp * SEG + slot] = at - n0;
    }
    if (base < a.V) {
      nrow = clip(nrow, N - 1);
      const int slot = warp_slot(prow >= 0 && nrow >= n0 && nrow < n0 + tn, &vcount);
      if (slot >= 0) {
        const int s = warp * SEG + slot;
        const size_t pr = (size_t)min(prow, P - 1);
        s_at[s] = nrow - n0;
        s_chips[s] = ch;
        const int32_t nz0 = __ldg(a.pod_non_zero + pr * 2);
        const int32_t nz1 = __ldg(a.pod_non_zero + pr * 2 + 1);
        // the request row 8 columns at a time, every load before its store
#pragma unroll 1
        for (int r0 = 0; r0 < R; r0 += 8) {
          int32_t v[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            v[q] = r0 + q < R ? __ldg(a.pod_request + pr * R + r0 + q) : 0;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (r0 + q < R) s_req[s * R + r0 + q] = v[q];
        }
        s_nz[2 * s] = nz0;
        s_nz[2 * s + 1] = nz1;
      }
    }
  }
  if (lane == 0) {
    s_vcnt[warp] = vcount;
    s_dcnt[warp] = dcount;
  }
  __syncthreads();

  // --- the tile's units: the staged entries applied in registers, then one
  // store each (past an overflow, the fork's payload walked in global memory)
  bool any_v, vover, any_d, dover;
  landed(s_vcnt, &any_v, &vover);
  landed(s_dcnt, &any_d, &dover);
  // f(local node, slot or −1, pod row) for each victim that may land here
  auto victims = [&](auto f) {
    if (!any_v) return;
    if (!vover) {
      each_staged(s_vcnt, [&](int s) { f(s_at[s], s, (size_t)0); });
      return;
    }
#pragma unroll 1
    for (int i = 0; i < a.V; ++i) {
      const int prow = __ldg(vp + i);
      if (prow >= 0) f(clip(__ldg(vn + i), N - 1) - n0, -i - 1, (size_t)min(prow, P - 1));
    }
  };
  finish(s_nv, u_nv, [&](Unit<uint8_t>& x, int e0, int m) {
    if (!any_d) return;
    if (!dover) {
      each_staged(s_dcnt, [&](int s) { clear_at(x, e0, m, s_del[s]); });
      return;
    }
#pragma unroll 1
    for (int i = 0; i < a.DD; ++i) {
      const int row = __ldg(dr + i);
      if (row >= 0) clear_at(x, e0, m, clip(row, N - 1) - n0);
    }
  });
  finish(s_rq, u_rq, [&](Unit<int32_t>& x, int e0, int m) {
    victims([&](int at, int s, size_t pr) {
      sub_row(x, e0, m, at, R, s >= 0 ? s_req + s * R : a.pod_request + pr * R);
    });
  });
  finish(s_nzs, u_nz, [&](Unit<int32_t>& x, int e0, int m) {
    victims([&](int at, int s, size_t pr) {
      sub_row(x, e0, m, at, 2, s >= 0 ? s_nz + 2 * s : a.pod_non_zero + pr * 2);
    });
  });
  if (chips) {
    finish(s_cl, u_cl, [&](Unit<int32_t>& x, int e0, int m) {
      victims([&](int at, int s, size_t) {
        sub_row(x, e0, m, at, 1, s >= 0 ? s_chips + s : vc + (-s - 1));
      });
    });
  }
}

__device__ void pod_tile(const MaskArgs& a, int k, int t, int32_t* sm) {
  __shared__ int s_cnt[MASK_WARPS];
  int32_t* s_at = sm;
  const int p0 = t * POD_TILE, tp = min(POD_TILE, a.P - p0);
  const Seg<uint8_t> s_pv{a.pv_in + p0, a.pv + (size_t)k * a.P + p0, tp,
                          (a.vec & VEC_PV) != 0};
  Unit<uint8_t> u_pv;
  prefetch(s_pv, u_pv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t* vp = a.vic_pod + (size_t)k * a.V;
  int count = 0;
#pragma unroll 1
  for (int base = warp * 32; base < a.V; base += THREADS) {
    const int i = base + lane;
    const int prow = i < a.V ? __ldg(vp + i) : -1;
    const int at = min(prow, a.P - 1);
    const int slot = warp_slot(prow >= 0 && at >= p0 && at < p0 + tp, &count);
    if (slot >= 0) s_at[warp * SEG + slot] = at - p0;
  }
  if (lane == 0) s_cnt[warp] = count;
  __syncthreads();
  bool any, over;
  landed(s_cnt, &any, &over);
  finish(s_pv, u_pv, [&](Unit<uint8_t>& x, int e0, int m) {
    if (!any) return;
    if (!over) {
      each_staged(s_cnt, [&](int s) { clear_at(x, e0, m, s_at[s]); });
      return;
    }
#pragma unroll 1
    for (int i = 0; i < a.V; ++i) {
      const int prow = __ldg(vp + i);
      if (prow >= 0) clear_at(x, e0, m, min(prow, a.P - 1) - p0);
    }
  });
}

__device__ void aff_tile(const MaskArgs& a, int k, int t, int32_t* sm) {
  __shared__ int s_cnt[MASK_WARPS];
  int32_t* s_at = sm;
  const int cells = a.G * a.D;
  const int c0 = t * AFF_TILE, tc = min(AFF_TILE, cells - c0);
  const Seg<float> s_af{a.aff_in + c0, a.aff + (size_t)k * cells + c0, tc,
                        (a.vec & VEC_AFF) != 0};
  Unit<float> u_af;
  prefetch(s_af, u_af);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t* ar = a.aff_rows + (size_t)k * a.A;
  const int32_t* av = a.aff_vals + (size_t)k * a.A;
  int count = 0;
#pragma unroll 1
  for (int base = warp * 32; base < a.A; base += THREADS) {
    const int i = base + lane;
    const int row = i < a.A ? __ldg(ar + i) : -1;
    const int val = i < a.A ? __ldg(av + i) : 0;  // loaded beside its row
    const int at = clip(row, a.G - 1) * a.D + clip(val, a.D - 1);
    const int slot = warp_slot(row >= 0 && at >= c0 && at < c0 + tc, &count);
    if (slot >= 0) s_at[warp * SEG + slot] = at - c0;
  }
  if (lane == 0) s_cnt[warp] = count;
  __syncthreads();
  bool any, over;
  landed(s_cnt, &any, &over);
  // 1.0 less per contribution at local cell `at`
  auto minus_one = [](Unit<float>& x, int e0, int m, int at) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < m && e0 + e == at) x.e[e] = __fsub_rn(x.e[e], 1.0f);
  };
  finish(s_af, u_af, [&](Unit<float>& x, int e0, int m) {
    if (!any) return;
    if (!over) {
      each_staged(s_cnt, [&](int s) { minus_one(x, e0, m, s_at[s]); });
      return;
    }
#pragma unroll 1
    for (int i = 0; i < a.A; ++i) {
      const int row = __ldg(ar + i);
      if (row >= 0)
        minus_one(x, e0, m, clip(row, a.G - 1) * a.D + clip(__ldg(av + i), a.D - 1) - c0);
    }
  });
}

// grid: (node tiles + pod tiles + affinity tiles, K forks)
__global__ void __launch_bounds__(THREADS) fork_masks_kernel(const MaskArgs a) {
  extern __shared__ int4 smem4[];
  int32_t* sm = (int32_t*)smem4;
  const int k = blockIdx.y;
  int t = blockIdx.x;
  if (t < a.tiles_n) {
    node_tile(a, k, t, sm);
  } else if ((t -= a.tiles_n) < a.tiles_p) {
    pod_tile(a, k, t, sm);
  } else {
    aff_tile(a, k, t - a.tiles_p, sm);
  }
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

extern "C" int launch_fork_masks(
    int K, int N, int P, int R, int G, int D, int V, int A, int DD, int node_per_fork,
    const void* node_valid_in, const void* requested_in, const void* non_zero_in,
    const void* claim_in, const void* pod_valid_in, const void* aff_in,
    const void* pod_request, const void* pod_non_zero, const void* vic_pod,
    const void* vic_node, const void* vic_chips, const void* aff_rows, const void* aff_vals,
    const void* del_rows, void* node_valid, void* pod_valid, void* requested, void* non_zero,
    void* aff_counts, void* claim_allocated, void* stream) {
  if (K <= 0) return 0;
  MaskArgs a;
  a.N = N, a.P = P, a.R = R, a.G = G, a.D = D, a.V = V, a.A = A, a.DD = DD;
  a.node_per_fork = node_per_fork;
  a.tiles_n = N > 0 ? (N + NODE_TILE - 1) / NODE_TILE : 0;
  a.tiles_p = P > 0 ? (P + POD_TILE - 1) / POD_TILE : 0;
  const int tiles_a = G * D > 0 ? (G * D + AFF_TILE - 1) / AFF_TILE : 0;
  a.nv_in = (const uint8_t*)node_valid_in;
  a.req_in = (const int32_t*)requested_in;
  a.nz_in = (const int32_t*)non_zero_in;
  a.claim_in = (const int32_t*)claim_in;
  a.pv_in = (const uint8_t*)pod_valid_in;
  a.aff_in = (const float*)aff_in;
  a.pod_request = (const int32_t*)pod_request;
  a.pod_non_zero = (const int32_t*)pod_non_zero;
  a.vic_pod = (const int32_t*)vic_pod;
  a.vic_node = (const int32_t*)vic_node;
  a.vic_chips = (const int32_t*)vic_chips;
  a.aff_rows = (const int32_t*)aff_rows;
  a.aff_vals = (const int32_t*)aff_vals;
  a.del_rows = (const int32_t*)del_rows;
  a.nv = (uint8_t*)node_valid;
  a.pv = (uint8_t*)pod_valid;
  a.req = (int32_t*)requested;
  a.nz = (int32_t*)non_zero;
  a.aff = (float*)aff_counts;
  a.claim = (int32_t*)claim_allocated;
  // 16-byte vectors where the base, the output and every fork's offset are
  // 16-byte aligned (the tiles start on 16-byte boundaries)
  auto vec = [&](const void* src, const void* dst, long long fork_bytes) {
    return aligned16(src) && aligned16(dst) && fork_bytes % 16 == 0;
  };
  a.vec = (vec(node_valid_in, node_valid, (long long)N) ? VEC_NV : 0u) |
          (vec(requested_in, requested, (long long)N * R * 4) ? VEC_REQ : 0u) |
          (vec(non_zero_in, non_zero, (long long)N * 8) ? VEC_NZ : 0u) |
          (claim_allocated && vec(claim_in, claim_allocated, (long long)N * 4) ? VEC_CLAIM : 0u) |
          (vec(pod_valid_in, pod_valid, (long long)P) ? VEC_PV : 0u) |
          (vec(aff_in, aff_counts, (long long)G * D * 4) ? VEC_AFF : 0u);
  const int tiles = a.tiles_n + a.tiles_p + tiles_a;
  if (tiles == 0) return 0;
  const size_t smem = (size_t)SLOTS * (5 + R) * 4;
  static size_t smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(fork_masks_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  fork_masks_kernel<<<dim3((unsigned)tiles, (unsigned)K), THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------- K31

struct AddTable {
  int n;
  const uint8_t* src[MAX_ARRAYS];
  uint8_t* dst[MAX_ARRAYS];
  const uint8_t* val[MAX_ARRAYS];
  long long row_bytes[MAX_ARRAYS];
};

__global__ void __launch_bounds__(THREADS) fork_add_rows_kernel(
    AddTable t, long long n_rows, int M, const int32_t* __restrict__ rows,
    const bool* __restrict__ ok) {
  __shared__ int slot[ROWS_PER_BLOCK];
  const int k = blockIdx.y;
  const long long r0 = (long long)blockIdx.x * ROWS_PER_BLOCK;
  for (int i = threadIdx.x; i < ROWS_PER_BLOCK; i += blockDim.x) slot[i] = -1;
  __syncthreads();
  for (int j = threadIdx.x; j < M; j += blockDim.x) {
    if (!ok[(long long)k * M + j]) continue;  // a pad writes nothing
    long long r = rows[(long long)k * M + j];
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    if (r >= r0 && r < r0 + ROWS_PER_BLOCK) slot[r - r0] = j;
  }
  __syncthreads();
  const long long n_here = min((long long)ROWS_PER_BLOCK, n_rows - r0);
  for (int a = 0; a < t.n; ++a) {
    const long long rb = t.row_bytes[a];
    const uint8_t* src = t.src[a];
    uint8_t* dst = t.dst[a] + (long long)k * n_rows * rb;
    const uint8_t* val = t.val[a] + (long long)k * M * rb;
    const bool aligned = rb % 4 == 0 && (((uintptr_t)src | (uintptr_t)dst | (uintptr_t)val) % 4 == 0);
    if (aligned) {
      const long long words = rb / 4;
      for (long long w = threadIdx.x; w < n_here * words; w += blockDim.x) {
        const long long lr = w / words, off = w % words;
        const int s = slot[lr];
        ((uint32_t*)dst)[(r0 + lr) * words + off] =
            s >= 0 ? ((const uint32_t*)val)[(long long)s * words + off]
                   : ((const uint32_t*)src)[(r0 + lr) * words + off];
      }
    } else {
      for (long long w = threadIdx.x; w < n_here * rb; w += blockDim.x) {
        const long long lr = w / rb, off = w % rb;
        const int s = slot[lr];
        dst[(r0 + lr) * rb + off] = s >= 0 ? val[(long long)s * rb + off] : src[(r0 + lr) * rb + off];
      }
    }
  }
}

extern "C" int launch_fork_add_rows(int n_arrays, const void* src_ptrs, const void* dst_ptrs,
                                    const void* val_ptrs, const void* row_bytes, long long n_rows,
                                    int K, int M, const void* rows, const void* ok, void* stream) {
  if (n_arrays <= 0 || n_rows <= 0 || K <= 0) return 0;
  if (n_arrays > MAX_ARRAYS) return (int)cudaErrorInvalidValue;
  AddTable t;
  t.n = n_arrays;
  for (int a = 0; a < n_arrays; ++a) {
    t.src[a] = ((const uint8_t* const*)src_ptrs)[a];
    t.dst[a] = ((uint8_t* const*)dst_ptrs)[a];
    t.val[a] = ((const uint8_t* const*)val_ptrs)[a];
    t.row_bytes[a] = ((const long long*)row_bytes)[a];
  }
  const long long blocks = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  dim3 grid((unsigned)blocks, (unsigned)K);
  fork_add_rows_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      t, n_rows, M, (const int32_t*)rows, (const bool*)ok);
  return (int)cudaGetLastError();
}
