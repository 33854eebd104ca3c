// K27 priority_prefix, K28 candidate_fit, K29 candidate_dense: preemption's
// candidate mask, "would pod b fit node n with every lower-priority pod on n
// evicted".
//
// Replaces (JAX package): whatif/dryrun.py candidate_mask_device (:31-96),
// which TPUScheduler's "cand" program (scheduler.py:1019-1028) runs after
// the static filters.  Its levels branch (:56-74) scatter-adds every bound
// pod's request into a [K+1, N, R] per-priority-level table, takes an
// exclusive prefix over the levels and gathers each batch pod's threshold row;
// its dense branch (:75-94, more than K distinct priorities) contracts
// B x P x N x R.
//
// The float32 order is the reference's, bit for bit:
//   * a level's total on a node is the sum of its pods' requests in
//     ascending pod-row order, starting from 0 (XLA:CPU's scatter-add walks
//     the updates in order);
//   * the prefix over the levels is XLA:CPU's cumsum, which is not left to
//     right: a blocked scan of base 16 -- an inclusive running sum inside
//     each block of 16 levels, the block totals summed left to right, and
//     each element of block j > 0 plus the totals of blocks 0..j-1 (K <= 256
//     keeps the totals' own scan to one block);
//   * the fit is (alloc - requested) first, then + freed, each one correctly
//     rounded operation (the library builds with --fmad=false).
// A float atomicAdd would sum in arrival order, so no kernel here uses one:
// one lane owns each sum and adds its node's pods in row order.  K27 and K29
// gather their nodes' pods themselves, in row order, in their one launch:
// no sort.
//
// K27: the whole call in one launch, no sort, each output element written
//   once.  A block owns a tile of 64 nodes (one block an SM).  It streams
//   the pod tier in ascending row order, PREFIX_CHUNK rows a chunk and 16
//   consecutive rows a thread (K29's 16-byte loads, the next chunk's issued
//   before this one is placed), and gathers the valid bound pods of its tile
//   (a node past N counts at N - 1, as the reference clips it) into a list
//   that keeps their row order: each thread's count, a warp scan, a scan of
//   the warps' totals.  The list grows across chunks; when it holds
//   PREFIX_CAP entries (and once at the end) it is flushed: each entry's
//   priority and requests loaded at once, its bucket found once by
//   lower_bound over the levels in shared memory, its requests converted
//   once; then warp w walks the list for channels w and w + 16 -- per group
//   of 32 entries each lane loads one entry, the entries of each node come
//   together as a mask (__match_any_sync), and each lane takes its nodes'
//   entries low bit first by shuffle -- adding with __fadd_rn into the
//   level totals, in registers for a window of at most 4 levels (the path's
//   2 live levels), else in shared memory.  So every (level, node, channel)
//   total is summed in ascending pod-row order from 0, however many rounds
//   a node's pods take.  Only the live levels are kept: Lw = the levels
//   below i32-max, plus the first i32-max pad (a pod at i32-max lands
//   there).  Where Lw levels do not fit shared memory (the plan's window
//   W, a multiple of 16), the levels go in windows: each re-walks the list
//   (re-streams the tier if the list overflowed a round) and the scan's
//   carry passes between windows through shared memory.  Then each
//   element's carry into each live 16-level block is computed once, and
//   each (output vector, block) pair -- a node's 4 channels or 4 nodes'
//   counts as a 16-byte store, a scalar where R or N is not a multiple of
//   4 -- runs XLA:CPU's blocked recurrence from registers and writes its
//   block's rows once, coalesced across the warp; the rows past the last
//   live level follow from the same recurrence (each adds 0.0).  Nothing
//   the kernel writes is read back.  Bound: bytes (the [K+1, N, R+1] output
//   written once, ~38 MB at N = 8192, R = 8, K = 128); each block re-reads
//   the tier's node and valid columns from L2, 5 bytes a row.
// K28: one thread per (batch pod, node): the threshold row
//   tb = searchsorted(levels, priority_b) of prefix / prefix_cnt, the fit over
//   R, has-victims (count > 0) and the static bits (bits & mask == mask; K1's
//   plane, zero on dead nodes and padding rows).  Bound: bytes.
// K29: the whole call in one launch, no sort.  A block takes a tile of 32
//   nodes (one a lane) and a slice of batch rows (KB a thread, one warp's
//   rows interleaved with the next's; KB = 8, 4 or 2 as R <= 4, 8 or 16, so
//   the sums and counts stay in registers).  It streams the pod tier in
//   ascending row order in chunks of 4096 rows, 16 consecutive rows a
//   thread (16-byte loads of the nodes and the valid flags), and gathers
//   the valid pods bound to its tile stably: each thread's count of them, a
//   warp scan, a scan of the warps' totals, so pod i of the list is the
//   i-th in row order; their rows, then (an entry a thread) their
//   priorities and requests as float go to shared memory, 1024 a round.
//   Each warp then walks the list 32 entries at a time: the entries of each
//   node as a bit mask (__match_any_sync over the entries' nodes, the
//   leader of each set writing it for that node's lane), and each lane
//   takes its node's entries low bit first, adding the requests of those
//   below each of its rows' priorities with __fadd_rn.  Chunks, rounds and
//   groups come in row order, so every (row, node) sum is in ascending
//   pod-row order from 0 whatever the node holds -- a node with more pods
//   than a chunk or a round included.  Then the fit as K28, every load
//   issued before the first compare.  Two blocks an SM (registers bounded
//   to 128 a thread): a chunk's barriers and loads leave the SM idle
//   unless another block has work.  Bound: bytes (the pod tier, the node
//   rows and the batch rows read once, the mask written once); each block
//   re-reads the tier's node and valid columns from L2, 5 bytes a row.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define BLOCK_BASE 16  // XLA:CPU's cumulative-sum rewrite base
#define MAX_LEVELS 256
#define MAX_R 16

__device__ __forceinline__ int lower_bound(const int32_t* lv, int K, int32_t x) {
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lv[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// --- the pod tier, as K27 and K29 stream it ------------------------------------------------
#define DENSE_PPT 16  // consecutive tier rows a thread loads
#define FULL_MASK 0xffffffffu

// DENSE_PPT rows from r0: their nodes (−1 past the tier) and their valid
// bits; 16-byte loads where the tier's arrays allow
__device__ __forceinline__ void load_pods(const uint8_t* __restrict__ valid,
                                          const int32_t* __restrict__ node, int P,
                                          long long r0, int vec, int (&nd)[DENSE_PPT],
                                          unsigned& vm) {
  vm = 0u;
  if (vec && r0 + DENSE_PPT <= P) {
    const int4* np = reinterpret_cast<const int4*>(node + r0);
#pragma unroll
    for (int q = 0; q < DENSE_PPT / 4; ++q) {
      const int4 v = __ldg(np + q);
      nd[4 * q] = v.x; nd[4 * q + 1] = v.y; nd[4 * q + 2] = v.z; nd[4 * q + 3] = v.w;
    }
    const uint4 vv = __ldg(reinterpret_cast<const uint4*>(valid + r0));
    const unsigned w[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int j = 0; j < DENSE_PPT; ++j)
      if ((w[j >> 2] >> (8 * (j & 3))) & 0xffu) vm |= 1u << j;
  } else {
#pragma unroll
    for (int j = 0; j < DENSE_PPT; ++j) {
      const long long r = r0 + j;
      nd[j] = r < P ? __ldg(node + r) : -1;
      if (r < P && __ldg(valid + r)) vm |= 1u << j;
    }
  }
}

// --- K27 ---------------------------------------------------------------------
// A block: PREFIX_TILE nodes (two a lane), PREFIX_THREADS threads, one block
// an SM; the tier in chunks of PREFIX_CHUNK rows, the gathered list flushed
// every PREFIX_CAP entries.  Dynamic shared memory: tot f32[W][R+1][TILE]
// (the window's level totals), exb f32[W/16 + 1][R+1][TILE] (the scan's
// carry into each of the window's live 16-level blocks, then past them),
// then the list's requests f32[CAP][R], rows i32[CAP], levels i16[CAP] and
// nodes u8[CAP].  A 32-node tile (two blocks an SM) and a 128-node tile
// both measured slower than 64 (PERF.md, the kernel table).
#define PREFIX_TILE 64
#define PREFIX_WARPS 16
#define PREFIX_THREADS (PREFIX_WARPS * 32)
#define PREFIX_CHUNK (PREFIX_THREADS * DENSE_PPT)
#define PREFIX_CAP 1024
#define PREFIX_MAX_SMEM (200 * 1024)  // dynamic bytes
#define PREFIX_REG_LEVELS 4           // a window this small sums in registers

static size_t prefix_list_bytes(int R) {
  return (size_t)PREFIX_CAP * (4 * (size_t)R + 4 + 2 + 1);
}

// the window (levels a pass keeps in shared memory, a multiple of 16, at
// most K rounded up) and the dynamic shared memory for R requests and K
// levels; cudaErrorInvalidValue where not even 16 levels fit
static int prefix_plan(int R, int K, int* window, size_t* smem) {
  const size_t per_level = (size_t)PREFIX_TILE * (R + 1) * 4, list = prefix_list_bytes(R);
  const int k16 = K > BLOCK_BASE ? (K + BLOCK_BASE - 1) / BLOCK_BASE * BLOCK_BASE : BLOCK_BASE;
  int w = 0;
  for (int c = BLOCK_BASE; c <= k16; c += BLOCK_BASE)
    if (list + (size_t)(c + c / BLOCK_BASE + 1) * per_level <= PREFIX_MAX_SMEM) w = c;
  if (!w) return (int)cudaErrorInvalidValue;
  *window = w;
  *smem = list + (size_t)(w + w / BLOCK_BASE + 1) * per_level;
  return 0;
}

struct PrefixList {
  float* tot;
  float* exb;
  float* req;
  int32_t* row;
  int16_t* lvl;
  uint8_t* node;
};

// the list's entries [0, len): each one's priority and requests loaded at
// once (two entries a thread, every load issued before the first store),
// its bucket by lower_bound over the Lw live levels (−1 where the reference
// drops it, a bucket of K), its requests converted once
template <int RB>
__device__ __forceinline__ void prefix_load_list(const PrefixList& s, int len, int R, int K,
                                                 int Lw, const int32_t* lv,
                                                 const int32_t* __restrict__ pprio,
                                                 const int32_t* __restrict__ preq) {
  for (int e0 = 0; e0 < len; e0 += 2 * PREFIX_THREADS) {
    int32_t pr[2], q[2][RB];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = e0 + u * PREFIX_THREADS + threadIdx.x;
      const long long row = e < len ? s.row[e] : 0;
      pr[u] = e < len ? __ldg(pprio + row) : 0;
#pragma unroll
      for (int r = 0; r < RB; ++r) q[u][r] = (e < len && r < R) ? __ldg(preq + row * R + r) : 0;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = e0 + u * PREFIX_THREADS + threadIdx.x;
      if (e >= len) continue;
      const int b = lower_bound(lv, Lw, pr[u]);
      s.lvl[e] = (int16_t)(b < K ? b : -1);
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < R) s.req[e * R + r] = __int2float_rn(q[u][r]);
    }
  }
}

__device__ __forceinline__ float* prefix_cell(const PrefixList& s, int C1, int l, int ch, int h) {
  return s.tot + ((size_t)l * C1 + ch) * PREFIX_TILE + h;
}

// the window's levels [w0, w0 + wn) of the list's entries [0, len) into tot:
// warp w owns channels w and w + 16 (the count is channel R), lane j nodes j,
// j + 32, ...  Per group of 32 entries each lane loads one entry (its level
// and the warp's channels' values) and the entries of each node come
// together as a mask (__match_any_sync); then, for as long as any lane has
// an entry left, each lane takes its node's next one, low bit first, by
// shuffle from the lane that loaded it -- so each sum is in list order,
// which is row order, and a node holding the whole group costs 32 shuffle
// rounds, not 32 trips to shared memory.  A window of at most
// PREFIX_REG_LEVELS levels sums in registers (loaded from tot, stored
// back); a wider one adds into tot directly.
__device__ __forceinline__ void prefix_walk(const PrefixList& s, int len, int R, int w0,
                                            int wn, unsigned (*s_mask)[PREFIX_TILE]) {
  constexpr int HN = PREFIX_TILE / 32;  // nodes a lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, C1 = R + 1;
  if (warp >= C1) return;
  const bool two = warp + PREFIX_WARPS < C1;  // a second channel
  const int ch1 = two ? warp + PREFIX_WARPS : warp;
  const bool reg = wn <= PREFIX_REG_LEVELS;
  float acc[PREFIX_REG_LEVELS][HN][2];
#pragma unroll
  for (int q = 0; q < PREFIX_REG_LEVELS; ++q)
#pragma unroll
    for (int hh = 0; hh < HN; ++hh) {
      const int h = lane + 32 * hh;
      acc[q][hh][0] = reg && q < wn ? *prefix_cell(s, C1, q, warp, h) : 0.0f;
      acc[q][hh][1] = reg && q < wn && two ? *prefix_cell(s, C1, q, ch1, h) : 0.0f;
    }
  for (int g = 0; g < len; g += 32) {
#pragma unroll
    for (int hh = 0; hh < HN; ++hh) s_mask[warp][lane + 32 * hh] = 0u;
    __syncwarp();
    const int e = g + lane;
    int key = -1, my_l = 0;
    float my0 = 0.0f, my1 = 0.0f;
    if (e < len) {
      const int l = s.lvl[e] - w0;
      if (l >= 0 && l < wn) {
        key = s.node[e];
        my_l = l;
        my0 = warp < R ? s.req[e * R + warp] : 1.0f;
        my1 = ch1 < R ? s.req[e * R + ch1] : 1.0f;
      }
    }
    const unsigned peers = __match_any_sync(FULL_MASK, key);
    if (key >= 0 && lane == __ffs(peers) - 1) s_mask[warp][key] = peers;
    __syncwarp();
#pragma unroll
    for (int hh = 0; hh < HN; ++hh) {
      const int h = lane + 32 * hh;
      unsigned mk = s_mask[warp][h];
      while (__any_sync(FULL_MASK, mk != 0u)) {
        const bool has = mk != 0u;
        const int j = has ? __ffs(mk) - 1 : lane;
        mk &= mk - 1u;
        const int l = __shfl_sync(FULL_MASK, my_l, j);
        const float v0 = __shfl_sync(FULL_MASK, my0, j);
        const float v1 = __shfl_sync(FULL_MASK, my1, j);
        if (!has) continue;
        if (reg) {
#pragma unroll
          for (int q = 0; q < PREFIX_REG_LEVELS; ++q) {
            if (q != l) continue;
            acc[q][hh][0] = __fadd_rn(acc[q][hh][0], v0);
            if (two) acc[q][hh][1] = __fadd_rn(acc[q][hh][1], v1);
          }
        } else {
          float* a0 = prefix_cell(s, C1, l, warp, h);
          *a0 = __fadd_rn(*a0, v0);
          if (two) {
            float* a1 = prefix_cell(s, C1, l, ch1, h);
            *a1 = __fadd_rn(*a1, v1);
          }
        }
      }
    }
    __syncwarp();
  }
  if (reg) {
#pragma unroll
    for (int q = 0; q < PREFIX_REG_LEVELS; ++q)
#pragma unroll
      for (int hh = 0; hh < HN; ++hh) {
        if (q >= wn) continue;
        *prefix_cell(s, C1, q, warp, lane + 32 * hh) = acc[q][hh][0];
        if (two) *prefix_cell(s, C1, q, ch1, lane + 32 * hh) = acc[q][hh][1];
      }
  }
}

// one output vector's rows of one 16-level block b: WIDTH elements (channels
// ch0.. of node h, dc = 1, dh = 0; or channel R of nodes h.., dc = 0, dh = 1)
// at out (row 0) + t * rs.  XLA:CPU's blocked recurrence from registers:
// an inclusive run inside the block, plus the carry into the block (b > 0);
// a live block reads its levels below Lw from tot and its carry from exb, a
// block past the live levels adds 0.0 and takes the carry past them.  Row 0
// (zero) by block 0.
template <int WIDTH>
__device__ __forceinline__ void prefix_block_rows(const PrefixList& s, float* __restrict__ out,
                                                  long long rs, int C1, int h, int ch0, int dc,
                                                  int dh, int K, int Lw, int w0, int b,
                                                  int b_lo, int b_live) {
  const bool live = b < b_live;
  float excl[WIDTH], x[BLOCK_BASE][WIDTH];
#pragma unroll
  for (int k = 0; k < WIDTH; ++k)
    excl[k] = s.exb[((size_t)(min(b, b_live) - b_lo) * C1 + ch0 + k * dc) * PREFIX_TILE + h +
                    k * dh];
  if (!live) {
    // the carry past the live levels, then one block of zeros each
    for (int d = b_live; d < b; ++d)
#pragma unroll
      for (int k = 0; k < WIDTH; ++k) excl[k] = __fadd_rn(excl[k], 0.0f);
  }
  const int len = min(BLOCK_BASE, K - b * BLOCK_BASE);
#pragma unroll
  for (int i = 0; i < BLOCK_BASE; ++i) {
    const int level = b * BLOCK_BASE + i;
    const bool in = live && i < len && level < Lw;
#pragma unroll
    for (int k = 0; k < WIDTH; ++k)
      x[i][k] = in ? s.tot[((size_t)(level - w0) * C1 + ch0 + k * dc) * PREFIX_TILE + h + k * dh]
                   : 0.0f;
  }
  if (b == 0) {
    if constexpr (WIDTH == 4)
      *reinterpret_cast<float4*>(out) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    else
      out[0] = 0.0f;
  }
  float run[WIDTH];
#pragma unroll
  for (int i = 0; i < BLOCK_BASE; ++i) {
    if (i >= len) break;
    float y[WIDTH];
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) {
      run[k] = i == 0 ? x[i][k] : __fadd_rn(run[k], x[i][k]);
      y[k] = b == 0 ? run[k] : __fadd_rn(run[k], excl[k]);
    }
    float* at = out + (long long)(b * BLOCK_BASE + i + 1) * rs;
    if constexpr (WIDTH == 4)
      *reinterpret_cast<float4*>(at) = make_float4(y[0], y[1], y[2], y[3]);
    else
      at[0] = y[0];
  }
}

template <int RB>
__global__ void __launch_bounds__(PREFIX_THREADS, 1)
priority_prefix_kernel(int N, int R, int K, int P, int W, int vec,
                       const uint8_t* __restrict__ pvalid, const int32_t* __restrict__ pnode,
                       const int32_t* __restrict__ pprio, const int32_t* __restrict__ preq,
                       const int32_t* __restrict__ levels, float* __restrict__ prefix,
                       float* __restrict__ prefix_cnt) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t lv[MAX_LEVELS];
  __shared__ int s_wsum[2][PREFIX_WARPS];  // the warps' gathered counts, by chunk parity
  __shared__ unsigned s_mask[PREFIX_WARPS][PREFIX_TILE];
  const int C1 = R + 1;
  PrefixList s;
  s.tot = reinterpret_cast<float*>(smem);
  s.exb = s.tot + (size_t)W * C1 * PREFIX_TILE;
  s.req = s.exb + (size_t)(W / BLOCK_BASE + 1) * C1 * PREFIX_TILE;
  s.row = reinterpret_cast<int32_t*>(s.req + (size_t)PREFIX_CAP * R);
  s.lvl = reinterpret_cast<int16_t*>(s.row + PREFIX_CAP);
  s.node = reinterpret_cast<uint8_t*>(s.lvl + PREFIX_CAP);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * PREFIX_TILE;
  for (int i = tid; i < K; i += PREFIX_THREADS) lv[i] = levels[i];
  __syncthreads();
  // the buckets a pod can take: the levels below i32-max and the first pad
  const int Lw = min(K, lower_bound(lv, K, INT_MAX) + 1);

  // the output vectors: (node, 4 channels) of prefix and (4 nodes) of
  // prefix_cnt where 16-byte stores line up, else one element
  const bool al = ((uintptr_t)prefix & 15u) == 0 && ((uintptr_t)prefix_cnt & 15u) == 0;
  const bool vreq = al && R % 4 == 0, vcnt = al && N % 4 == 0;
  const int nreq = vreq ? PREFIX_TILE * R / 4 : PREFIX_TILE * R;
  const int items = nreq + (vcnt ? PREFIX_TILE / 4 : PREFIX_TILE);

  bool listed = false;  // the whole list stayed in shared memory (no overflow)
  int len = 0;
  for (int w0 = 0; w0 == 0 || w0 < Lw; w0 += W) {
    const int wn = max(0, min(W, Lw - w0));
    const bool last = w0 + W >= Lw;
    for (int i = tid; i < wn * C1 * PREFIX_TILE; i += PREFIX_THREADS) s.tot[i] = 0.0f;
    __syncthreads();
    if (listed) {
      prefix_walk(s, len, R, w0, wn, s_mask);
    } else if (wn > 0) {
      // stream the tier: the tile's pods in row order, flushed a round at a time
      bool overflow = false;
      len = 0;
      int nd[DENSE_PPT];
      unsigned vm;
      load_pods(pvalid, pnode, P, (long long)tid * DENSE_PPT, vec, nd, vm);
      for (long long c0 = 0, parity = 0; c0 < P; c0 += PREFIX_CHUNK, parity ^= 1) {
        unsigned fm = 0u, loc[DENSE_PPT / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < DENSE_PPT; ++j) {
          const int l = min(nd[j], N - 1) - n0;
          if (((vm >> j) & 1u) && nd[j] >= 0 && l >= 0 && l < PREFIX_TILE) {
            fm |= 1u << j;
            loc[j >> 2] |= (unsigned)l << (8 * (j & 3));
          }
        }
        if (c0 + PREFIX_CHUNK < P)  // the next chunk's rows, in flight while this one's placed
          load_pods(pvalid, pnode, P, c0 + PREFIX_CHUNK + (long long)tid * DENSE_PPT, vec, nd,
                    vm);
        const int mine = __popc(fm);
        int incl = mine;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(FULL_MASK, incl, off);
          if (lane >= off) incl += y;
        }
        if (lane == 31) s_wsum[parity][warp] = incl;
        __syncthreads();
        int first = incl - mine, total = 0;
#pragma unroll
        for (int w = 0; w < PREFIX_WARPS; ++w) {
          const int sw = s_wsum[parity][w];
          if (w < warp) first += sw;
          total += sw;
        }
        for (int base = 0; base < total;) {
          const int take = min(total - base, PREFIX_CAP - len);
          int idx = first;
#pragma unroll
          for (int j = 0; j < DENSE_PPT; ++j) {
            if (!((fm >> j) & 1u)) continue;
            if (idx >= base && idx < base + take) {
              s.row[len + idx - base] = (int32_t)(c0 + tid * DENSE_PPT + j);
              s.node[len + idx - base] = (uint8_t)((loc[j >> 2] >> (8 * (j & 3))) & 0xffu);
            }
            ++idx;
          }
          len += take;
          base += take;
          if (len == PREFIX_CAP) {  // a full round: load, walk, start the list again
            __syncthreads();
            prefix_load_list<RB>(s, len, R, K, Lw, lv, pprio, preq);
            __syncthreads();
            prefix_walk(s, len, R, w0, wn, s_mask);
            __syncthreads();
            len = 0;
            overflow = true;
          }
        }
      }
      if (len > 0) {
        __syncthreads();
        prefix_load_list<RB>(s, len, R, K, Lw, lv, pprio, preq);
        __syncthreads();
        prefix_walk(s, len, R, w0, wn, s_mask);
      }
      listed = !overflow;
    }
    __syncthreads();
    // the window's 16-level blocks: [b_lo, b_live) hold live levels; on the
    // last window every block up to K follows.  First each element's carry
    // into each live block (exb), then each (output vector, block) writes
    // its rows.
    const int b_lo = w0 / BLOCK_BASE;
    const int b_live = (w0 + wn + BLOCK_BASE - 1) / BLOCK_BASE;
    const int b_hi = last ? (K + BLOCK_BASE - 1) / BLOCK_BASE : (w0 + W) / BLOCK_BASE;
    for (int i = tid; i < C1 * PREFIX_TILE; i += PREFIX_THREADS) {
      const int ch = i / PREFIX_TILE, h = i % PREFIX_TILE;
      const size_t at = (size_t)ch * PREFIX_TILE + h, step = (size_t)C1 * PREFIX_TILE;
      // the carry into this window: the last window's carry past its blocks
      float e = w0 == 0 ? 0.0f : s.exb[(size_t)(W / BLOCK_BASE) * step + at];
      for (int b = b_lo; b < b_live; ++b) {
        s.exb[(size_t)(b - b_lo) * step + at] = e;
        float run = 0.0f;
        for (int q = 0; q < BLOCK_BASE && b * BLOCK_BASE + q < K; ++q) {
          const int level = b * BLOCK_BASE + q;
          const float x = level < Lw ? s.tot[(size_t)(level - w0) * step + at] : 0.0f;
          run = q == 0 ? x : __fadd_rn(run, x);
        }
        e = b == 0 ? run : __fadd_rn(e, run);
      }
      s.exb[(size_t)(b_live - b_lo) * step + at] = e;
      if (!last) s.exb[(size_t)(W / BLOCK_BASE) * step + at] = e;
    }
    __syncthreads();
    const int nb = max(b_hi - b_lo, 1);  // K = 0: block 0 writes row 0
    for (int it = tid; it < items * nb; it += PREFIX_THREADS) {
      const int v = it % items, b = b_lo + it / items;
      if (v < nreq) {
        const int f = vreq ? 4 * v : v;
        const int h = f / max(R, 1), ch0 = f % max(R, 1);
        if (n0 + h >= N) continue;
        float* out = prefix + (long long)(n0 + h) * R + ch0;
        if (vreq)
          prefix_block_rows<4>(s, out, (long long)N * R, C1, h, ch0, 1, 0, K, Lw, w0, b, b_lo,
                               b_live);
        else
          prefix_block_rows<1>(s, out, (long long)N * R, C1, h, ch0, 1, 0, K, Lw, w0, b, b_lo,
                               b_live);
      } else {
        const int h = vcnt ? 4 * (v - nreq) : v - nreq;
        if (n0 + h >= N) continue;
        if (vcnt)
          prefix_block_rows<4>(s, prefix_cnt + n0 + h, N, C1, h, R, 0, 1, K, Lw, w0, b, b_lo,
                               b_live);
        else
          prefix_block_rows<1>(s, prefix_cnt + n0 + h, N, C1, h, R, 0, 1, K, Lw, w0, b, b_lo,
                               b_live);
      }
    }
    __syncthreads();
  }
}

// the fit of one (batch pod, node) given the freed vector
__device__ __forceinline__ bool fits_freed(int R, const int32_t* __restrict__ rq,
                                           const int32_t* __restrict__ alloc,
                                           const int32_t* __restrict__ requested,
                                           const float* freed, long long fstride) {
  for (int r = 0; r < R; ++r) {
    const float q = __int2float_rn(rq[r]);
    if (q == 0.0f) continue;
    const float base = __fsub_rn(__int2float_rn(alloc[r]), __int2float_rn(requested[r]));
    if (!(q <= __fadd_rn(base, freed[r * fstride]))) return false;
  }
  return true;
}

__global__ void candidate_fit_kernel(int B, int N, int R, int K,
                                     const float* __restrict__ prefix,
                                     const float* __restrict__ prefix_cnt,
                                     const int32_t* __restrict__ levels,
                                     const int32_t* __restrict__ priority,
                                     const int32_t* __restrict__ request,
                                     const int32_t* __restrict__ alloc,
                                     const int32_t* __restrict__ requested,
                                     const int32_t* __restrict__ bits, int32_t mask,
                                     uint8_t* __restrict__ out) {
  __shared__ int32_t lv[MAX_LEVELS];
  for (int i = threadIdx.x; i < K; i += blockDim.x) lv[i] = levels[i];
  __syncthreads();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)B * N) return;
  const int b = (int)(tid / N);
  const int n = (int)(tid % N);
  bool ok = (bits[tid] & mask) == mask;
  if (ok) {
    const long long tb = lower_bound(lv, K, priority[b]);
    ok = prefix_cnt[tb * N + n] > 0.0f
         && fits_freed(R, request + (long long)b * R, alloc + (long long)n * R,
                       requested + (long long)n * R, prefix + (tb * N + n) * R, 1);
  }
  out[tid] = ok ? 1 : 0;
}

// --- K29 ---------------------------------------------------------------------
// A block: DENSE_TILE nodes (one a lane) x DENSE_WARPS * KB batch rows (warp w
// takes rows w, w + DENSE_WARPS, ...); it streams the pod tier in chunks of
// DENSE_CHUNK rows, DENSE_PPT consecutive rows a thread, and gathers the
// tile's pods in row order into shared memory, DENSE_CAP a round.
#define DENSE_TILE 32
#define DENSE_WARPS 8
#define DENSE_CHUNK (DENSE_WARPS * 32 * DENSE_PPT)
#define DENSE_CAP 1024

// batch rows a thread carries: KB * (RB + 1) registers of sums and counts
template <int RB>
struct DenseRows {
  static constexpr int value = RB <= 4 ? 8 : (RB <= 8 ? 4 : 2);
};

template <int RB>
__global__ void __launch_bounds__(DENSE_WARPS * 32, 2)
candidate_dense_kernel(int B, int N, int R, int P, int vec,
                       const uint8_t* __restrict__ pvalid, const int32_t* __restrict__ pnode,
                       const int32_t* __restrict__ pprio, const int32_t* __restrict__ preq,
                       const int32_t* __restrict__ priority, const int32_t* __restrict__ request,
                       const int32_t* __restrict__ alloc, const int32_t* __restrict__ requested,
                       const int32_t* __restrict__ bits, int32_t mask,
                       uint8_t* __restrict__ out) {
  constexpr int KB = DenseRows<RB>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_req = reinterpret_cast<float*>(smem);                 // [DENSE_CAP][R]
  int32_t* s_prio = reinterpret_cast<int32_t*>(s_req + DENSE_CAP * R);  // [DENSE_CAP]
  int32_t* s_row = s_prio + DENSE_CAP;                                  // [DENSE_CAP]
  uint8_t* s_node = reinterpret_cast<uint8_t*>(s_row + DENSE_CAP);      // [DENSE_CAP]
  __shared__ int s_wsum[2][DENSE_WARPS];  // the warps' gathered counts, by chunk parity
  __shared__ unsigned s_mask[DENSE_WARPS][32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * DENSE_TILE, n = n0 + lane;
  const int b0 = blockIdx.y * (DENSE_WARPS * KB);
  int32_t thr[KB];
  float freed[KB][RB];
  int cnt[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const int b = b0 + warp + DENSE_WARPS * k;
    thr[k] = b < B ? __ldg(priority + b) : INT_MIN;  // a row past B counts nothing
    cnt[k] = 0;
#pragma unroll
    for (int r = 0; r < RB; ++r) freed[k][r] = 0.0f;
  }

  for (long long c0 = 0, parity = 0; c0 < P; c0 += DENSE_CHUNK, parity ^= 1) {
    int nd[DENSE_PPT];
    unsigned vm;
    load_pods(pvalid, pnode, P, c0 + (long long)tid * DENSE_PPT, vec, nd, vm);
    // this thread's pods of the tile, then their places in the chunk's
    // row-ordered list: a warp scan of the counts, then the warps' totals
    unsigned fm = 0u;
#pragma unroll
    for (int j = 0; j < DENSE_PPT; ++j)
      if (((vm >> j) & 1u) && nd[j] >= n0 && nd[j] < n0 + DENSE_TILE) fm |= 1u << j;
    const int mine = __popc(fm);
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_wsum[parity][warp] = incl;
    __syncthreads();
    int first = incl - mine, total = 0;
#pragma unroll
    for (int w = 0; w < DENSE_WARPS; ++w) {
      const int sw = s_wsum[parity][w];
      if (w < warp) first += sw;
      total += sw;
    }
    for (int rb = 0; rb < total; rb += DENSE_CAP) {
      // the round's list: each thread places its pods' rows and nodes
      int idx = first;
#pragma unroll
      for (int j = 0; j < DENSE_PPT; ++j) {
        if (!((fm >> j) & 1u)) continue;
        if (idx >= rb && idx < rb + DENSE_CAP) {
          s_row[idx - rb] = tid * DENSE_PPT + j;  // the row, past c0
          s_node[idx - rb] = (uint8_t)(nd[j] - n0);
        }
        ++idx;
      }
      __syncthreads();
      // their priorities and requests, an entry a thread, every load of an
      // entry issued before its first store
      const int m = min(DENSE_CAP, total - rb);
      for (int e = tid; e < m; e += DENSE_WARPS * 32) {
        const long long row = c0 + s_row[e];
        const int32_t pr = __ldg(pprio + row);
        int32_t q[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) q[r] = r < R ? __ldg(preq + row * R + r) : 0;
        s_prio[e] = pr;
#pragma unroll
        for (int r = 0; r < RB; ++r)
          if (r < R) s_req[e * R + r] = __int2float_rn(q[r]);
      }
      __syncthreads();
      // each lane sums its node's pods in list order: per group of 32
      // entries, the entries of each node as a mask (the group leader of
      // equal nodes writes it to that node's lane), walked low bit first
      for (int g = 0; g < m; g += 32) {
        s_mask[warp][lane] = 0u;
        __syncwarp();
        const int e = g + lane;
        const int ne = e < m ? (int)s_node[e] : -1;
        const unsigned peers = __match_any_sync(FULL_MASK, ne);
        if (ne >= 0 && lane == __ffs(peers) - 1) s_mask[warp][ne] = peers;
        __syncwarp();
        unsigned mk = s_mask[warp][lane];
        while (mk) {
          const int ei = g + __ffs(mk) - 1;
          mk &= mk - 1u;
          const int32_t pr = s_prio[ei];
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            if (!(pr < thr[k])) continue;
            ++cnt[k];
#pragma unroll
            for (int r = 0; r < RB; ++r)
              if (r < R) freed[k][r] = __fadd_rn(freed[k][r], s_req[ei * R + r]);
          }
        }
        __syncwarp();
      }
      __syncthreads();
    }
  }

  if (n >= N) return;
  // the fit: the node's free room once, then each row's request, every
  // load issued before the first compare
  float base[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r)
    base[r] = r < R ? __fsub_rn(__int2float_rn(__ldg(alloc + (long long)n * R + r)),
                                __int2float_rn(__ldg(requested + (long long)n * R + r)))
                    : 0.0f;
  int32_t sb[KB], rq[KB][RB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const int b = b0 + warp + DENSE_WARPS * k;
    sb[k] = b < B ? __ldg(bits + (long long)b * N + n) : 0;
#pragma unroll
    for (int r = 0; r < RB; ++r)
      rq[k][r] = (b < B && r < R) ? __ldg(request + (long long)b * R + r) : 0;
  }
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const int b = b0 + warp + DENSE_WARPS * k;
    if (b >= B) continue;
    bool ok = (sb[k] & mask) == mask && cnt[k] > 0;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float q = __int2float_rn(rq[k][r]);  // 0 past R
      if (q != 0.0f && !(q <= __fadd_rn(base[r], freed[k][r]))) ok = false;
    }
    out[(long long)b * N + n] = ok ? 1 : 0;
  }
}

static int blocks_for(long long total, int threads) {
  return (int)((total + threads - 1) / threads);
}

template <int RB>
static int launch_prefix(int N, int R, int K, int P, const void* pod_valid, const void* pod_node,
                         const void* pod_prio, const void* pod_req, const void* levels,
                         void* prefix, void* prefix_cnt, cudaStream_t stream) {
  int window;
  size_t smem;
  const int e = prefix_plan(R, K, &window, &smem);
  if (e) return e;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t a = cudaFuncSetAttribute(priority_prefix_kernel<RB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               PREFIX_MAX_SMEM);
    if (a != cudaSuccess) return (int)a;
    attr_set = true;
  }
  const int vec = ((uintptr_t)pod_valid % 16 == 0 && (uintptr_t)pod_node % 16 == 0) ? 1 : 0;
  priority_prefix_kernel<RB><<<(N + PREFIX_TILE - 1) / PREFIX_TILE, PREFIX_THREADS, smem,
                               stream>>>(
      N, R, K, P, window, vec, (const uint8_t*)pod_valid, (const int32_t*)pod_node,
      (const int32_t*)pod_prio, (const int32_t*)pod_req, (const int32_t*)levels,
      (float*)prefix, (float*)prefix_cnt);
  return (int)cudaGetLastError();
}

extern "C" int launch_priority_prefix(int N, int R, int K, int P, const void* pod_valid,
                                      const void* pod_node, const void* pod_prio,
                                      const void* pod_req, const void* levels, void* prefix,
                                      void* prefix_cnt, void* stream) {
  if (K < 0 || K > MAX_LEVELS || R < 0 || R > MAX_R || N < 0 || P < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (R <= 4)
    return launch_prefix<4>(N, R, K, P, pod_valid, pod_node, pod_prio, pod_req, levels, prefix,
                            prefix_cnt, st);
  if (R <= 8)
    return launch_prefix<8>(N, R, K, P, pod_valid, pod_node, pod_prio, pod_req, levels, prefix,
                            prefix_cnt, st);
  return launch_prefix<16>(N, R, K, P, pod_valid, pod_node, pod_prio, pod_req, levels, prefix,
                           prefix_cnt, st);
}

// K27's plan, for the CPU mirror's copy (kernel_work.k27_plan): out[0] the
// window in levels, out[1] the dynamic shared memory in bytes
extern "C" int priority_prefix_plan(int R, int K, int* out) {
  int window;
  size_t smem;
  const int e = prefix_plan(R, K, &window, &smem);
  if (e) return e;
  out[0] = window;
  out[1] = (int)smem;
  return 0;
}

extern "C" int launch_candidate_fit(int B, int N, int R, int K, const void* prefix,
                                    const void* prefix_cnt, const void* levels,
                                    const void* priority, const void* request,
                                    const void* alloc, const void* requested,
                                    const void* bits, int mask, void* out, void* stream) {
  if (K > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * N;
  if (total <= 0) return 0;
  const int threads = 256;
  candidate_fit_kernel<<<blocks_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      B, N, R, K, (const float*)prefix, (const float*)prefix_cnt, (const int32_t*)levels,
      (const int32_t*)priority, (const int32_t*)request, (const int32_t*)alloc,
      (const int32_t*)requested, (const int32_t*)bits, (int32_t)mask, (uint8_t*)out);
  return (int)cudaGetLastError();
}

template <int RB>
static int launch_dense(int B, int N, int R, int P, const void* pod_valid,
                        const void* pod_node, const void* pod_prio, const void* pod_req,
                        const void* priority, const void* request, const void* alloc,
                        const void* requested, const void* bits, int mask, void* out,
                        cudaStream_t stream) {
  constexpr int TB = DENSE_WARPS * DenseRows<RB>::value;
  const long long gy = ((long long)B + TB - 1) / TB;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)DENSE_CAP * (4 * R + 9);
  static bool attr_set = false;
  if (smem > 48 * 1024 && !attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        candidate_dense_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)((size_t)DENSE_CAP * (4 * MAX_R + 9)));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int vec = ((uintptr_t)pod_valid % 16 == 0 && (uintptr_t)pod_node % 16 == 0) ? 1 : 0;
  const dim3 grid((unsigned)((N + DENSE_TILE - 1) / DENSE_TILE), (unsigned)gy);
  candidate_dense_kernel<RB><<<grid, DENSE_WARPS * 32, smem, stream>>>(
      B, N, R, P, vec, (const uint8_t*)pod_valid, (const int32_t*)pod_node,
      (const int32_t*)pod_prio, (const int32_t*)pod_req, (const int32_t*)priority,
      (const int32_t*)request, (const int32_t*)alloc, (const int32_t*)requested,
      (const int32_t*)bits, (int32_t)mask, (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int launch_candidate_dense(int B, int N, int R, int P, const void* pod_valid,
                                      const void* pod_node, const void* pod_prio,
                                      const void* pod_req, const void* priority,
                                      const void* request, const void* alloc,
                                      const void* requested, const void* bits, int mask,
                                      void* out, void* stream) {
  if (R < 0 || R > MAX_R || B < 0 || N < 0 || P < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (R <= 4)
    return launch_dense<4>(B, N, R, P, pod_valid, pod_node, pod_prio, pod_req, priority,
                           request, alloc, requested, bits, mask, out, st);
  if (R <= 8)
    return launch_dense<8>(B, N, R, P, pod_valid, pod_node, pod_prio, pod_req, priority,
                           request, alloc, requested, bits, mask, out, st);
  return launch_dense<16>(B, N, R, P, pod_valid, pod_node, pod_prio, pod_req, priority,
                          request, alloc, requested, bits, mask, out, st);
}
