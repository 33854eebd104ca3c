// K5–K8: PodTopologySpread's domain count tables for the identity-class
// dedup cycle (and, at identity classes, the full auction); K14: their
// deep-pipeline chain hook; K18: the exact scan's per-pod update.
//
// Replaces (JAX package): plugins/podtopologyspread.py prepare (:112-134),
// filter (:166-182), score (:186-215) + normalize (:217-232),
// update_batch_classes (:341-364), update_batch (:366-388), chain_prev
// (:306-339) and update (:287-304), with the
// ops/segment.py domain gather, scatter-add and any (:27-97) they are built
// on.
//
// Tables are [C, Cc, D1] int32 (C class rows, Cc constraints per pod,
// D1 = D + 1 domains with the trash slot D of nodes without the key);
// dom_val [C, Cc, N] holds each node's domain under each constraint's key.
//
// K5 spread_prepare_counts: one thread per (constraint row, scheduled pod)
//   adds the pod to its node's domain with an integer atomic (the reference
//   builds the same counts through a [C·Cc, P] × [P, N] matmul against a
//   pod→node one-hot, 268 MB of float32 at P = N = 8192), and one thread per
//   (constraint row, node) marks the present domains.  Bound: bytes (the
//   match plane and dom_val, read once).
// K6 spread_filter_bits: clears the filter's bit in K1's pass-bit plane in
//   place.  Bound: bytes (the tables once, dom_val / has_key of the hard
//   constraints, the bits where the filter fails); at C = 1–4 latency.  One
//   pass: each thread issues its 4-node vector's loads (bits, every
//   constraint's dom_val and has_key) at entry, before any barrier.  The
//   test matchNum + selfMatch − min ≤ maxSkew depends only on the domain, so
//   it is built once per (constraint, domain) as a bitmap and a node's test
//   is its key and one bit.  Up to 32 domains (a zone
//   key) every warp loads the row's tables and scalars with its node loads
//   and builds each constraint's word in registers with warp reductions and
//   a ballot: no barrier at all.  Above (a hostname key, up to 8193) the
//   words live in shared memory and a row's blocks form a cluster of up to 8
//   (cudaLaunchKernelEx) that split the table by whole verdict words: past
//   a first cluster barrier every block reads the others' partial minima
//   and present counts through distributed shared memory and pushes its
//   words (from the counts its reduction loaded, kept in registers) into
//   every block, a second barrier before they are read.  A bit
//   vector is written back only where a word changes.
// K7 spread_score_combine: score + normalize + the weighted floor into K2's
//   total.  Bound: bytes (the bit plane read once, the total read and
//   written on feasible nodes, has_key / dom_val of the soft constraints).
//   A row with no soft constraint (DoNotSchedule: TopologySpreading) scores
//   0 everywhere, so its feasible nodes normalize to 100: one pass over the
//   bits and the total, total += weight · 100.  Otherwise one read: each
//   thread keeps its nodes' feasible / scored masks and raw scores in
//   registers; the scored nodes' domains go into a shared-memory bitmap per
//   constraint; at most 16 rows a row is split over a thread-block cluster
//   of up to 8 blocks (cudaLaunchKernelEx; the plan, cluster size and slice,
//   a by-value kernel parameter), whose bitmaps are OR-merged through
//   distributed shared memory (topo_size by popcount) and whose max / min
//   partials are pushed into every block of the cluster — two cluster
//   barriers; above 16 rows one block a row (two at the 100k-node tier).
//   The raw score is computed once, after the merge, and the normalize /
//   floor / weight / add is written from registers.
// K8 spread_update_classes: one auction round's commits into the class
//   tables.  O(B · C · Cc) where the reference's einsum is O(C · Cc · N).
//   Bound: latency (a round of TopologySpreading commits one pod).  One
//   launch a call: class_of is read as the engines hand it over (int64),
//   choice as int32, so the wrapper makes no copy on the path's dtypes.  One thread a (pod, class constraint row), a warp 32
//   consecutive pods of one row, so the per-pod inputs are a warp's three
//   coalesced loads.  Two dependent round trips where there were five: the
//   pod's commit flag, class and node are issued together at entry, with
//   no branch between them; then, for a committed pod, the row's match
//   byte with the node's domain and counted flags at once; then the adds,
//   atomic adds that nothing waits on, a warp's adds to one domain summed
//   first.  (Measured slower, PERF.md §6: a thread owning a pod and a group
//   of up to 8 rows, 2.54 µs on the one-commit round at C = 4 where a row a
//   thread takes 1.46; summing a block's adds in shared memory, a barrier
//   more on the path's one-commit rounds.)
// K14 spread_chain_prev: the deep pipeline's chain hook — a still-in-flight
//   batch's placements folded into this batch's tables (chain_prev,
//   :306-339).  One thread per (class constraint row, prev pod): a placed
//   prev pod the row's selector matches adds one at its node's domain,
//   where that node counts.  The reference scatters a [C, Cc, B0] float
//   plane over a [.., B0, D+1] one-hot; the integer atomics need none.
//   Bound: latency (≤ C · Cc · B0 threads, a few hundred bytes written).
// K18 spread_update_row: the scan's step update (update, :287-304) — pod i
//   placed on the node K17 wrote to node_row[i] (read on the card; < 0: no
//   change).  One thread per (pending pod j, constraint) whose selector
//   matches pod i: one add at the node's domain (the trash slot for a
//   keyless node, as the reference's point scatter) where the node counts
//   for j.  No one-hot, no host read.  Bound: latency (B · Cc threads, the
//   match column read once).  The node's load cannot be avoided; after it
//   one round trip carries the match byte with the node's domain and
//   counted flags, and the add is an atomic add that nothing waits on, in
//   place of the read-modify-write: two dependent round trips where there
//   were four.  (Loading the row's table rows with the node, to store
//   count + 1 from registers, was measured slower than the old kernel: 18
//   strided loads a thread; loading the match byte with the node made a
//   step whose node is −1 wait on it.)  The match column stays strided
//   (Bp bytes apart): one round trip either way, and a transposed copy
//   would cost a launch and an aux field each batch.
//
// Numerics (built with --fmad=false): the score term is cnt · w + (maxSkew −
// 1) as a rounded multiply then a rounded add, summed over the constraints in
// order, rounded half to even (rintf, as jnp.round; never roundf); w comes
// from the TOPO_LOG table (XLA:CPU's float32 log bits); the normalization is
// 100 · ((max + min) − s) / max with a correctly rounded divide.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define MAX_CC 8
#define BIG (1 << 30)
#define MAX_NODE_SCORE 100.0f

// --- K5 -----------------------------------------------------------------------------

__global__ void spread_prepare_kernel(int C, int Cc, int P, int N, int D1,
                                      const uint8_t* __restrict__ match,  // [C, Cc, P]
                                      const int32_t* __restrict__ pod_node,  // [P]
                                      const int32_t* __restrict__ dom_val,  // [C, Cc, N]
                                      const uint8_t* __restrict__ counted_hard,  // [C, N]
                                      const uint8_t* __restrict__ counted_soft,  // [C, N]
                                      int32_t* __restrict__ hard,  // [C, Cc, D1]
                                      int32_t* __restrict__ soft,  // [C, Cc, D1]
                                      uint8_t* __restrict__ present) {  // [C, Cc, D1]
  const int row = blockIdx.y;  // c * Cc + cc
  const int c = row / Cc;
  const int D = D1 - 1;
  const long long total = (long long)P + N;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < P) {
      const int p = (int)i;
      if (!match[(long long)row * P + p]) continue;
      int n = pod_node[p];
      if (n < 0) continue;
      if (n > N - 1) n = N - 1;  // the reference clips the pod's node row
      const int dv = dom_val[(long long)row * N + n];
      if (counted_hard[(long long)c * N + n]) atomicAdd(&hard[(long long)row * D1 + dv], 1);
      if (counted_soft[(long long)c * N + n]) atomicAdd(&soft[(long long)row * D1 + dv], 1);
    } else {
      const int n = (int)(i - P);
      const int dv = dom_val[(long long)row * N + n];
      if (counted_hard[(long long)c * N + n] && dv < D) present[(long long)row * D1 + dv] = 1;
    }
  }
}

extern "C" int launch_spread_prepare(int C, int Cc, int P, int N, int D1,
                                     const void* match, const void* pod_node,
                                     const void* dom_val, const void* counted_hard,
                                     const void* counted_soft, void* hard, void* soft,
                                     void* present, void* stream) {
  if (C <= 0 || Cc <= 0 || (long long)P + N <= 0) return 0;
  const int threads = 256;
  long long blocks = ((long long)P + N + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  dim3 grid((unsigned)blocks, C * Cc);
  spread_prepare_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      C, Cc, P, N, D1, (const uint8_t*)match, (const int32_t*)pod_node,
      (const int32_t*)dom_val, (const uint8_t*)counted_hard, (const uint8_t*)counted_soft,
      (int32_t*)hard, (int32_t*)soft, (uint8_t*)present);
  return (int)cudaGetLastError();
}

// --- shared by K6–K8 and K18 ------------------------------------------------------

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int VEC>
__device__ __forceinline__ void ld_i32(const int32_t* p, int (&o)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
    o[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ unsigned ld_flags(const uint8_t* p) {
  if constexpr (VEC == 4) {
    const uchar4 v = __ldg(reinterpret_cast<const uchar4*>(p));
    return (v.x ? 1u : 0u) | (v.y ? 2u : 0u) | (v.z ? 4u : 0u) | (v.w ? 8u : 0u);
  } else {
    return __ldg(p) ? 1u : 0u;
  }
}

// loads issued where they stand: a volatile asm is neither dropped nor sunk
// into the one branch that uses its result, so a prefetch stays a prefetch
// across an early exit or a barrier
template <int VEC>
__device__ __forceinline__ void ld_early_i32(const int32_t* p, int (&o)[VEC]) {
  if constexpr (VEC == 4) {
    asm volatile("ld.global.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(o[0]), "=r"(o[1]), "=r"(o[2]), "=r"(o[3]) : "l"(p));
  } else {
    asm volatile("ld.global.s32 %0, [%1];" : "=r"(o[0]) : "l"(p));
  }
}

// VEC bool bytes → bit e set where byte e is not 0
template <int VEC>
__device__ __forceinline__ unsigned ld_early_flags(const uint8_t* p) {
  unsigned v;
  if constexpr (VEC == 4) {
    asm volatile("ld.global.u32 %0, [%1];" : "=r"(v) : "l"(p));
    return ((v & 0xffu) ? 1u : 0u) | ((v & 0xff00u) ? 2u : 0u) | ((v & 0xff0000u) ? 4u : 0u) |
           ((v & 0xff000000u) ? 8u : 0u);
  } else {
    asm volatile("ld.global.u8 %0, [%1];" : "=r"(v) : "l"(p));
    return v ? 1u : 0u;
  }
}

static bool aligned_to(const void* p, uintptr_t a) { return ((uintptr_t)p & (a - 1)) == 0; }

// --- K6 -----------------------------------------------------------------------------

#define FILTER_THREADS 256
#define FILTER_MAX_CLUSTER 8
#define FILTER_WORDS 257    // a constraint's verdict bits: D + 1 ≤ 8193 (TOPO_LOG_MAX + 1)
#define FILTER_SMALL_D1 32  // a table whose verdict is one word: one warp builds it
#define FILTER_PRE 5        // a large table's verdict words a warp builds from registers

struct FilterRow {
  int C, Cc, N, D1, enable_min_domains, bit;
  const int32_t* counts;       // [C, Cc, D1] hard counts
  const uint8_t* present;      // [C, Cc, D1]
  const uint8_t* hard_valid;   // [C, Cc]
  const int32_t* max_skew;     // [C, Cc]
  const int32_t* min_domains;  // [C, Cc]
  const uint8_t* self_match;   // [C, Cc]
  const int32_t* dom_val;      // [C, Cc, N]
  const uint8_t* has_key;      // [C, Cc, N]
  int32_t* bits;               // [C, N], updated in place
};

// the launch's shape, a kernel parameter: NB blocks a row, block r taking
// the nodes [r · threads · VEC, (r + 1) · threads · VEC), one vector a
// thread; above FILTER_SMALL_D1 domains, CL consecutive blocks of a row (a
// thread-block cluster when CL > 1) split the table, block q building the
// verdict words [q WS, (q + 1) WS) of every hard constraint
struct FilterPlan {
  int NB;
  int CL;
  int WS;
};

// a constraint's scalars: minDomains, selfMatch (0 / 1) and maxSkew
struct FilterScalars {
  int md, sf, ms;
};

__device__ __forceinline__ FilterScalars filter_scalars(const FilterRow& r, size_t ck) {
  int md[1], ms[1];
  ld_early_i32<1>(r.min_domains + ck, md);
  ld_early_i32<1>(r.max_skew + ck, ms);
  return {md[0], (int)ld_early_flags<1>(r.self_match + ck), ms[0]};
}

// the constraint's global minimum over present domains (BIG when none is
// present), lowered to 0 where minDomains asks for more domains than are
// present: the reference's min_match
__device__ __forceinline__ int filter_min(const FilterRow& r, const FilterScalars& f, int m,
                                          int n_present) {
  return (r.enable_min_domains && f.md > 0 && n_present < f.md) ? 0 : m;
}

// a domain's verdict: matchNum + selfMatch − min ≤ maxSkew
__device__ __forceinline__ bool filter_ok(const FilterScalars& f, int count, int mn) {
  return count + f.sf - mn <= f.ms;
}

// grid: C rows of NB consecutive blocks (clusters of CL when CL > 1);
// LARGE: a table above FILTER_SMALL_D1 domains (its own kernel, so that the
// small form keeps its own registers)
template <int VEC, int KMAX, bool LARGE>
__global__ void __launch_bounds__(FILTER_THREADS)
spread_filter_kernel(FilterRow r, const FilterPlan plan) {
  __shared__ uint32_t s_verdict[MAX_CC * FILTER_WORDS];
  __shared__ int s_wmin[FILTER_THREADS / 32][KMAX], s_wcnt[FILTER_THREADS / 32][KMAX];
  __shared__ int s_pmin[KMAX], s_pcnt[KMAX];
  __shared__ FilterScalars s_f[KMAX];

  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nw = nt >> 5;
  const int c = blockIdx.x / plan.NB, blk = blockIdx.x % plan.NB;
  const int CL = plan.CL, rank = blk % CL;
  const int Cc = r.Cc, D1 = r.D1;
  const size_t ck0 = (size_t)c * Cc;
  const int n = (blk * nt + tid) * VEC;
  const bool mine = n < r.N;

  // --- the node loads first, before any barrier: the bit vector, and every
  // constraint's domains and key flags (a soft constraint's too: the hard
  // flags are not known yet) ---------------------------------------------------
  int b[VEC];
  int dv[KMAX][VEC];
  unsigned hk[KMAX];
  if (mine) {
    ld_early_i32<VEC>(r.bits + (size_t)c * r.N + n, b);
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < Cc) {
        ld_early_i32<VEC>(r.dom_val + (ck0 + k) * r.N + n, dv[k]);
        hk[k] = ld_early_flags<VEC>(r.has_key + (ck0 + k) * r.N + n);
      }
    }
  }
  // with them the row's hard flags, and on a small table every
  // constraint's scalars and one domain a lane (every warp loads them)
  unsigned hard = 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    if (k < Cc && ld_early_flags<1>(r.hard_valid + ck0 + k)) hard |= 1u << k;
  constexpr bool small = !LARGE;
  FilterScalars fk[KMAX];
  int cnt[KMAX][1];
  unsigned pres[KMAX];
  if constexpr (small) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      cnt[k][0] = 0;
      pres[k] = 0;
      if (k < Cc) {
        fk[k] = filter_scalars(r, ck0 + k);
        if (lane < D1) {
          ld_early_i32<1>(r.counts + (ck0 + k) * D1 + lane, cnt[k]);
          pres[k] = ld_early_flags<1>(r.present + (ck0 + k) * D1 + lane);
        }
      }
    }
  } else if (tid < Cc) {
    fk[0] = filter_scalars(r, ck0 + tid);
  }
  if (!hard) return;  // no hard constraint in the row: the filter passes everywhere

  const int W = (D1 + 31) >> 5;
  uint32_t word[KMAX];
  if constexpr (small) {
    // --- a small table (a zone key: D + 1 = 9): every warp builds each hard
    // constraint's verdict word in registers from one lane a domain, the
    // minimum and the present count by warp reductions, the verdict by a
    // ballot: no barrier ---------------------------------------------------------
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      word[k] = 0;
      if (k < Cc && ((hard >> k) & 1u)) {
        const bool p = pres[k];
        const int m = __reduce_min_sync(0xffffffffu, p ? cnt[k][0] : BIG);
        const int mn = filter_min(r, fk[k], m, __popc(__ballot_sync(0xffffffffu, p)));
        word[k] = __ballot_sync(0xffffffffu, lane < D1 && filter_ok(fk[k], cnt[k][0], mn));
      }
    }
  } else {
    if (tid < Cc) s_f[tid] = fk[0];  // read after the first barrier below
    // --- a large table (a hostname key: D + 1 up to 8193): the cluster's
    // blocks each reduce a slice of whole verdict words; past a cluster
    // barrier every block reads the others' partial minima and present
    // counts through distributed shared memory, then builds its slice's
    // words and pushes them into every block of the cluster (CL = 1: the
    // block does all of it) -------------------------------------------------------
    const int w_lo = min(rank * plan.WS, W), w_hi = min(w_lo + plan.WS, W);
    const int d_lo = w_lo * 32, d_hi = min(w_hi * 32, D1);
    // a thread's first FILTER_PRE domains of the slice (d_lo + tid + i nt)
    // are the lanes of its warp's first FILTER_PRE verdict words (w_lo +
    // warp + i nw): their counts, loaded for the reduction, stay in
    // registers for the verdict
    int m[KMAX], np[KMAX], pre[KMAX][FILTER_PRE];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      m[k] = BIG;
      np[k] = 0;
      if (k < Cc && ((hard >> k) & 1u)) {
        const size_t o = (ck0 + k) * D1;
#pragma unroll
        for (int i = 0; i < FILTER_PRE; ++i) {
          const int d = d_lo + tid + i * nt;
          pre[k][i] = 0;
          if (d < d_hi) {
            pre[k][i] = __ldg(r.counts + o + d);
            if (__ldg(r.present + o + d)) {
              m[k] = min(m[k], pre[k][i]);
              np[k] += 1;
            }
          }
        }
#pragma unroll 4
        for (int d = d_lo + tid + FILTER_PRE * nt; d < d_hi; d += nt) {
          const int x = __ldg(r.counts + o + d);
          if (__ldg(r.present + o + d)) {
            m[k] = min(m[k], x);
            np[k] += 1;
          }
        }
      }
      m[k] = __reduce_min_sync(0xffffffffu, m[k]);
      np[k] = __reduce_add_sync(0xffffffffu, np[k]);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        s_wmin[warp][k] = m[k];
        s_wcnt[warp][k] = np[k];
      }
    }
    __syncthreads();
    if (tid < Cc) {
      int mm = BIG, cc = 0;
      for (int w = 0; w < nw; ++w) {
        mm = min(mm, s_wmin[w][tid]);
        cc += s_wcnt[w][tid];
      }
      s_pmin[tid] = mm;
      s_pcnt[tid] = cc;
    }
    // no block touches another's shared memory before this barrier: past
    // it every block of the cluster runs and holds its slice's partials
    if (CL > 1) {
      cluster_arrive_release();
      cluster_wait_acquire();
    } else {
      __syncthreads();
    }
    // a verdict word into every block of the cluster
    auto put = [&](int k, int w, unsigned word) {
      if (CL > 1) {
        if (lane < CL) *cg::this_cluster().map_shared_rank(&s_verdict[k * W + w], lane) = word;
      } else if (lane == 0) {
        s_verdict[k * W + w] = word;
      }
    };
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k >= Cc || !((hard >> k) & 1u)) continue;
      int mm = s_pmin[k], cc = s_pcnt[k];
      if (CL > 1) {  // lane q reads block q's partials
        int x = BIG, y = 0;
        if (lane < CL) {
          cg::cluster_group cluster = cg::this_cluster();
          x = *cluster.map_shared_rank(&s_pmin[k], lane);
          y = *cluster.map_shared_rank(&s_pcnt[k], lane);
        }
        mm = __reduce_min_sync(0xffffffffu, x);
        cc = __reduce_add_sync(0xffffffffu, y);
      }
      const FilterScalars f = s_f[k];
      const int mn = filter_min(r, f, mm, cc);
#pragma unroll
      for (int i = 0; i < FILTER_PRE; ++i) {
        const int w = w_lo + warp + i * nw;
        if (w < w_hi)
          put(k, w, __ballot_sync(0xffffffffu, w * 32 + lane < D1 && filter_ok(f, pre[k][i], mn)));
      }
      const int32_t* row = r.counts + (ck0 + k) * D1;
      for (int w = w_lo + warp + FILTER_PRE * nw; w < w_hi; w += nw) {
        const int d = w * 32 + lane;
        put(k, w, __ballot_sync(0xffffffffu, d < D1 && filter_ok(f, __ldg(row + d), mn)));
      }
    }
    if (CL > 1) {
      cluster_arrive_release();
      cluster_wait_acquire();  // every block holds every verdict word
    } else {
      __syncthreads();
    }
  }

  // --- each node: its key and a shared-memory verdict bit per hard
  // constraint; the bit vector written back only where a word changes ---------
  if (!mine) return;
  unsigned fail = 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= Cc || !((hard >> k) & 1u)) continue;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int d = dv[k][e];
      const uint32_t w = small ? word[k] : s_verdict[k * W + (d >> 5)];
      const bool ok = ((hk[k] >> e) & 1u) && (unsigned)d < (unsigned)D1 && ((w >> (d & 31)) & 1u);
      if (!ok) fail |= 1u << e;
    }
  }
  const int m_bit = 1 << r.bit;
  bool changed = false;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    if (((fail >> e) & 1u) && (b[e] & m_bit)) {
      b[e] &= ~m_bit;
      changed = true;
    }
  }
  if (!changed) return;
  int32_t* bp = r.bits + (size_t)c * r.N + n;
  if constexpr (VEC == 4) {
    *reinterpret_cast<int4*>(bp) = make_int4(b[0], b[1], b[2], b[3]);
  } else {
    *bp = b[0];
  }
}

// the plan: one vector a thread, threads a whole number of warps up to
// FILTER_THREADS covering the row, as many blocks as the row needs; above
// FILTER_SMALL_D1 domains clusters of up to 8 blocks, the
// fewest powers of two covering a row, its block count rounded up to one
static void filter_plan(int N, int D1, int VEC, FilterPlan* plan, int* threads) {
  int t = ((N + VEC - 1) / VEC + 31) / 32 * 32;
  if (t < 32) t = 32;
  if (t > FILTER_THREADS) t = FILTER_THREADS;
  const int nb = (N + t * VEC - 1) / (t * VEC);
  int cl = 1;
  if (D1 > FILTER_SMALL_D1)
    while (cl < FILTER_MAX_CLUSTER && cl < nb) cl <<= 1;
  const int W = (D1 + 31) / 32;
  plan->NB = (nb + cl - 1) / cl * cl;
  plan->CL = cl;
  plan->WS = (W + cl - 1) / cl;
  *threads = t;
}

// the plan as K6 takes it, for the host's copy (kernel_work.k6_plan) to be
// held against: out = {threads, NB, CL, WS}
extern "C" void spread_filter_plan(int N, int D1, int VEC, int* out) {
  FilterPlan plan;
  filter_plan(N, D1, VEC, &plan, out);
  out[1] = plan.NB;
  out[2] = plan.CL;
  out[3] = plan.WS;
}

template <int VEC, int KMAX>
static int launch_filter(const FilterRow& r, cudaStream_t stream) {
  FilterPlan plan;
  int threads;
  filter_plan(r.N, r.D1, VEC, &plan, &threads);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(r.C * plan.NB));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)plan.CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = plan.CL > 1 ? 1 : 0;
  cudaError_t e = r.D1 > FILTER_SMALL_D1
                      ? cudaLaunchKernelEx(&cfg, spread_filter_kernel<VEC, KMAX, true>, r, plan)
                      : cudaLaunchKernelEx(&cfg, spread_filter_kernel<VEC, KMAX, false>, r, plan);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int VEC>
static int launch_filter_k(const FilterRow& r, cudaStream_t stream) {
  if (r.Cc == 1) return launch_filter<VEC, 1>(r, stream);
  if (r.Cc == 2) return launch_filter<VEC, 2>(r, stream);
  return launch_filter<VEC, MAX_CC>(r, stream);
}

extern "C" int launch_spread_filter(int C, int Cc, int N, int D1, const void* counts,
                                    const void* present, const void* hard_valid,
                                    const void* max_skew, const void* min_domains,
                                    const void* self_match, const void* dom_val,
                                    const void* has_key, int enable_min_domains, int bit,
                                    void* bits, void* stream) {
  if (Cc > MAX_CC || (D1 + 31) / 32 > FILTER_WORDS) return (int)cudaErrorInvalidValue;
  if (C <= 0 || N <= 0 || Cc <= 0) return 0;
  FilterRow r{C, Cc, N, D1, enable_min_domains, bit, (const int32_t*)counts,
              (const uint8_t*)present, (const uint8_t*)hard_valid, (const int32_t*)max_skew,
              (const int32_t*)min_domains, (const uint8_t*)self_match,
              (const int32_t*)dom_val, (const uint8_t*)has_key, (int32_t*)bits};
  // 16-byte vectors where every row starts on a 16-byte boundary (has_key's
  // 4-byte vectors on a 4-byte one)
  const bool vec4 = N % 4 == 0 && aligned_to(bits, 16) && aligned_to(dom_val, 16) &&
                    aligned_to(has_key, 4);
  cudaStream_t s = (cudaStream_t)stream;
  return vec4 ? launch_filter_k<4>(r, s) : launch_filter_k<1>(r, s);
}

// --- K7 -----------------------------------------------------------------------------

#define SCORE_MAX_THREADS 512
#define SCORE_ITEMS 4          // vectors a thread keeps in registers
#define SCORE_MAX_CLUSTER 8
#define SCORE_WORDS 257        // a constraint's present-domain bits: D + 1 ≤ 8193

struct ScoreRow {
  int C, Cc, N, D1, full;
  const int32_t* bits;        // [C, N]
  const int32_t* counts;      // [C, Cc, D1] soft counts
  const uint8_t* soft_valid;  // [C, Cc]
  const int32_t* max_skew;    // [C, Cc]
  const int32_t* dom_val;     // [C, Cc, N]
  const uint8_t* has_key;     // [C, Cc, N]
};

// the launch's shape, a kernel parameter: CL blocks a row (a thread-block
// cluster when CL > 1), block r of a row taking the nodes [r S, (r + 1) S)
struct ScorePlan {
  int CL;
  int S;
  float weight;
};

// vector v of a row slice: its feasible nodes (all filter bits set) and its
// scored ones (feasible and carrying every soft constraint's key), as masks
template <int VEC>
__device__ __forceinline__ void node_masks(const ScoreRow& r, int c, int n, unsigned soft,
                                           unsigned* fm, unsigned* sm) {
  int b[VEC];
  ld_i32<VEC>(r.bits + (size_t)c * r.N + n, b);
  unsigned f = 0;
#pragma unroll
  for (int e = 0; e < VEC; ++e) f |= (b[e] == r.full ? 1u : 0u) << e;
  unsigned s = f;
  for (int k = 0; k < r.Cc && s; ++k)
    if ((soft >> k) & 1u) s &= ld_flags<VEC>(r.has_key + (size_t)(c * r.Cc + k) * r.N + n);
  *fm = f;
  *sm = s;
}

// the scored nodes' domains under each soft constraint into the block's
// present-domain bits (a word is read before it is written: after the
// first node of a domain the rest read a set bit)
template <int VEC>
__device__ __forceinline__ void mark_present(const ScoreRow& r, int c, int n, unsigned soft,
                                             unsigned sm, uint32_t* s_present, int Wd) {
  const int D = r.D1 - 1;
  for (int k = 0; k < r.Cc && sm; ++k) {
    if (!((soft >> k) & 1u)) continue;
    int dv[VEC];
    ld_i32<VEC>(r.dom_val + (size_t)(c * r.Cc + k) * r.N + n, dv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (!((sm >> e) & 1u) || dv[e] >= D) continue;
      uint32_t* w = s_present + k * Wd + (dv[e] >> 5);
      const uint32_t bit = 1u << (dv[e] & 31);
      if (!(*w & bit)) atomicOr(w, bit);
    }
  }
}

// the raw score of the scored nodes of vector v (0 elsewhere): the
// constraint terms cnt · w + (maxSkew − 1) summed in constraint order, then
// rounded half to even.  A scored node's domain is present (the node itself
// made it so) whenever it is below D, so the term needs no present bits.
template <int VEC>
__device__ __forceinline__ void raw_scores(const ScoreRow& r, int c, int n, unsigned soft,
                                           unsigned sm, const float* s_w, float (&raw)[VEC]) {
  const int D = r.D1 - 1;
  float s[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s[e] = 0.0f;
  for (int k = 0; k < r.Cc; ++k) {
    const int ck = c * r.Cc + k;
    if (!((soft >> k) & 1u)) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) s[e] = __fadd_rn(s[e], 0.0f);
      continue;
    }
    int dv[VEC];
    ld_i32<VEC>(r.dom_val + (size_t)ck * r.N + n, dv);
    const float skew = __fsub_rn((float)__ldg(r.max_skew + ck), 1.0f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float term = 0.0f;
      if (((sm >> e) & 1u) && dv[e] < D) {
        const float cnt = (float)__ldg(r.counts + (size_t)ck * r.D1 + dv[e]);
        term = __fadd_rn(__fmul_rn(cnt, s_w[k]), skew);
      }
      s[e] = __fadd_rn(s[e], term);
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) raw[e] = rintf(s[e]);
}

// total += weight · floor(normalize(raw)) on the feasible nodes of vector v
// (0 where a feasible node is not scored; the infeasible are not written)
template <int VEC>
__device__ __forceinline__ void add_scores(float* p, unsigned fm, unsigned sm,
                                           const float (&raw)[VEC], float mx, float mn,
                                           float weight) {
  float t[VEC];
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    t[0] = v.x; t[1] = v.y; t[2] = v.z; t[3] = v.w;
  } else {
    t[0] = p[0];
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    if (!((fm >> e) & 1u)) continue;
    float out = 0.0f;
    if ((sm >> e) & 1u) {
      out = (mx == 0.0f)
                ? MAX_NODE_SCORE
                : __fdiv_rn(__fmul_rn(MAX_NODE_SCORE, __fsub_rn(__fadd_rn(mx, mn), raw[e])), mx);
    }
    t[e] = __fadd_rn(t[e], __fmul_rn(weight, floorf(out)));
  }
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(t[0], t[1], t[2], t[3]);
  } else {
    p[0] = t[0];
  }
}

// grid: C rows of CL consecutive blocks (a cluster when CL > 1)
template <int VEC>
__global__ void __launch_bounds__(SCORE_MAX_THREADS)
spread_score_kernel(ScoreRow r, const float* __restrict__ topo_log, int topo_log_len,
                    const ScorePlan plan, float* __restrict__ total) {
  constexpr unsigned VM = (1u << VEC) - 1u;
  __shared__ uint32_t s_present[MAX_CC * SCORE_WORDS];
  __shared__ float s_wmax[SCORE_MAX_THREADS / 32], s_wmin[SCORE_MAX_THREADS / 32];
  __shared__ float s_pmax[SCORE_MAX_CLUSTER], s_pmin[SCORE_MAX_CLUSTER];
  __shared__ int s_topo[MAX_CC];
  __shared__ float s_w[MAX_CC];

  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int CL = plan.CL;
  const int c = blockIdx.x / CL, rank = blockIdx.x % CL;
  const int lo = min(rank * plan.S, r.N), nvec = (min(lo + plan.S, r.N) - lo) / VEC;
  float* trow = total + (size_t)c * r.N + lo;
  unsigned soft = 0;
  for (int k = 0; k < r.Cc; ++k) soft |= (r.soft_valid[c * r.Cc + k] ? 1u : 0u) << k;

  if (!soft) {
    // no soft constraint: every raw score is 0, so every feasible node
    // normalizes to 100 — one pass over the bits and the total, and no
    // block of the row waits on another
    const float add = __fmul_rn(plan.weight, MAX_NODE_SCORE);
    for (int v = tid; v < nvec; v += nt) {
      int b[VEC];
      ld_i32<VEC>(r.bits + (size_t)c * r.N + lo + (size_t)v * VEC, b);
      unsigned fm = 0;
#pragma unroll
      for (int e = 0; e < VEC; ++e) fm |= (b[e] == r.full ? 1u : 0u) << e;
      if (!fm) continue;
      float* p = trow + (size_t)v * VEC;
      float t[VEC];
      if constexpr (VEC == 4) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        t[0] = x.x; t[1] = x.y; t[2] = x.z; t[3] = x.w;
      } else {
        t[0] = p[0];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if ((fm >> e) & 1u) t[e] = __fadd_rn(t[e], add);
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(t[0], t[1], t[2], t[3]);
      } else {
        p[0] = t[0];
      }
    }
    return;
  }

  const int Wd = (r.D1 + 31) >> 5;
  for (int x = tid; x < r.Cc * Wd; x += nt) s_present[x] = 0u;
  if (tid < MAX_CC) s_topo[tid] = 0;
  __syncthreads();

  // --- the one read: each thread's first SCORE_ITEMS vectors keep their
  // feasible and scored masks in registers; the scored nodes' domains go
  // into the block's present bits -------------------------------------------
  unsigned fmask = 0u, smask = 0u;
#pragma unroll
  for (int it = 0; it < SCORE_ITEMS; ++it) {
    const int v = it * nt + tid;
    if (v < nvec) {
      unsigned f, s;
      node_masks<VEC>(r, c, lo + v * VEC, soft, &f, &s);
      mark_present<VEC>(r, c, lo + v * VEC, soft, s, s_present, Wd);
      fmask |= f << (it * VEC);
      smask |= s << (it * VEC);
    }
  }
  for (int v = SCORE_ITEMS * nt + tid; v < nvec; v += nt) {  // a slice longer than that
    unsigned f, s;
    node_masks<VEC>(r, c, lo + v * VEC, soft, &f, &s);
    mark_present<VEC>(r, c, lo + v * VEC, soft, s, s_present, Wd);
  }

  // --- the row's present domains: OR over the cluster's blocks (distributed
  // shared memory), topo_size by popcount, the weight log(topo_size + 2)
  // from the table ----------------------------------------------------------
  if (CL > 1) {
    __syncthreads();
    cluster_arrive_release();
    cluster_wait_acquire();  // every block of the row has its bits
  } else {
    __syncthreads();
  }
  for (int x = tid; x < r.Cc * Wd; x += nt) {
    const int k = x / Wd;
    if (!((soft >> k) & 1u)) continue;
    uint32_t m = s_present[x];
    if (CL > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      for (int q = 0; q < CL; ++q)
        if (q != rank) m |= *cluster.map_shared_rank(&s_present[x], q);
    }
    if (m) atomicAdd(&s_topo[k], __popc(m));
  }
  __syncthreads();
  if (tid < r.Cc) s_w[tid] = __ldg(topo_log + min(s_topo[tid], topo_log_len - 1));
  __syncthreads();

  // --- the raw score, once, kept in registers; its max and min over the
  // scored nodes ------------------------------------------------------------
  float raw[SCORE_ITEMS][VEC];
  float mx = -INFINITY, mn = INFINITY;
#pragma unroll
  for (int it = 0; it < SCORE_ITEMS; ++it) {
    const unsigned sm = (smask >> (it * VEC)) & VM;
    if (sm) {
      raw_scores<VEC>(r, c, lo + (it * nt + tid) * VEC, soft, sm, s_w, raw[it]);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if ((sm >> e) & 1u) {
          mx = fmaxf(mx, raw[it][e]);
          mn = fminf(mn, raw[it][e]);
        }
    }
  }
  for (int v = SCORE_ITEMS * nt + tid; v < nvec; v += nt) {
    unsigned f, s;
    node_masks<VEC>(r, c, lo + v * VEC, soft, &f, &s);
    if (!s) continue;
    float rr[VEC];
    raw_scores<VEC>(r, c, lo + v * VEC, soft, s, s_w, rr);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if ((s >> e) & 1u) {
        mx = fmaxf(mx, rr[e]);
        mn = fminf(mn, rr[e]);
      }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
  }
  if (lane == 0) {
    s_wmax[warp] = mx;
    s_wmin[warp] = mn;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = nt >> 5;
    mx = lane < nw ? s_wmax[lane] : -INFINITY;
    mn = lane < nw ? s_wmin[lane] : INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    }
  }
  if (CL > 1) {
    // warp 0's lane q pushes the block's partials into block q; one
    // cluster barrier later every block holds the row's (and no block
    // reads another's shared memory after it)
    if (warp == 0 && lane < CL) {
      cg::cluster_group cluster = cg::this_cluster();
      *cluster.map_shared_rank(&s_pmax[rank], lane) = mx;
      *cluster.map_shared_rank(&s_pmin[rank], lane) = mn;
    }
    __syncwarp();
    cluster_arrive_release();
    cluster_wait_acquire();
  } else {
    if (tid == 0) {
      s_pmax[0] = mx;
      s_pmin[0] = mn;
    }
    __syncthreads();
  }
  mx = -INFINITY;
  mn = INFINITY;
  for (int q = 0; q < CL; ++q) {
    mx = fmaxf(mx, s_pmax[q]);
    mn = fminf(mn, s_pmin[q]);
  }
  if (!isfinite(mx)) mx = 0.0f;
  if (!isfinite(mn)) mn = 0.0f;

  // --- normalize, floor, weight, add into the total, from registers --------
#pragma unroll
  for (int it = 0; it < SCORE_ITEMS; ++it) {
    const unsigned fm = (fmask >> (it * VEC)) & VM;
    if (fm)
      add_scores<VEC>(trow + (size_t)(it * nt + tid) * VEC, fm, (smask >> (it * VEC)) & VM,
                      raw[it], mx, mn, plan.weight);
  }
  for (int v = SCORE_ITEMS * nt + tid; v < nvec; v += nt) {
    unsigned f, s;
    node_masks<VEC>(r, c, lo + v * VEC, soft, &f, &s);
    if (!f) continue;
    float rr[VEC];
    raw_scores<VEC>(r, c, lo + v * VEC, soft, s, s_w, rr);
    add_scores<VEC>(trow + (size_t)v * VEC, f, s, rr, mx, mn, plan.weight);
  }
}

// the plan: up to 8 blocks a row while a row is longer than 1024 nodes a
// block (at most 16 rows: a scan step, a TopologySpreading round) or than
// SCORE_MAX_THREADS threads' registers' worth (more rows: one block a row
// at N = 8192); threads a whole number of warps covering the block's
// slice, a vector a thread at most 16 rows and SCORE_ITEMS above that
static void score_config(int C, int N, int VEC, ScorePlan* plan, int* threads) {
  const long long per_block = C <= 16 ? 1024 : (long long)SCORE_MAX_THREADS * SCORE_ITEMS * VEC;
  int cl = 1;
  while (cl < SCORE_MAX_CLUSTER && cl * per_block < N) cl <<= 1;
  const int S = ((N + cl - 1) / cl + VEC - 1) / VEC * VEC;
  const int per_thread = C <= 16 ? VEC : VEC * SCORE_ITEMS;
  int t = ((S + per_thread - 1) / per_thread + 31) / 32 * 32;
  if (t < 32) t = 32;
  if (t > SCORE_MAX_THREADS) t = SCORE_MAX_THREADS;
  plan->CL = cl;
  plan->S = S;
  *threads = t;
}

template <int VEC>
static int launch_score(const ScoreRow& r, const float* topo_log, int topo_log_len,
                        float weight, float* total, cudaStream_t stream) {
  ScorePlan plan;
  int threads;
  score_config(r.C, r.N, VEC, &plan, &threads);
  plan.weight = weight;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(r.C * plan.CL));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)plan.CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = plan.CL > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, spread_score_kernel<VEC>, r, topo_log,
                                     topo_log_len, plan, total);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int launch_spread_score(int C, int Cc, int N, int D1, const void* bits, int full,
                                   const void* counts, const void* soft_valid,
                                   const void* max_skew, const void* dom_val,
                                   const void* has_key, const void* topo_log,
                                   int topo_log_len, float weight, void* total,
                                   void* stream) {
  if (Cc > MAX_CC || (D1 + 31) / 32 > SCORE_WORDS) return (int)cudaErrorInvalidValue;
  if (C <= 0 || N <= 0) return 0;
  ScoreRow r{C, Cc, N, D1, full, (const int32_t*)bits, (const int32_t*)counts,
             (const uint8_t*)soft_valid, (const int32_t*)max_skew,
             (const int32_t*)dom_val, (const uint8_t*)has_key};
  // 16-byte vectors where every row starts on a 16-byte boundary (has_key's
  // 4-byte vectors on a 4-byte one)
  const bool vec4 = N % 4 == 0 && aligned_to(bits, 16) && aligned_to(dom_val, 16) &&
                    aligned_to(total, 16) && aligned_to(has_key, 4);
  cudaStream_t s = (cudaStream_t)stream;
  return vec4 ? launch_score<4>(r, (const float*)topo_log, topo_log_len, weight, (float*)total, s)
              : launch_score<1>(r, (const float*)topo_log, topo_log_len, weight, (float*)total, s);
}

// --- K8 -----------------------------------------------------------------------------

#define UPDATE_THREADS 256

// a pod's class row (int64), issued where it stands
__device__ __forceinline__ long long ld_early_class(const long long* p) {
  long long v;
  asm volatile("ld.global.s64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

// one thread a (pod i, class constraint row); a warp 32 consecutive pods of
// one row.  Round trip 1: i's commit flag, class and node, all issued
// before the test on the flag (a warp with no committed pod stops there).
// Round trip 2, for a committed pod: the row's match byte at i's class with
// the row's domain and its class row's counted flags at i's node.  Then the
// adds, atomic adds that nothing waits on: a lone adding lane adds 1; where
// more lanes of the warp add, their adds to one domain of a table are summed
// by their lowest lane (__match_any_sync), one atomic add a sum.
__global__ void __launch_bounds__(UPDATE_THREADS)
spread_update_kernel(int B, int Cc, int Cp, int N, int D1,
                     const uint8_t* __restrict__ commit,  // [B]
                     const int32_t* __restrict__ choice,  // [B]
                     const long long* __restrict__ class_of,  // [B]
                     const uint8_t* __restrict__ match_pending,  // [C, Cc, Cp]
                     const uint8_t* __restrict__ counted_hard,  // [C, N]
                     const uint8_t* __restrict__ counted_soft,  // [C, N]
                     const int32_t* __restrict__ dom_val,  // [C, Cc, N]
                     int32_t* __restrict__ hard,  // [C, Cc, D1]
                     int32_t* __restrict__ soft) {
  const int i = blockIdx.x * UPDATE_THREADS + threadIdx.x;
  const int row = blockIdx.y;  // c * Cc + cc
  // --- round trip 1 -----------------------------------------------------------------
  unsigned com = 0u;
  long long k = 0;
  int ch[1] = {0};
  if (i < B) {
    com = ld_early_flags<1>(commit + i);
    k = ld_early_class(class_of + i);
    ld_early_i32<1>(choice + i, ch);
  }
  if (!__any_sync(0xffffffffu, com)) return;
  // --- round trip 2 -----------------------------------------------------------------
  unsigned m = 0u, h = 0u, s = 0u;
  int dv = -1;
  if (com) {
    const int n = min(max(ch[0], 0), N - 1);  // the reference clips the node row
    const int c = row / Cc;
    int d[1];
    m = ld_early_flags<1>(match_pending + (size_t)row * Cp + k);
    ld_early_i32<1>(dom_val + (size_t)row * N + n, d);
    h = ld_early_flags<1>(counted_hard + (size_t)c * N + n);
    s = ld_early_flags<1>(counted_soft + (size_t)c * N + n);
    dv = d[0];
  }
  // --- the adds ------------------------------------------------------------------------
  const int lane = threadIdx.x & 31;
  const bool add_h = m && h, add_s = m && s;
  const unsigned adders = __ballot_sync(0xffffffffu, add_h || add_s);
  if (!(adders & (adders - 1))) {  // at most one lane adds: nothing to sum
    if (add_h) atomicAdd(hard + (size_t)row * D1 + dv, 1);
    if (add_s) atomicAdd(soft + (size_t)row * D1 + dv, 1);
    return;
  }
  const unsigned ph = __match_any_sync(0xffffffffu, add_h ? dv : -1);
  const unsigned ps = __match_any_sync(0xffffffffu, add_s ? dv : -1);
  if (add_h && lane == __ffs(ph) - 1) atomicAdd(hard + (size_t)row * D1 + dv, __popc(ph));
  if (add_s && lane == __ffs(ps) - 1) atomicAdd(soft + (size_t)row * D1 + dv, __popc(ps));
}

extern "C" int launch_spread_update(int B, int C, int Cc, int Cp, int N, int D1,
                                    const void* commit, const void* choice,
                                    const void* class_of, const void* match_pending,
                                    const void* counted_hard, const void* counted_soft,
                                    const void* dom_val, void* hard, void* soft,
                                    void* stream) {
  if (B <= 0 || C <= 0 || Cc <= 0 || N <= 0) return 0;
  const dim3 grid((B + UPDATE_THREADS - 1) / UPDATE_THREADS, C * Cc);
  spread_update_kernel<<<grid, UPDATE_THREADS, 0, (cudaStream_t)stream>>>(
      B, Cc, Cp, N, D1, (const uint8_t*)commit, (const int32_t*)choice,
      (const long long*)class_of, (const uint8_t*)match_pending,
      (const uint8_t*)counted_hard, (const uint8_t*)counted_soft, (const int32_t*)dom_val,
      (int32_t*)hard, (int32_t*)soft);
  return (int)cudaGetLastError();
}

// --- K14 ----------------------------------------------------------------------------

__global__ void spread_chain_kernel(int B0, int Cc, int N, int D1,
                                    const uint8_t* __restrict__ match,  // [C, Cc, B0]
                                    const int32_t* __restrict__ rows,  // [B0]
                                    const uint8_t* __restrict__ counted_hard,  // [C, N]
                                    const uint8_t* __restrict__ counted_soft,  // [C, N]
                                    const int32_t* __restrict__ dom_val,  // [C, Cc, N]
                                    int32_t* __restrict__ hard,  // [C, Cc, D1]
                                    int32_t* __restrict__ soft) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;  // c * Cc + cc
  if (j >= B0 || !match[(long long)row * B0 + j]) return;
  const int r = rows[j];
  if (r < 0) return;  // the prev pod was not placed
  const int c = row / Cc;
  const int n = min(r, N - 1);
  const int dv = dom_val[(long long)row * N + n];
  if (counted_hard[(long long)c * N + n]) atomicAdd(&hard[(long long)row * D1 + dv], 1);
  if (counted_soft[(long long)c * N + n]) atomicAdd(&soft[(long long)row * D1 + dv], 1);
}

extern "C" int launch_spread_chain(int B0, int C, int Cc, int N, int D1, const void* match,
                                   const void* rows, const void* counted_hard,
                                   const void* counted_soft, const void* dom_val, void* hard,
                                   void* soft, void* stream) {
  if (B0 <= 0 || C <= 0 || Cc <= 0) return 0;
  const int threads = 256;
  dim3 grid((B0 + threads - 1) / threads, C * Cc);
  spread_chain_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      B0, Cc, N, D1, (const uint8_t*)match, (const int32_t*)rows,
      (const uint8_t*)counted_hard, (const uint8_t*)counted_soft, (const int32_t*)dom_val,
      (int32_t*)hard, (int32_t*)soft);
  return (int)cudaGetLastError();
}

// --- K18 ----------------------------------------------------------------------------

#define UPDATE_ROW_THREADS 128

// one thread a (pending pod j, constraint) row: pod i's node first (below
// 0 the thread exits after that one load, as before); then one round trip
// for the row's match byte with the node's domain and j's counted flags;
// a matching row adds 1 with an atomic add whose result nothing waits on
// (no read of the count first)
__global__ void __launch_bounds__(UPDATE_ROW_THREADS)
spread_update_row_kernel(int B, int Cc, int Bp, int N, int D1, int i,
                         const int32_t* __restrict__ node_at,  // pod i's node
                         const uint8_t* __restrict__ match_pending,  // [B, Cc, Bp]
                         const uint8_t* __restrict__ counted_hard,  // [B, N]
                         const uint8_t* __restrict__ counted_soft,  // [B, N]
                         const int32_t* __restrict__ dom_val,  // [B, Cc, N]
                         int32_t* __restrict__ hard,  // [B, Cc, D1]
                         int32_t* __restrict__ soft) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;  // j * Cc + cc
  if (row >= B * Cc) return;
  const int node = *node_at;
  if (node < 0) return;  // pod i was not placed: the step changes nothing
  // --- one round trip: the match byte, the node's domain (the trash slot
  // for a keyless node) and whether the node counts for j ------------------------
  const int n = min(node, N - 1);  // the reference clips the node row
  const int j = row / Cc;
  int dv[1];
  ld_early_i32<1>(dom_val + (size_t)row * N + n, dv);
  const unsigned ch = ld_early_flags<1>(counted_hard + (size_t)j * N + n);
  const unsigned cs = ld_early_flags<1>(counted_soft + (size_t)j * N + n);
  if (!ld_early_flags<1>(match_pending + (size_t)row * Bp + i)) return;  // j's selector misses pod i
  // one thread owns each (j, cc) row, so the atomic is not there for a race:
  // it adds where the count is without a read that the thread would wait on
  if (ch) atomicAdd(hard + (size_t)row * D1 + dv[0], 1);
  if (cs) atomicAdd(soft + (size_t)row * D1 + dv[0], 1);
}

extern "C" int launch_spread_update_row(int B, int Cc, int Bp, int N, int D1, int i,
                                        const void* node_at, const void* match_pending,
                                        const void* counted_hard, const void* counted_soft,
                                        const void* dom_val, void* hard, void* soft,
                                        void* stream) {
  if (B <= 0 || Cc <= 0 || N <= 0) return 0;
  const int rows = B * Cc;
  const int blocks = (rows + UPDATE_ROW_THREADS - 1) / UPDATE_ROW_THREADS;
  spread_update_row_kernel<<<blocks, UPDATE_ROW_THREADS, 0, (cudaStream_t)stream>>>(
      B, Cc, Bp, N, D1, i, (const int32_t*)node_at, (const uint8_t*)match_pending,
      (const uint8_t*)counted_hard, (const uint8_t*)counted_soft, (const int32_t*)dom_val,
      (int32_t*)hard, (int32_t*)soft);
  return (int)cudaGetLastError();
}
