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
// K6 spread_filter_bits: one thread per (class row, node); each block first
//   reduces the row's minimum over present domains in shared memory.
//   Clears the filter's bit in K1's pass-bit plane in place.  Bound: bytes.
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
// K8 spread_update_classes: one thread per (committed pod, class
//   constraint row); integer atomics into the tables.  O(B · C · Cc) where
//   the reference's einsum is O(C · Cc · N).  Bound: latency.
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
//   match column read once).
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

// --- block reductions (blockDim.x a multiple of 32, at most 1024) ---------------

__device__ __forceinline__ int block_min_int(int v, int* scratch) {
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_down_sync(0xffffffff, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int r = scratch[0];
    for (int w = 1; w < (int)(blockDim.x / 32); ++w) r = min(r, scratch[w]);
    scratch[0] = r;
  }
  __syncthreads();
  return scratch[0];
}

__device__ __forceinline__ int block_sum_int(int v, int* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffff, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int r = 0;
    for (int w = 0; w < (int)(blockDim.x / 32); ++w) r += scratch[w];
    scratch[0] = r;
  }
  __syncthreads();
  return scratch[0];
}

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

// --- K6 -----------------------------------------------------------------------------

#define FILTER_THREADS 256

__global__ void __launch_bounds__(FILTER_THREADS) spread_filter_kernel(int C, int Cc, int N, int D1,
                                     const int32_t* __restrict__ counts,  // [C, Cc, D1]
                                     const uint8_t* __restrict__ present,  // [C, Cc, D1]
                                     const uint8_t* __restrict__ hard_valid,  // [C, Cc]
                                     const int32_t* __restrict__ max_skew,  // [C, Cc]
                                     const int32_t* __restrict__ min_domains,  // [C, Cc]
                                     const uint8_t* __restrict__ self_match,  // [C, Cc]
                                     const int32_t* __restrict__ dom_val,  // [C, Cc, N]
                                     const uint8_t* __restrict__ has_key,  // [C, Cc, N]
                                     int enable_min_domains, int bit,
                                     int32_t* __restrict__ bits) {  // [C, N]
  __shared__ int scratch[FILTER_THREADS / 32];
  __shared__ int s_min[MAX_CC];
  const int c = blockIdx.y;
  // the row's global minimum over present domains, per constraint
  for (int k = 0; k < Cc; ++k) {
    const long long o = (long long)(c * Cc + k) * D1;
    int m = BIG, cnt = 0;
    for (int d = threadIdx.x; d < D1; d += blockDim.x) {
      if (present[o + d]) {
        m = min(m, counts[o + d]);
        cnt += 1;
      }
    }
    m = block_min_int(m, scratch);
    cnt = block_sum_int(cnt, scratch);
    if (threadIdx.x == 0) {
      const int md = min_domains[c * Cc + k];
      if (enable_min_domains && md > 0 && cnt < md) m = 0;
      s_min[k] = m;
    }
    __syncthreads();
  }
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  bool ok = true;
  for (int k = 0; k < Cc; ++k) {
    const int ck = c * Cc + k;
    if (!hard_valid[ck]) continue;
    const long long on = (long long)ck * N + n;
    const int dv = dom_val[on];
    const int skew = counts[(long long)ck * D1 + dv] + (self_match[ck] ? 1 : 0) - s_min[k];
    if (!(has_key[on] && skew <= max_skew[ck])) ok = false;
  }
  if (!ok) bits[(long long)c * N + n] &= ~(1 << bit);
}

extern "C" int launch_spread_filter(int C, int Cc, int N, int D1, const void* counts,
                                    const void* present, const void* hard_valid,
                                    const void* max_skew, const void* min_domains,
                                    const void* self_match, const void* dom_val,
                                    const void* has_key, int enable_min_domains, int bit,
                                    void* bits, void* stream) {
  if (Cc > MAX_CC) return (int)cudaErrorInvalidValue;
  if (C <= 0 || N <= 0) return 0;
  dim3 grid((N + FILTER_THREADS - 1) / FILTER_THREADS, C);
  spread_filter_kernel<<<grid, FILTER_THREADS, 0, (cudaStream_t)stream>>>(
      C, Cc, N, D1, (const int32_t*)counts, (const uint8_t*)present,
      (const uint8_t*)hard_valid, (const int32_t*)max_skew, (const int32_t*)min_domains,
      (const uint8_t*)self_match, (const int32_t*)dom_val, (const uint8_t*)has_key,
      enable_min_domains, bit, (int32_t*)bits);
  return (int)cudaGetLastError();
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

static bool score_aligned(const void* p, uintptr_t a) { return ((uintptr_t)p & (a - 1)) == 0; }

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
  const bool vec4 = N % 4 == 0 && score_aligned(bits, 16) && score_aligned(dom_val, 16) &&
                    score_aligned(total, 16) && score_aligned(has_key, 4);
  cudaStream_t s = (cudaStream_t)stream;
  return vec4 ? launch_score<4>(r, (const float*)topo_log, topo_log_len, weight, (float*)total, s)
              : launch_score<1>(r, (const float*)topo_log, topo_log_len, weight, (float*)total, s);
}

// --- K8 -----------------------------------------------------------------------------

__global__ void spread_update_kernel(int B, int C, int Cc, int Cp, int N, int D1,
                                     const uint8_t* __restrict__ commit,  // [B]
                                     const int32_t* __restrict__ choice,  // [B]
                                     const int32_t* __restrict__ class_of,  // [B]
                                     const uint8_t* __restrict__ match_pending,  // [C, Cc, Cp]
                                     const uint8_t* __restrict__ counted_hard,  // [C, N]
                                     const uint8_t* __restrict__ counted_soft,  // [C, N]
                                     const int32_t* __restrict__ dom_val,  // [C, Cc, N]
                                     int32_t* __restrict__ hard,  // [C, Cc, D1]
                                     int32_t* __restrict__ soft) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;  // c * Cc + cc
  if (i >= B || !commit[i]) return;
  const int k = class_of[i];
  if (!match_pending[(long long)row * Cp + k]) return;
  const int c = row / Cc;
  const int n = min(max(choice[i], 0), N - 1);
  const int dv = dom_val[(long long)row * N + n];
  if (counted_hard[(long long)c * N + n]) atomicAdd(&hard[(long long)row * D1 + dv], 1);
  if (counted_soft[(long long)c * N + n]) atomicAdd(&soft[(long long)row * D1 + dv], 1);
}

extern "C" int launch_spread_update(int B, int C, int Cc, int Cp, int N, int D1,
                                    const void* commit, const void* choice,
                                    const void* class_of, const void* match_pending,
                                    const void* counted_hard, const void* counted_soft,
                                    const void* dom_val, void* hard, void* soft,
                                    void* stream) {
  if (B <= 0 || C <= 0 || Cc <= 0) return 0;
  const int threads = 256;
  dim3 grid((B + threads - 1) / threads, C * Cc);
  spread_update_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      B, C, Cc, Cp, N, D1, (const uint8_t*)commit, (const int32_t*)choice,
      (const int32_t*)class_of, (const uint8_t*)match_pending,
      (const uint8_t*)counted_hard, (const uint8_t*)counted_soft,
      (const int32_t*)dom_val, (int32_t*)hard, (int32_t*)soft);
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

__global__ void spread_update_row_kernel(int B, int Cc, int Bp, int N, int D1, int i,
                                         const int32_t* __restrict__ node_at,  // pod i's node
                                         const uint8_t* __restrict__ match_pending,  // [B, Cc, Bp]
                                         const uint8_t* __restrict__ counted_hard,  // [B, N]
                                         const uint8_t* __restrict__ counted_soft,  // [B, N]
                                         const int32_t* __restrict__ dom_val,  // [B, Cc, N]
                                         int32_t* __restrict__ hard,  // [B, Cc, D1]
                                         int32_t* __restrict__ soft) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;  // j * Cc + cc
  if (row >= B * Cc) return;
  const int n = *node_at;
  if (n < 0) return;  // pod i was not placed: the step changes nothing
  if (!match_pending[(long long)row * Bp + i]) return;
  const int j = row / Cc;
  const int dv = dom_val[(long long)row * N + n];  // the trash slot for a keyless node
  // one thread owns each (j, cc) row: plain adds, no other thread writes it
  if (counted_hard[(long long)j * N + n]) hard[(long long)row * D1 + dv] += 1;
  if (counted_soft[(long long)j * N + n]) soft[(long long)row * D1 + dv] += 1;
}

extern "C" int launch_spread_update_row(int B, int Cc, int Bp, int N, int D1, int i,
                                        const void* node_at, const void* match_pending,
                                        const void* counted_hard, const void* counted_soft,
                                        const void* dom_val, void* hard, void* soft,
                                        void* stream) {
  if (B <= 0 || Cc <= 0) return 0;
  const int threads = 256;
  const int rows = B * Cc;
  spread_update_row_kernel<<<(rows + threads - 1) / threads, threads, 0,
                             (cudaStream_t)stream>>>(
      B, Cc, Bp, N, D1, i, (const int32_t*)node_at, (const uint8_t*)match_pending,
      (const uint8_t*)counted_hard, (const uint8_t*)counted_soft, (const int32_t*)dom_val,
      (int32_t*)hard, (int32_t*)soft);
  return (int)cudaGetLastError();
}
