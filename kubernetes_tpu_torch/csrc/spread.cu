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
// K7 spread_score_combine: one block per class row, four sweeps over the
//   row: the scored nodes' present domains (a shared-memory bitmap), their
//   count per constraint (topo_size), the raw score's max and min over the
//   valid nodes, then the normalized, floored, weighted score added into K2's
//   total.  Bound: bytes (dom_val and the bit plane read three times, total
//   read and written once) — at C = 4 the four blocks leave the card idle.
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ float block_max_float(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffff, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = scratch[0];
    for (int w = 1; w < (int)(blockDim.x / 32); ++w) r = fmaxf(r, scratch[w]);
    scratch[0] = r;
  }
  __syncthreads();
  return scratch[0];
}

__device__ __forceinline__ float block_min_float(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_down_sync(0xffffffff, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = scratch[0];
    for (int w = 1; w < (int)(blockDim.x / 32); ++w) r = fminf(r, scratch[w]);
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

#define SCORE_THREADS 1024

struct ScoreRow {
  int C, Cc, N, D1, full;
  const int32_t* bits;        // [C, N]
  const int32_t* counts;      // [C, Cc, D1] soft counts
  const uint8_t* soft_valid;  // [C, Cc]
  const int32_t* max_skew;    // [C, Cc]
  const int32_t* dom_val;     // [C, Cc, N]
  const uint8_t* has_key;     // [C, Cc, N]
};

// node n of row c is scored: feasible and carrying every soft constraint's key
__device__ __forceinline__ bool scored_node(const ScoreRow& r, int c, int n) {
  if (r.bits[(long long)c * r.N + n] != r.full) return false;
  for (int k = 0; k < r.Cc; ++k) {
    const int ck = c * r.Cc + k;
    if (r.soft_valid[ck] && !r.has_key[(long long)ck * r.N + n]) return false;
  }
  return true;
}

// the raw score of node n (NaN where a soft row's node is not scored)
__device__ __forceinline__ float raw_score(const ScoreRow& r, int c, int n, bool has_soft,
                                           const uint8_t* s_present, const float* s_w) {
  if (!has_soft) return 0.0f;
  if (!scored_node(r, c, n)) return __int_as_float(0x7fc00000);  // NaN
  float s = 0.0f;
  for (int k = 0; k < r.Cc; ++k) {
    const int ck = c * r.Cc + k;
    float term = 0.0f;
    const long long on = (long long)ck * r.N + n;
    if (r.soft_valid[ck] && r.has_key[on]) {
      const int dv = r.dom_val[on];
      if (s_present[k * r.D1 + dv]) {
        const float cnt = (float)r.counts[(long long)ck * r.D1 + dv];
        term = __fadd_rn(__fmul_rn(cnt, s_w[k]), __fsub_rn((float)r.max_skew[ck], 1.0f));
      }
    }
    s = __fadd_rn(s, term);
  }
  return rintf(s);
}

__global__ void __launch_bounds__(SCORE_THREADS) spread_score_kernel(ScoreRow r, const float* __restrict__ topo_log,
                                    int topo_log_len, float weight,
                                    float* __restrict__ total) {
  extern __shared__ uint8_t s_present[];  // [Cc, D1]
  __shared__ float fscratch[SCORE_THREADS / 32];
  __shared__ int iscratch[SCORE_THREADS / 32];
  __shared__ float s_w[MAX_CC];
  __shared__ int s_topo[MAX_CC];
  const int c = blockIdx.x;
  const int D = r.D1 - 1;
  for (int i = threadIdx.x; i < r.Cc * r.D1; i += blockDim.x) s_present[i] = 0;
  __syncthreads();
  // sweep 1: domains present among the scored nodes
  for (int n = threadIdx.x; n < r.N; n += blockDim.x) {
    if (!scored_node(r, c, n)) continue;
    for (int k = 0; k < r.Cc; ++k) {
      const int dv = r.dom_val[(long long)(c * r.Cc + k) * r.N + n];
      if (dv < D) s_present[k * r.D1 + dv] = 1;
    }
  }
  __syncthreads();
  // sweep 2: topo_size per constraint, and its weight log(topo_size + 2)
  for (int k = 0; k < r.Cc; ++k) {
    int cnt = 0;
    for (int d = threadIdx.x; d < D; d += blockDim.x) cnt += s_present[k * r.D1 + d];
    cnt = block_sum_int(cnt, iscratch);
    if (threadIdx.x == 0) s_topo[k] = cnt;
    __syncthreads();
  }
  if (threadIdx.x < r.Cc) s_w[threadIdx.x] = topo_log[min(s_topo[threadIdx.x], topo_log_len - 1)];
  bool has_soft = false;
  for (int k = 0; k < r.Cc; ++k) has_soft = has_soft || r.soft_valid[c * r.Cc + k];
  __syncthreads();
  // sweep 3: max and min of the raw score over the valid (feasible, not NaN) nodes
  float mx = -INFINITY, mn = INFINITY;
  for (int n = threadIdx.x; n < r.N; n += blockDim.x) {
    if (r.bits[(long long)c * r.N + n] != r.full) continue;
    const float v = raw_score(r, c, n, has_soft, s_present, s_w);
    if (isnan(v)) continue;
    mx = fmaxf(mx, v);
    mn = fminf(mn, v);
  }
  mx = block_max_float(mx, fscratch);
  mn = block_min_float(mn, fscratch);
  if (!isfinite(mx)) mx = 0.0f;
  if (!isfinite(mn)) mn = 0.0f;
  // sweep 4: normalize, floor, weight, add into the total (−inf off the mask)
  float* trow = total + (long long)c * r.N;
  for (int n = threadIdx.x; n < r.N; n += blockDim.x) {
    if (r.bits[(long long)c * r.N + n] != r.full) continue;
    const float v = raw_score(r, c, n, has_soft, s_present, s_w);
    float out = 0.0f;
    if (!isnan(v)) {
      out = (mx == 0.0f)
                ? MAX_NODE_SCORE
                : __fdiv_rn(__fmul_rn(MAX_NODE_SCORE, __fsub_rn(__fadd_rn(mx, mn), v)), mx);
    }
    trow[n] = __fadd_rn(trow[n], __fmul_rn(weight, floorf(out)));
  }
}

extern "C" int launch_spread_score(int C, int Cc, int N, int D1, const void* bits, int full,
                                   const void* counts, const void* soft_valid,
                                   const void* max_skew, const void* dom_val,
                                   const void* has_key, const void* topo_log,
                                   int topo_log_len, float weight, void* total,
                                   void* stream) {
  if (Cc > MAX_CC) return (int)cudaErrorInvalidValue;
  if (C <= 0 || N <= 0) return 0;
  const size_t smem = (size_t)Cc * D1;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(spread_score_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ScoreRow r{C, Cc, N, D1, full, (const int32_t*)bits, (const int32_t*)counts,
             (const uint8_t*)soft_valid, (const int32_t*)max_skew,
             (const int32_t*)dom_val, (const uint8_t*)has_key};
  spread_score_kernel<<<C, SCORE_THREADS, smem, (cudaStream_t)stream>>>(
      r, (const float*)topo_log, topo_log_len, weight, (float*)total);
  return (int)cudaGetLastError();
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
