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
// each thread owns its output and walks its node's pods in row order over a
// per-node segment (pod rows sorted stably by node, built by the wrapper --
// index preparation, not the function).
//
// K27: one thread per (node, channel), channel R = the pod count.  The
//   thread zeroes its column of the [K+1, N, *] output, adds each pod of its
//   segment into row bucket + 1 (bucket = searchsorted(levels, priority,
//   left); invalid and unbound pods are not in any segment), then scans rows
//   1..K in place.  Bound: bytes (the [K+1, N, R+1] output, ~21 MB at
//   K = 128, N = 8192, R = 4; each element written twice and read once).
// K28: one thread per (batch pod, node): the threshold row
//   tb = searchsorted(levels, priority_b) of prefix / prefix_cnt, the fit over
//   R, has-victims (count > 0) and the static bits (bits & mask == mask; K1's
//   plane, zero on dead nodes and padding rows).  Bound: bytes.
// K29: one thread per (batch pod, node): the node's segment walked once,
//   summing the requests of the pods below the batch pod's priority in row
//   order, then the fit as K28.  Bound: bytes (B x the segment walk).

#include <cuda_runtime.h>
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

__global__ void priority_prefix_kernel(int N, int R, int K,
                                       const int64_t* __restrict__ perm,
                                       const int64_t* __restrict__ offsets,
                                       const int32_t* __restrict__ prio,
                                       const int32_t* __restrict__ req,
                                       const int32_t* __restrict__ levels,
                                       float* __restrict__ prefix,
                                       float* __restrict__ prefix_cnt) {
  __shared__ int32_t lv[MAX_LEVELS];
  for (int i = threadIdx.x; i < K; i += blockDim.x) lv[i] = levels[i];
  __syncthreads();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)N * (R + 1)) return;
  const int n = (int)(tid / (R + 1));
  const int c = (int)(tid % (R + 1));
  // this thread's column: element t at col[t * stride]
  float* col;
  long long stride;
  if (c < R) { col = prefix + (long long)n * R + c; stride = (long long)N * R; }
  else { col = prefix_cnt + n; stride = N; }
  for (int t = 0; t <= K; ++t) col[t * stride] = 0.0f;
  // the level totals, each in ascending pod-row order
  const long long s0 = offsets[n], s1 = offsets[n + 1];
  for (long long j = s0; j < s1; ++j) {
    const long long p = perm[j];
    const int b = lower_bound(lv, K, prio[p]);
    if (b >= K) continue;  // the reference's overflow bucket
    const float v = c < R ? __int2float_rn(req[p * R + c]) : 1.0f;
    float* at = col + (long long)(b + 1) * stride;
    *at = __fadd_rn(*at, v);
  }
  // rows 1..K: XLA:CPU's blocked cumulative sum
  float excl = 0.0f;
  for (int blk = 0; blk * BLOCK_BASE < K; ++blk) {
    float run = 0.0f;
    const int len = min(BLOCK_BASE, K - blk * BLOCK_BASE);
    for (int i = 0; i < len; ++i) {
      float* at = col + (long long)(1 + blk * BLOCK_BASE + i) * stride;
      run = i == 0 ? *at : __fadd_rn(run, *at);
      *at = blk == 0 ? run : __fadd_rn(run, excl);
    }
    excl = blk == 0 ? run : __fadd_rn(excl, run);
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

__global__ void candidate_dense_kernel(int B, int N, int R,
                                       const int64_t* __restrict__ perm,
                                       const int64_t* __restrict__ offsets,
                                       const int32_t* __restrict__ prio,
                                       const int32_t* __restrict__ req,
                                       const int32_t* __restrict__ priority,
                                       const int32_t* __restrict__ request,
                                       const int32_t* __restrict__ alloc,
                                       const int32_t* __restrict__ requested,
                                       const int32_t* __restrict__ bits, int32_t mask,
                                       uint8_t* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)B * N) return;
  const int b = (int)(tid / N);
  const int n = (int)(tid % N);
  bool ok = (bits[tid] & mask) == mask;
  if (ok) {
    const int32_t mine = priority[b];
    float freed[MAX_R];
    for (int r = 0; r < R; ++r) freed[r] = 0.0f;
    int cnt = 0;
    const long long s0 = offsets[n], s1 = offsets[n + 1];
    for (long long j = s0; j < s1; ++j) {
      const long long p = perm[j];
      if (prio[p] >= mine) continue;
      ++cnt;
      for (int r = 0; r < R; ++r)
        freed[r] = __fadd_rn(freed[r], __int2float_rn(req[p * R + r]));
    }
    ok = cnt > 0 && fits_freed(R, request + (long long)b * R, alloc + (long long)n * R,
                               requested + (long long)n * R, freed, 1);
  }
  out[tid] = ok ? 1 : 0;
}

static int blocks_for(long long total, int threads) {
  return (int)((total + threads - 1) / threads);
}

extern "C" int launch_priority_prefix(int N, int R, int K, const void* perm,
                                      const void* offsets, const void* prio,
                                      const void* req, const void* levels, void* prefix,
                                      void* prefix_cnt, void* stream) {
  if (K > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  const long long total = (long long)N * (R + 1);
  if (total <= 0) return 0;
  const int threads = 128;
  priority_prefix_kernel<<<blocks_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      N, R, K, (const int64_t*)perm, (const int64_t*)offsets, (const int32_t*)prio,
      (const int32_t*)req, (const int32_t*)levels, (float*)prefix, (float*)prefix_cnt);
  return (int)cudaGetLastError();
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

extern "C" int launch_candidate_dense(int B, int N, int R, const void* perm,
                                      const void* offsets, const void* prio,
                                      const void* req, const void* priority,
                                      const void* request, const void* alloc,
                                      const void* requested, const void* bits, int mask,
                                      void* out, void* stream) {
  if (R > MAX_R) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * N;
  if (total <= 0) return 0;
  const int threads = 256;
  candidate_dense_kernel<<<blocks_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      B, N, R, (const int64_t*)perm, (const int64_t*)offsets, (const int32_t*)prio,
      (const int32_t*)req, (const int32_t*)priority, (const int32_t*)request,
      (const int32_t*)alloc, (const int32_t*)requested, (const int32_t*)bits,
      (int32_t)mask, (uint8_t*)out);
  return (int)cudaGetLastError();
}
