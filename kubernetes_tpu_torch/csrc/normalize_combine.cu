// K2 normalize_combine: per-plugin normalization and the weighted total of
// the dedup cycle's score planes, one block per class row, two passes.
//
// Replaces (JAX package): the total that framework/runtime.py
// _batch_assign_dedup.dense_rep (and run_scores, :206-218) builds each
// round — Σ_plugin weight · floor(normalize(raw)), −inf where infeasible —
// with plugins/helpers.py default_normalize (:58) for NodeAffinity and the
// reversed form for TaintToleration, identity for Fit, BalancedAllocation
// and ImageLocality, and the pass-through plugins' constant contribution
// (computed on the host from their own normalize of an all-zero plane).
// Also the row's feasible-node count (the reference's sum of the mask).
//
// Pass 1 reduces each default-normalized plane's row maximum over the
// feasible nodes (mask = all filter bits set) and counts them; pass 2 writes
// the total.  Bound on the card: bytes (the raw planes are read twice, the
// total written once).  Design: one block of 1024 threads per class row,
// strided over the row; the row maxima and the count go through shared
// memory.  Numerics: `raw * 100 / max` is a multiply then a correctly
// rounded divide (--fmad=false -prec-div=true), as in the reference; every
// weighted term is an integer, so the sum is exact in any order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_PLANES 8
#define THREADS 1024
#define KIND_IDENTITY 0
#define KIND_DEFAULT 1
#define KIND_DEFAULT_REVERSED 2

__global__ void normalize_combine_kernel(int C, int N, int P,
                                         const int32_t* __restrict__ bits,
                                         int full, const float* __restrict__ raw,
                                         const int32_t* __restrict__ kind,
                                         const float* __restrict__ weight,
                                         float const_add, float* __restrict__ total,
                                         int32_t* __restrict__ feas) {
  __shared__ float s_max[MAX_PLANES][THREADS / 32];
  __shared__ int s_cnt[THREADS / 32];
  __shared__ float row_max[MAX_PLANES];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const long long plane = (long long)C * N;
  const int32_t* brow = bits + (long long)c * N;

  float m[MAX_PLANES];
  for (int p = 0; p < MAX_PLANES; ++p) m[p] = -INFINITY;
  int cnt = 0;
  for (int n = tid; n < N; n += blockDim.x) {
    if (brow[n] != full) continue;
    cnt += 1;
    for (int p = 0; p < P; ++p) {
      if (kind[p] != KIND_IDENTITY)
        m[p] = fmaxf(m[p], raw[p * plane + (long long)c * N + n]);
    }
  }
  // warp then block reduction
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffff, cnt, off);
    for (int p = 0; p < P; ++p)
      m[p] = fmaxf(m[p], __shfl_down_sync(0xffffffff, m[p], off));
  }
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    s_cnt[warp] = cnt;
    for (int p = 0; p < P; ++p) s_max[p][warp] = m[p];
  }
  __syncthreads();
  if (tid == 0) {
    int total_cnt = 0;
    for (int w = 0; w < (int)(blockDim.x / 32); ++w) total_cnt += s_cnt[w];
    feas[c] = total_cnt;
    for (int p = 0; p < P; ++p) {
      float mx = -INFINITY;
      for (int w = 0; w < (int)(blockDim.x / 32); ++w) mx = fmaxf(mx, s_max[p][w]);
      row_max[p] = isfinite(mx) ? mx : 0.0f;
    }
  }
  __syncthreads();

  float* trow = total + (long long)c * N;
  for (int n = tid; n < N; n += blockDim.x) {
    if (brow[n] != full) {
      trow[n] = -INFINITY;
      continue;
    }
    float t = 0.0f;
    for (int p = 0; p < P; ++p) {
      const float x = raw[p * plane + (long long)c * N + n];
      float norm;
      if (kind[p] == KIND_IDENTITY) {
        norm = x;
      } else {
        const float mx = row_max[p];
        const bool zero_max = (mx == 0.0f);
        const float scaled =
            floorf(__fdiv_rn(__fmul_rn(x, 100.0f), zero_max ? 1.0f : mx));
        if (kind[p] == KIND_DEFAULT_REVERSED)
          norm = zero_max ? 100.0f : __fsub_rn(100.0f, scaled);
        else
          norm = zero_max ? 0.0f : scaled;
      }
      t = __fadd_rn(t, __fmul_rn(weight[p], floorf(norm)));
    }
    trow[n] = __fadd_rn(t, const_add);
  }
}

extern "C" int launch_normalize_combine(int C, int N, int P, const void* bits,
                                        int full, const void* raw,
                                        const void* kind, const void* weight,
                                        float const_add, void* total, void* feas,
                                        void* stream) {
  if (P > MAX_PLANES) return (int)cudaErrorInvalidValue;
  normalize_combine_kernel<<<C, THREADS, 0, (cudaStream_t)stream>>>(
      C, N, P, (const int32_t*)bits, full, (const float*)raw,
      (const int32_t*)kind, (const float*)weight, const_add, (float*)total,
      (int32_t*)feas);
  return (int)cudaGetLastError();
}
