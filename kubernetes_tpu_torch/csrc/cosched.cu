// K21 cosched_score_into: Coscheduling's anchor-slice score, added into the
// weighted total of the cycle's score planes.
//
// Replaces (JAX package): gang/coscheduling.py CoschedulingPlugin.score
// (:100) — the 0/1 plane [anchor[c] >= 0 and slice_dom[n] == anchor[c]] —
// with its normalize, plugins/helpers.py default_normalize, floored and
// weighted by framework/runtime.py run_scores (:206-218).
//
// The closed form.  The match plane is 0/1.  default_normalize scales a row
// by its maximum over the feasible nodes (all filter bits set): when some
// feasible node of row c lies in the anchor slice that maximum is 1 and
// every feasible match scores floor(100 * 1 / 1) = 100; when none does the
// maximum is 0 and the row scores 0 — where every feasible entry is a
// non-match anyway.  So on every feasible node the term is
// w * 100 * [match], with no row reduction, and infeasible nodes keep the
// total's -inf.  Every term of the total is an integer below 2^24, so the
// order of the additions cannot change a sum (--fmad=false; __fadd_rn).
//
// One thread per (row, node); the anchor is read once per thread, the slice
// plane is shared by every row.  Bound on the card: bytes (the pass bits and
// the total read, the total written: 12 bytes per entry).  Runs on the full
// auction's [C, N] planes and on the exact scan's single row (C = 1).

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void cosched_score_into_kernel(int C, int N, const int32_t* __restrict__ bits,
                                          int full, const int32_t* __restrict__ anchor,
                                          const int32_t* __restrict__ slice_dom,
                                          float add, float* __restrict__ total) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)C * N) return;
  const int c = (int)(k / N);
  const int n = (int)(k - (long long)c * N);
  const int a = anchor[c];
  if (a < 0 || slice_dom[n] != a || bits[k] != full) return;
  total[k] = __fadd_rn(total[k], add);
}

extern "C" int launch_cosched_score_into(int C, int N, const void* bits, int full,
                                         const void* anchor, const void* slice_dom,
                                         float add, void* total, void* stream) {
  const long long work = (long long)C * N;
  if (work <= 0) return 0;
  const int threads = 256;
  const long long blocks = (work + threads - 1) / threads;
  cosched_score_into_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      C, N, (const int32_t*)bits, full, (const int32_t*)anchor,
      (const int32_t*)slice_dom, add, (float*)total);
  return (int)cudaGetLastError();
}
