// K32 selector_spread_score: SelectorSpread's score, added into the weighted
// total of the cycle's score planes.
//
// Replaces (JAX package): plugins/selectorspread.py score_row (:109) and its
// vmapped score (:134) — ROADMAP Queue B B13 — floored and weighted by
// framework/runtime.py run_scores (:206-218).
//
// For each row c of [C, N], over the row's mask (bits == full):
//   max_c, max_z = maxima of counts, zone_counts on the mask (0 off it);
//   node = (max_c - counts) * 100 / max(max_c, 1), or 100 when max_c == 0;
//   zone = the same over zone_counts and max_z;
//   blended = fma(0.33333334, node, 0.6666667 * zone) where has_zone and
//             max_z > 0, else node;
//   total += weight * floor(blended) on the masked cells.
// Exactness: multiply first, (max_c - c) * 100, then one correctly rounded
// division (the reciprocal form flips floors); the node weight is the
// reference's (1 - 2/3) taken in double and rounded to float32
// (0.33333334f, not 1 - 0.6666667f); the blend is ONE fused multiply-add,
// as XLA:CPU contracts the reference's a * node + b * zone (a separate
// product and sum flip about 3 floors in a million); every other step an
// __f*_rn intrinsic and the library built with --fmad=false.
// Every term of the total is an integer below 2^24, so the order in which
// the planes are added cannot change a sum.
//
// One block per row: a strided pass reduces the two masked maxima (warp
// shuffles, then shared memory across the warps), a second pass writes the
// row.  A block has 256 threads, or 1024 when there are fewer rows than
// SMs (the exact scan's one row: a lone block then walks the row in a
// quarter of the steps).  Bound on the card: bytes — the pass bits over every entry (4 bytes),
// and on the masked entries only both count planes and the total read and
// the total written (16 bytes an entry: an unmasked entry, node-tier padding
// included, is skipped after its bit test), plus has_zone.  Runs on the full
// auction's [C, N] rows and on the exact scan's one row (C = 1).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define THREADS_FEW_ROWS 1024
#define FEW_ROWS 132  // the H100 SXM's SM count
#define MAX_NODE_SCORE 100.0f
#define W_NODE 0.33333334f
#define W_ZONE 0.6666667f

__global__ void selector_spread_score_kernel(int C, int N, const int32_t* __restrict__ bits,
                                             int full, const float* __restrict__ counts,
                                             const float* __restrict__ zone_counts,
                                             const uint8_t* __restrict__ has_zone,
                                             float weight, float* __restrict__ total) {
  __shared__ float s_c[THREADS_FEW_ROWS / 32];
  __shared__ float s_z[THREADS_FEW_ROWS / 32];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const long long base = (long long)c * N;
  float mc = 0.0f, mz = 0.0f;
  for (int n = tid; n < N; n += blockDim.x) {
    if (bits[base + n] != full) continue;
    mc = fmaxf(mc, counts[base + n]);
    mz = fmaxf(mz, zone_counts[base + n]);
  }
  for (int off = 16; off > 0; off >>= 1) {
    mc = fmaxf(mc, __shfl_down_sync(0xffffffff, mc, off));
    mz = fmaxf(mz, __shfl_down_sync(0xffffffff, mz, off));
  }
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    s_c[warp] = mc;
    s_z[warp] = mz;
  }
  __syncthreads();
  float max_c = 0.0f, max_z = 0.0f;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) {
    max_c = fmaxf(max_c, s_c[w]);
    max_z = fmaxf(max_z, s_z[w]);
  }
  const float div_c = fmaxf(max_c, 1.0f), div_z = fmaxf(max_z, 1.0f);
  for (int n = tid; n < N; n += blockDim.x) {
    if (bits[base + n] != full) continue;
    const float node =
        max_c > 0.0f
            ? __fdiv_rn(__fmul_rn(__fsub_rn(max_c, counts[base + n]), MAX_NODE_SCORE), div_c)
            : MAX_NODE_SCORE;
    float blended = node;
    if (has_zone[n] && max_z > 0.0f) {
      const float zone = __fdiv_rn(
          __fmul_rn(__fsub_rn(max_z, zone_counts[base + n]), MAX_NODE_SCORE), div_z);
      blended = __fmaf_rn(W_NODE, node, __fmul_rn(W_ZONE, zone));
    }
    total[base + n] = __fadd_rn(total[base + n], __fmul_rn(weight, floorf(blended)));
  }
}

extern "C" int launch_selector_spread_score(int C, int N, const void* bits, int full,
                                            const void* counts, const void* zone_counts,
                                            const void* has_zone, float weight, void* total,
                                            void* stream) {
  if (C <= 0 || N <= 0) return 0;
  const int threads = C < FEW_ROWS ? THREADS_FEW_ROWS : THREADS;
  selector_spread_score_kernel<<<C, threads, 0, (cudaStream_t)stream>>>(
      C, N, (const int32_t*)bits, full, (const float*)counts, (const float*)zone_counts,
      (const uint8_t*)has_zone, weight, (float*)total);
  return (int)cudaGetLastError();
}
