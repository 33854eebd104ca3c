// K24–K26: DynamicResources' device half — the claim filter, the tight-pack
// score and the device assume of the chips a placed pod's claims take.
//
// Replaces (JAX package): dra/plugin.py DynamicResourcesPlugin.filter
// (:109) and filter_row (:117); _score_plane (:127) through score (:137) and
// score_row (:142), with normalize (:147), floored and weighted by
// framework/runtime.py run_scores (:206-218); update (:152), update_batch
// (:157) and update_batch_classes (:163).
//
// Inputs per row c (a pod, or a class row): demand[c], the chips the pod's
// pending claims need; pinned[c], the node row an allocated claim pins it
// to (below 0: none); blocked[c], an unresolvable claim.  Per node n:
// cap[n], the chips its ResourceSlices publish; free[n] = cap − allocated,
// carried through an engine's rounds or steps (may be negative where a
// slice shrank under allocated claims).
//
// K24 dra_filter_bits: one thread per (row, node); clears DynamicResources'
//   bit of K1's pass-bit plane where free[n] < demand[c], the row is pinned
//   to another node, or the row is blocked.  Bound: bytes (the plane's
//   failing words written; demand / pinned / blocked and free read once).
// K25 dra_score_into: one thread per (row, node); on a feasible entry (all
//   `full` bits set) adds w · raw into K2's total, where raw is the
//   reference's float32 arithmetic in its order:
//     used = (cap − free) + demand, raw = floor(used · 100 / max(cap, 1)),
//     clipped to [0, 100]; 0 where demand ≤ 0 or cap ≤ 0.
//   Each step is one correctly rounded float32 operation (__fsub_rn,
//   __fadd_rn, __fmul_rn, __fdiv_rn; --fmad=false -prec-div=true): the
//   operands are integers below 2^24, so used and used · 100 are exact and
//   only the division rounds, as in the reference.  A reciprocal form
//   (used · 100 · (1 / cap)) moves the floor at 25 (used, cap) pairs with
//   cap ≤ 256 (the first: used = cap = 61 gives 99), a divide-first form
//   ((used / cap) · 100) at 4 (the first: used 53, cap 100 gives 52).  The
//   normalize is the identity on feasible nodes (the raw score is already
//   0..100 and integral), so no row reduction.  Infeasible entries keep the
//   total's −inf.  Bound: bytes (bits and total read, total written).
// K26 dra_take: one thread per pod; a committed pod (the auction's commit
//   mask; the scan's pod when its node is ≥ 0) takes its row's demand (its
//   class row's: class_of is the auction's int64 index, read as it is)
//   from free[node] with an integer atomicSub.  The reference sums the
//   round's demands per node in float32 (an einsum) and casts back: equal
//   to the integer sum below 2^24 chips a node, so the atomics' order
//   cannot change a result.  Bound: latency (≤ B threads, a few hundred
//   bytes).

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void dra_filter_bits_kernel(int C, int N, const int32_t* __restrict__ demand,
                                       const int32_t* __restrict__ pinned,
                                       const uint8_t* __restrict__ blocked,
                                       const int32_t* __restrict__ free_, int bit,
                                       int32_t* __restrict__ bits) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)C * N) return;
  const int c = (int)(k / N);
  const int n = (int)(k - (long long)c * N);
  const int pin = pinned[c];
  const bool ok = free_[n] >= demand[c] && (pin < 0 || n == pin) && !blocked[c];
  if (!ok) bits[k] &= ~(1 << bit);
}

__global__ void dra_score_into_kernel(int C, int N, const int32_t* __restrict__ bits,
                                      int full, const int32_t* __restrict__ cap,
                                      const int32_t* __restrict__ free_,
                                      const int32_t* __restrict__ demand, float weight,
                                      float* __restrict__ total) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)C * N) return;
  if (bits[k] != full) return;
  const int c = (int)(k / N);
  const int n = (int)(k - (long long)c * N);
  const int d = demand[c];
  const int cp = cap[n];
  float raw = 0.0f;
  if (d > 0 && cp > 0) {
    const float capf = (float)cp;
    const float used = __fadd_rn(__fsub_rn(capf, (float)free_[n]), (float)d);
    const float q = __fdiv_rn(__fmul_rn(used, 100.0f), fmaxf(capf, 1.0f));
    raw = fminf(fmaxf(floorf(q), 0.0f), 100.0f);
  }
  total[k] = __fadd_rn(total[k], __fmul_rn(weight, raw));
}

__global__ void dra_take_kernel(int B, int N, const uint8_t* __restrict__ commit,
                                const int32_t* __restrict__ choice,
                                const long long* __restrict__ class_of,
                                const int32_t* __restrict__ demand,
                                int32_t* __restrict__ free_) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  if (commit != nullptr && !commit[b]) return;
  const int node = choice[b];
  if (node < 0 || node >= N) return;
  const int d = demand[class_of != nullptr ? (int)class_of[b] : b];
  if (d != 0) atomicSub(&free_[node], d);
}

extern "C" int launch_dra_filter_bits(int C, int N, const void* demand, const void* pinned,
                                      const void* blocked, const void* free_, int bit,
                                      void* bits, void* stream) {
  const long long work = (long long)C * N;
  if (work <= 0) return 0;
  const int threads = 256;
  const long long blocks = (work + threads - 1) / threads;
  dra_filter_bits_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      C, N, (const int32_t*)demand, (const int32_t*)pinned, (const uint8_t*)blocked,
      (const int32_t*)free_, bit, (int32_t*)bits);
  return (int)cudaGetLastError();
}

extern "C" int launch_dra_score_into(int C, int N, const void* bits, int full,
                                     const void* cap, const void* free_, const void* demand,
                                     float weight, void* total, void* stream) {
  const long long work = (long long)C * N;
  if (work <= 0) return 0;
  const int threads = 256;
  const long long blocks = (work + threads - 1) / threads;
  dra_score_into_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      C, N, (const int32_t*)bits, full, (const int32_t*)cap, (const int32_t*)free_,
      (const int32_t*)demand, weight, (float*)total);
  return (int)cudaGetLastError();
}

extern "C" int launch_dra_take(int B, int N, const void* commit, const void* choice,
                               const void* class_of, const void* demand, void* free_,
                               void* stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  const int blocks = (B + threads - 1) / threads;
  dra_take_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      B, N, (const uint8_t*)commit, (const int32_t*)choice, (const long long*)class_of,
      (const int32_t*)demand, (int32_t*)free_);
  return (int)cudaGetLastError();
}
