// K33 tie_noise: JAX's threefry2x32 tie noise of the keyed engines, one
// thread an element, three entries.
//
// Replaces (JAX package): the jax.random draws of framework/runtime.py under
// jax_threefry_partitionable=True — greedy_assign's per-step keys
// (jax.random.split(key, b), :397), select_host's uniform row
// (jax.random.uniform(key, (N,)), :307; greedy_assign's steps, :421, draw
// theirs inside K17's keyed pass), and
// batch_assign's noise plane (jax.random.uniform(key, (b, N)) * 0.5 added to
// the scores where the mask holds, :546-548, :588-589).
//
//   split: keys[i] = threefry2x32(key, (0, i)), both output words.
//   plane: total[c, n] += 0.5 * u(c * N + n) where bits[c, n] == full; the
//          uniform u(j) = bitcast_f32(((x0 ^ x1) >> 9) | 0x3F800000) - 1 with
//          (x0, x1) = threefry2x32(key, (0, j)).  The product by 0.5 is exact
//          and the add is one correctly rounded float add (__fadd_rn), as
//          XLA:CPU's; totals are integer-valued, so the noise reorders ties
//          only.  Off the mask total stays -inf (K2 wrote it there).
//   row:   noise[n] = u(n) under keys[k] (k a row of the key table, read
//          from the card): select_host's draw.  The scan's steps draw
//          inside K17's keyed pass instead.
//
// The threefry rounds and the uniform are threefry.cuh's, which K17's keyed
// mode (scan.cu) includes too: one copy of the device code.
//
// Bound on the card: the plane's bytes (the total read and written, the bit
// plane read: 12 bytes an element) against ~120 integer operations an
// element; the split and the row are a few kB — launch latency.  Design: a
// grid-stride loop, no shared memory, every word in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

__global__ void tie_split_kernel(uint32_t k0, uint32_t k1, int n, uint32_t* __restrict__ keys) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    uint32_t x0 = 0, x1 = (uint32_t)i;
    threefry2x32(k0, k1, x0, x1);
    keys[2 * i] = x0;
    keys[2 * i + 1] = x1;
  }
}

__global__ void tie_plane_kernel(uint32_t k0, uint32_t k1, long long total_n, int full,
                                 const int32_t* __restrict__ bits, float* __restrict__ total) {
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < total_n;
       j += (long long)gridDim.x * blockDim.x) {
    if (bits[j] != full) continue;
    const float u = uniform_at(k0, k1, (unsigned long long)j);
    total[j] = __fadd_rn(total[j], __fmul_rn(u, 0.5f));
  }
}

__global__ void tie_row_kernel(const uint32_t* __restrict__ keys, int k, int n,
                               float* __restrict__ noise) {
  const uint32_t k0 = keys[2 * k], k1 = keys[2 * k + 1];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    noise[i] = uniform_at(k0, k1, (unsigned long long)i);
}

static int blocks_for(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
  if (b < 1) b = 1;
  if (b > 132 * 32) b = 132 * 32;
  return (int)b;
}

extern "C" int launch_tie_split(unsigned int k0, unsigned int k1, int n, void* keys,
                                void* stream) {
  if (n <= 0) return 0;
  tie_split_kernel<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(k0, k1, n,
                                                                          (uint32_t*)keys);
  return (int)cudaGetLastError();
}

extern "C" int launch_tie_plane(unsigned int k0, unsigned int k1, long long total_n, int full,
                                const void* bits, void* total, void* stream) {
  if (total_n <= 0) return 0;
  tie_plane_kernel<<<blocks_for(total_n, 256), 256, 0, (cudaStream_t)stream>>>(
      k0, k1, total_n, full, (const int32_t*)bits, (float*)total);
  return (int)cudaGetLastError();
}

extern "C" int launch_tie_row(const void* keys, int k, int n, void* noise, void* stream) {
  if (n <= 0) return 0;
  tie_row_kernel<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>((const uint32_t*)keys,
                                                                         k, n, (float*)noise);
  return (int)cudaGetLastError();
}
