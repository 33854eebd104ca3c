// K33 tie_noise: JAX's threefry2x32 tie noise of the keyed engines, one
// thread an element, three entries.
//
// Replaces (JAX package): the jax.random draws of framework/runtime.py under
// jax_threefry_partitionable=True — greedy_assign's per-step keys
// (jax.random.split(key, b), :397) and their uniform rows
// (select_host's jax.random.uniform(keys[k], (N,)), :307, :421), and
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
//   row:   noise[n] = u(n) under keys[k], the scan's k-th step key (k is the
//          scan position, not the pod row), read from the card.
//
// Threefry-2x32: 20 rounds of add / rotate-left / xor, rotations (13, 15, 26,
// 6) then (17, 29, 16, 24), the key schedule (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
// injected after every 4 rounds with the injection index added to word 1.
// Bound on the card: the plane's bytes (the total read and written, the bit
// plane read: 12 bytes an element) against ~120 integer operations an
// element; the split and the row are a few kB — launch latency.  Design: a
// grid-stride loop, no shared memory, every word in registers.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl32(x1, rot[g & 1][r]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
}

__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1, unsigned long long j) {
  uint32_t x0 = (uint32_t)(j >> 32), x1 = (uint32_t)(j & 0xFFFFFFFFull);
  threefry2x32(k0, k1, x0, x1);
  const uint32_t w = ((x0 ^ x1) >> 9) | 0x3F800000u;
  return __fsub_rn(__uint_as_float(w), 1.0f);
}

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
