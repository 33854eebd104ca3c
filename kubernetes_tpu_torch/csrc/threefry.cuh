// JAX's threefry2x32 on the card: the device code that K33 (tie_noise.cu)
// and K17's keyed mode (scan.cu) share, so that both draw the same bits.
//
// Threefry-2x32: 20 rounds of add / rotate-left / xor, rotations (13, 15, 26,
// 6) then (17, 29, 16, 24), the key schedule (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
// injected after every 4 rounds with the injection index added to word 1.
// The uniform at counter j under a key is jax.random.uniform's float32 under
// jax_threefry_partitionable=True: bitcast_f32(((x0 ^ x1) >> 9) | 0x3F800000)
// - 1 with (x0, x1) = threefry2x32(key, (0, j)) for j < 2^32, the subtraction
// one correctly rounded float op (__fsub_rn; exact here).

#pragma once

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
