// K22 diag_pack: the cycle's diagnosis bits and its one [3, B] result.
//
// Replaces (JAX package): framework/runtime.py diagnose_bits (:237-255) —
// for each filter plugin k, does it leave row c ANY node — and the fused
// program's pack_diag (scheduler.py:918-930): row 0 the node row per pod
// (after the gang mask, K20), row 1 the diagnosis bitmask of the pod's class
// row (bit k = filter k leaves it a node), row 2 the engine's round count.
// The one device->host fetch of every cycle reads this array.
//
// The pass-bit plane already folds in every filter, live nodes and row
// validity (K1 and the dynamic filters), so bit k of the OR of a row's words
// over N is exactly "filter k leaves the row a node"; it is masked to the
// n_filters <= 31 low bits.  One block per class row: a strided OR over the
// row, a warp-shuffle and shared-memory OR reduction, then the block writes
// the three entries of every pod whose class is its row (class_of null: the
// row is the pod).  Bound on the card: bytes (the [C, N] plane read once).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

__global__ void diag_pack_kernel(int C, int N, int B, const int32_t* __restrict__ bits,
                                 int mask, const int32_t* __restrict__ class_of,
                                 const int32_t* __restrict__ node_row, int rounds,
                                 int32_t* __restrict__ out) {
  __shared__ int s_or[THREADS / 32];
  const int c = blockIdx.x;
  const int32_t* row = bits + (long long)c * N;
  int acc = 0;
  for (int n = threadIdx.x; n < N; n += blockDim.x) acc |= row[n];
  for (int off = 16; off > 0; off >>= 1) acc |= __shfl_down_sync(0xffffffff, acc, off);
  if ((threadIdx.x & 31) == 0) s_or[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int v = 0;
    for (int w = 0; w < THREADS / 32; ++w) v |= s_or[w];
    s_or[0] = v & mask;
  }
  __syncthreads();
  const int diag = s_or[0];
  if (class_of == nullptr) {
    if (threadIdx.x == 0 && c < B) {
      out[c] = node_row[c];
      out[B + c] = diag;
      out[2 * B + c] = rounds;
    }
    return;
  }
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    if (class_of[b] != c) continue;
    out[b] = node_row[b];
    out[B + b] = diag;
    out[2 * B + b] = rounds;
  }
}

extern "C" int launch_diag_pack(int C, int N, int B, const void* bits, int n_filters,
                                const void* class_of, const void* node_row, int rounds,
                                void* out, void* stream) {
  if (C <= 0 || B <= 0) return 0;
  const int mask = (int)((1u << n_filters) - 1u);
  diag_pack_kernel<<<C, THREADS, 0, (cudaStream_t)stream>>>(
      C, N, B, (const int32_t*)bits, mask, (const int32_t*)class_of,
      (const int32_t*)node_row, rounds, (int32_t*)out);
  return (int)cudaGetLastError();
}
