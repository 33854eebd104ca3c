// K3 topk_rows: for each row of an f32[C, N] plane, the first K entries in
// (value descending, column ascending) order, −inf entries last by column.
//
// Replaces (JAX package): jax.lax.top_k at framework/runtime.py:875 in
// _batch_assign_dedup.  The dedup auction's exactness rests on that order
// (runtime.py:766-767): ties must break by ascending node row, so a
// general top-k with no tie order (torch.topk) cannot stand in for it.
//
// Design: a chunked selection that works at every node tier.  One block
// sorts a chunk of CHUNK candidates of one row in shared memory (bitonic
// sort of 64-bit keys: the value mapped to an order-preserving unsigned
// key, inverted for descending order, in the high half; the column in the
// low half — so equal values sort by ascending column) and writes the
// chunk's best K columns.  The wrapper repeats the pass over the survivors
// (CHUNK/K fewer each time) until one chunk remains; at N = 8192 and
// K = 512 that is two passes, at N = 131072 four.  Padding entries carry
// the largest key and never reach the first K (N ≥ K).  Bound on the card:
// bytes for the first pass (the whole plane is read once); the sort's
// shared-memory traffic (log² CHUNK stages) dominates the time of this
// simple version.

#include <cuda_runtime.h>
#include <stdint.h>

#define CHUNK 4096
#define THREADS 1024

__device__ __forceinline__ uint32_t desc_key(float v) {
  // canonicalise −0.0 to +0.0 so that equal values tie exactly
  if (v == 0.0f) v = 0.0f;
  uint32_t u = __float_as_uint(v);
  // order-preserving map: ascending floats → ascending unsigned
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ~u;  // descending value order
}

// in:  eff [C, N]; cand_in [C, L] column ids (nullptr: the identity 0..N-1,
//      L = N); out: cand_out [C, nchunks*K] columns, val_out (may be null)
__global__ void topk_pass_kernel(const float* __restrict__ eff, int N,
                                 const int32_t* __restrict__ cand_in, int L,
                                 int K, int32_t* __restrict__ cand_out,
                                 float* __restrict__ val_out) {
  __shared__ unsigned long long keys[CHUNK];
  const int row = blockIdx.y;
  const int chunk = blockIdx.x;
  const int nchunks = gridDim.x;
  const int base = chunk * CHUNK;
  const float* erow = eff + (long long)row * N;
  for (int i = threadIdx.x; i < CHUNK; i += blockDim.x) {
    const int j = base + i;
    unsigned long long key = ~0ull;
    if (j < L) {
      const int col = cand_in ? cand_in[(long long)row * L + j] : j;
      if (col >= 0 && col < N) {
        key = ((unsigned long long)desc_key(erow[col]) << 32) | (uint32_t)col;
      }
    }
    keys[i] = key;
  }
  __syncthreads();
  // bitonic sort, ascending
  for (int size = 2; size <= CHUNK; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < CHUNK; i += blockDim.x) {
        const int partner = i ^ stride;
        if (partner > i) {
          const bool up = ((i & size) == 0);
          const unsigned long long a = keys[i], b = keys[partner];
          if ((a > b) == up) {
            keys[i] = b;
            keys[partner] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const long long out_base = (long long)row * nchunks * K + (long long)chunk * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const unsigned long long key = keys[i];
    const int col = (key == ~0ull) ? -1 : (int)(uint32_t)(key & 0xffffffffull);
    cand_out[out_base + i] = col;
    if (val_out) val_out[out_base + i] = (col >= 0) ? erow[col] : -INFINITY;
  }
}

extern "C" int topk_chunk() { return CHUNK; }

extern "C" int launch_topk_pass(int C, int N, const void* eff, const void* cand_in,
                                int L, int K, int nchunks, void* cand_out,
                                void* val_out, void* stream) {
  if (K > CHUNK) return (int)cudaErrorInvalidValue;
  dim3 grid(nchunks, C);
  topk_pass_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)eff, N, (const int32_t*)cand_in, L, K, (int32_t*)cand_out,
      (float*)val_out);
  return (int)cudaGetLastError();
}
