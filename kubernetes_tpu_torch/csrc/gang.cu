// K20 gang_all_or_nothing: the in-batch all-or-nothing mask of gang
// scheduling.
//
// Replaces (JAX package): gang/device.py gang_all_or_nothing (:17), run
// inside the fused cycle after the assignment engine — every member of a gang
// segment with ANY unplaced member is withdrawn (node row -1), so a partly
// placed gang never reaches the binding cycle.  Pods outside every gang
// (gang_seg -1, padding rows too) keep their row; an all(-1) gang_seg is the
// identity.
//
// One block over the whole batch (B <= 1024 on the card, the auction's own
// limit; the block strides, so a larger B also works): a per-segment count of
// unplaced members in shared memory, built with integer atomics (the
// reference sums a float32 one-hot; counts below 2^24 are the same), then
// each member of a segment whose count is above 0 writes -1.  Bound on the
// card: latency (two B-long int32 reads, one write, ~6 kB at B = 512).

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void gang_all_or_nothing_kernel(int B, const int32_t* __restrict__ node_row,
                                           const int32_t* __restrict__ gang_seg,
                                           int32_t* __restrict__ out) {
  extern __shared__ int miss[];  // [B]: unplaced members per segment
  for (int i = threadIdx.x; i < B; i += blockDim.x) miss[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const int s = gang_seg[i];
    if (s >= 0 && s < B && node_row[i] < 0) atomicAdd(&miss[s], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const int s = gang_seg[i];
    const bool withdraw = s >= 0 && s < B && miss[s] > 0;
    out[i] = withdraw ? -1 : node_row[i];
  }
}

extern "C" int launch_gang_all_or_nothing(int B, const void* node_row, const void* gang_seg,
                                          void* out, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = (size_t)B * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gang_all_or_nothing_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = B < 1024 ? ((B + 31) / 32) * 32 : 1024;
  gang_all_or_nothing_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      B, (const int32_t*)node_row, (const int32_t*)gang_seg, (int32_t*)out);
  return (int)cudaGetLastError();
}
