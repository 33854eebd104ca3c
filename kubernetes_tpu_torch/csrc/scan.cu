// K17 scan_select_assume: one step of the exact serial scan — select pod i's
// node from its folded row and assume it.
//
// Replaces (JAX package): framework/runtime.py greedy_assign's step
// (:358-393) with select_host (:299-308, key=None) and _apply_dynamic's
// resource half (:434-438): the feasible count of the row; the first
// maximum of the masked total (jnp.argmax: the lowest row among ties, row 0
// when nothing is feasible); the nominated-node fast path (:380-383); node
// 0 when infeasible and −1 out when infeasible or the pod is padding; then
// requested[node] += request[i], non_zero[node] += non_zero[i] when the pod
// was placed.  node_row[i] and feasible_count[i] are written on the card,
// where the next step's update kernels (K18, K19) read the node: the scan
// queues every step back to back with no read on the host.
//
// Keyed mode (noise != NULL; the reference's select_host with a key,
// :305-308): the node is the argmax of where(masked == max, noise, -1) —
// the largest noise among the tied maxima, the lower row on equal noise; an
// all -inf row is all ties.  The noise row is K33's uniform draw under the
// step's key.  The nominated path and the infeasible rule are unchanged.
//
// One block of up to 1024 threads: each thread folds a strided slice of the
// row into (feasible count, best value, best row) and a warp-shuffle then
// shared-memory reduction combines them — best is the larger value, the
// lower row on a tie.  In keyed mode the maximum goes to every thread
// through shared memory and a second strided pass reduces (noise, row) over
// the ties the same way.  Thread 0 finishes the step.  Bound: bytes (the bit
// row and the total row read once, a few dozen bytes written); at one row
// the card is mostly idle — the launch latency is the step's cost.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SELECT_THREADS 1024

struct Best {
  float v;
  int n;
};

__device__ __forceinline__ Best better(Best a, Best b) {
  // the larger value; on a tie the lower row (a first-max argmax)
  if (b.v > a.v || (b.v == a.v && b.n < a.n)) return b;
  return a;
}

__global__ void __launch_bounds__(SELECT_THREADS) scan_select_kernel(
    int N, int R, int full, int i,
    const int32_t* __restrict__ bits,      // [N] pod i's pass bits
    const float* __restrict__ total,       // [N] pod i's total (−inf off the mask)
    const int32_t* __restrict__ nominated, // [B] nominated node row, < 0 none
    const uint8_t* __restrict__ valid,     // [B]
    const int32_t* __restrict__ request,   // [B, R]
    const int32_t* __restrict__ pod_nz,    // [B, 2]
    int32_t* __restrict__ requested,       // [N, R] in/out
    int32_t* __restrict__ node_nz,         // [N, 2] in/out
    int32_t* __restrict__ node_row,        // [B] out at i
    int32_t* __restrict__ feasible_count,  // [B] out at i
    const float* __restrict__ noise) {     // [N] the step's draw, or NULL
  __shared__ int s_cnt[SELECT_THREADS / 32];
  __shared__ float s_v[SELECT_THREADS / 32];
  __shared__ int s_n[SELECT_THREADS / 32];
  __shared__ float s_max;
  int cnt = 0;
  // the sentinel row N loses every tie, so an all −inf row selects row 0
  Best best{-INFINITY, N};
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const bool m = bits[n] == full;
    cnt += m;
    best = better(best, Best{m ? total[n] : -INFINITY, n});
  }
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffff, cnt, off);
    Best o{__shfl_down_sync(0xffffffff, best.v, off), __shfl_down_sync(0xffffffff, best.n, off)};
    best = better(best, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_cnt[warp] = cnt;
    s_v[warp] = best.v;
    s_n[warp] = best.n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = 0;
    Best b{-INFINITY, N};
    for (int w = 0; w < (int)(blockDim.x / 32); ++w) {
      c += s_cnt[w];
      b = better(b, Best{s_v[w], s_n[w]});
    }
    s_cnt[0] = c;
    s_n[0] = b.n;
    s_max = b.v;
  }
  __syncthreads();
  cnt = s_cnt[0];
  best = Best{s_max, s_n[0]};
  if (noise != nullptr) {
    // the uniform draw among the tied maxima (noise >= 0 beats the -1 of
    // every other row, so only ties compete)
    const float mx = s_max;
    Best tie{-1.0f, N};
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const float v = bits[n] == full ? total[n] : -INFINITY;
      tie = better(tie, Best{v == mx ? noise[n] : -1.0f, n});
    }
    for (int off = 16; off > 0; off >>= 1) {
      Best o{__shfl_down_sync(0xffffffff, tie.v, off), __shfl_down_sync(0xffffffff, tie.n, off)};
      tie = better(tie, o);
    }
    __syncthreads();  // every thread has read s_n[0] and s_max
    if (lane == 0) {
      s_v[warp] = tie.v;
      s_n[warp] = tie.n;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      tie = Best{-1.0f, N};
      for (int w = 0; w < (int)(blockDim.x / 32); ++w) tie = better(tie, Best{s_v[w], s_n[w]});
      best = tie;
    }
  }
  if (threadIdx.x != 0) return;
  const bool feasible = cnt > 0;
  int node = best.n;
  const int nom = nominated[i];
  const int nomc = min(max(nom, 0), N - 1);
  if (nom >= 0 && bits[nomc] == full) node = nomc;  // nominated-node fast path
  if (!feasible) node = 0;
  const bool placed = feasible && valid[i];
  node_row[i] = placed ? node : -1;
  feasible_count[i] = cnt;
  if (!placed) return;
  for (int r = 0; r < R; ++r) requested[(long long)node * R + r] += request[(long long)i * R + r];
  for (int k = 0; k < 2; ++k) node_nz[(long long)node * 2 + k] += pod_nz[(long long)i * 2 + k];
}

extern "C" int launch_scan_select(int N, int R, int full, int i, const void* bits,
                                  const void* total, const void* nominated, const void* valid,
                                  const void* request, const void* pod_nz, void* requested,
                                  void* node_nz, void* node_row, void* feasible_count,
                                  const void* noise, void* stream) {
  if (N <= 0) return 0;
  int threads = 32;
  while (threads < N && threads < SELECT_THREADS) threads *= 2;
  scan_select_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      N, R, full, i, (const int32_t*)bits, (const float*)total, (const int32_t*)nominated,
      (const uint8_t*)valid, (const int32_t*)request, (const int32_t*)pod_nz,
      (int32_t*)requested, (int32_t*)node_nz, (int32_t*)node_row, (int32_t*)feasible_count,
      (const float*)noise);
  return (int)cudaGetLastError();
}
