// K13 prev_delta_apply: the nominated pods' reservations and the in-flight
// batches' resource delta of the fused cycle.
//
// Replaces (JAX package): scheduler.py _build_jitted.reserve_nominated
// (:889-895) and apply_prev_delta (:897-916), the scatter-adds of the
// nominated pods' requests into requested[N, R] (non_zero untouched: the
// bundle's nz rows are zero) and of each still-in-flight batch's request rows
// into requested[N, R] and non_zero[N, 2] at the node rows its
// device-resident decision chose; rows below 0 (unplaced pods, padding) add
// nothing.  The fused program applies up to three bundles (the nominated
// rows, then the two newest in-flight batches at depth 3); integer adds
// commute, so one launch takes all of them and their order changes no bit.
//
// One thread per (bundle, pod): R + 2 integer atomics into the caller's
// arrays, which the wrapper has copied first — the snapshot's own
// requested / non_zero stay untouched for the next dispatch's row-scatter.
// Bound: latency (≤ 2 · 512 pods plus the nominated rows, ~20 kB of
// payload); the atomics only collide where two pods share a node, and
// integer adds are exact in any order.

#include <cuda_runtime.h>
#include <stdint.h>

struct Bundle {
  int n;                 // pods in the bundle (B0)
  const int32_t* rows;   // [B0] node row, < 0 = none
  const int32_t* req;    // [B0, R]
  const int32_t* nz;     // [B0, 2]
};

#define MAX_BUNDLES 3

struct Bundles {
  Bundle b[MAX_BUNDLES];
};

__global__ void prev_delta_kernel(Bundles bs, int N, int R,
                                  int32_t* __restrict__ requested,
                                  int32_t* __restrict__ non_zero) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int k = 0;
  while (k < MAX_BUNDLES && i >= bs.b[k].n) {
    i -= bs.b[k].n;
    ++k;
  }
  if (k == MAX_BUNDLES) return;
  const Bundle* bd = &bs.b[k];
  const int row = bd->rows[i];
  if (row < 0) return;
  const long long r = min(row, N - 1);  // the reference clips the row
  for (int k = 0; k < R; ++k) {
    const int32_t v = bd->req[(long long)i * R + k];
    if (v) atomicAdd(&requested[r * R + k], v);
  }
  for (int k = 0; k < 2; ++k) {
    const int32_t v = bd->nz[(long long)i * 2 + k];
    if (v) atomicAdd(&non_zero[r * 2 + k], v);
  }
}

extern "C" int launch_prev_delta(int n_a, const void* rows_a, const void* req_a,
                                 const void* nz_a, int n_b, const void* rows_b,
                                 const void* req_b, const void* nz_b, int n_c,
                                 const void* rows_c, const void* req_c,
                                 const void* nz_c, int N, int R,
                                 void* requested, void* non_zero, void* stream) {
  const int total = n_a + n_b + n_c;
  if (total <= 0 || N <= 0) return 0;
  Bundles bs;
  bs.b[0] = Bundle{n_a, (const int32_t*)rows_a, (const int32_t*)req_a, (const int32_t*)nz_a};
  bs.b[1] = Bundle{n_b, (const int32_t*)rows_b, (const int32_t*)req_b, (const int32_t*)nz_b};
  bs.b[2] = Bundle{n_c, (const int32_t*)rows_c, (const int32_t*)req_c, (const int32_t*)nz_c};
  const int threads = 256;
  prev_delta_kernel<<<(total + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      bs, N, R, (int32_t*)requested, (int32_t*)non_zero);
  return (int)cudaGetLastError();
}
