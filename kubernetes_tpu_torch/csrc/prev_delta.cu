// K13 prev_delta_apply: the nominated pods' reservations and the in-flight
// batches' resource delta of the fused cycle.
//
// Replaces (JAX package): scheduler.py _build_jitted.reserve_nominated
// (:889-895) and apply_prev_delta (:897-916), the scatter-adds of the
// nominated pods' requests into requested[N, R] (non_zero untouched: the
// bundle has no nz rows) and of each still-in-flight batch's request rows
// into requested[N, R] and non_zero[N, 2] at the node rows its
// device-resident decision chose; rows below 0 (unplaced pods, padding) add
// nothing and rows at or above N land on row N - 1 (the reference's clip).
// The fused program applies up to three bundles (the nominated rows, then
// the two newest in-flight batches at depth 3); integer adds commute, so one
// launch takes all of them and their order changes no bit.
//
// Out of place, in one launch: the outputs are written from the inputs, so
// the snapshot's own requested / non_zero stay untouched for the next
// dispatch's row-scatter and no separate copy runs.  Each block owns a tile
// of TILE node rows: it stages the tile's requested / non_zero rows and
// every bundle's rows, requests and nz rows in shared memory (cp.async, 16
// bytes a copy where aligned, all in flight together: one round trip to
// memory), adds the pods that land in its tile into the staged tile with
// shared-memory integer adds, and writes the tile out, coalesced.  No
// global atomics.
// Bundles larger than the staging room go through in chunks.
//
// Bound on the card: latency (~20 kB of bundle payload, the [N, R + 2]
// arrays read and written once); every block reads the whole bundle payload
// from L2, which at 32 tiles of 256 rows (N = 8192) is ~1.4 MB.  With one
// block an SM, the copies each thread issues are the critical path, so a
// block has twice as many threads as tile rows.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 256      // node rows a block
#define THREADS 512
#define MAX_BUNDLES 3
#define SMEM_BUDGET (96 * 1024)  // dynamic shared memory a block may take

struct Bundle {
  int n;                 // pods in the bundle (B0)
  const int32_t* rows;   // [B0] node row, < 0 = none
  const int32_t* req;    // [B0, R]
  const int32_t* nz;     // [B0, 2], or null: the bundle adds nothing to non_zero
};

struct Bundles {
  Bundle b[MAX_BUNDLES];
};

// count words from src (global) to dst (shared) with cp.async: 16-byte
// copies when both ends are 16-byte aligned, else 4-byte ones; nothing waits
// here, so every copy of the block is in flight together (cp_async_wait)
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void stage(int32_t* dst, const int32_t* __restrict__ src,
                                      int count) {
  int start = 0;
  if (((((uintptr_t)dst) | ((uintptr_t)src)) & 15) == 0) {
    const int n4 = count >> 2;
    for (int q = threadIdx.x; q < n4; q += blockDim.x) cp_async(dst + 4 * q, src + 4 * q, 16);
    start = n4 << 2;
  }
  for (int q = start + threadIdx.x; q < count; q += blockDim.x) cp_async(dst + q, src + q, 4);
}

// count words from src (shared) to dst (global), 128-bit stores when aligned
__device__ __forceinline__ void store(int32_t* __restrict__ dst, const int32_t* src,
                                      int count) {
  int start = 0;
  if (((((uintptr_t)dst) | ((uintptr_t)src)) & 15) == 0) {
    const int n4 = count >> 2;
    const int4* s4 = (const int4*)src;
    int4* d4 = (int4*)dst;
    for (int q = threadIdx.x; q < n4; q += blockDim.x) d4[q] = s4[q];
    start = n4 << 2;
  }
  for (int q = start + threadIdx.x; q < count; q += blockDim.x) dst[q] = src[q];
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

__global__ void __launch_bounds__(THREADS)
prev_delta_kernel(Bundles bs, int total, int chunk, int N, int R,
                  const int32_t* __restrict__ req_in, const int32_t* __restrict__ nz_in,
                  int32_t* __restrict__ req_out, int32_t* __restrict__ nz_out) {
  extern __shared__ int4 smem4[];
  int32_t* s_treq = (int32_t*)smem4;           // [TILE, R]
  int32_t* s_tnz = s_treq + round4(TILE * R);  // [TILE, 2]
  int32_t* s_rows = s_tnz + TILE * 2;          // [chunk]
  int32_t* s_req = s_rows + round4(chunk);     // [chunk, R]
  int32_t* s_nz = s_req + round4(chunk * R);   // [chunk, 2]

  const int n0 = blockIdx.x * TILE;
  const int nt = min(TILE, N - n0);
  stage(s_treq, req_in + (long long)n0 * R, nt * R);
  stage(s_tnz, nz_in + (long long)n0 * 2, nt * 2);

  for (int base = 0; base < total; base += chunk) {
    const int len = min(chunk, total - base);
    // the chunk [base, base + len) of the bundles laid end to end
    int off = 0;
    for (int k = 0; k < MAX_BUNDLES; ++k) {
      const Bundle& b = bs.b[k];
      const int lo = max(base, off), hi = min(base + len, off + b.n);
      if (lo < hi) {
        stage(s_rows + (lo - base), b.rows + (lo - off), hi - lo);
        stage(s_req + (lo - base) * R, b.req + (long long)(lo - off) * R, (hi - lo) * R);
        if (b.nz) stage(s_nz + (lo - base) * 2, b.nz + (long long)(lo - off) * 2, (hi - lo) * 2);
      }
      off += b.n;
    }
    cp_async_wait();
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const int row = s_rows[i];
      if (row < 0) continue;
      const int t = min(row, N - 1) - n0;  // the reference clips the row
      if (t < 0 || t >= nt) continue;
      for (int k = 0; k < R; ++k) {
        const int32_t v = s_req[i * R + k];
        if (v) atomicAdd(&s_treq[t * R + k], v);
      }
      const int g = base + i;
      const bool has_nz = g < bs.b[0].n ? bs.b[0].nz != nullptr
                          : g < bs.b[0].n + bs.b[1].n ? bs.b[1].nz != nullptr
                                                      : bs.b[2].nz != nullptr;
      if (has_nz) {
        for (int k = 0; k < 2; ++k) {
          const int32_t v = s_nz[i * 2 + k];
          if (v) atomicAdd(&s_tnz[t * 2 + k], v);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait();  // the tile's copies, where no bundle row was staged
  __syncthreads();
  store(req_out + (long long)n0 * R, s_treq, nt * R);
  store(nz_out + (long long)n0 * 2, s_tnz, nt * 2);
}

extern "C" int launch_prev_delta(int n_a, const void* rows_a, const void* req_a,
                                 const void* nz_a, int n_b, const void* rows_b,
                                 const void* req_b, const void* nz_b, int n_c,
                                 const void* rows_c, const void* req_c,
                                 const void* nz_c, int N, int R,
                                 const void* requested, const void* non_zero,
                                 void* out_requested, void* out_non_zero, void* stream) {
  if (N <= 0) return 0;
  const int total = n_a + n_b + n_c;
  Bundles bs;
  bs.b[0] = Bundle{n_a, (const int32_t*)rows_a, (const int32_t*)req_a, (const int32_t*)nz_a};
  bs.b[1] = Bundle{n_b, (const int32_t*)rows_b, (const int32_t*)req_b, (const int32_t*)nz_b};
  bs.b[2] = Bundle{n_c, (const int32_t*)rows_c, (const int32_t*)req_c, (const int32_t*)nz_c};
  // the staging room left beside the tile, in pods (4-word aligned segments)
  const int tile_words = round4(TILE * R) + TILE * 2;
  int chunk = (SMEM_BUDGET / 4 - tile_words - 12) / (R + 3);
  chunk = max(4, min(chunk, round4(max(total, 1)))) & ~3;
  const size_t smem =
      (size_t)(tile_words + round4(chunk) + round4(chunk * R) + chunk * 2) * 4;
  static size_t smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(prev_delta_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  prev_delta_kernel<<<(N + TILE - 1) / TILE, THREADS, smem, (cudaStream_t)stream>>>(
      bs, total, chunk, N, R, (const int32_t*)requested, (const int32_t*)non_zero,
      (int32_t*)out_requested, (int32_t*)out_non_zero);
  return (int)cudaGetLastError();
}
