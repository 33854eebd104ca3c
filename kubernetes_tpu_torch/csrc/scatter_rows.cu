// K16 scatter_rows: the deferred snapshot row-scatter, out of place.
//
// Replaces (JAX package): state/encoding.py apply_scatter (:168) and
// _scatter_rows (:883) — each dirty row of a group of arrays (the node,
// pod or affinity-group arrays, :894-912) set from the payload, every other
// row kept.  The reference does not donate its buffers (:883-890): an
// in-flight batch still reads the previous snapshot, so the result is a new
// set of arrays, as here.
//
// One launch per array group.  A table of (source, destination, payload,
// row bytes) entries, passed by value, covers the group's arrays (rows of
// bool, int32 and float32 of any width).  Each block owns ROWS_PER_BLOCK
// consecutive output rows: it first marks in shared memory which payload
// entry (if any) writes each of its rows — a scan of the k payload rows —
// then copies every array's row from the payload or from the source, in
// 4-byte words where the row width allows it.  Each output byte is written
// exactly once, so there is no ordering between blocks to respect.  The
// payload pads its row list by repeating a row with equal values, so which
// duplicate a block keeps does not matter.  Bound: bytes (every array read
// and written once, the payload read once).

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_ARRAYS 24
#define ROWS_PER_BLOCK 64
#define THREADS 256

struct Table {
  int n;
  const uint8_t* src[MAX_ARRAYS];
  uint8_t* dst[MAX_ARRAYS];
  const uint8_t* val[MAX_ARRAYS];
  long long row_bytes[MAX_ARRAYS];
};

__global__ void __launch_bounds__(THREADS) scatter_rows_kernel(
    Table t, long long n_rows, const long long* __restrict__ rows, int k) {
  __shared__ int slot[ROWS_PER_BLOCK];
  const long long r0 = (long long)blockIdx.x * ROWS_PER_BLOCK;
  for (int i = threadIdx.x; i < ROWS_PER_BLOCK; i += blockDim.x) slot[i] = -1;
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const long long r = rows[j];
    if (r >= r0 && r < r0 + ROWS_PER_BLOCK) slot[r - r0] = j;
  }
  __syncthreads();
  const long long n_here = min((long long)ROWS_PER_BLOCK, n_rows - r0);
  for (int a = 0; a < t.n; ++a) {
    const long long rb = t.row_bytes[a];
    const bool aligned = ((uintptr_t)t.src[a] | (uintptr_t)t.dst[a] | (uintptr_t)t.val[a]) % 4 == 0;
    if (rb % 4 == 0 && aligned) {
      const long long words = rb / 4;
      const uint32_t* src = (const uint32_t*)t.src[a];
      const uint32_t* val = (const uint32_t*)t.val[a];
      uint32_t* dst = (uint32_t*)t.dst[a];
      for (long long w = threadIdx.x; w < n_here * words; w += blockDim.x) {
        const long long lr = w / words, off = w % words;
        const int s = slot[lr];
        dst[(r0 + lr) * words + off] =
            s >= 0 ? val[(long long)s * words + off] : src[(r0 + lr) * words + off];
      }
    } else {
      const uint8_t* src = t.src[a];
      const uint8_t* val = t.val[a];
      uint8_t* dst = t.dst[a];
      for (long long w = threadIdx.x; w < n_here * rb; w += blockDim.x) {
        const long long lr = w / rb, off = w % rb;
        const int s = slot[lr];
        dst[(r0 + lr) * rb + off] =
            s >= 0 ? val[(long long)s * rb + off] : src[(r0 + lr) * rb + off];
      }
    }
  }
}

extern "C" int launch_scatter_rows(int n_arrays, const void* src_ptrs, const void* dst_ptrs,
                                   const void* val_ptrs, const void* row_bytes,
                                   long long n_rows, const void* rows, int k, void* stream) {
  if (n_arrays <= 0 || n_rows <= 0) return 0;
  if (n_arrays > MAX_ARRAYS) return (int)cudaErrorInvalidValue;
  Table t;
  t.n = n_arrays;
  for (int a = 0; a < n_arrays; ++a) {
    t.src[a] = ((const uint8_t* const*)src_ptrs)[a];
    t.dst[a] = ((uint8_t* const*)dst_ptrs)[a];
    t.val[a] = ((const uint8_t* const*)val_ptrs)[a];
    t.row_bytes[a] = ((const long long*)row_bytes)[a];
  }
  const long long blocks = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  scatter_rows_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      t, n_rows, (const long long*)rows, k);
  return (int)cudaGetLastError();
}
