// K16 scatter_rows: the deferred snapshot row-scatter, out of place.
//
// Replaces (JAX package): state/encoding.py apply_scatter (:168) and
// _scatter_rows (:883) — each dirty row of a group of arrays (the node,
// pod or affinity-group arrays, :894-912) set from the payload, every other
// row kept.  The reference does not donate its buffers (:883-890): an
// in-flight batch still reads the previous snapshot, so the result is a new
// set of arrays, as here.
//
// One launch per array group.  Bound: bytes (every array written once, its
// clean rows read once, the payload read once) — a copy of a few MB, so
// what the design has to do is keep enough loads in flight on every SM:
//
// * The work is split over the group's bytes, not over rows.  A by-value
//   table holds, per array, its plan (``array_plan``: the vector width, the
//   rows a block owns) and its first block, so the grid covers every
//   array's rows in tiles of THREADS · UNROLL vectors — several blocks per
//   SM at N = 8192, and a tile of one array's contiguous rows each.
// * 16-byte vectors where the row bytes and the three pointers allow it,
//   else 4-byte words where a row is whole words, else bytes.  Rows
//   narrower than a 16-byte vector (the bool and one-int rows) are copied as
//   a run of rows: a vector of the old array with each dirty row's bytes
//   patched in from the payload.  A narrow
//   array's last vector, where the array ends inside it, goes byte by byte.
// * Loads ahead of stores: each thread issues its UNROLL vector loads of the
//   old array at entry, before the slot map below, and only then stores.
//   Inputs and outputs never alias (the wrapper allocates the outputs), so
//   the pointers are __restrict__ and the old array is read through the
//   non-coherent path.
// * 32-bit index arithmetic: a vector's row is its byte offset in the tile
//   times a reciprocal precomputed on the host (__umulhi), exact for the
//   offsets a tile holds; no 64-bit divide or modulo per word.
// * Payload rows as before: a block marks in shared memory which payload
//   entry writes each of its rows (one scan of the k payload rows); a dirty
//   row's vector is then loaded from the payload, a clean one stored as
//   loaded.  The payload pads its row list by repeating a row with equal
//   values, so which duplicate a block keeps does not matter.  Each output
//   byte is written exactly once, so blocks need no order between them.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

#define MAX_ARRAYS 24
#define THREADS 256
#define UNROLL 2  // vectors a thread loads before its first store
#define MAX_TILE_ROWS 1024  // rows of a block's slot map

struct Table {
  int n;  // arrays in the group
  int n_rows;  // rows of every array
  int block0[MAX_ARRAYS + 1];  // array a's first block; block0[n] is the grid
  int row_bytes[MAX_ARRAYS];
  int vec[MAX_ARRAYS];  // 16, 4 or 1: the bytes a thread moves at once
  int tile_rows[MAX_ARRAYS];  // rows a block owns
  unsigned magic[MAX_ARRAYS];  // ceil(2^32 / row bytes); 0 where a tile is one row
  const uint8_t* src[MAX_ARRAYS];
  uint8_t* dst[MAX_ARRAYS];
  const uint8_t* val[MAX_ARRAYS];
};

// the plan of one array of ``n_rows`` rows of ``rb`` bytes: the vector
// width (16 where every pointer is 16-byte aligned and a row is whole
// vectors or divides one, else 4 where every pointer is 4-byte aligned and
// a row is whole words, else 1), the rows a
// block owns (a tile of THREADS · UNROLL vectors, at least one row, at most
// MAX_TILE_ROWS) and the blocks
static void array_plan(int rb, int n_rows, bool al16, bool al4, int* vec, int* tile_rows,
                       int* blocks) {
  int v = 1;
  if (rb > 0 && al16 && (rb % 16 == 0 || 16 % rb == 0)) {
    v = 16;
  } else if (rb > 0 && al4 && rb % 4 == 0) {
    v = 4;
  }
  const int tile_bytes = THREADS * UNROLL * v;
  int tr = rb >= tile_bytes ? 1 : tile_bytes / (rb > 0 ? rb : 1);
  if (tr > MAX_TILE_ROWS) tr = MAX_TILE_ROWS;
  *vec = v;
  *tile_rows = tr;
  *blocks = rb > 0 ? (n_rows + tr - 1) / tr : 0;  // a zero-width array has nothing to copy
}

template <int V> struct VecT;
template <> struct VecT<16> { typedef uint4 T; };
template <> struct VecT<4> { typedef uint32_t T; };
template <> struct VecT<1> { typedef uint32_t T; };  // one byte, in a register

// loads issued where they stand: a volatile asm is not sunk past the
// barriers that follow, so the old array's vectors are in flight while the
// slot map is built
template <int V>
__device__ __forceinline__ void ld_early(const uint8_t* p, typename VecT<V>::T& v) {
  if constexpr (V == 16) {
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  } else if constexpr (V == 4) {
    asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
  } else {
    asm volatile("ld.global.nc.u8 %0, [%1];" : "=r"(v) : "l"(p));
  }
}

template <int V>
__device__ __forceinline__ void store(uint8_t* p, const typename VecT<V>::T& v) {
  if constexpr (V == 1) {
    *p = (uint8_t)v;
  } else {
    *reinterpret_cast<typename VecT<V>::T*>(p) = v;
  }
}

// a byte offset's row in the tile: exact while offset · (magic · rb − 2^32)
// < 2^32, which a tile of at least two rows (offsets below THREADS · UNROLL
// · 16 bytes, rows at most half of that) always meets
__device__ __forceinline__ int row_of(unsigned o, int rb, unsigned magic) {
  return rb == 1 ? (int)o : (int)__umulhi(o, magic);
}

// the RB-byte rows (RB of 1, 2, 4 or 8) of a V-byte vector that the payload
// writes, patched in from it: word by word, sub-words by shift and mask
template <int V, int RB>
__device__ __forceinline__ void patch_rows(typename VecT<V>::T& x, int row, const int* slot,
                                           const uint8_t* __restrict__ val) {
  uint32_t w[V / 4];
  memcpy(w, &x, V);
#pragma unroll
  for (int e = 0; e < V / RB; ++e) {
    const int s = slot[row + e];
    if (s < 0) continue;
    const uint8_t* p = val + (size_t)s * RB;
    if constexpr (RB == 8) {
      w[2 * e] = __ldg(reinterpret_cast<const uint32_t*>(p));
      w[2 * e + 1] = __ldg(reinterpret_cast<const uint32_t*>(p) + 1);
    } else if constexpr (RB == 4) {
      w[e] = __ldg(reinterpret_cast<const uint32_t*>(p));
    } else if constexpr (RB == 2) {
      const int sh = (e & 1) * 16;
      const uint32_t h = __ldg(reinterpret_cast<const uint16_t*>(p));
      w[e / 2] = (w[e / 2] & ~(0xffffu << sh)) | (h << sh);
    } else {
      const int sh = (e & 3) * 8;
      const uint32_t b = __ldg(p);
      w[e / 4] = (w[e / 4] & ~(0xffu << sh)) | (b << sh);
    }
  }
  memcpy(&x, w, V);
}

// one block: one tile of array a.  RB is the row width where rows are
// narrower than a vector (a run of V / RB rows a vector), 0 where a row is
// whole vectors
template <int V, int RB>
__device__ __forceinline__ void copy_tile(const Table& t, int a,
                                          const long long* __restrict__ rows, int k,
                                          int* slot) {
  typedef typename VecT<V>::T T;
  const int rb = t.row_bytes[a], tr = t.tile_rows[a];
  const unsigned magic = t.magic[a];
  const int r0 = ((int)blockIdx.x - t.block0[a]) * tr;
  const int nr = min(tr, t.n_rows - r0);
  const size_t base = (size_t)r0 * rb;
  const uint8_t* __restrict__ src = t.src[a] + base;
  uint8_t* __restrict__ dst = t.dst[a] + base;
  const uint8_t* __restrict__ val = t.val[a];
  const int bytes = nr * rb;
  const int whole = bytes / V;  // a narrow array's last tile may end inside a vector
  const int nv = (bytes + V - 1) / V;
  T v[UNROLL];
  // the first chunk's loads, before the slot map
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = threadIdx.x + u * THREADS;
    if (i < whole) ld_early<V>(src + (size_t)i * V, v[u]);
  }
  // which payload entry writes each row of the tile
  for (int r = threadIdx.x; r < nr; r += THREADS) slot[r] = -1;
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += THREADS) {
    const long long r = rows[j] - r0;
    if (r >= 0 && r < nr) slot[r] = j;
  }
  __syncthreads();
  for (int c = 0; c < nv; c += THREADS * UNROLL) {
    if (c > 0) {  // a row longer than a tile: the next chunk
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = c + threadIdx.x + u * THREADS;
        if (i < whole) ld_early<V>(src + (size_t)i * V, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = c + threadIdx.x + u * THREADS;
      if (i >= nv) continue;
      const unsigned o = (unsigned)i * V;  // the vector's byte offset in the tile
      if (i >= whole) {  // the array ends inside this vector: byte by byte
        for (int q = (int)o; q < bytes; ++q) {
          const int row = row_of((unsigned)q, rb, magic);
          const int s = slot[row];
          dst[q] = s >= 0 ? val[(size_t)s * rb + (q - row * rb)] : src[q];
        }
        continue;
      }
      const int row = row_of(o, rb, magic);
      if constexpr (RB == 0) {
        const int s = slot[row];
        if (s >= 0) ld_early<V>(val + (size_t)s * rb + (o - (unsigned)row * rb), v[u]);
      } else {
        patch_rows<V, RB>(v[u], row, slot, val);
      }
      store<V>(dst + o, v[u]);
    }
  }
}

__global__ void __launch_bounds__(THREADS) scatter_rows_kernel(
    const __grid_constant__ Table t, const long long* __restrict__ rows, int k) {
  __shared__ int slot[MAX_TILE_ROWS];
  int a = 0;  // the array whose blocks hold this one
  while (a + 1 < t.n && (int)blockIdx.x >= t.block0[a + 1]) ++a;
  const int v = t.vec[a], rb = t.row_bytes[a];
  if (v == 16) {
    switch (rb) {
      case 1: copy_tile<16, 1>(t, a, rows, k, slot); break;
      case 2: copy_tile<16, 2>(t, a, rows, k, slot); break;
      case 4: copy_tile<16, 4>(t, a, rows, k, slot); break;
      case 8: copy_tile<16, 8>(t, a, rows, k, slot); break;
      default: copy_tile<16, 0>(t, a, rows, k, slot);
    }
  } else if (v == 4) {
    copy_tile<4, 0>(t, a, rows, k, slot);
  } else {
    copy_tile<1, 0>(t, a, rows, k, slot);
  }
}

static bool aligned_to(const void* p, uintptr_t a) { return ((uintptr_t)p & (a - 1)) == 0; }

// the plan the launcher takes for one array → out[0..2] = (vector bytes,
// tile rows, blocks): held against kernel_work.k16_plan on the card
extern "C" void scatter_rows_plan(int row_bytes, int n_rows, int aligned16, int aligned4,
                                  int* out) {
  array_plan(row_bytes, n_rows, aligned16 != 0, aligned4 != 0, out, out + 1, out + 2);
}

extern "C" int launch_scatter_rows(int n_arrays, const void* src_ptrs, const void* dst_ptrs,
                                   const void* val_ptrs, const void* row_bytes,
                                   long long n_rows, const void* rows, int k, void* stream) {
  if (n_arrays <= 0 || n_rows <= 0) return 0;
  if (n_arrays > MAX_ARRAYS || n_rows > INT_MAX) return (int)cudaErrorInvalidValue;
  Table t;
  memset(&t, 0, sizeof(t));
  t.n = n_arrays;
  t.n_rows = (int)n_rows;
  long long blocks = 0;
  for (int a = 0; a < n_arrays; ++a) {
    t.src[a] = ((const uint8_t* const*)src_ptrs)[a];
    t.dst[a] = ((uint8_t* const*)dst_ptrs)[a];
    t.val[a] = ((const uint8_t* const*)val_ptrs)[a];
    const long long rb = ((const long long*)row_bytes)[a];
    if (rb < 0 || rb > INT_MAX / 2) return (int)cudaErrorInvalidValue;
    const bool al16 = aligned_to(t.src[a], 16) && aligned_to(t.dst[a], 16) &&
                      aligned_to(t.val[a], 16);
    const bool al4 = aligned_to(t.src[a], 4) && aligned_to(t.dst[a], 4) &&
                     aligned_to(t.val[a], 4);
    int nb;
    array_plan((int)rb, t.n_rows, al16, al4, &t.vec[a], &t.tile_rows[a], &nb);
    t.row_bytes[a] = (int)rb;
    t.magic[a] = (rb <= 1 || t.tile_rows[a] == 1)
                     ? 0u : (unsigned)(((1ull << 32) + (unsigned long long)rb - 1) / rb);
    t.block0[a] = (int)blocks;
    blocks += nb;
  }
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  t.block0[n_arrays] = (int)blocks;
  if (blocks == 0) return 0;
  scatter_rows_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      t, (const long long*)rows, k);
  return (int)cudaGetLastError();
}
