// K30 fork_masks and K31 fork_add_rows: the counterfactual snapshot forks.
//
// Replaces (JAX package): whatif/fork.py apply_fork (:73-129), vmapped over K
// stacked fork payloads by whatif/engine.py (:370-390).  A fork is a COPY of
// the live snapshot with a hypothetical change applied; nothing is written
// back.  Both kernels write K forked copies, one per payload, in one launch
// function.
//
// K30 fork_masks (apply_fork minus the node-add, fork.py:92-129), two passes
// in stream order:
//   1. copy: every output array [K, ...] from its base — the live array
//      (shared by the K forks: source stride 0) or, for the node arrays of a
//      fork set that adds nodes, K31's per-fork output (stride one fork);
//   2. scatter, one thread per (fork, payload entry):
//      - node-remove: node_valid[k, del] = false (a scatter-max of "ok");
//      - victim-mask: pod_valid[k, pod] = false, and the victim's request and
//        non-zero request subtracted from its host's requested /
//        non_zero_requested rows, and its claim chips from claim_allocated;
//      - affinity mask: 1.0 subtracted from aff_counts[k, group, value] per
//        contribution.
//   Rows clip to the array as the reference's jnp.clip does; an entry whose
//   row is -1 (a pad) writes nothing.  The reference's duplicates are kept:
//   pod_valid is a scatter-max, so a duplicate victim masks once, while the
//   resource deltas are scatter-adds, so a duplicate subtracts twice — here
//   integer atomics, exact in any order.  aff_counts is float32 holding
//   integer counts: subtracting 1.0 per contribution is exact in any order
//   while the counts stay below 2^24, so float atomics give the reference's
//   bits.
//
// K31 fork_add_rows (the node-add activation, fork.py:82-91): each fork's
// captured template rows written into its own [K, N, ...] copy of the twenty
// node arrays (a table of (source, destination, payload, row bytes), as K16
// has).  Each block owns ROWS_PER_BLOCK consecutive rows of one fork: it
// marks in shared memory which of the fork's REAL adds (ok = true) writes
// each of its rows, then copies every array's row from the payload or from
// the live source.  A pad (ok = false) writes nothing, so a real add always
// wins over a pad at the same row.  (The reference rewrites a pad's row with
// the row's current values inside the same scatter, and XLA:CPU's last
// write wins: pads placed after a real add at row 0 undo it — see ROADMAP
// Queue C.  Here the add wins, as the reference's docstring promises.)  Two
// real adds of one fork at one row carry the same node's values, so which
// one a block keeps does not matter.
//
// Bound: bytes (each output written once, its base read once, the payload
// read once).

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_ARRAYS 24
#define ROWS_PER_BLOCK 64
#define THREADS 256

// ---------------------------------------------------------------- K30 copy pass

struct CopyTable {
  int n;
  const uint8_t* src[8];
  uint8_t* dst[8];
  long long bytes[8];       // bytes of one fork's copy
  long long src_stride[8];  // bytes between forks in the source (0: shared)
};

__global__ void __launch_bounds__(THREADS) fork_copy_kernel(CopyTable t, int K) {
  const int a = blockIdx.y;
  const int k = blockIdx.z;
  if (a >= t.n || k >= K) return;
  const long long nb = t.bytes[a];
  const uint8_t* src = t.src[a] + (long long)k * t.src_stride[a];
  uint8_t* dst = t.dst[a] + (long long)k * nb;
  const bool words = nb % 4 == 0 && (((uintptr_t)src | (uintptr_t)dst) % 4 == 0);
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (words) {
    const uint32_t* s = (const uint32_t*)src;
    uint32_t* d = (uint32_t*)dst;
    for (long long i = start; i < nb / 4; i += step) d[i] = s[i];
  } else {
    for (long long i = start; i < nb; i += step) dst[i] = src[i];
  }
}

// ------------------------------------------------------------- K30 scatter pass

__device__ __forceinline__ long long clip(long long v, long long hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(THREADS) fork_scatter_kernel(
    int K, int N, int P, int R, int G, int D, int V, int A, int DD,
    const int32_t* __restrict__ pod_request, const int32_t* __restrict__ pod_non_zero,
    const int32_t* __restrict__ vic_pod, const int32_t* __restrict__ vic_node,
    const int32_t* __restrict__ vic_chips, const int32_t* __restrict__ aff_rows,
    const int32_t* __restrict__ aff_vals, const int32_t* __restrict__ del_rows,
    bool* __restrict__ node_valid, bool* __restrict__ pod_valid,
    int32_t* __restrict__ requested, int32_t* __restrict__ non_zero,
    float* __restrict__ aff_counts, int32_t* __restrict__ claim_allocated) {
  const int k = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  if (t < V) {
    const int pr = vic_pod[(long long)k * V + t];
    if (pr >= 0) {
      const long long prow = clip(pr, P - 1);
      const long long nrow = clip(vic_node[(long long)k * V + t], N - 1);
      pod_valid[(long long)k * P + prow] = false;
      int32_t* req = requested + ((long long)k * N + nrow) * R;
      for (int r = 0; r < R; ++r) atomicSub(req + r, pod_request[prow * R + r]);
      int32_t* nz = non_zero + ((long long)k * N + nrow) * 2;
      atomicSub(nz, pod_non_zero[prow * 2]);
      atomicSub(nz + 1, pod_non_zero[prow * 2 + 1]);
      if (claim_allocated != nullptr)
        atomicSub(claim_allocated + (long long)k * N + nrow, vic_chips[(long long)k * V + t]);
    }
  }
  if (t < A) {
    const int ar = aff_rows[(long long)k * A + t];
    if (ar >= 0 && G > 0 && D > 0) {
      const long long g = clip(ar, G - 1);
      const long long d = clip(aff_vals[(long long)k * A + t], D - 1);
      atomicAdd(aff_counts + ((long long)k * G + g) * D + d, -1.0f);
    }
  }
  if (t < DD) {
    const int dr = del_rows[(long long)k * DD + t];
    if (dr >= 0) node_valid[(long long)k * N + clip(dr, N - 1)] = false;
  }
}

extern "C" int launch_fork_masks(
    int K, int N, int P, int R, int G, int D, int V, int A, int DD, int node_per_fork,
    const void* node_valid_in, const void* requested_in, const void* non_zero_in,
    const void* claim_in, const void* pod_valid_in, const void* aff_in,
    const void* pod_request, const void* pod_non_zero, const void* vic_pod,
    const void* vic_node, const void* vic_chips, const void* aff_rows, const void* aff_vals,
    const void* del_rows, void* node_valid, void* pod_valid, void* requested, void* non_zero,
    void* aff_counts, void* claim_allocated, void* stream) {
  if (K <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  CopyTable t;
  t.n = 0;
  auto add = [&](const void* src, void* dst, long long bytes, bool per_fork) {
    if (bytes <= 0) return;
    t.src[t.n] = (const uint8_t*)src;
    t.dst[t.n] = (uint8_t*)dst;
    t.bytes[t.n] = bytes;
    t.src_stride[t.n] = per_fork ? bytes : 0;
    ++t.n;
  };
  const bool pf = node_per_fork != 0;
  add(node_valid_in, node_valid, (long long)N, pf);
  add(requested_in, requested, (long long)N * R * 4, pf);
  add(non_zero_in, non_zero, (long long)N * 2 * 4, pf);
  if (claim_allocated != nullptr) add(claim_in, claim_allocated, (long long)N * 4, pf);
  add(pod_valid_in, pod_valid, (long long)P, false);
  add(aff_in, aff_counts, (long long)G * D * 4, false);
  long long biggest = 0;
  for (int a = 0; a < t.n; ++a) biggest = t.bytes[a] > biggest ? t.bytes[a] : biggest;
  if (t.n > 0) {
    long long bx = (biggest / 4 + THREADS - 1) / THREADS;
    if (bx < 1) bx = 1;
    if (bx > 4096) bx = 4096;
    dim3 grid((unsigned)bx, (unsigned)t.n, (unsigned)K);
    fork_copy_kernel<<<grid, THREADS, 0, s>>>(t, K);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  int most = V > A ? V : A;
  most = most > DD ? most : DD;
  if (most > 0) {
    dim3 grid((unsigned)((most + THREADS - 1) / THREADS), (unsigned)K);
    fork_scatter_kernel<<<grid, THREADS, 0, s>>>(
        K, N, P, R, G, D, V, A, DD, (const int32_t*)pod_request,
        (const int32_t*)pod_non_zero, (const int32_t*)vic_pod, (const int32_t*)vic_node,
        (const int32_t*)vic_chips, (const int32_t*)aff_rows, (const int32_t*)aff_vals,
        (const int32_t*)del_rows, (bool*)node_valid, (bool*)pod_valid, (int32_t*)requested,
        (int32_t*)non_zero, (float*)aff_counts, (int32_t*)claim_allocated);
  }
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------- K31

struct AddTable {
  int n;
  const uint8_t* src[MAX_ARRAYS];
  uint8_t* dst[MAX_ARRAYS];
  const uint8_t* val[MAX_ARRAYS];
  long long row_bytes[MAX_ARRAYS];
};

__global__ void __launch_bounds__(THREADS) fork_add_rows_kernel(
    AddTable t, long long n_rows, int M, const int32_t* __restrict__ rows,
    const bool* __restrict__ ok) {
  __shared__ int slot[ROWS_PER_BLOCK];
  const int k = blockIdx.y;
  const long long r0 = (long long)blockIdx.x * ROWS_PER_BLOCK;
  for (int i = threadIdx.x; i < ROWS_PER_BLOCK; i += blockDim.x) slot[i] = -1;
  __syncthreads();
  for (int j = threadIdx.x; j < M; j += blockDim.x) {
    if (!ok[(long long)k * M + j]) continue;  // a pad writes nothing
    long long r = rows[(long long)k * M + j];
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    if (r >= r0 && r < r0 + ROWS_PER_BLOCK) slot[r - r0] = j;
  }
  __syncthreads();
  const long long n_here = min((long long)ROWS_PER_BLOCK, n_rows - r0);
  for (int a = 0; a < t.n; ++a) {
    const long long rb = t.row_bytes[a];
    const uint8_t* src = t.src[a];
    uint8_t* dst = t.dst[a] + (long long)k * n_rows * rb;
    const uint8_t* val = t.val[a] + (long long)k * M * rb;
    const bool aligned = rb % 4 == 0 && (((uintptr_t)src | (uintptr_t)dst | (uintptr_t)val) % 4 == 0);
    if (aligned) {
      const long long words = rb / 4;
      for (long long w = threadIdx.x; w < n_here * words; w += blockDim.x) {
        const long long lr = w / words, off = w % words;
        const int s = slot[lr];
        ((uint32_t*)dst)[(r0 + lr) * words + off] =
            s >= 0 ? ((const uint32_t*)val)[(long long)s * words + off]
                   : ((const uint32_t*)src)[(r0 + lr) * words + off];
      }
    } else {
      for (long long w = threadIdx.x; w < n_here * rb; w += blockDim.x) {
        const long long lr = w / rb, off = w % rb;
        const int s = slot[lr];
        dst[(r0 + lr) * rb + off] = s >= 0 ? val[(long long)s * rb + off] : src[(r0 + lr) * rb + off];
      }
    }
  }
}

extern "C" int launch_fork_add_rows(int n_arrays, const void* src_ptrs, const void* dst_ptrs,
                                    const void* val_ptrs, const void* row_bytes, long long n_rows,
                                    int K, int M, const void* rows, const void* ok, void* stream) {
  if (n_arrays <= 0 || n_rows <= 0 || K <= 0) return 0;
  if (n_arrays > MAX_ARRAYS) return (int)cudaErrorInvalidValue;
  AddTable t;
  t.n = n_arrays;
  for (int a = 0; a < n_arrays; ++a) {
    t.src[a] = ((const uint8_t* const*)src_ptrs)[a];
    t.dst[a] = ((uint8_t* const*)dst_ptrs)[a];
    t.val[a] = ((const uint8_t* const*)val_ptrs)[a];
    t.row_bytes[a] = ((const long long*)row_bytes)[a];
  }
  const long long blocks = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  dim3 grid((unsigned)blocks, (unsigned)K);
  fork_add_rows_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      t, n_rows, M, (const int32_t*)rows, (const bool*)ok);
  return (int)cudaGetLastError();
}
