// K27 priority_prefix, K28 candidate_fit, K29 candidate_dense: preemption's
// candidate mask, "would pod b fit node n with every lower-priority pod on n
// evicted".
//
// Replaces (JAX package): whatif/dryrun.py candidate_mask_device (:31-96),
// which TPUScheduler's "cand" program (scheduler.py:1019-1028) runs after
// the static filters.  Its levels branch (:56-74) scatter-adds every bound
// pod's request into a [K+1, N, R] per-priority-level table, takes an
// exclusive prefix over the levels and gathers each batch pod's threshold row;
// its dense branch (:75-94, more than K distinct priorities) contracts
// B x P x N x R.
//
// The float32 order is the reference's, bit for bit:
//   * a level's total on a node is the sum of its pods' requests in
//     ascending pod-row order, starting from 0 (XLA:CPU's scatter-add walks
//     the updates in order);
//   * the prefix over the levels is XLA:CPU's cumsum, which is not left to
//     right: a blocked scan of base 16 -- an inclusive running sum inside
//     each block of 16 levels, the block totals summed left to right, and
//     each element of block j > 0 plus the totals of blocks 0..j-1 (K <= 256
//     keeps the totals' own scan to one block);
//   * the fit is (alloc - requested) first, then + freed, each one correctly
//     rounded operation (the library builds with --fmad=false).
// A float atomicAdd would sum in arrival order, so no kernel here uses one:
// each thread owns its output and adds its node's pods in row order.  K27
// walks a per-node segment (pod rows sorted stably by node, built by the
// wrapper's ``node_segments`` -- index preparation, not the function); K29
// gathers its nodes' pods itself, in row order, in the one launch.
//
// K27: one thread per (node, channel), channel R = the pod count.  The
//   thread zeroes its column of the [K+1, N, *] output, adds each pod of its
//   segment into row bucket + 1 (bucket = searchsorted(levels, priority,
//   left); invalid and unbound pods are not in any segment), then scans rows
//   1..K in place.  Bound: bytes (the [K+1, N, R+1] output, ~21 MB at
//   K = 128, N = 8192, R = 4; each element written twice and read once).
// K28: one thread per (batch pod, node): the threshold row
//   tb = searchsorted(levels, priority_b) of prefix / prefix_cnt, the fit over
//   R, has-victims (count > 0) and the static bits (bits & mask == mask; K1's
//   plane, zero on dead nodes and padding rows).  Bound: bytes.
// K29: the whole call in one launch, no sort.  A block takes a tile of 32
//   nodes (one a lane) and a slice of batch rows (KB a thread, one warp's
//   rows interleaved with the next's; KB = 8, 4 or 2 as R <= 4, 8 or 16, so
//   the sums and counts stay in registers).  It streams the pod tier in
//   ascending row order in chunks of 4096 rows, 16 consecutive rows a
//   thread (16-byte loads of the nodes and the valid flags), and gathers
//   the valid pods bound to its tile stably: each thread's count of them, a
//   warp scan, a scan of the warps' totals, so pod i of the list is the
//   i-th in row order; their rows, then (an entry a thread) their
//   priorities and requests as float go to shared memory, 1024 a round.
//   Each warp then walks the list 32 entries at a time: the entries of each
//   node as a bit mask (__match_any_sync over the entries' nodes, the
//   leader of each set writing it for that node's lane), and each lane
//   takes its node's entries low bit first, adding the requests of those
//   below each of its rows' priorities with __fadd_rn.  Chunks, rounds and
//   groups come in row order, so every (row, node) sum is in ascending
//   pod-row order from 0 whatever the node holds -- a node with more pods
//   than a chunk or a round included.  Then the fit as K28, every load
//   issued before the first compare.  Two blocks an SM (registers bounded
//   to 128 a thread): a chunk's barriers and loads leave the SM idle
//   unless another block has work.  Bound: bytes (the pod tier, the node
//   rows and the batch rows read once, the mask written once); each block
//   re-reads the tier's node and valid columns from L2, 5 bytes a row.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define BLOCK_BASE 16  // XLA:CPU's cumulative-sum rewrite base
#define MAX_LEVELS 256
#define MAX_R 16

__device__ __forceinline__ int lower_bound(const int32_t* lv, int K, int32_t x) {
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lv[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void priority_prefix_kernel(int N, int R, int K,
                                       const int64_t* __restrict__ perm,
                                       const int64_t* __restrict__ offsets,
                                       const int32_t* __restrict__ prio,
                                       const int32_t* __restrict__ req,
                                       const int32_t* __restrict__ levels,
                                       float* __restrict__ prefix,
                                       float* __restrict__ prefix_cnt) {
  __shared__ int32_t lv[MAX_LEVELS];
  for (int i = threadIdx.x; i < K; i += blockDim.x) lv[i] = levels[i];
  __syncthreads();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)N * (R + 1)) return;
  const int n = (int)(tid / (R + 1));
  const int c = (int)(tid % (R + 1));
  // this thread's column: element t at col[t * stride]
  float* col;
  long long stride;
  if (c < R) { col = prefix + (long long)n * R + c; stride = (long long)N * R; }
  else { col = prefix_cnt + n; stride = N; }
  for (int t = 0; t <= K; ++t) col[t * stride] = 0.0f;
  // the level totals, each in ascending pod-row order
  const long long s0 = offsets[n], s1 = offsets[n + 1];
  for (long long j = s0; j < s1; ++j) {
    const long long p = perm[j];
    const int b = lower_bound(lv, K, prio[p]);
    if (b >= K) continue;  // the reference's overflow bucket
    const float v = c < R ? __int2float_rn(req[p * R + c]) : 1.0f;
    float* at = col + (long long)(b + 1) * stride;
    *at = __fadd_rn(*at, v);
  }
  // rows 1..K: XLA:CPU's blocked cumulative sum
  float excl = 0.0f;
  for (int blk = 0; blk * BLOCK_BASE < K; ++blk) {
    float run = 0.0f;
    const int len = min(BLOCK_BASE, K - blk * BLOCK_BASE);
    for (int i = 0; i < len; ++i) {
      float* at = col + (long long)(1 + blk * BLOCK_BASE + i) * stride;
      run = i == 0 ? *at : __fadd_rn(run, *at);
      *at = blk == 0 ? run : __fadd_rn(run, excl);
    }
    excl = blk == 0 ? run : __fadd_rn(excl, run);
  }
}

// the fit of one (batch pod, node) given the freed vector
__device__ __forceinline__ bool fits_freed(int R, const int32_t* __restrict__ rq,
                                           const int32_t* __restrict__ alloc,
                                           const int32_t* __restrict__ requested,
                                           const float* freed, long long fstride) {
  for (int r = 0; r < R; ++r) {
    const float q = __int2float_rn(rq[r]);
    if (q == 0.0f) continue;
    const float base = __fsub_rn(__int2float_rn(alloc[r]), __int2float_rn(requested[r]));
    if (!(q <= __fadd_rn(base, freed[r * fstride]))) return false;
  }
  return true;
}

__global__ void candidate_fit_kernel(int B, int N, int R, int K,
                                     const float* __restrict__ prefix,
                                     const float* __restrict__ prefix_cnt,
                                     const int32_t* __restrict__ levels,
                                     const int32_t* __restrict__ priority,
                                     const int32_t* __restrict__ request,
                                     const int32_t* __restrict__ alloc,
                                     const int32_t* __restrict__ requested,
                                     const int32_t* __restrict__ bits, int32_t mask,
                                     uint8_t* __restrict__ out) {
  __shared__ int32_t lv[MAX_LEVELS];
  for (int i = threadIdx.x; i < K; i += blockDim.x) lv[i] = levels[i];
  __syncthreads();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)B * N) return;
  const int b = (int)(tid / N);
  const int n = (int)(tid % N);
  bool ok = (bits[tid] & mask) == mask;
  if (ok) {
    const long long tb = lower_bound(lv, K, priority[b]);
    ok = prefix_cnt[tb * N + n] > 0.0f
         && fits_freed(R, request + (long long)b * R, alloc + (long long)n * R,
                       requested + (long long)n * R, prefix + (tb * N + n) * R, 1);
  }
  out[tid] = ok ? 1 : 0;
}

// --- K29 ---------------------------------------------------------------------
// A block: DENSE_TILE nodes (one a lane) x DENSE_WARPS * KB batch rows (warp w
// takes rows w, w + DENSE_WARPS, ...); it streams the pod tier in chunks of
// DENSE_CHUNK rows, DENSE_PPT consecutive rows a thread, and gathers the
// tile's pods in row order into shared memory, DENSE_CAP a round.
#define DENSE_TILE 32
#define DENSE_WARPS 8
#define DENSE_PPT 16
#define DENSE_CHUNK (DENSE_WARPS * 32 * DENSE_PPT)
#define DENSE_CAP 1024
#define FULL_MASK 0xffffffffu

// batch rows a thread carries: KB * (RB + 1) registers of sums and counts
template <int RB>
struct DenseRows {
  static constexpr int value = RB <= 4 ? 8 : (RB <= 8 ? 4 : 2);
};

// DENSE_PPT rows from r0: their nodes (−1 past the tier) and their valid
// bits; 16-byte loads where the tier's arrays allow
__device__ __forceinline__ void load_pods(const uint8_t* __restrict__ valid,
                                          const int32_t* __restrict__ node, int P,
                                          long long r0, int vec, int (&nd)[DENSE_PPT],
                                          unsigned& vm) {
  vm = 0u;
  if (vec && r0 + DENSE_PPT <= P) {
    const int4* np = reinterpret_cast<const int4*>(node + r0);
#pragma unroll
    for (int q = 0; q < DENSE_PPT / 4; ++q) {
      const int4 v = __ldg(np + q);
      nd[4 * q] = v.x; nd[4 * q + 1] = v.y; nd[4 * q + 2] = v.z; nd[4 * q + 3] = v.w;
    }
    const uint4 vv = __ldg(reinterpret_cast<const uint4*>(valid + r0));
    const unsigned w[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int j = 0; j < DENSE_PPT; ++j)
      if ((w[j >> 2] >> (8 * (j & 3))) & 0xffu) vm |= 1u << j;
  } else {
#pragma unroll
    for (int j = 0; j < DENSE_PPT; ++j) {
      const long long r = r0 + j;
      nd[j] = r < P ? __ldg(node + r) : -1;
      if (r < P && __ldg(valid + r)) vm |= 1u << j;
    }
  }
}

template <int RB>
__global__ void __launch_bounds__(DENSE_WARPS * 32, 2)
candidate_dense_kernel(int B, int N, int R, int P, int vec,
                       const uint8_t* __restrict__ pvalid, const int32_t* __restrict__ pnode,
                       const int32_t* __restrict__ pprio, const int32_t* __restrict__ preq,
                       const int32_t* __restrict__ priority, const int32_t* __restrict__ request,
                       const int32_t* __restrict__ alloc, const int32_t* __restrict__ requested,
                       const int32_t* __restrict__ bits, int32_t mask,
                       uint8_t* __restrict__ out) {
  constexpr int KB = DenseRows<RB>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_req = reinterpret_cast<float*>(smem);                 // [DENSE_CAP][R]
  int32_t* s_prio = reinterpret_cast<int32_t*>(s_req + DENSE_CAP * R);  // [DENSE_CAP]
  int32_t* s_row = s_prio + DENSE_CAP;                                  // [DENSE_CAP]
  uint8_t* s_node = reinterpret_cast<uint8_t*>(s_row + DENSE_CAP);      // [DENSE_CAP]
  __shared__ int s_wsum[2][DENSE_WARPS];  // the warps' gathered counts, by chunk parity
  __shared__ unsigned s_mask[DENSE_WARPS][32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * DENSE_TILE, n = n0 + lane;
  const int b0 = blockIdx.y * (DENSE_WARPS * KB);
  int32_t thr[KB];
  float freed[KB][RB];
  int cnt[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const int b = b0 + warp + DENSE_WARPS * k;
    thr[k] = b < B ? __ldg(priority + b) : INT_MIN;  // a row past B counts nothing
    cnt[k] = 0;
#pragma unroll
    for (int r = 0; r < RB; ++r) freed[k][r] = 0.0f;
  }

  for (long long c0 = 0, parity = 0; c0 < P; c0 += DENSE_CHUNK, parity ^= 1) {
    int nd[DENSE_PPT];
    unsigned vm;
    load_pods(pvalid, pnode, P, c0 + (long long)tid * DENSE_PPT, vec, nd, vm);
    // this thread's pods of the tile, then their places in the chunk's
    // row-ordered list: a warp scan of the counts, then the warps' totals
    unsigned fm = 0u;
#pragma unroll
    for (int j = 0; j < DENSE_PPT; ++j)
      if (((vm >> j) & 1u) && nd[j] >= n0 && nd[j] < n0 + DENSE_TILE) fm |= 1u << j;
    const int mine = __popc(fm);
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_wsum[parity][warp] = incl;
    __syncthreads();
    int first = incl - mine, total = 0;
#pragma unroll
    for (int w = 0; w < DENSE_WARPS; ++w) {
      const int sw = s_wsum[parity][w];
      if (w < warp) first += sw;
      total += sw;
    }
    for (int rb = 0; rb < total; rb += DENSE_CAP) {
      // the round's list: each thread places its pods' rows and nodes
      int idx = first;
#pragma unroll
      for (int j = 0; j < DENSE_PPT; ++j) {
        if (!((fm >> j) & 1u)) continue;
        if (idx >= rb && idx < rb + DENSE_CAP) {
          s_row[idx - rb] = tid * DENSE_PPT + j;  // the row, past c0
          s_node[idx - rb] = (uint8_t)(nd[j] - n0);
        }
        ++idx;
      }
      __syncthreads();
      // their priorities and requests, an entry a thread, every load of an
      // entry issued before its first store
      const int m = min(DENSE_CAP, total - rb);
      for (int e = tid; e < m; e += DENSE_WARPS * 32) {
        const long long row = c0 + s_row[e];
        const int32_t pr = __ldg(pprio + row);
        int32_t q[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) q[r] = r < R ? __ldg(preq + row * R + r) : 0;
        s_prio[e] = pr;
#pragma unroll
        for (int r = 0; r < RB; ++r)
          if (r < R) s_req[e * R + r] = __int2float_rn(q[r]);
      }
      __syncthreads();
      // each lane sums its node's pods in list order: per group of 32
      // entries, the entries of each node as a mask (the group leader of
      // equal nodes writes it to that node's lane), walked low bit first
      for (int g = 0; g < m; g += 32) {
        s_mask[warp][lane] = 0u;
        __syncwarp();
        const int e = g + lane;
        const int ne = e < m ? (int)s_node[e] : -1;
        const unsigned peers = __match_any_sync(FULL_MASK, ne);
        if (ne >= 0 && lane == __ffs(peers) - 1) s_mask[warp][ne] = peers;
        __syncwarp();
        unsigned mk = s_mask[warp][lane];
        while (mk) {
          const int ei = g + __ffs(mk) - 1;
          mk &= mk - 1u;
          const int32_t pr = s_prio[ei];
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            if (!(pr < thr[k])) continue;
            ++cnt[k];
#pragma unroll
            for (int r = 0; r < RB; ++r)
              if (r < R) freed[k][r] = __fadd_rn(freed[k][r], s_req[ei * R + r]);
          }
        }
        __syncwarp();
      }
      __syncthreads();
    }
  }

  if (n >= N) return;
  // the fit: the node's free room once, then each row's request, every
  // load issued before the first compare
  float base[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r)
    base[r] = r < R ? __fsub_rn(__int2float_rn(__ldg(alloc + (long long)n * R + r)),
                                __int2float_rn(__ldg(requested + (long long)n * R + r)))
                    : 0.0f;
  int32_t sb[KB], rq[KB][RB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const int b = b0 + warp + DENSE_WARPS * k;
    sb[k] = b < B ? __ldg(bits + (long long)b * N + n) : 0;
#pragma unroll
    for (int r = 0; r < RB; ++r)
      rq[k][r] = (b < B && r < R) ? __ldg(request + (long long)b * R + r) : 0;
  }
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const int b = b0 + warp + DENSE_WARPS * k;
    if (b >= B) continue;
    bool ok = (sb[k] & mask) == mask && cnt[k] > 0;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float q = __int2float_rn(rq[k][r]);  // 0 past R
      if (q != 0.0f && !(q <= __fadd_rn(base[r], freed[k][r]))) ok = false;
    }
    out[(long long)b * N + n] = ok ? 1 : 0;
  }
}

static int blocks_for(long long total, int threads) {
  return (int)((total + threads - 1) / threads);
}

extern "C" int launch_priority_prefix(int N, int R, int K, const void* perm,
                                      const void* offsets, const void* prio,
                                      const void* req, const void* levels, void* prefix,
                                      void* prefix_cnt, void* stream) {
  if (K > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  const long long total = (long long)N * (R + 1);
  if (total <= 0) return 0;
  const int threads = 128;
  priority_prefix_kernel<<<blocks_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      N, R, K, (const int64_t*)perm, (const int64_t*)offsets, (const int32_t*)prio,
      (const int32_t*)req, (const int32_t*)levels, (float*)prefix, (float*)prefix_cnt);
  return (int)cudaGetLastError();
}

extern "C" int launch_candidate_fit(int B, int N, int R, int K, const void* prefix,
                                    const void* prefix_cnt, const void* levels,
                                    const void* priority, const void* request,
                                    const void* alloc, const void* requested,
                                    const void* bits, int mask, void* out, void* stream) {
  if (K > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * N;
  if (total <= 0) return 0;
  const int threads = 256;
  candidate_fit_kernel<<<blocks_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      B, N, R, K, (const float*)prefix, (const float*)prefix_cnt, (const int32_t*)levels,
      (const int32_t*)priority, (const int32_t*)request, (const int32_t*)alloc,
      (const int32_t*)requested, (const int32_t*)bits, (int32_t)mask, (uint8_t*)out);
  return (int)cudaGetLastError();
}

template <int RB>
static int launch_dense(int B, int N, int R, int P, const void* pod_valid,
                        const void* pod_node, const void* pod_prio, const void* pod_req,
                        const void* priority, const void* request, const void* alloc,
                        const void* requested, const void* bits, int mask, void* out,
                        cudaStream_t stream) {
  constexpr int TB = DENSE_WARPS * DenseRows<RB>::value;
  const long long gy = ((long long)B + TB - 1) / TB;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)DENSE_CAP * (4 * R + 9);
  static bool attr_set = false;
  if (smem > 48 * 1024 && !attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        candidate_dense_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)((size_t)DENSE_CAP * (4 * MAX_R + 9)));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int vec = ((uintptr_t)pod_valid % 16 == 0 && (uintptr_t)pod_node % 16 == 0) ? 1 : 0;
  const dim3 grid((unsigned)((N + DENSE_TILE - 1) / DENSE_TILE), (unsigned)gy);
  candidate_dense_kernel<RB><<<grid, DENSE_WARPS * 32, smem, stream>>>(
      B, N, R, P, vec, (const uint8_t*)pod_valid, (const int32_t*)pod_node,
      (const int32_t*)pod_prio, (const int32_t*)pod_req, (const int32_t*)priority,
      (const int32_t*)request, (const int32_t*)alloc, (const int32_t*)requested,
      (const int32_t*)bits, (int32_t)mask, (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int launch_candidate_dense(int B, int N, int R, int P, const void* pod_valid,
                                      const void* pod_node, const void* pod_prio,
                                      const void* pod_req, const void* priority,
                                      const void* request, const void* alloc,
                                      const void* requested, const void* bits, int mask,
                                      void* out, void* stream) {
  if (R < 0 || R > MAX_R || B < 0 || N < 0 || P < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (R <= 4)
    return launch_dense<4>(B, N, R, P, pod_valid, pod_node, pod_prio, pod_req, priority,
                           request, alloc, requested, bits, mask, out, st);
  if (R <= 8)
    return launch_dense<8>(B, N, R, P, pod_valid, pod_node, pod_prio, pod_req, priority,
                           request, alloc, requested, bits, mask, out, st);
  return launch_dense<16>(B, N, R, P, pod_valid, pod_node, pod_prio, pod_req, priority,
                          request, alloc, requested, bits, mask, out, st);
}
