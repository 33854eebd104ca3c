// K2 normalize_combine: per-plugin normalization and the weighted total of
// the dedup cycle's score planes, one launch, every plane read once.
//
// Replaces (JAX package): the total that framework/runtime.py
// _batch_assign_dedup.dense_rep (and run_scores, :206-218) builds each
// round — Σ_plugin weight · floor(normalize(raw)), −inf where infeasible —
// with plugins/helpers.py default_normalize (:58) for NodeAffinity and the
// reversed form for TaintToleration, identity for Fit, BalancedAllocation
// and ImageLocality, and the pass-through plugins' constant contribution
// (computed on the host from their own normalize of an all-zero plane).
// Also the row's feasible-node count (the reference's sum of the mask).
//
// Bound on the card: bytes — the bit row and the raw planes read once, the
// total written once.  The work per node is a handful of float operations,
// so what costs is the number of SMs that stream a row and the number of
// times each byte crosses the memory bus.
//
// Design.
//   * A row is split over a thread-block cluster of CL blocks (CL in 1, 2,
//     4, 8; launched with cudaLaunchKernelEx), block r taking the nodes
//     [r S, (r + 1) S).  At most 16 rows (a scan step's C = 1, a NorthStar
//     or coupled round's C = 4) one block a row would leave all but C of
//     the 132 SMs idle: the row goes to up to 8 blocks of 1024 nodes or
//     more, a 16-byte vector a thread.  Above 16 rows the rows fill the
//     card; a block takes 256 threads' registers' worth of nodes (2048 at
//     P = 5, so 4 blocks a row at N = 8192).  ``launch_config`` holds the
//     rule, placed by timing the alternatives on the H100 (PERF.md).
//   * One read.  Each thread loads its nodes' bit words and P raw values,
//     16-byte vectors where the row allows (N a multiple of 4 and aligned
//     pointers), and keeps them in registers (ITEMS vectors a thread, sized
//     from P so that the cache stays near 48 registers).  At most 16 rows
//     every load is issued before any is used (latency counts); above 16
//     the raw values of a vector are read only where its bits hold a
//     feasible node (bytes count: a tier's dead rows and rows that fit few
//     nodes cost only their bits).  A slice longer than the block's
//     registers hold (the 100k-node tier) loops over the rest with a
//     second read of that rest only.
//   * Reduction.  Each thread's per-plane maxima over its feasible nodes
//     (mask = all filter bits set) and its feasible count reduce by warp
//     shuffles, then across the block's warps; warp 0's lane r pushes the
//     block's partials into block r's shared memory (distributed shared
//     memory), and one cluster barrier later every block reduces the CL
//     partials itself.  The maximum is order-free and the count an
//     integer, so every block holds the same bits.  (The barrier that
//     makes the pushes safe — every block of the cluster running — is
//     split: arrived at the kernel's start, waited on before the push.)
//   * Write.  Every thread writes its totals from its registers.
//   * The plan (kinds, weights, const_add, the full bit mask) is a kernel
//     parameter, and P a template parameter: nothing of the plan is read
//     from memory in the per-node loop.
// Numerics (as the plain version): `raw * 100 / max` is a multiply then a
// correctly rounded divide (--fmad=false -prec-div=true), floored; the
// reversed kind is 100 − that floor, 100 where the maximum is 0 (0 for the
// default kind); a maximum that is not finite counts as 0; the weighted
// terms are summed in plane order from 0 with correctly rounded adds, then
// const_add; −inf off the mask.
//
// Packed mode (feas == NULL): the extender rounds' compute_packed
// (runtime.py:225, jitted at scheduler.py:1052) — the same one pass, the
// plane alone as the round's single f32 [B, N] fetch, -inf where the filter
// bits miss `full`, and no feasible count written.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define MAX_PLANES 8
#define MAX_CLUSTER 8
#define MAX_THREADS 512
#define KIND_IDENTITY 0
#define KIND_DEFAULT 1
#define KIND_DEFAULT_REVERSED 2

struct CombinePlan {
  int kind[MAX_PLANES];
  float weight[MAX_PLANES];
  float const_add;
  int full;
};

// vectors of VEC nodes a thread keeps in registers: P raw words a node,
// about 48 registers in all, 1 to 8 vectors
__host__ __device__ constexpr int items_for(int P, int VEC) {
  const int n = 48 / (VEC * (P > 0 ? P : 1));
  return n < 1 ? 1 : (n > 8 ? 8 : n);
}

template <int VEC>
__device__ __forceinline__ void load_bits(const int32_t* p, int (&o)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
    o[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_raw(const float* p, float (&o)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
    o[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_total(float* p, const float (&o)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    p[0] = o[0];
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the total of one feasible node from its P raw values and the row maxima
template <int P>
__device__ __forceinline__ float combine(const CombinePlan& plan, const float* row_max,
                                         const float (&x)[P > 0 ? P : 1]) {
  float t = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float norm;
    if (plan.kind[p] == KIND_IDENTITY) {
      norm = x[p];
    } else {
      const float mx = row_max[p];
      const bool zero_max = (mx == 0.0f);
      const float scaled = floorf(__fdiv_rn(__fmul_rn(x[p], 100.0f), zero_max ? 1.0f : mx));
      if (plan.kind[p] == KIND_DEFAULT_REVERSED)
        norm = zero_max ? 100.0f : __fsub_rn(100.0f, scaled);
      else
        norm = zero_max ? 0.0f : scaled;
    }
    t = __fadd_rn(t, __fmul_rn(plan.weight[p], floorf(norm)));
  }
  return __fadd_rn(t, plan.const_add);
}

// grid: C clusters of CL consecutive blocks (a cluster when CL > 1), one a
// row, block r of it taking the nodes [r S, (r + 1) S); S a multiple of
// VEC (N too when VEC > 1)
template <int P, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
normalize_combine_kernel(int C, int N, int S, int CL, const int32_t* __restrict__ bits,
                         const float* __restrict__ raw, const CombinePlan plan,
                         float* __restrict__ total, int32_t* __restrict__ feas) {
  constexpr int ITEMS = items_for(P, VEC);
  constexpr int PP = P > 0 ? P : 1;
  __shared__ float s_wmax[MAX_THREADS / 32][PP];
  __shared__ int s_wcnt[MAX_THREADS / 32];
  __shared__ float s_pmax[MAX_CLUSTER][PP];  // the cluster's blocks' partials, by rank
  __shared__ int s_pcnt[MAX_CLUSTER];

  if (CL > 1) cluster_arrive_relaxed();  // this block runs; waited on before the push
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x / CL, rank = blockIdx.x % CL;
  const int lo = min(rank * S, N), nvec = (min(lo + S, N) - lo) / VEC;
  const size_t plane = (size_t)C * N;
  const int32_t* brow = bits + (size_t)c * N + lo;
  const float* rrow = raw + (size_t)c * N + lo;
  float* trow = total + (size_t)c * N + lo;

  // --- the one read; the feasible nodes as a bit mask (bit it * VEC + j).
  // At most 16 rows latency counts: every load is issued before any is
  // used.  Above that the rows fill the card and bytes count: a vector's
  // raw values are read only where its bits hold a feasible node (a
  // node tier's dead rows, a row that fits few nodes). ----------------------
  int b[ITEMS][VEC];
  float x[ITEMS][VEC][PP];
  auto load_values = [&](int it) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float r[VEC];
      load_raw<VEC>(rrow + p * plane + (size_t)(it * nt + tid) * VEC, r);
#pragma unroll
      for (int j = 0; j < VEC; ++j) x[it][j][p] = r[j];
    }
  };
  const bool only_feasible = C > 16;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    if (it * nt + tid < nvec) {
      load_bits<VEC>(brow + (size_t)(it * nt + tid) * VEC, b[it]);
      if (!only_feasible) load_values(it);
    }
  }
  unsigned fm = 0u;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (it * nt + tid < nvec && b[it][j] == plan.full) fm |= 1u << (it * VEC + j);
  if (only_feasible) {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it)
      if ((fm >> (it * VEC)) & ((1u << VEC) - 1u)) load_values(it);
  }
  float m[PP];
#pragma unroll
  for (int p = 0; p < PP; ++p) m[p] = -INFINITY;
  int cnt = __popc(fm);
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if ((fm >> (it * VEC + j)) & 1u) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          if (plan.kind[p] != KIND_IDENTITY) m[p] = fmaxf(m[p], x[it][j][p]);
      }
  // the rest of a slice longer than the registers hold
  for (int v = ITEMS * nt + tid; v < nvec; v += nt) {
    int bb[VEC];
    load_bits<VEC>(brow + (size_t)v * VEC, bb);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (plan.kind[p] == KIND_IDENTITY) continue;
      float r[VEC];
      load_raw<VEC>(rrow + p * plane + (size_t)v * VEC, r);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (bb[j] == plan.full) m[p] = fmaxf(m[p], r[j]);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) cnt += bb[j] == plan.full;
  }

  // --- the row's maxima and count: warp, block, cluster ------------------
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
#pragma unroll
    for (int p = 0; p < P; ++p) m[p] = fmaxf(m[p], __shfl_xor_sync(0xffffffffu, m[p], off));
  }
  if (lane == 0) {
    s_wcnt[warp] = cnt;
#pragma unroll
    for (int p = 0; p < P; ++p) s_wmax[warp][p] = m[p];
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = nt >> 5;
    cnt = lane < nw ? s_wcnt[lane] : 0;
#pragma unroll
    for (int p = 0; p < P; ++p) m[p] = lane < nw ? s_wmax[lane][p] : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
#pragma unroll
      for (int p = 0; p < P; ++p) m[p] = fmaxf(m[p], __shfl_xor_sync(0xffffffffu, m[p], off));
    }
  }
  if (CL > 1) {
    cluster_wait_acquire();  // every block of the cluster runs
    if (warp == 0 && lane < CL) {
      cg::cluster_group cluster = cg::this_cluster();
      float* dmax = cluster.map_shared_rank(&s_pmax[rank][0], lane);
      int* dcnt = cluster.map_shared_rank(&s_pcnt[rank], lane);
#pragma unroll
      for (int p = 0; p < P; ++p) dmax[p] = m[p];
      *dcnt = cnt;
    }
    __syncwarp();
    cluster_arrive_release();
    cluster_wait_acquire();
  } else {
    if (tid == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p) s_pmax[0][p] = m[p];
      s_pcnt[0] = cnt;
    }
    __syncthreads();
  }
  float row_max[PP];
#pragma unroll
  for (int p = 0; p < PP; ++p) row_max[p] = -INFINITY;
  int row_cnt = 0;
  for (int r = 0; r < CL; ++r) {
    row_cnt += s_pcnt[r];
#pragma unroll
    for (int p = 0; p < P; ++p) row_max[p] = fmaxf(row_max[p], s_pmax[r][p]);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) row_max[p] = isfinite(row_max[p]) ? row_max[p] : 0.0f;
  if (feas != nullptr && rank == 0 && tid == 0) feas[c] = row_cnt;

  // --- the write, from registers -----------------------------------------
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int v = it * nt + tid;
    if (v < nvec) {
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o[j] = ((fm >> (it * VEC + j)) & 1u) ? combine<P>(plan, row_max, x[it][j]) : -INFINITY;
      store_total<VEC>(trow + (size_t)v * VEC, o);
    }
  }
  for (int v = ITEMS * nt + tid; v < nvec; v += nt) {
    int bb[VEC];
    float xx[VEC][PP];
    load_bits<VEC>(brow + (size_t)v * VEC, bb);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float r[VEC];
      load_raw<VEC>(rrow + p * plane + (size_t)v * VEC, r);
#pragma unroll
      for (int j = 0; j < VEC; ++j) xx[j][p] = r[j];
    }
    float o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o[j] = bb[j] == plan.full ? combine<P>(plan, row_max, xx[j]) : -INFINITY;
    store_total<VEC>(trow + (size_t)v * VEC, o);
  }
}

template <int P, int VEC>
static int launch(int C, int N, int CL, int threads, const int32_t* bits, const float* raw,
                  const CombinePlan& plan, float* total, int32_t* feas, cudaStream_t stream) {
  const int per = (N + CL - 1) / CL;
  const int S = (per + VEC - 1) / VEC * VEC;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * CL));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, normalize_combine_kernel<P, VEC>, C, N, S, CL,
                                     bits, raw, plan, total, feas);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int VEC>
static int launch_p(int P, int C, int N, int CL, int threads, const int32_t* bits,
                    const float* raw, const CombinePlan& plan, float* total, int32_t* feas,
                    cudaStream_t s) {
  switch (P) {
    case 0: return launch<0, VEC>(C, N, CL, threads, bits, raw, plan, total, feas, s);
    case 1: return launch<1, VEC>(C, N, CL, threads, bits, raw, plan, total, feas, s);
    case 2: return launch<2, VEC>(C, N, CL, threads, bits, raw, plan, total, feas, s);
    case 3: return launch<3, VEC>(C, N, CL, threads, bits, raw, plan, total, feas, s);
    case 4: return launch<4, VEC>(C, N, CL, threads, bits, raw, plan, total, feas, s);
    case 5: return launch<5, VEC>(C, N, CL, threads, bits, raw, plan, total, feas, s);
    case 6: return launch<6, VEC>(C, N, CL, threads, bits, raw, plan, total, feas, s);
    case 7: return launch<7, VEC>(C, N, CL, threads, bits, raw, plan, total, feas, s);
    case 8: return launch<8, VEC>(C, N, CL, threads, bits, raw, plan, total, feas, s);
  }
  return (int)cudaErrorInvalidValue;
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// 16-byte vectors where every row starts on a 16-byte boundary
static int vec_width(int N, const void* bits, const void* raw, const void* total) {
  return (N % 4 == 0 && aligned16(bits) && aligned16(raw) && aligned16(total)) ? 4 : 1;
}

// the launch's shape: blocks a row, up to 8 while a row is longer than
// 1024 nodes a block (at most 16 rows: a scan step, a NorthStar or coupled
// round) or 256 threads' registers' worth (more rows); threads a whole
// number of warps covering the block's slice, a vector a thread at most 16
// rows and with the registers above that, at most 512 (the rest of a
// longer slice re-read)
static void launch_config(int C, int N, int P, int VEC, int* CL, int* threads) {
  const int npt = VEC * items_for(P, VEC);
  const long long per_block = C <= 16 ? 1024 : (long long)npt * 256;
  int cl = 1;
  while (cl < MAX_CLUSTER && cl * per_block < N) cl <<= 1;
  const int S = ((N + cl - 1) / cl + VEC - 1) / VEC * VEC;
  const int per_thread = C <= 16 ? VEC : npt;
  int t = ((S + per_thread - 1) / per_thread + 31) / 32 * 32;
  if (t < 32) t = 32;
  if (t > MAX_THREADS) t = MAX_THREADS;
  *CL = cl;
  *threads = t;
}

extern "C" int launch_normalize_combine(int C, int N, int P, const void* bits,
                                        CombinePlan plan, const void* raw, void* total,
                                        void* feas, void* stream) {
  if (P < 0 || P > MAX_PLANES || C < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const int vec = vec_width(N, bits, raw, total);
  int cl, threads;
  launch_config(C, N, P, vec, &cl, &threads);
  const int32_t* b = (const int32_t*)bits;
  const float* r = (const float*)raw;
  float* t = (float*)total;
  int32_t* f = (int32_t*)feas;
  cudaStream_t s = (cudaStream_t)stream;
  return vec == 4 ? launch_p<4>(P, C, N, cl, threads, b, r, plan, t, f, s)
                  : launch_p<1>(P, C, N, cl, threads, b, r, plan, t, f, s);
}
