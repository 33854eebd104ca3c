// K32 selector_spread_score: SelectorSpread's score, added into the weighted
// total of the cycle's score planes.
//
// Replaces (JAX package): plugins/selectorspread.py score_row (:109) and its
// vmapped score (:134) — ROADMAP Queue B B13 — floored and weighted by
// framework/runtime.py run_scores (:206-218).
//
// For each row c of [C, N], over the row's mask (bits == full):
//   max_c, max_z = maxima of counts, zone_counts on the mask (0 off it);
//   node = (max_c - counts) * 100 / max(max_c, 1), or 100 when max_c == 0;
//   zone = the same over zone_counts and max_z;
//   blended = fma(0.33333334, node, 0.6666667 * zone) where has_zone and
//             max_z > 0, else node;
//   total += weight * floor(blended) on the masked cells.
// Exactness: multiply first, (max_c - c) * 100, then one correctly rounded
// division (the reciprocal form flips floors); the node weight is the
// reference's (1 - 2/3) taken in double and rounded to float32
// (0.33333334f, not 1 - 0.6666667f); the blend is ONE fused multiply-add,
// as XLA:CPU contracts the reference's a * node + b * zone (a separate
// product and sum flip about 3 floors in a million); every other step an
// __f*_rn intrinsic and the library built with --fmad=false.
// Every term of the total is an integer below 2^24, so the order in which
// the planes are added cannot change a sum.  A maximum is exact in any
// order, so the row's partial maxima merge in any order.
//
// Two forms, one launch a call either way:
// - At most SPLIT_ROWS rows (the exact scan's one row, C = 1): a row split
//   across a thread-block cluster of up to 8 blocks (cudaLaunchKernelEx),
//   one 16-byte vector a thread at N = 8192.  Every load of a thread —
//   bits as int4, counts, zone_counts and total as float4, has_zone as a
//   4-byte word (a scalar tail, and a scalar form where a row does not
//   start on a 16-byte boundary) — issues at entry, before any barrier.
//   The masked maxima: warp shuffles, one shared-memory step, then warp
//   0's lane q pushes the block's (max_c, max_z) partial into block q
//   through distributed shared memory — after a cluster barrier every
//   thread arrived at on entry (so every block has started; the loads'
//   round trip hides the wait) — and past a second cluster barrier every
//   block reads the row's partials from its own shared memory and touches
//   no peer again.  (Each block publishing its partial at home, a cluster
//   barrier, every thread reading its peers', and a last barrier keeping
//   the peers alive took 0.00421 ms against this order's 0.00354 at
//   C = 1, N = 8192 on an H100 SXM at 700 W.)  The score is computed and total
//   written from registers, on vectors holding a masked entry only (an
//   unmasked entry keeps its loaded bits, -inf included): the row is read
//   from DRAM once and written once.  This form is latency: one round trip
//   to memory, a block barrier and two cluster barriers, the first hidden
//   behind the loads.
// - Above that (the full auction, C = 512): one block per row, a strided
//   pass for the two maxima, a second pass writing the row (256 threads a
//   block, 1024 when there are fewer rows than SMs).
// Bound on the card: bytes — the pass bits over every entry (4 bytes), and
// on the masked entries only both count planes and the total read and the
// total written (16 bytes an entry), plus has_zone.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define THREADS 256
#define THREADS_FEW_ROWS 1024
#define FEW_ROWS 132  // the H100 SXM's SM count
#define SPLIT_ROWS 16
#define SPLIT_MAX_CLUSTER 8
#define SPLIT_MAX_THREADS 1024
#define SPLIT_BLOCK_NODES 1024  // nodes a block of the split form takes (a power of two)
#define MAX_NODE_SCORE 100.0f
#define W_NODE 0.33333334f
#define W_ZONE 0.6666667f

// one masked entry's term: weight * floor(blended)
__device__ __forceinline__ float term(float cnt, float zc, bool hz, float max_c, float max_z,
                                      float div_c, float div_z, float weight) {
  const float node = max_c > 0.0f
                         ? __fdiv_rn(__fmul_rn(__fsub_rn(max_c, cnt), MAX_NODE_SCORE), div_c)
                         : MAX_NODE_SCORE;
  float blended = node;
  if (hz && max_z > 0.0f) {
    const float zone = __fdiv_rn(__fmul_rn(__fsub_rn(max_z, zc), MAX_NODE_SCORE), div_z);
    blended = __fmaf_rn(W_NODE, node, __fmul_rn(W_ZONE, zone));
  }
  return __fmul_rn(weight, floorf(blended));
}

// ---------------------------------------------------------------- above SPLIT_ROWS

__global__ void selector_spread_score_rows_kernel(int C, int N, const int32_t* __restrict__ bits,
                                                  int full, const float* __restrict__ counts,
                                                  const float* __restrict__ zone_counts,
                                                  const uint8_t* __restrict__ has_zone,
                                                  float weight, float* __restrict__ total) {
  __shared__ float s_c[THREADS_FEW_ROWS / 32];
  __shared__ float s_z[THREADS_FEW_ROWS / 32];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const long long base = (long long)c * N;
  float mc = 0.0f, mz = 0.0f;
  for (int n = tid; n < N; n += blockDim.x) {
    if (bits[base + n] != full) continue;
    mc = fmaxf(mc, counts[base + n]);
    mz = fmaxf(mz, zone_counts[base + n]);
  }
  for (int off = 16; off > 0; off >>= 1) {
    mc = fmaxf(mc, __shfl_down_sync(0xffffffff, mc, off));
    mz = fmaxf(mz, __shfl_down_sync(0xffffffff, mz, off));
  }
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    s_c[warp] = mc;
    s_z[warp] = mz;
  }
  __syncthreads();
  float max_c = 0.0f, max_z = 0.0f;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) {
    max_c = fmaxf(max_c, s_c[w]);
    max_z = fmaxf(max_z, s_z[w]);
  }
  const float div_c = fmaxf(max_c, 1.0f), div_z = fmaxf(max_z, 1.0f);
  for (int n = tid; n < N; n += blockDim.x) {
    if (bits[base + n] != full) continue;
    total[base + n] = __fadd_rn(total[base + n], term(counts[base + n], zone_counts[base + n],
                                                      has_zone[n] != 0, max_c, max_z, div_c,
                                                      div_z, weight));
  }
}

// ------------------------------------------------------- at most SPLIT_ROWS rows

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

struct SplitRow {
  int N, full;
  const int32_t* bits;
  const float* counts;
  const float* zone_counts;
  const uint8_t* has_zone;
  float* total;
  float weight;
};

// the launch's shape, a kernel parameter: CL blocks a row (a cluster when
// CL > 1), block q of a row taking the nodes [q S, (q + 1) S)
struct SplitPlan {
  int CL;
  int S;
};

// a thread's item: VEC consecutive entries of a row (fewer in a row's
// tail), its loads issued where it is filled
template <int VEC>
struct Item {
  int b[VEC];
  float c[VEC], z[VEC], t[VEC];
  unsigned hz;  // bit e: entry e has a zone
  unsigned fm;  // bit e: entry e is masked (every filter bit set)
};

// the item at entry n of row c with `len` entries (len == VEC: vector
// loads; fewer: scalar loads of the tail), every load issued here through
// volatile asm: no later branch or barrier sinks it
template <int VEC>
__device__ __forceinline__ void load_item(const SplitRow& r, int c, int n, int len,
                                          Item<VEC>& it) {
  const size_t at = (size_t)c * r.N + n;
  bool done = false;
  if constexpr (VEC == 4) {
    if (len == 4) {
      unsigned h;
      asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(it.b[0]), "=r"(it.b[1]), "=r"(it.b[2]), "=r"(it.b[3])
                   : "l"(r.bits + at));
      asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(it.c[0]), "=f"(it.c[1]), "=f"(it.c[2]), "=f"(it.c[3])
                   : "l"(r.counts + at));
      asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(it.z[0]), "=f"(it.z[1]), "=f"(it.z[2]), "=f"(it.z[3])
                   : "l"(r.zone_counts + at));
      asm volatile("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(it.t[0]), "=f"(it.t[1]), "=f"(it.t[2]), "=f"(it.t[3])
                   : "l"(r.total + at));
      asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(h) : "l"(r.has_zone + n));
      it.hz = ((h & 0xffu) ? 1u : 0u) | ((h & 0xff00u) ? 2u : 0u) |
              ((h & 0xff0000u) ? 4u : 0u) | ((h & 0xff000000u) ? 8u : 0u);
      done = true;
    }
  }
  if (!done) {
    it.hz = 0u;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      it.b[e] = ~r.full;
      it.c[e] = it.z[e] = it.t[e] = 0.0f;
      if (e < len) {
        unsigned h;
        asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(it.b[e]) : "l"(r.bits + at + e));
        asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(it.c[e]) : "l"(r.counts + at + e));
        asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(it.z[e]) : "l"(r.zone_counts + at + e));
        asm volatile("ld.global.f32 %0, [%1];" : "=f"(it.t[e]) : "l"(r.total + at + e));
        asm volatile("ld.global.nc.u8 %0, [%1];" : "=r"(h) : "l"(r.has_zone + n + e));
        it.hz |= (h ? 1u : 0u) << e;
      }
    }
  }
  it.fm = 0u;
#pragma unroll
  for (int e = 0; e < VEC; ++e) it.fm |= (it.b[e] == r.full ? 1u : 0u) << e;
}

template <int VEC>
__device__ __forceinline__ void fold_max(const Item<VEC>& it, float* mc, float* mz) {
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    if ((it.fm >> e) & 1u) {
      *mc = fmaxf(*mc, it.c[e]);
      *mz = fmaxf(*mz, it.z[e]);
    }
}

// total += the term on the item's masked entries, from registers; a vector
// is stored whole (its unmasked entries with the bits they were loaded
// with), a tail entry alone where it is masked
template <int VEC>
__device__ __forceinline__ void store_item(const SplitRow& r, int c, int n, int len,
                                           Item<VEC>& it, float max_c, float max_z) {
  if (!it.fm) return;
  const float div_c = fmaxf(max_c, 1.0f), div_z = fmaxf(max_z, 1.0f);
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    if ((it.fm >> e) & 1u)
      it.t[e] = __fadd_rn(it.t[e], term(it.c[e], it.z[e], (it.hz >> e) & 1u, max_c, max_z,
                                        div_c, div_z, r.weight));
  float* p = r.total + (size_t)c * r.N + n;
  if constexpr (VEC == 4) {
    if (len == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(it.t[0], it.t[1], it.t[2], it.t[3]);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    if ((it.fm >> e) & 1u) p[e] = it.t[e];
}

// grid: C rows of CL consecutive blocks (a cluster when CL > 1)
template <int VEC>
__global__ void __launch_bounds__(SPLIT_MAX_THREADS)
selector_spread_score_split_kernel(const SplitRow r, const SplitPlan plan) {
  __shared__ float s_wc[SPLIT_MAX_THREADS / 32], s_wz[SPLIT_MAX_THREADS / 32];
  __shared__ float2 s_part[SPLIT_MAX_CLUSTER];  // block q's (max_c, max_z) at q
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int CL = plan.CL;
  const int c = blockIdx.x / CL, rank = blockIdx.x % CL;
  const int lo = min(rank * plan.S, r.N), hi = min(lo + plan.S, r.N);
  const int items = (hi - lo + VEC - 1) / VEC;

  // --- the thread's first item: every load at entry ------------------------
  Item<VEC> it;
  const int n0 = lo + tid * VEC;
  if (tid < items) {
    load_item<VEC>(r, c, n0, min(VEC, hi - n0), it);
  } else {
    it.fm = 0u;
  }
  // every block of the cluster has started once all have arrived here: the
  // wait before the push below finds them there long since
  if (CL > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  float mc = 0.0f, mz = 0.0f;
  fold_max<VEC>(it, &mc, &mz);
  for (int v = tid + nt; v < items; v += nt) {  // a slice longer than a vector a thread
    Item<VEC> x;
    load_item<VEC>(r, c, lo + v * VEC, min(VEC, hi - (lo + v * VEC)), x);
    fold_max<VEC>(x, &mc, &mz);
  }

  // --- the row's masked maxima: warp shuffles, one shared-memory step, then
  // the cluster's partials through distributed shared memory ---------------
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
    mz = fmaxf(mz, __shfl_xor_sync(0xffffffffu, mz, off));
  }
  if (lane == 0) {
    s_wc[warp] = mc;
    s_wz[warp] = mz;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = nt >> 5;
    mc = lane < nw ? s_wc[lane] : 0.0f;
    mz = lane < nw ? s_wz[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      mz = fmaxf(mz, __shfl_xor_sync(0xffffffffu, mz, off));
    }
    if (CL > 1) {
      // lane q pushes the block's partial into block q's slot `rank`
      cluster_wait();
      if (lane < CL)
        *cg::this_cluster().map_shared_rank(&s_part[rank], lane) = make_float2(mc, mz);
    } else if (lane == 0) {
      s_part[0] = make_float2(mc, mz);
    }
  }
  float max_c = 0.0f, max_z = 0.0f;
  if (CL > 1) {
    if (warp != 0) cluster_wait();
    cluster_arrive_release();
    cluster_wait_acquire();  // every block holds every partial; none is touched again
  } else {
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < SPLIT_MAX_CLUSTER; ++q) {
    if (q < CL) {
      max_c = fmaxf(max_c, s_part[q].x);
      max_z = fmaxf(max_z, s_part[q].y);
    }
  }

  // --- the score into the total, from registers ----------------------------
  if (tid < items) store_item<VEC>(r, c, n0, min(VEC, hi - n0), it, max_c, max_z);
  for (int v = tid + nt; v < items; v += nt) {
    Item<VEC> x;
    const int n = lo + v * VEC;
    load_item<VEC>(r, c, n, min(VEC, hi - n), x);
    store_item<VEC>(r, c, n, min(VEC, hi - n), x, max_c, max_z);
  }
}

// the plan: the fewest blocks, a power of two up to 8, of at most
// SPLIT_BLOCK_NODES nodes; S, a block's slice, a multiple of 4; threads a
// whole number of warps covering the slice's items of VEC nodes, 32 to 1024
static void split_plan(int N, int VEC, SplitPlan* plan, int* threads) {
  int cl = 1;
  while (cl < SPLIT_MAX_CLUSTER && (long long)cl * SPLIT_BLOCK_NODES < N) cl <<= 1;
  const int S = ((N + cl - 1) / cl + 3) / 4 * 4;
  int t = ((S + VEC - 1) / VEC + 31) / 32 * 32;
  if (t < 32) t = 32;
  if (t > SPLIT_MAX_THREADS) t = SPLIT_MAX_THREADS;
  plan->CL = cl;
  plan->S = S;
  *threads = t;
}

// (CL, S, threads) of a row of n nodes, for the copy in the port's
// perf/kernel_work.py (k32_plan), which the chip check holds to this one
extern "C" void selector_spread_split_plan(int n, int vec, int* out) {
  SplitPlan plan;
  int threads;
  split_plan(n, vec, &plan, &threads);
  out[0] = plan.CL;
  out[1] = plan.S;
  out[2] = threads;
}

template <int VEC>
static int launch_split(int C, const SplitRow& r, cudaStream_t stream) {
  SplitPlan plan;
  int threads;
  split_plan(r.N, VEC, &plan, &threads);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * plan.CL));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)plan.CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = plan.CL > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, selector_spread_score_split_kernel<VEC>, r, plan);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

static bool aligned_to(const void* p, uintptr_t a) { return ((uintptr_t)p & (a - 1)) == 0; }

extern "C" int launch_selector_spread_score(int C, int N, const void* bits, int full,
                                            const void* counts, const void* zone_counts,
                                            const void* has_zone, float weight, void* total,
                                            void* stream) {
  if (C <= 0 || N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (C > SPLIT_ROWS) {
    const int threads = C < FEW_ROWS ? THREADS_FEW_ROWS : THREADS;
    selector_spread_score_rows_kernel<<<C, threads, 0, s>>>(
        C, N, (const int32_t*)bits, full, (const float*)counts, (const float*)zone_counts,
        (const uint8_t*)has_zone, weight, (float*)total);
    return (int)cudaGetLastError();
  }
  const SplitRow r{N, full, (const int32_t*)bits, (const float*)counts,
                   (const float*)zone_counts, (const uint8_t*)has_zone, (float*)total, weight};
  // 16-byte vectors where every row starts on a 16-byte boundary (has_zone's
  // 4-byte words on a 4-byte one); a row's last N % 4 entries are its tail
  const bool vec4 = (C == 1 || N % 4 == 0) && aligned_to(bits, 16) && aligned_to(counts, 16) &&
                    aligned_to(zone_counts, 16) && aligned_to(total, 16) &&
                    aligned_to(has_zone, 4);
  return vec4 ? launch_split<4>(C, r, s) : launch_split<1>(C, r, s);
}
