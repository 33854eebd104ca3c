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
// Keyed mode (keys != NULL; the reference's select_host with a key,
// :305-308, under greedy_assign's step keys, :397, :421): the node is the
// argmax of where(masked == max, noise, -1) — the largest noise among the
// tied maxima, the lower row on equal noise; an all -inf row is all ties.
// The noise at node n is u(n), threefry2x32 of the step's key keys[k] (the
// table from K33's split, k the scan position) at the counter (0, n),
// drawn here beside the fold that reads it (threefry.cuh, shared with
// K33): no noise row and no K33 launch a step.  The nominated path and the
// infeasible rule are unchanged.
//
// Bound on the card: bytes (the bit row and the total row read once, the
// step's 8-byte key keyed; a few dozen bytes of the step's own rows) —
// and, keyed, ~120 integer operations a draw.  At one
// row that is ~20 ns of the card's bandwidth, so latency sets the time:
// how many SMs stream the row, how many dependent round trips follow it.
//
// Design.
//   * A row is split over a thread-block cluster of CL blocks (CL in 1, 2,
//     4, 8; launched with cudaLaunchKernelEx), block r taking the nodes
//     [r S, min((r + 1) S, N)), S a multiple of 4.  ``select_plan`` gives a
//     block about 1024 nodes, a 16-byte vector a thread: N = 8192 is a
//     cluster of 8 blocks of 256 threads; N <= 1024 (the small tiers, the
//     tests' rows, N = 1) one block and no cluster.
//   * One read.  Each thread issues its loads (int4 bits, float4 total;
//     keyed, the step's two key words) before its first compare.  The last
//     slice's N mod 4 nodes go one a thread; a row whose pointers are not
//     16-byte aligned (a view) takes the scalar form throughout (VEC = 1).
//   * Keyed, every node of a thread's vector is drawn, the four threefry
//     chains computed together (independent rounds, interleaved) once the
//     key has come — it is loaded first of all — then folded with the
//     values.  Drawing only where the fold can use a draw (a thread's nodes
//     equal to its local maximum of the masked total) was measured against
//     it and lost on the card: a warp that holds a tie inside one thread
//     (frequent on real rows, every warp on an all-tied row) draws whole
//     vectors anyway, after a second pass.
//   * One fold in both modes.  Each thread folds (count, value, noise, row)
//     in the order value descending, noise descending, row ascending: the
//     first argmax keyless (no noise), and keyed the argmax of
//     where(masked == max, noise, -1) — noise >= 0 beats the -1 of every
//     row below the maximum, every row at the maximum is a tie (all of them
//     when the row is all -inf), +0.0 and -0.0 tie as == says, equal noise
//     goes to the lower row.  The order is total, so any merge order gives
//     the same result: warp shuffles, one shared-memory step across the
//     warps, then each block's partial pushed into the leader block (rank
//     0) through distributed shared memory behind one cluster barrier (the
//     barrier that makes the push safe — every block running — is split:
//     arrived at entry, waited on before the push).  No float arithmetic,
//     only compares; the count is an integer add.
//   * The step's own inputs are prefetched at entry by the leader's warp 0:
//     lane 31 loads nominated[i] and valid[i] (then bits[clamp(nom)], once
//     its row is folded), lanes 0..R+1 request[i, :] and pod_nz[i, :].  They
//     overlap the row instead of following the reduction.
//   * The assume is R + 2 fire-and-forget adds (atomicAdd with the result
//     unused: a reduction to global memory, exact for int32, one writer a
//     step) by those lanes; node_row[i] and feasible_count[i] are plain
//     stores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

namespace cg = cooperative_groups;

#define SELECT_MAX_THREADS 1024
#define SELECT_MAX_CLUSTER 8
#define SELECT_NODES_PER_BLOCK 1024
#define FULL_MASK 0xffffffffu

// the launch's shape, a kernel parameter: CL blocks, block r taking the
// nodes [r S, min((r + 1) S, N))
struct SelectPlan {
  int CL;
  int S;
};

// a partial of the row: its feasible count and its best (value, noise, row)
struct Part {
  int c;
  float v;
  float z;
  int n;
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the larger value; on equal values (+0.0 == -0.0) the larger noise (keyed);
// then the lower row
template <bool KEYED>
__device__ __forceinline__ bool beats(const Part& b, const Part& a) {
  if (b.v != a.v) return b.v > a.v;
  if (KEYED && b.z != a.z) return b.z > a.z;
  return b.n < a.n;
}

template <bool KEYED>
__device__ __forceinline__ Part merge(const Part& a, const Part& b) {
  Part o = beats<KEYED>(b, a) ? b : a;
  o.c = a.c + b.c;
  return o;
}

// the identity: no node, -inf, noise -1 (below every draw), the sentinel row
// N (above every row)
__device__ __forceinline__ Part none(int N) { return Part{0, -INFINITY, -1.0f, N}; }

// every lane ends with the warp's merge (the order is total, so the
// butterfly's two operand orders agree)
template <bool KEYED>
__device__ __forceinline__ Part warp_merge(Part p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Part o;
    o.c = __shfl_xor_sync(FULL_MASK, p.c, off);
    o.v = __shfl_xor_sync(FULL_MASK, p.v, off);
    o.z = KEYED ? __shfl_xor_sync(FULL_MASK, p.z, off) : p.z;
    o.n = __shfl_xor_sync(FULL_MASK, p.n, off);
    p = merge<KEYED>(p, o);
  }
  return p;
}

template <bool KEYED>
__device__ __forceinline__ void fold(Part& p, int b, int full, float t, float z, int n) {
  const bool m = b == full;
  p.c += m;
  const Part q{0, m ? t : -INFINITY, z, n};
  if (beats<KEYED>(q, p)) {
    p.v = q.v;
    p.z = q.z;
    p.n = q.n;
  }
}

// grid: CL blocks, one cluster when CL > 1
template <int VEC, bool KEYED>
__global__ void __launch_bounds__(SELECT_MAX_THREADS) scan_select_kernel(
    int N, int R, int full, int i, const SelectPlan plan,
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
    const int32_t* __restrict__ keys,      // [b, 2] the batch's step keys (keyed)
    int k) {                               // the scan position: the step's key row
  __shared__ Part s_warp[SELECT_MAX_THREADS / 32];
  __shared__ Part s_cl[SELECT_MAX_CLUSTER];
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int CL = plan.CL, rank = blockIdx.x;
  if (CL > 1) cluster_arrive_relaxed();  // this block runs; waited on before the push

  uint32_t k0 = 0, k1 = 0;
  if constexpr (KEYED) {  // the step's key, first of every load
    k0 = (uint32_t)__ldg(keys + 2 * k);
    k1 = (uint32_t)__ldg(keys + 2 * k + 1);
  }

  // --- the step's own inputs, prefetched by the leader's warp 0 -----------
  const bool lead = rank == 0 && warp == 0;
  int nom = -1, vld = 0, pre = 0;
  if (lead) {
    if (lane == 31) {
      nom = __ldg(nominated + i);
      vld = __ldg(valid + i);
    }
    if (lane < R) pre = __ldg(request + (size_t)i * R + lane);
    else if (lane < R + 2) pre = __ldg(pod_nz + (size_t)i * 2 + (lane - R));
  }

  // --- the one read of the slice, folded -----------------------------------
  const int lo = min(rank * plan.S, N), hi = min(lo + plan.S, N);
  const int nvec = (hi - lo) / VEC, tail = lo + nvec * VEC;
  Part p = none(N);
  for (int v = tid; v < nvec; v += nt) {
    const int n0 = lo + v * VEC;
    int b[VEC];
    float t[VEC], z[VEC];
    if constexpr (VEC == 4) {
      const int4 bv = __ldg(reinterpret_cast<const int4*>(bits + n0));
      const float4 tv = __ldg(reinterpret_cast<const float4*>(total + n0));
      b[0] = bv.x; b[1] = bv.y; b[2] = bv.z; b[3] = bv.w;
      t[0] = tv.x; t[1] = tv.y; t[2] = tv.z; t[3] = tv.w;
    } else {
      b[0] = __ldg(bits + n0);
      t[0] = __ldg(total + n0);
    }
    // keyed, a vector's draws computed together: they need only the key, so
    // their rounds run while the row's loads are in flight
#pragma unroll
    for (int e = 0; e < VEC; ++e) z[e] = KEYED ? uniform_at(k0, k1, n0 + e) : -1.0f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) fold<KEYED>(p, b[e], full, t[e], z[e], n0 + e);
  }
  if (tail + tid < hi) {  // the last slice's N mod 4 nodes, one a thread
    const int n = tail + tid;
    const float z = KEYED ? uniform_at(k0, k1, n) : -1.0f;
    fold<KEYED>(p, __ldg(bits + n), full, __ldg(total + n), z, n);
  }
  int nomc = 0, nom_ok = 0;
  if (lead && lane == 31) {  // the one dependent read: the nominated row's bits
    nomc = min(max(nom, 0), N - 1);
    nom_ok = nom >= 0 && __ldg(bits + nomc) == full;
  }

  // --- the block's partial: warp shuffles, one shared-memory step ----------
  p = warp_merge<KEYED>(p);
  if (lane == 0) s_warp[warp] = p;
  __syncthreads();
  if (warp == 0) {
    p = lane < (nt >> 5) ? s_warp[lane] : none(N);
    p = warp_merge<KEYED>(p);
  }

  // --- the row's: every block's partial pushed into the leader ------------
  if (CL > 1) {
    cluster_wait_acquire();  // every block of the cluster runs
    if (tid == 0) {
      cg::cluster_group cluster = cg::this_cluster();
      *cluster.map_shared_rank(&s_cl[rank], 0) = p;
    }
    __syncwarp();
    cluster_arrive_release();
    cluster_wait_acquire();  // the leader holds every partial
    if (rank != 0) return;
    if (warp == 0) {
      p = lane < CL ? s_cl[lane] : none(N);
      p = warp_merge<KEYED>(p);
    }
  }
  if (warp != 0) return;

  // --- the step: node, outputs and the assume, by the leader's warp 0 -----
  nom_ok = __shfl_sync(FULL_MASK, nom_ok, 31);
  nomc = __shfl_sync(FULL_MASK, nomc, 31);
  vld = __shfl_sync(FULL_MASK, vld, 31);
  const bool feasible = p.c > 0;
  int node = nom_ok ? nomc : p.n;  // nominated-node fast path
  if (!feasible) node = 0;
  const bool placed = feasible && vld;
  if (lane == 0) {
    node_row[i] = placed ? node : -1;
    feasible_count[i] = p.c;
  }
  if (!placed) return;
  for (int r = lane; r < R + 2; r += 32) {
    int add = pre;
    if (r >= 32)
      add = r < R ? __ldg(request + (size_t)i * R + r) : __ldg(pod_nz + (size_t)i * 2 + (r - R));
    if (r < R) atomicAdd(requested + (size_t)node * R + r, add);
    else atomicAdd(node_nz + (size_t)node * 2 + (r - R), add);
  }
}

// the plan: the fewest blocks (a power of two, at most 8) of at most 1024
// nodes; threads a whole number of warps covering a block's vectors
static void select_plan(int N, int VEC, SelectPlan* plan, int* threads) {
  int cl = 1;
  while (cl < SELECT_MAX_CLUSTER && (long long)cl * SELECT_NODES_PER_BLOCK < N) cl <<= 1;
  const int S = ((N + cl - 1) / cl + 3) / 4 * 4;
  int t = ((S + VEC - 1) / VEC + 31) / 32 * 32;
  if (t < 32) t = 32;
  if (t > SELECT_MAX_THREADS) t = SELECT_MAX_THREADS;
  plan->CL = cl;
  plan->S = S;
  *threads = t;
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <int VEC, bool KEYED>
static int launch_select(int N, int R, int full, int i, const int32_t* bits, const float* total,
                         const int32_t* nominated, const uint8_t* valid, const int32_t* request,
                         const int32_t* pod_nz, int32_t* requested, int32_t* node_nz,
                         int32_t* node_row, int32_t* feasible_count, const int32_t* keys, int k,
                         cudaStream_t stream) {
  SelectPlan plan;
  int threads;
  select_plan(N, VEC, &plan, &threads);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)plan.CL);
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
  cudaError_t e = cudaLaunchKernelEx(&cfg, scan_select_kernel<VEC, KEYED>, N, R, full, i, plan,
                                     bits, total, nominated, valid, request, pod_nz, requested,
                                     node_nz, node_row, feasible_count, keys, k);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the plan for a row of N nodes in vectors of VEC, as the launch takes it:
// out = {CL, S, threads} (the Python copy, kernel_work.k17_plan, is held
// against this one on the card)
extern "C" void scan_select_plan(int N, int VEC, int* out) {
  SelectPlan plan;
  select_plan(N, VEC, &plan, out + 2);
  out[0] = plan.CL;
  out[1] = plan.S;
}

// keys: the batch's int32 [b, 2] step keys and k the step's row (keyed), or
// null (keyless)
extern "C" int launch_scan_select(int N, int R, int full, int i, const void* bits,
                                  const void* total, const void* nominated, const void* valid,
                                  const void* request, const void* pod_nz, void* requested,
                                  void* node_nz, void* node_row, void* feasible_count,
                                  const void* keys, int k, void* stream) {
  if (N <= 0) return 0;
  if (R < 0 || (keys != nullptr && k < 0)) return (int)cudaErrorInvalidValue;
  // 16-byte vectors where both rows start on a 16-byte boundary
  const bool vec4 = aligned16(bits) && aligned16(total);
  const bool keyed = keys != nullptr;
  const auto go = vec4 ? (keyed ? launch_select<4, true> : launch_select<4, false>)
                       : (keyed ? launch_select<1, true> : launch_select<1, false>);
  return go(N, R, full, i, (const int32_t*)bits, (const float*)total, (const int32_t*)nominated,
            (const uint8_t*)valid, (const int32_t*)request, (const int32_t*)pod_nz,
            (int32_t*)requested, (int32_t*)node_nz, (int32_t*)node_row,
            (int32_t*)feasible_count, (const int32_t*)keys, k, (cudaStream_t)stream);
}
