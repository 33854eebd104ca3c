// K3 topk_rows: for each row of an f32[C, N] plane, the first K entries in
// (value descending, column ascending) order, −inf entries last by column.
//
// Replaces (JAX package): jax.lax.top_k at framework/runtime.py:875 in
// _batch_assign_dedup.  The dedup auction's exactness rests on that order
// (runtime.py:766-767): ties must break by ascending node row, so a
// general top-k with no tie order (torch.topk) cannot stand in for it.
//
// Design: one launch, one block per row, select first and sort only K.
//   1. Each value maps to an order-preserving 32-bit key, inverted so that
//      a smaller key is a larger value (−0.0 canonicalised to +0.0, so the
//      two tie).  Where the row fits (N <= STAGE_MAX_N: 32 KB at N = 8192)
//      the keys are staged in shared memory; above that every pass streams
//      the row from L2 (N = 131072: 512 KB a row).
//   2. Radix select finds the K-th smallest key T, 8 bits a pass from the
//      top: a 256-bin histogram in shared memory of the entries that match
//      the digits fixed so far (one atomicAdd per distinct digit per warp:
//      __match_any_sync groups a warp's equal digits, so a row of ties
//      costs one atomic a warp, not 32), then warp 0 scans the bins and
//      fixes the next digit and the rank left inside its bin.  It stops
//      early once the chosen bin is taken whole.
//   3. The selected set: every entry whose key prefix beats T's, and of the
//      entries that match it the first `rank` in column order — each warp
//      walks a contiguous column range 32 at a time, ballots rank a tied
//      entry among the warp's ties and a scan of the warps' tie counts
//      places it in the row.  That set is exactly the (value desc, column
//      asc) top K, ties included.
//   4. Only those K (key, column) pairs, as 64-bit keys, are bitonic-sorted
//      (padded to a power of two >= 64): each thread holds two entries in
//      registers, strides below 32 are warp shuffles, stride 32 is in the
//      thread, and only strides of 64 and more pass through shared memory
//      with block barriers.  They are written in order with the row's
//      original values (−0.0 stays −0.0).
//   5. Parallelism.  At C = 512 one block a row fills the card (512 threads
//      a block, four blocks an SM).  At small C (NorthStar's C = 4, a
//      coupled round's 1–8) one block a row would leave most of the 132
//      SMs idle, and a row's time grows with N (at C = 4, ~1.1 µs per 1024
//      columns over ~8 µs of fixed cost, measured); so where that pays
//      (``cluster_size``: N = 8192 at C <= 16, measured 0.0162 against
//      0.0180 ms) a thread-block cluster of up to 8 blocks takes each row,
//      block r the columns [r S, (r + 1) S).  Each block histograms its slice and adds it into every
//      block's totals through distributed shared memory (totals by pass
//      parity, so one cluster barrier a pass); every block then picks the
//      same digit from its totals; the tie counts
//      meet the same way, so each block knows the ties to the left of its
//      slice; the selected entries go straight into block 0's shared
//      memory, which sorts them.
// Bound on the card: bytes — the plane is read once and K (value, column)
// pairs written a row.
//
// Range: C >= 1, N >= 1, 0 < K <= min(N, MAX_K); anything else is refused.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define MAX_K 1024
#define BINS 256
#define STAGE_MAX_N 16384
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ uint32_t desc_key(float v) {
  // canonicalise −0.0 to +0.0 so that equal values tie exactly
  if (v == 0.0f) v = 0.0f;
  uint32_t u = __float_as_uint(v);
  // order-preserving map: ascending floats → ascending unsigned
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ~u;  // descending value order
}

// eff [C, N] → cand_out [C, K] columns, val_out [C, K] values; P is the
// power of two >= max(K, 64) that the sort runs over (blockDim.x >= P / 2).
// CLUSTER: the grid's clusters of CL blocks each take one row, block r the
// columns [r * S, (r + 1) * S); the histograms and tie counts meet through
// distributed shared memory and the selected entries gather in block 0,
// which sorts them.  Otherwise one block takes a row (S unused).
template <bool STAGED, bool CLUSTER>
__global__ void __launch_bounds__(1024)
topk_select_kernel(const float* __restrict__ eff, int N, int K, int P, int S,
                   int32_t* __restrict__ cand_out, float* __restrict__ val_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* sel = (unsigned long long*)smem;  // [P] (block 0 of a cluster)
  uint32_t* keys = (uint32_t*)(sel + P);                // the columns' keys when STAGED
  __shared__ uint32_t hist[BINS], total[2][BINS];  // total: the cluster's, by pass parity
  __shared__ int wsum[32];
  __shared__ uint32_t s_digit, s_rank, s_whole;
  __shared__ int s_fill, s_eq;

  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = CLUSTER ? (int)cluster.num_blocks() : 1;
  const int crank = CLUSTER ? (int)cluster.block_rank() : 0;
  const size_t row = blockIdx.x / cl;
  const float* erow = eff + row * (size_t)N;
  const int lo = CLUSTER ? min(crank * S, N) : 0;  // this block's columns [lo, lo + len)
  const int len = CLUSTER ? min(lo + S, N) - lo : N;
  if (STAGED)
    for (int j = tid; j < len; j += nt) keys[j] = desc_key(erow[lo + j]);
  if (tid == 0) s_fill = 0;
  if (CLUSTER) {  // the first pass's totals are zero before any block adds to them
    for (int b = tid; b < BINS; b += nt) total[0][b] = 0u;
    cluster.sync();
  }
  auto key_at = [&](int j) -> uint32_t {
    return STAGED ? keys[j] : desc_key(__ldg(erow + lo + j));
  };

  // --- radix select: the digits of the K-th smallest key, top down --------
  uint32_t prefix = 0, pmask = 0, rank = (uint32_t)K;  // rank: 1-based, in the bin
  for (int shift = 24, pass = 0; shift >= 0; shift -= 8, ++pass) {
    for (int b = tid; b < BINS; b += nt) {
      hist[b] = 0u;
      // the next pass's totals: no block adds to them before this pass's
      // cluster barrier
      if (CLUSTER) total[(pass + 1) & 1][b] = 0u;
    }
    __syncthreads();
    for (int j0 = 0; j0 < len; j0 += nt) {
      const int j = j0 + tid;
      int digit = -1;
      if (j < len) {
        const uint32_t k = key_at(j);
        if ((k & pmask) == prefix) digit = (int)((k >> shift) & 0xffu);
      }
      // one add per distinct digit in the warp (a run of ties adds once)
      const unsigned peers = __match_any_sync(FULL_MASK, digit);
      if (digit >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&hist[digit], (uint32_t)__popc(peers));
    }
    __syncthreads();  // (the first one also orders the staging)
    uint32_t* bins = hist;
    if (CLUSTER) {  // the row's histogram: every block adds its bins into
                    // every block's totals, then one cluster barrier
      bins = total[pass & 1];
      for (int i = tid; i < BINS * cl; i += nt) {
        const uint32_t v = hist[i % BINS];
        if (v) atomicAdd(cluster.map_shared_rank(&bins[i % BINS], i / BINS), v);
      }
      cluster.sync();
    }
    if (tid < 32) {  // lane l scans bins [8l, 8l + 8)
      uint32_t cnt[8], s = 0;
      for (int q = 0; q < 8; ++q) {
        cnt[q] = bins[lane * 8 + q];
        s += cnt[q];
      }
      uint32_t incl = s;
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += y;
      }
      uint32_t before = incl - s;
      if (before < rank && rank <= incl) {
        for (int q = 0; q < 8; ++q) {
          if (rank <= before + cnt[q]) {
            s_digit = (uint32_t)(lane * 8 + q);
            s_rank = rank - before;
            s_whole = (rank - before) == cnt[q];
            break;
          }
          before += cnt[q];
        }
      }
    }
    __syncthreads();
    prefix |= s_digit << shift;
    pmask |= 0xffu << shift;
    rank = s_rank;
    if (s_whole) break;  // the bin is taken whole: no entry of it is left out
  }

  // --- the selected set: prefix beaten, or matched and within `rank` by
  // column order.  Warp w takes the contiguous columns [w * span, (w + 1) *
  // span) of the block's, 32 at a time in column order: ballots rank each
  // tied entry among the warp's ties, a scan of the warps' tie counts (and
  // of the cluster's blocks' before this one) places it in the row.
  const int nw = nt >> 5, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int span = (((len + nw - 1) / nw) + 31) & ~31;
  const int w_lo = min(warp * span, len), w_hi = min(w_lo + span, len);
  int w_eq = 0;
  for (int j0 = w_lo; j0 < w_hi; j0 += 32) {
    const int j = j0 + lane;
    w_eq += __popc(__ballot_sync(FULL_MASK, j < w_hi && (key_at(j) & pmask) == prefix));
  }
  if (lane == 0) wsum[warp] = w_eq;
  __syncthreads();
  if (warp == 0) {
    int v = lane < nw ? wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, v, o);
      if (lane >= o) v += y;
    }
    wsum[lane] = v;
    if (lane == 31) s_eq = v;
  }
  __syncthreads();
  int eq_seen = warp ? wsum[warp - 1] : 0;  // ties in the columns before this one
  unsigned long long* out_sel = sel;
  int* out_fill = &s_fill;
  if (CLUSTER) {
    cluster.sync();  // every block's tie count is in its s_eq
    for (int r = 0; r < crank; ++r) eq_seen += *cluster.map_shared_rank(&s_eq, r);
    out_sel = cluster.map_shared_rank(sel, 0);
    out_fill = cluster.map_shared_rank(&s_fill, 0);
  }
  for (int j0 = w_lo; j0 < w_hi; j0 += 32) {
    const int j = j0 + lane;
    uint32_t k = 0;
    bool lt = false, eq = false;
    if (j < w_hi) {
      k = key_at(j);
      lt = (k & pmask) < prefix;
      eq = (k & pmask) == prefix;
    }
    const unsigned eqb = __ballot_sync(FULL_MASK, eq);
    const bool take = lt || (eq && eq_seen + __popc(eqb & below) < (int)rank);
    eq_seen += __popc(eqb);
    const unsigned tb = __ballot_sync(FULL_MASK, take);
    int base = 0;
    if (lane == 0 && tb) base = atomicAdd(out_fill, __popc(tb));
    base = __shfl_sync(FULL_MASK, base, 0);
    if (take)
      out_sel[base + __popc(tb & below)] = ((unsigned long long)k << 32) | (uint32_t)(lo + j);
  }
  if (crank == 0)
    for (int i = K + tid; i < P; i += nt) sel[i] = ~0ull;
  if (CLUSTER) {
    cluster.sync();  // every selected entry is in block 0's sel
    if (crank != 0) return;
  } else {
    __syncthreads();
  }

  // --- bitonic sort of the P (>= 64) selected keys, ascending.  Thread t < P/2
  // holds entries i0 = 64 (t / 32) + t % 32 and i1 = i0 + 32 in registers:
  // strides below 32 are warp shuffles, stride 32 is within the thread, and
  // only strides of 64 and more go through shared memory with barriers.
  const bool act = tid < P / 2;
  const int i0 = 64 * warp + lane, i1 = i0 + 32;
  unsigned long long a = 0, b = 0;
  if (act) {
    a = sel[i0];
    b = sel[i1];
  }
  for (int size = 2; size <= P; size <<= 1) {
    int stride = size >> 1;
    if (stride >= 64) {
      if (act) {
        sel[i0] = a;
        sel[i1] = b;
      }
      __syncthreads();
      for (; stride >= 64; stride >>= 1) {
        if (act) {
          const int i = 2 * tid - (tid & (stride - 1));
          const int j = i + stride;
          const bool up = (i & size) == 0;
          const unsigned long long x = sel[i], y = sel[j];
          if ((x > y) == up) {
            sel[i] = y;
            sel[j] = x;
          }
        }
        __syncthreads();
      }
      if (act) {
        a = sel[i0];
        b = sel[i1];
      }
    }
    if (act) {
      if (stride == 32) {
        const bool up = (i0 & size) == 0;
        if ((a > b) == up) {
          const unsigned long long x = a;
          a = b;
          b = x;
        }
        stride = 16;
      }
      const bool up_a = (i0 & size) == 0, up_b = (i1 & size) == 0;
      for (; stride > 0; stride >>= 1) {
        const unsigned long long xa = __shfl_xor_sync(FULL_MASK, a, stride);
        const unsigned long long xb = __shfl_xor_sync(FULL_MASK, b, stride);
        const bool lower = (lane & stride) == 0;  // the lower entry of its pair
        a = (lower == up_a) ? (a < xa ? a : xa) : (a < xa ? xa : a);
        b = (lower == up_b) ? (b < xb ? b : xb) : (b < xb ? xb : b);
      }
    }
  }
  if (act) {
    int32_t* co = cand_out + row * (size_t)K;
    float* vo = val_out + row * (size_t)K;
    if (i0 < K) {
      const int col = (int)(uint32_t)(a & 0xffffffffull);
      co[i0] = col;
      vo[i0] = erow[col];
    }
    if (i1 < K) {
      const int col = (int)(uint32_t)(b & 0xffffffffull);
      co[i1] = col;
      vo[i1] = erow[col];
    }
  }
}

template <bool STAGED, bool CLUSTER>
static int launch(int C, int N, int K, int cl, const float* eff, int32_t* cand_out,
                  float* val_out, cudaStream_t stream) {
  static bool attrs_set = false;
  if (!attrs_set) {
    const int most = MAX_K * 8 + (STAGED ? STAGE_MAX_N * 4 : 0);
    cudaError_t e = cudaFuncSetAttribute(topk_select_kernel<STAGED, CLUSTER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(topk_select_kernel<STAGED, CLUSTER>,
                             cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (e != cudaSuccess) return (int)e;
    attrs_set = true;
  }
  int P = 64;
  while (P < K) P <<= 1;
  // a slice of each row for each block of a cluster, whole warps of columns
  const int S = CLUSTER ? (((N + cl - 1) / cl + 31) & ~31) : N;
  // 1024 threads a block while the rows leave SMs free (two such blocks an
  // SM), 512 once they would not (four an SM)
  const int threads = (CLUSTER || C <= 264) ? 1024 : 512;
  const size_t smem = (size_t)P * 8 + (STAGED ? (size_t)S * 4 : 0);
  if (!CLUSTER) {
    topk_select_kernel<STAGED, false><<<C, threads, smem, stream>>>(eff, N, K, P, S, cand_out,
                                                                   val_out);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * cl));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, topk_select_kernel<STAGED, true>, eff, N, K, P, S,
                                     cand_out, val_out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// blocks a row's cluster takes: up to 8 (the portable cluster size) while
// the clusters fit on the 132 SMs in one wave, and only where the columns it
// takes off each block outweigh the cluster's fixed cost (H100: ~6 µs of
// barriers and pushes against ~1.1 µs per 1024 columns of one block's
// passes, so 7168 columns or more), with at most STAGE_MAX_N a block;
// 1 (no cluster) otherwise
static int cluster_size(int C, int N) {
  int cl = 8;
  while (cl > 1 && C * cl > 132) cl >>= 1;
  if (cl > 1 && (N - N / cl < 7168 || (N + cl - 1) / cl > STAGE_MAX_N)) cl = 1;
  return cl;
}

extern "C" int topk_max_k() { return MAX_K; }

extern "C" int launch_topk_rows(int C, int N, int K, const void* eff, void* cand_out,
                                void* val_out, void* stream) {
  if (C < 1 || N < 1 || K < 1 || K > N || K > MAX_K) return (int)cudaErrorInvalidValue;
  const int cl = cluster_size(C, N);
  const float* e = (const float*)eff;
  int32_t* co = (int32_t*)cand_out;
  float* vo = (float*)val_out;
  cudaStream_t st = (cudaStream_t)stream;
  if (cl > 1) return launch<true, true>(C, N, K, cl, e, co, vo, st);
  if (N <= STAGE_MAX_N) return launch<true, false>(C, N, K, 1, e, co, vo, st);
  return launch<false, false>(C, N, K, 1, e, co, vo, st);
}
