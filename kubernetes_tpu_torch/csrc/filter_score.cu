// K1 filter_score_planes: the per-plugin filter bits and raw score planes of
// the identity-class dedup cycle, over node tiles × class chunks.
//
// Replaces (JAX package): the [C, N] filter and raw score planes that
// framework/runtime.py _batch_assign_dedup.dense_rep builds each round from
// plugins/trivial.py (NodeUnschedulable :74, NodeName :26, NodePorts :45,
// ImageLocality score :89), plugins/tainttoleration.py (:25-63),
// plugins/noderesources.py (fit_filter :28, FitPlugin.score :82-126 under
// its three strategies, BalancedAllocationPlugin.score :169) and the
// precomputed NodeAffinity planes (plugins/nodeaffinity.py).
//
// Output: an i32[C, N] pass-bit plane (bit k set when filter plugin k of the
// framework's filter order passes; live_nodes and the class's valid flag are
// folded in, so a dead node or a padding class row has no bit set; a filter
// the profile does not run has bit index -1 and sets nothing) and five
// raw f32 planes [5, C, N]: TaintToleration, NodeAffinity, Fit,
// BalancedAllocation, ImageLocality.
//
// Bound on the card: bytes (the node rows, ~350 B a node at R = T = P = I
// = 8, read once; 29 B a cell: the NodeAffinity planes read, bits and the
// raw planes written).  What the time goes to instead: at C = 1 and 4 an SM
// holds two warps, so every instruction on a thread's path costs its full
// latency; at C = 512, the cells' arithmetic (divisions and compares).
// Design:
//   * A block owns a tile of nodes (one a thread) and a group of classes
//     (a grid axis, so that C = 1 and C = 4 still fill the 132 SMs).  Each
//     thread loads its node's rows once into registers with 128-bit loads
//     (the rows are 32 B at the default widths), all issued before the
//     class rows' loads: the resource rows stay in registers for every class
//     of the group; the first NODE_CAP taint effects, host ports and images
//     only set the node's skip flags (an acting taint — NoSchedule,
//     PreferNoSchedule, NoExecute —, a host port, a valid node's image), so
//     a node with none skips those walks for every class.  A flagged node,
//     or one wider than NODE_CAP, walks its rows in global memory (L1).
//   * Per chunk of CLS classes, the block's warps stage the class rows in
//     shared memory once, a warp a class, every lane's loads issued before
//     the warp votes: requests, the tolerates-unschedulable flag, Fit's and
//     BalancedAllocation's per-dimension include masks (weight or
//     selection, and an extended dimension only when requested), the valid
//     tolerations, the non-missing host ports and the non-missing image ids
//     compacted in order (with their spread-scaled sizes), the image
//     threshold and the image score of a node holding none of them.  A
//     class with more than the staged count reads its rows in global
//     memory.  The chunk's NodeAffinity rows over the tile come in by
//     cp.async beside them, so a class costs no load of its own.  Fit's
//     weights and RequestedToCapacityRatio's shape points are staged once a
//     block.
//   * BalancedAllocation keeps its per-dimension fractions in registers, so
//     each division happens once; the sums keep the reference's order.  A
//     division by a power of two (32Gi of memory in KiB, two resources) is
//     the product with its exact reciprocal, the same bits.
//   * Each (class, tile) pass writes bits and the five raw planes coalesced
//     along nodes.  live_nodes (node_valid & node_ready) is folded in, so a
//     call is this one launch.
// The numerics repeat the reference's float32 operation order exactly: the
// library is built with --fmad=false -prec-div=true -prec-sqrt=true, so no
// multiply is contracted into an add and every division and square root is
// correctly rounded; the floors then land where the reference's do.  A term
// the kernel skips (an excluded dimension, an absent image) is an add of
// +0.0 in the reference, which leaves every sum it could meet unchanged.
//
// Fit's score follows the profile's scoring strategy (one instantiation of
// the kernel a strategy): LeastAllocated floor((alloc - total) * 100 / alloc),
// MostAllocated floor(total * 100 / alloc) (0 where total > alloc), or
// RequestedToCapacityRatio: util = min(total / alloc, 1) * 100 (100 where
// alloc = 0) through the shape's points as jnp.interp computes it (its
// binary search, then fp[i-1] + (delta / dx) * df as ONE fused
// multiply-add: XLA:CPU contracts it, so __fmaf_rn here), not floored per
// resource; only sum(w * per_dim) / sum(w) is floored.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MISSING (-1)
#define TOL_OP_EXISTS 1
#define NUM_BASE_DIMS 4
#define DIM_CPU 0
#define DIM_MEMORY 1
#define MAX_NODE_SCORE 100.0f
#define MIN_THRESHOLD 24117248.0f  // 23 MiB
#define MAX_CONTAINER_THRESHOLD 1048576000LL  // 1000 MiB
#define STRATEGY_LEAST 0
#define STRATEGY_MOST 1
#define STRATEGY_RTCR 2
// np.spacing(np.finfo(float32).eps): jnp.interp's flat-segment threshold
#define DX_EPS 0x1p-46f

#define TILE_MAX 128  // nodes a block at most (one a thread)
#define CLS 16        // class rows staged at a time
#define RS 8          // resource dimensions held in registers (more: global)
static_assert(RS == 8, "the node rows are loaded as two int4 a row");
#define NODE_CAP 8    // a node's taints, host ports, images read for its flags
static_assert(NODE_CAP == 8, "the flags read two int4 a row");
#define CT_CAP 8      // a class's tolerations staged
#define CP_CAP 8      // a class's host ports staged
#define CI_CAP 8      // a class's image ids staged
#define SHAPE_CAP 32  // RequestedToCapacityRatio shape points staged
#define TARGET_BLOCKS (132 * 16)

struct ClassRows {
  const uint8_t* valid;        // [C]
  const int32_t* request;      // [C, R]
  const int32_t* non_zero;     // [C, 2]
  const int32_t* node_name_id; // [C]
  const uint8_t* tol_valid;    // [C, TT]
  const int32_t* tol_key;      // [C, TT]
  const int32_t* tol_val;      // [C, TT]
  const int32_t* tol_op;       // [C, TT]
  const int32_t* tol_effect;   // [C, TT]
  const int32_t* ports;        // [C, PP]
  const int32_t* ports_ip;     // [C, PP]
  const int32_t* image_ids;    // [C, CI]
  int TT, PP, CI;
};

struct NodeRows {
  const uint8_t* node_ready;     // [N] (live_nodes = node_valid & node_ready)
  const uint8_t* node_valid;     // [N]
  const int32_t* node_name_ids;  // [N]
  const uint8_t* unschedulable;  // [N]
  const int32_t* allocatable;    // [N, R]
  const int32_t* requested;      // [N, R] (dynamic state)
  const int32_t* non_zero;       // [N, 2] (dynamic state)
  const int32_t* taint_keys;     // [N, T]
  const int32_t* taint_vals;     // [N, T]
  const int32_t* taint_effects;  // [N, T]
  const int32_t* ports;          // [N, P]
  const int32_t* ports_ip;       // [N, P]
  const int32_t* image_ids;      // [N, I]
  int T, P, I;
};

struct Extra {
  const uint8_t* na_mask;     // [C, N] NodeAffinity filter plane
  const float* na_pref;       // [C, N] NodeAffinity preferred-weight sum
  const float* img_scaled;    // [num_ids] spread-scaled image sizes
  int num_ids;
  const float* fit_w;         // [R] Fit weights
  const uint8_t* ba_sel;      // [R] BalancedAllocation resource selection
  int bit_unsched, bit_name, bit_taint, bit_affinity, bit_ports, bit_fit;  // -1: absent
  int pass_bits;              // bits of the pass-through filters
  int strategy;               // Fit's scoring strategy (STRATEGY_*; picks the kernel)
  const float* shape_x;       // [S] RequestedToCapacityRatio utilization points
  const float* shape_y;       // [S] their scores (x 10)
  int n_shape;
  // dictionary ids (state/dictionary.py): the node.kubernetes.io/unschedulable
  // taint key and the 0.0.0.0 host IP
  int id_unsched_taint, id_wildcard_ip;
};

// a class chunk's NodeAffinity rows over the node tile
struct __align__(16) AffinityTile {
  float pref[CLS][TILE_MAX];
  uint8_t mask[CLS][TILE_MAX];
};

// a chunk of CLS class rows and their invariants; a count of -1 means the
// class's list is read in global memory
struct ClassTile {
  int valid[CLS], nid[CLS], tol_unsched[CLS], fitmask[CLS], bamask[CLS];
  int req[CLS][RS], nz[CLS][2];
  int nt[CLS], tk[CLS][CT_CAP], tv[CLS][CT_CAP], top[CLS][CT_CAP], te[CLS][CT_CAP];
  int np[CLS], pp[CLS][CP_CAP], pip[CLS][CP_CAP];
  int ni[CLS], img[CLS][CI_CAP];
  float imgs[CLS][CI_CAP];
  float max_t[CLS], img_score0[CLS];
};

__device__ __forceinline__ bool tolerates(int pk, int pv, int po, int pe, int tk, int tv,
                                          int te) {
  const bool key_ok = (pk == MISSING) || (pk == tk);
  const bool effect_ok = (pe == -1) || (pe == te);
  const bool value_ok = (po == TOL_OP_EXISTS) || (pv == tv);
  return key_ok && effect_ok && value_ok;
}

// x / d, correctly rounded.  Where d is a power of two in the normal range
// its reciprocal is exact, and x * (1 / d) is the same real number as x / d,
// so the product rounds to the quotient's bits; otherwise a division.
__device__ __forceinline__ float div_rn(float x, float d) {
  const unsigned u = __float_as_uint(d);
  const unsigned e = (u >> 23) & 0xffu;
  if ((u & 0x807fffffu) == 0u && e >= 2u && e <= 252u)
    return __fmul_rn(x, __uint_as_float((254u - e) << 23));
  return __fdiv_rn(x, d);
}

// jnp.interp(x, xp, fp) in float32, as jax computes it: searchsorted(xp, x,
// side="right") by ceil(log2(S + 1)) halvings of [0, S) (left while
// x < xp[mid]), the segment clipped to [1, S - 1], fp[0] / fp[S - 1] outside.
__device__ __forceinline__ float rtcr_interp(float x, const float* xp, const float* fp,
                                             int S) {
  int levels = 0;
  while ((1 << levels) < S + 1) ++levels;
  int low = 0, high = S;
  for (int l = 0; l < levels; ++l) {
    const int mid = (low + high) / 2;
    if (x < xp[min(mid, S - 1)]) high = mid; else low = mid;
  }
  const int i = min(max(high, 1), S - 1);
  const float df = __fsub_rn(fp[i], fp[i - 1]);
  const float dx = __fsub_rn(xp[i], xp[i - 1]);
  const float delta = __fsub_rn(x, xp[i - 1]);
  const bool dx0 = fabsf(dx) <= DX_EPS;
  float f = dx0 ? fp[i - 1] : __fmaf_rn(div_rn(delta, dx), df, fp[i - 1]);
  if (x < xp[0]) f = fp[0];
  if (x > xp[S - 1]) f = fp[S - 1];
  return f;
}

// four entries [j0, j0 + 4) of an int32 row of width W: one 128-bit load
// where the row is 16-byte aligned and holds them all, else one by one
// (MISSING past the row's end)
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ row, int W, int j0) {
  if (j0 + 4 <= W && (((uintptr_t)(row + j0)) & 15) == 0)
    return __ldg((const int4*)(row + j0));
  int4 v;
  v.x = j0 < W ? __ldg(row + j0) : MISSING;
  v.y = j0 + 1 < W ? __ldg(row + j0 + 1) : MISSING;
  v.z = j0 + 2 < W ? __ldg(row + j0 + 2) : MISSING;
  v.w = j0 + 3 < W ? __ldg(row + j0 + 3) : MISSING;
  return v;
}

__device__ __forceinline__ int lane4(const int4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// a 4-byte cp.async from global to shared memory; nothing waits here
__device__ __forceinline__ void cp_async4(int* dst, const int32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// rows [c0, c0 + cn) x columns [n0, n0 + nt) of the [C, N] NodeAffinity
// planes into the chunk's tile: 16-byte copies where aligned
__device__ void stage_affinity(AffinityTile& sa, const uint8_t* __restrict__ mask,
                               const float* __restrict__ pref, int c0, int cn, int N, int n0,
                               int nt) {
  for (int k = 0; k < cn; ++k) {
    const long long row = (long long)(c0 + k) * N + n0;
    const float* p = pref + row;
    const uint8_t* m = mask + row;
    if ((((uintptr_t)p) & 15) == 0 && (nt & 3) == 0) {
      for (int q = threadIdx.x; q < nt / 4; q += blockDim.x) cp_async16(&sa.pref[k][4 * q], p + 4 * q);
    } else {
      for (int q = threadIdx.x; q < nt; q += blockDim.x) cp_async4((int*)&sa.pref[k][q], (const int32_t*)(p + q));
    }
    if ((((uintptr_t)m) & 15) == 0 && (nt & 15) == 0) {
      for (int q = threadIdx.x; q < nt / 16; q += blockDim.x) cp_async16(&sa.mask[k][16 * q], m + 16 * q);
    } else {
      for (int q = threadIdx.x; q < nt; q += blockDim.x) sa.mask[k][q] = m[q];
    }
  }
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Fit's per-dimension score under the strategy (the reference's per_dim)
__device__ __forceinline__ float fit_per_dim(int strategy, float total, float alloc,
                                             const float* sx, const float* sy, int S) {
  if (strategy == STRATEGY_RTCR) {
    const float util =
        (alloc == 0.0f)
            ? MAX_NODE_SCORE
            : __fmul_rn(fminf(div_rn(total, fmaxf(alloc, 1.0f)), 1.0f), MAX_NODE_SCORE);
    return rtcr_interp(util, sx, sy, S);
  }
  if (alloc == 0.0f || total > alloc) return 0.0f;
  const float num = (strategy == STRATEGY_MOST)
                        ? __fmul_rn(total, MAX_NODE_SCORE)
                        : __fmul_rn(__fsub_rn(alloc, total), MAX_NODE_SCORE);
  return floorf(div_rn(num, fmaxf(alloc, 1.0f)));
}

// ImageLocality's score from the summed scaled sizes and the class's threshold
__device__ __forceinline__ float image_score(float img_sum, float max_t) {
  const float clamped = fminf(fmaxf(img_sum, MIN_THRESHOLD), max_t);
  return div_rn(__fmul_rn(MAX_NODE_SCORE, __fsub_rn(clamped, MIN_THRESHOLD)),
                __fsub_rn(max_t, MIN_THRESHOLD));
}

// one list entry a lane: compact the kept ones (in order) at [base, ...)
// of ``dst`` up to ``cap``; → the number kept
__device__ __forceinline__ int compact_lane(bool keep, int base, int cap, int* dst, int v,
                                            int* dst2 = nullptr, int v2 = 0) {
  const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
  const unsigned m = __ballot_sync(0xffffffffu, keep);
  const int at = base + __popc(m & lt);
  if (keep && at < cap) {
    dst[at] = v;
    if (dst2) dst2[at] = v2;
  }
  return __popc(m);
}

// stage class rows [c0, c0 + cn) in shared memory, a warp a class: every
// lane's loads (its request dimension, toleration, host port and image id)
// issued before the warp votes on any of them
__device__ void stage_classes(ClassTile& sc, int c0, int cn, int R, const ClassRows& cr,
                              const Extra& ex, bool first, float* s_w, float* s_sx,
                              float* s_sy) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  for (int k = threadIdx.x >> 5; k < cn; k += blockDim.x >> 5) {
    const int c = c0 + k;
    const bool dim = lane < RS && lane < R;
    const long long ot = (long long)c * cr.TT + lane, op = (long long)c * cr.PP + lane,
                    oi = (long long)c * cr.CI + lane;
    const int req = dim ? cr.request[(long long)c * R + lane] : 0;
    const int nz = lane < 2 ? cr.non_zero[c * 2 + lane] : 0;
    const bool sel = dim && ex.ba_sel[lane];
    const bool weighted = dim && ex.fit_w[lane] > 0.0f;
    const bool tv0 = lane < cr.TT && cr.tol_valid[ot];
    const int pk0 = lane < cr.TT ? cr.tol_key[ot] : 0, pv0 = lane < cr.TT ? cr.tol_val[ot] : 0;
    const int po0 = lane < cr.TT ? cr.tol_op[ot] : 0, pe0 = lane < cr.TT ? cr.tol_effect[ot] : 0;
    const int pp0 = lane < cr.PP ? cr.ports[op] : MISSING;
    const int pip0 = lane < cr.PP ? cr.ports_ip[op] : MISSING;
    const int id0 = lane < cr.CI ? cr.image_ids[oi] : MISSING;
    if (first && k == 0) {  // Fit's weights and the shape points, once a block
      if (lane < RS) s_w[lane] = dim ? ex.fit_w[lane] : 0.0f;
      if (ex.n_shape <= SHAPE_CAP && lane < ex.n_shape) {
        s_sx[lane] = ex.shape_x[lane];
        s_sy[lane] = ex.shape_y[lane];
      }
    }
    if (lane == 0) {
      sc.valid[k] = cr.valid[c];
      sc.nid[k] = cr.node_name_id[c];
    }
    if (lane < 2) sc.nz[k][lane] = nz;
    if (lane < RS) sc.req[k][lane] = req;
    // the include masks (dimensions < RS; the rest inline): weighted or
    // selected, and an extended dimension only when requested
    const bool ext_ok = lane < NUM_BASE_DIMS || req > 0;
    const unsigned fitm = __ballot_sync(0xffffffffu, weighted && ext_ok);
    const unsigned bam = __ballot_sync(0xffffffffu, sel && ext_ok);
    // tolerations: the valid ones compacted; the unschedulable taint's
    bool unsched = __any_sync(0xffffffffu, tv0 && (pk0 == MISSING || pk0 == ex.id_unsched_taint) &&
                                               (pe0 == -1 || pe0 == 0) && po0 == TOL_OP_EXISTS);
    int cnt = 0;
    {
      const unsigned m = __ballot_sync(0xffffffffu, tv0);
      const int at = __popc(m & lt);
      if (tv0 && at < CT_CAP) {
        sc.tk[k][at] = pk0;
        sc.tv[k][at] = pv0;
        sc.top[k][at] = po0;
        sc.te[k][at] = pe0;
      }
      cnt = __popc(m);
    }
    for (int j0 = 32; j0 < cr.TT; j0 += 32) {  // past 32 tolerations: only counted
      const long long o = (long long)c * cr.TT + j0 + lane;
      const bool v = j0 + lane < cr.TT && cr.tol_valid[o];
      int pk = 0, pe = 0, po = 0;
      if (v) {
        pk = cr.tol_key[o];
        po = cr.tol_op[o];
        pe = cr.tol_effect[o];
      }
      unsched |= __any_sync(0xffffffffu, v && (pk == MISSING || pk == ex.id_unsched_taint) &&
                                             (pe == -1 || pe == 0) && po == TOL_OP_EXISTS);
      cnt += __popc(__ballot_sync(0xffffffffu, v));
    }
    // host ports: the non-missing ones compacted
    int pcnt = compact_lane(pp0 != MISSING, 0, CP_CAP, sc.pp[k], pp0, sc.pip[k], pip0);
    for (int j0 = 32; j0 < cr.PP; j0 += 32)
      pcnt += __popc(__ballot_sync(
          0xffffffffu, j0 + lane < cr.PP && cr.ports[(long long)c * cr.PP + j0 + lane] != MISSING));
    // image ids: the non-missing ones compacted in container order, then
    // their scaled sizes
    int icnt = compact_lane(id0 != MISSING, 0, CI_CAP, sc.img[k], id0);
    for (int j0 = 32; j0 < cr.CI; j0 += 32)
      icnt += __popc(__ballot_sync(
          0xffffffffu, j0 + lane < cr.CI && cr.image_ids[(long long)c * cr.CI + j0 + lane] != MISSING));
    __syncwarp();
    if (icnt <= CI_CAP && cr.CI <= 32 && lane < icnt)
      sc.imgs[k][lane] = ex.img_scaled[min(max(sc.img[k][lane], 0), ex.num_ids - 1)];
    __syncwarp();
    // a list past its staged count, or wider than a warp, is read in
    // global memory
    const bool staged_i = icnt <= CI_CAP && cr.CI <= 32;
    if (lane == 0) {
      sc.fitmask[k] = (int)fitm;
      sc.bamask[k] = (int)bam;
      sc.tol_unsched[k] = unsched;
      sc.nt[k] = cnt <= CT_CAP && cr.TT <= 32 ? cnt : -1;
      sc.np[k] = pcnt <= CP_CAP && cr.PP <= 32 ? pcnt : -1;
      sc.ni[k] = staged_i ? icnt : -1;
      // the threshold (int32 arithmetic wraps as the reference's) and the
      // score on a node that holds none of the images: a sum of +0.0 terms
      const long long mt = (long long)max(icnt, 1) * MAX_CONTAINER_THRESHOLD;
      const float max_t = (float)(int32_t)(uint32_t)(mt & 0xffffffffLL);
      float img_sum = 0.0f;
      for (int q = 0; q < cr.CI; ++q) {
        const int id = staged_i ? (q < icnt ? sc.img[k][q] : MISSING)
                                : cr.image_ids[(long long)c * cr.CI + q];
        if (id == MISSING) continue;
        const float s = staged_i ? sc.imgs[k][q]
                                 : ex.img_scaled[min(max(id, 0), ex.num_ids - 1)];
        img_sum = __fadd_rn(img_sum, __fmul_rn(s, 0.0f));
      }
      sc.max_t[k] = max_t;
      sc.img_score0[k] = image_score(img_sum, max_t);
    }
  }
}

template <int STRATEGY>
__global__ void __launch_bounds__(TILE_MAX)
filter_score_kernel(int C, int N, int R, int per_group, ClassRows cr, NodeRows nr, Extra ex,
                    int32_t* __restrict__ bits, float* __restrict__ raw) {
  __shared__ ClassTile sc;
  __shared__ AffinityTile sa;
  __shared__ float s_w[RS];
  __shared__ float s_sx[SHAPE_CAP], s_sy[SHAPE_CAP];

  const int t = threadIdx.x;
  const int n = blockIdx.x * blockDim.x + t;
  const bool in = n < N;
  const int n0 = blockIdx.x * blockDim.x;
  const int nt_tile = min((int)blockDim.x, N - n0);
  const float* sx = ex.n_shape <= SHAPE_CAP ? s_sx : ex.shape_x;
  const float* sy = ex.n_shape <= SHAPE_CAP ? s_sy : ex.shape_y;

  // --- the node's rows, one thread a node, 128-bit loads into registers, all
  // issued before the first class chunk's loads: the resource rows kept for
  // every class; the first NODE_CAP taint effects, host ports and images
  // only for the node's skip flags (a walk reads the rows again where one
  // runs) --------------------------------------------------------------------------
  const int4 none = make_int4(MISSING, MISSING, MISSING, MISSING);
  int4 a0 = none, a1 = none, q0 = none, q1 = none, e0 = none, e1 = none, p0 = none,
       p1 = none, m0 = none, m1 = none;
  int nzn0 = 0, nzn1 = 0, name_id = 0;
  bool live = false, unsched = false, nvalid = false;
  const long long ot = (long long)n * nr.T, op = (long long)n * nr.P, oi = (long long)n * nr.I;
  if (in) {
    a0 = load4(nr.allocatable + (long long)n * R, R, 0);
    a1 = load4(nr.allocatable + (long long)n * R, R, 4);
    q0 = load4(nr.requested + (long long)n * R, R, 0);
    q1 = load4(nr.requested + (long long)n * R, R, 4);
    e0 = load4(nr.taint_effects + ot, nr.T, 0);
    e1 = load4(nr.taint_effects + ot, nr.T, 4);
    p0 = load4(nr.ports + op, nr.P, 0);
    p1 = load4(nr.ports + op, nr.P, 4);
    m0 = load4(nr.image_ids + oi, nr.I, 0);
    m1 = load4(nr.image_ids + oi, nr.I, 4);
    nzn0 = nr.non_zero[(long long)n * 2];
    nzn1 = nr.non_zero[(long long)n * 2 + 1];
    name_id = nr.node_name_ids[n];
    unsched = nr.unschedulable[n];
    nvalid = nr.node_valid[n];
    live = nvalid && nr.node_ready[n];
  }
  const int al[RS] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const int rq[RS] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
  // per-node flags: a walk runs only where the node has an acting taint
  // (NoSchedule, PreferNoSchedule, NoExecute), a host port or (a valid
  // node) an image, or more entries than were read here
  bool any_t = false, any_p = false, any_i = false;

  const long long plane = (long long)C * N;
  const int c_begin = blockIdx.y * per_group;
  const int c_end = min(C, c_begin + per_group);
  for (int c0 = c_begin; c0 < c_end; c0 += CLS) {
    const int cn = min(CLS, c_end - c0);
    if (c0 != c_begin) __syncthreads();  // the last chunk's readers are done
    stage_affinity(sa, ex.na_mask, ex.na_pref, c0, cn, N, n0, nt_tile);
    stage_classes(sc, c0, cn, R, cr, ex, c0 == c_begin, s_w, s_sx, s_sy);
    if (c0 == c_begin && in) {
      any_t = nr.T > NODE_CAP;
      any_p = nr.P > NODE_CAP;
      any_i = nvalid && nr.I > NODE_CAP;
#pragma unroll
      for (int j = 0; j < NODE_CAP; ++j) {
        const int te = lane4(j < 4 ? e0 : e1, j & 3);
        any_t |= te == 0 || te == 1 || te == 2;
        any_p |= lane4(j < 4 ? p0 : p1, j & 3) != MISSING;
        any_i |= nvalid && lane4(j < 4 ? m0 : m1, j & 3) != MISSING;
      }
    }
    cp_async_wait();
    __syncthreads();
    if (!in) continue;
    for (int k = 0; k < cn; ++k) {
      const int c = c0 + k;
      const long long cnn = (long long)c * N + n;

      // --- NodeUnschedulable, NodeName ----------------------------------------
      const bool f_unsched = !unsched || sc.tol_unsched[k];
      const int nid = sc.nid[k];
      const bool f_name = (nid == MISSING) || (nid == name_id);

      // --- TaintToleration filter + score --------------------------------------
      bool f_taint = true;
      int prefer_count = 0;
      if (any_t) {
        const int n_tol = sc.nt[k] >= 0 ? sc.nt[k] : cr.TT;
        const long long otol = (long long)c * cr.TT;
        for (int j = 0; j < nr.T; ++j) {
          const int te = __ldg(nr.taint_effects + ot + j);
          if (te != 0 && te != 1 && te != 2) continue;
          const int tk = __ldg(nr.taint_keys + ot + j);
          const int tv = __ldg(nr.taint_vals + ot + j);
          bool tol = false;
          for (int q = 0; q < n_tol && !tol; ++q) {
            int pk, pv, po, pe;
            if (sc.nt[k] >= 0) {
              pk = sc.tk[k][q]; pv = sc.tv[k][q]; po = sc.top[k][q]; pe = sc.te[k][q];
            } else {
              if (!cr.tol_valid[otol + q]) continue;
              pk = cr.tol_key[otol + q]; pv = cr.tol_val[otol + q];
              po = cr.tol_op[otol + q]; pe = cr.tol_effect[otol + q];
            }
            // PreferNoSchedule: only effect "" / PreferNoSchedule tolerations
            if (te == 1 && pe != -1 && pe != 1) continue;
            tol = tolerates(pk, pv, po, pe, tk, tv, te);
          }
          if (!tol) {
            if (te == 1) prefer_count += 1;
            else f_taint = false;
          }
        }
      }

      // --- NodePorts (wildcard-IP conflict rule) -------------------------------
      bool f_ports = true;
      if (any_p && sc.np[k] != 0) {
        const int n_pp = sc.np[k] >= 0 ? sc.np[k] : cr.PP;
        const long long oc = (long long)c * cr.PP;
        for (int i = 0; i < n_pp && f_ports; ++i) {
          const int pp = sc.np[k] >= 0 ? sc.pp[k][i] : cr.ports[oc + i];
          if (pp == MISSING) continue;
          const int pip = sc.np[k] >= 0 ? sc.pip[k][i] : cr.ports_ip[oc + i];
          for (int j = 0; j < nr.P; ++j) {
            const int np_ = __ldg(nr.ports + op + j);
            const int nip = __ldg(nr.ports_ip + op + j);
            if (np_ == pp &&
                (pip == nip || pip == ex.id_wildcard_ip || nip == ex.id_wildcard_ip))
              f_ports = false;
          }
        }
      }

      // --- Fit filter + the strategy's score; BalancedAllocation ---------------
      bool f_fit = true;
      float wsum = 0.0f, wscore = 0.0f, ba_sum = 0.0f;
      int ba_n = 0;
      float frac[RS];
      const int fitm = sc.fitmask[k], bam = sc.bamask[k];
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        frac[r] = 0.0f;
        if (r < R) {
          const int req = sc.req[k][r];
          if (!(req == 0 || req <= al[r] - rq[r])) f_fit = false;
          if (al[r] > 0) {
            if ((fitm >> r) & 1) {
              const float nz_node = r == DIM_CPU ? (float)nzn0
                                    : r == DIM_MEMORY ? (float)nzn1 : (float)rq[r];
              const float nz_pod = r == DIM_CPU ? (float)sc.nz[k][0]
                                   : r == DIM_MEMORY ? (float)sc.nz[k][1] : (float)req;
              const float w = s_w[r];
              const float per_dim = fit_per_dim(STRATEGY, __fadd_rn(nz_node, nz_pod),
                                                (float)al[r], sx, sy, ex.n_shape);
              wsum = __fadd_rn(wsum, w);
              wscore = __fadd_rn(wscore, __fmul_rn(per_dim, w));
            }
            if ((bam >> r) & 1) {
              frac[r] = fminf(div_rn((float)(rq[r] + req), fmaxf((float)al[r], 1.0f)), 1.0f);
              ba_sum = __fadd_rn(ba_sum, frac[r]);
              ba_n += 1;
            }
          }
        }
      }
      // dimensions past RS, read in global memory (extended: only when requested)
      for (int r = RS; r < R; ++r) {
        const int req = cr.request[(long long)c * R + r];
        const int a = nr.allocatable[(long long)n * R + r];
        const int q = nr.requested[(long long)n * R + r];
        if (!(req == 0 || req <= a - q)) f_fit = false;
        if (a > 0 && req > 0) {
          const float w = ex.fit_w[r];
          if (w > 0.0f) {
            const float per_dim = fit_per_dim(STRATEGY, __fadd_rn((float)q, (float)req),
                                              (float)a, sx, sy, ex.n_shape);
            wsum = __fadd_rn(wsum, w);
            wscore = __fadd_rn(wscore, __fmul_rn(per_dim, w));
          }
          if (ex.ba_sel[r]) {
            ba_sum = __fadd_rn(ba_sum, fminf(div_rn((float)(q + req), fmaxf((float)a, 1.0f)),
                                             1.0f));
            ba_n += 1;
          }
        }
      }
      const float fit_score =
          (wsum == 0.0f) ? 0.0f : floorf(div_rn(wscore, fmaxf(wsum, 1.0f)));
      float ba_score = 0.0f;
      if (ba_n > 0) {
        const float denom = (float)ba_n;
        const float mean = div_rn(ba_sum, denom);
        float var = 0.0f;
#pragma unroll
        for (int r = 0; r < RS; ++r) {
          if (r < R && al[r] > 0 && ((bam >> r) & 1)) {
            const float d = __fsub_rn(frac[r], mean);
            var = __fadd_rn(var, __fmul_rn(d, d));
          }
        }
        for (int r = RS; r < R; ++r) {
          const int req = cr.request[(long long)c * R + r];
          const int a = nr.allocatable[(long long)n * R + r];
          if (a > 0 && req > 0 && ex.ba_sel[r]) {
            const int q = nr.requested[(long long)n * R + r];
            const float f = fminf(div_rn((float)(q + req), fmaxf((float)a, 1.0f)), 1.0f);
            const float d = __fsub_rn(f, mean);
            var = __fadd_rn(var, __fmul_rn(d, d));
          }
        }
        const float sd = __fsqrt_rn(div_rn(var, denom));
        ba_score = __fmul_rn(__fsub_rn(1.0f, sd), MAX_NODE_SCORE);
      }

      // --- ImageLocality ---------------------------------------------------------
      float img_score = sc.img_score0[k];
      if (any_i && sc.ni[k] != 0) {
        const int n_ci = sc.ni[k] >= 0 ? sc.ni[k] : cr.CI;
        float img_sum = 0.0f;
        for (int q = 0; q < n_ci; ++q) {
          const int id = sc.ni[k] >= 0 ? sc.img[k][q] : cr.image_ids[(long long)c * cr.CI + q];
          if (id == MISSING) continue;
          const float s = sc.ni[k] >= 0 ? sc.imgs[k][q]
                                        : ex.img_scaled[min(max(id, 0), ex.num_ids - 1)];
          bool present = false;
          for (int j = 0; j < nr.I && !present; ++j)
            present = __ldg(nr.image_ids + oi + j) == id;
          img_sum = __fadd_rn(img_sum, __fmul_rn(s, present ? 1.0f : 0.0f));
        }
        img_score = image_score(img_sum, sc.max_t[k]);
      }

      // --- outputs -----------------------------------------------------------------
      int b = 0;
      if (live && sc.valid[k]) {
        b = ex.pass_bits;
        if (f_unsched && ex.bit_unsched >= 0) b |= 1 << ex.bit_unsched;
        if (f_name && ex.bit_name >= 0) b |= 1 << ex.bit_name;
        if (f_taint && ex.bit_taint >= 0) b |= 1 << ex.bit_taint;
        if (sa.mask[k][t] && ex.bit_affinity >= 0) b |= 1 << ex.bit_affinity;
        if (f_ports && ex.bit_ports >= 0) b |= 1 << ex.bit_ports;
        if (f_fit && ex.bit_fit >= 0) b |= 1 << ex.bit_fit;
      }
      bits[cnn] = b;
      raw[0 * plane + cnn] = (float)prefer_count;
      raw[1 * plane + cnn] = sa.pref[k][t];
      raw[2 * plane + cnn] = fit_score;
      raw[3 * plane + cnn] = ba_score;
      raw[4 * plane + cnn] = img_score;
    }
  }
}

extern "C" int launch_filter_score(
    int C, int N, int R,
    const void* c_valid, const void* c_request, const void* c_non_zero,
    const void* c_node_name_id, const void* c_tol_valid, const void* c_tol_key,
    const void* c_tol_val, const void* c_tol_op, const void* c_tol_effect,
    const void* c_ports, const void* c_ports_ip, const void* c_image_ids,
    int TT, int PP, int CI,
    const void* node_ready, const void* node_valid, const void* node_name_ids,
    const void* unschedulable, const void* allocatable, const void* requested,
    const void* non_zero, const void* taint_keys, const void* taint_vals,
    const void* taint_effects, const void* ports, const void* ports_ip,
    const void* image_ids, int T, int P, int I,
    const void* na_mask, const void* na_pref, const void* img_scaled, int num_ids,
    const void* fit_w, const void* ba_sel,
    int bit_unsched, int bit_name, int bit_taint, int bit_affinity,
    int bit_ports, int bit_fit, int pass_bits,
    int id_unsched_taint, int id_wildcard_ip,
    int strategy, const void* shape_x, const void* shape_y, int n_shape,
    void* bits, void* raw, void* stream) {
  if (C <= 0 || N <= 0) return 0;
  ClassRows cr{(const uint8_t*)c_valid, (const int32_t*)c_request,
               (const int32_t*)c_non_zero, (const int32_t*)c_node_name_id,
               (const uint8_t*)c_tol_valid, (const int32_t*)c_tol_key,
               (const int32_t*)c_tol_val, (const int32_t*)c_tol_op,
               (const int32_t*)c_tol_effect, (const int32_t*)c_ports,
               (const int32_t*)c_ports_ip, (const int32_t*)c_image_ids,
               TT, PP, CI};
  NodeRows nr{(const uint8_t*)node_ready, (const uint8_t*)node_valid,
              (const int32_t*)node_name_ids, (const uint8_t*)unschedulable,
              (const int32_t*)allocatable, (const int32_t*)requested,
              (const int32_t*)non_zero, (const int32_t*)taint_keys,
              (const int32_t*)taint_vals, (const int32_t*)taint_effects,
              (const int32_t*)ports, (const int32_t*)ports_ip,
              (const int32_t*)image_ids, T, P, I};
  Extra ex{(const uint8_t*)na_mask, (const float*)na_pref,
           (const float*)img_scaled, num_ids, (const float*)fit_w,
           (const uint8_t*)ba_sel, bit_unsched, bit_name, bit_taint,
           bit_affinity, bit_ports, bit_fit, pass_bits, strategy,
           (const float*)shape_x, (const float*)shape_y, n_shape, id_unsched_taint,
           id_wildcard_ip};
  // node tiles of 128 (64 where tiles × classes would not fill two blocks an
  // SM), then class groups up to TARGET_BLOCKS blocks
  int threads = TILE_MAX;
  if ((long long)((N + TILE_MAX - 1) / TILE_MAX) * C < 2 * 132) threads = TILE_MAX / 2;
  const int tiles = (N + threads - 1) / threads;
  int groups = (TARGET_BLOCKS + tiles - 1) / tiles;
  groups = max(1, min(groups, C));
  const int per_group = (C + groups - 1) / groups;
  groups = (C + per_group - 1) / per_group;
  dim3 grid(tiles, groups);
  // one instantiation a strategy: the others' arithmetic is not in the loop
  if (strategy == STRATEGY_MOST)
    filter_score_kernel<STRATEGY_MOST><<<grid, threads, 0, (cudaStream_t)stream>>>(
        C, N, R, per_group, cr, nr, ex, (int32_t*)bits, (float*)raw);
  else if (strategy == STRATEGY_RTCR)
    filter_score_kernel<STRATEGY_RTCR><<<grid, threads, 0, (cudaStream_t)stream>>>(
        C, N, R, per_group, cr, nr, ex, (int32_t*)bits, (float*)raw);
  else
    filter_score_kernel<STRATEGY_LEAST><<<grid, threads, 0, (cudaStream_t)stream>>>(
        C, N, R, per_group, cr, nr, ex, (int32_t*)bits, (float*)raw);
  return (int)cudaGetLastError();
}
