// K1 filter_score_planes: the per-plugin filter bits and raw score planes of
// the identity-class dedup cycle, one thread per (class, node).
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
// Bound on the card: bytes.  Each thread reads its node's rows (~350 B at
// R = T = P = I = 8) and writes 24 B; the arithmetic is a few hundred
// scalar operations.  Design: nodes are the fast grid axis, so one warp
// reads 32 consecutive node rows; the class row (≤ a few hundred bytes) is
// read through the L1/L2 cache by every thread of the row.  The numerics
// repeat the reference's float32 operation order exactly: the library is
// built with --fmad=false -prec-div=true -prec-sqrt=true, so no multiply
// is contracted into an add and every division and square root is
// correctly rounded; the floors then land where the reference's do.
//
// Fit's score follows the profile's scoring strategy (a switch on
// Extra.strategy): LeastAllocated floor((alloc - total) * 100 / alloc),
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
  const uint8_t* live;           // [N] node_valid & node_ready
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
  int strategy;               // Fit's scoring strategy (STRATEGY_*)
  const float* shape_x;       // [S] RequestedToCapacityRatio utilization points
  const float* shape_y;       // [S] their scores (x 10)
  int n_shape;
  // dictionary ids (state/dictionary.py): the node.kubernetes.io/unschedulable
  // taint key and the 0.0.0.0 host IP
  int id_unsched_taint, id_wildcard_ip;
};

__device__ __forceinline__ bool tolerates(const ClassRows& cr, int c, int j,
                                          int tk, int tv, int te) {
  const int o = c * cr.TT + j;
  if (!cr.tol_valid[o]) return false;
  const int pk = cr.tol_key[o];
  const int pe = cr.tol_effect[o];
  const bool key_ok = (pk == MISSING) || (pk == tk);
  const bool effect_ok = (pe == -1) || (pe == te);
  const bool value_ok = (cr.tol_op[o] == TOL_OP_EXISTS) || (cr.tol_val[o] == tv);
  return key_ok && effect_ok && value_ok;
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
  float f = dx0 ? fp[i - 1] : __fmaf_rn(__fdiv_rn(delta, dx), df, fp[i - 1]);
  if (x < xp[0]) f = fp[0];
  if (x > xp[S - 1]) f = fp[S - 1];
  return f;
}

__global__ void filter_score_kernel(int C, int N, int R, ClassRows cr,
                                    NodeRows nr, Extra ex, int32_t* bits,
                                    float* raw) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (n >= N || c >= C) return;
  const long long cn = (long long)c * N + n;
  const long long plane = (long long)C * N;

  // --- NodeUnschedulable -----------------------------------------------------
  bool tol_unsched = false;
  for (int j = 0; j < cr.TT; ++j) {
    const int o = c * cr.TT + j;
    const int pk = cr.tol_key[o];
    const int pe = cr.tol_effect[o];
    if (cr.tol_valid[o] && (pk == MISSING || pk == ex.id_unsched_taint) &&
        (pe == -1 || pe == 0) && cr.tol_op[o] == TOL_OP_EXISTS)
      tol_unsched = true;
  }
  const bool f_unsched = !nr.unschedulable[n] || tol_unsched;

  // --- NodeName --------------------------------------------------------------
  const int nid = cr.node_name_id[c];
  const bool f_name = (nid == MISSING) || (nid == nr.node_name_ids[n]);

  // --- TaintToleration filter + score -----------------------------------------
  bool f_taint = true;
  int prefer_count = 0;
  for (int t = 0; t < nr.T; ++t) {
    const int o = n * nr.T + t;
    const int te = nr.taint_effects[o];
    const int tk = nr.taint_keys[o];
    const int tv = nr.taint_vals[o];
    if (te == 0 || te == 2) {  // NoSchedule / NoExecute
      bool tol = false;
      for (int j = 0; j < cr.TT; ++j) tol = tol || tolerates(cr, c, j, tk, tv, te);
      if (!tol) f_taint = false;
    }
    if (te == 1) {  // PreferNoSchedule: only effect "" / PreferNoSchedule tolerations
      bool tol = false;
      for (int j = 0; j < cr.TT; ++j) {
        const int pe = cr.tol_effect[c * cr.TT + j];
        if (pe == -1 || pe == 1) tol = tol || tolerates(cr, c, j, tk, tv, te);
      }
      if (!tol) prefer_count += 1;
    }
  }

  // --- NodePorts (wildcard-IP conflict rule) -----------------------------------
  bool f_ports = true;
  for (int i = 0; i < cr.PP; ++i) {
    const int pp = cr.ports[c * cr.PP + i];
    if (pp == MISSING) continue;
    const int pip = cr.ports_ip[c * cr.PP + i];
    for (int j = 0; j < nr.P; ++j) {
      const int np_ = nr.ports[n * nr.P + j];
      const int nip = nr.ports_ip[n * nr.P + j];
      if (np_ == pp && (pip == nip || pip == ex.id_wildcard_ip || nip == ex.id_wildcard_ip))
        f_ports = false;
    }
  }

  // --- Fit filter + the strategy's score; BalancedAllocation -------------------
  bool f_fit = true;
  float wsum = 0.0f, wscore = 0.0f;
  float ba_sum = 0.0f;
  int ba_n = 0;
  for (int r = 0; r < R; ++r) {
    const int req = cr.request[c * R + r];
    const int al = nr.allocatable[n * R + r];
    const int rq = nr.requested[n * R + r];
    if (!(req == 0 || req <= al - rq)) f_fit = false;

    const float alloc = (float)al;
    float nz_node = (float)rq, nz_pod = (float)req;
    if (r == DIM_CPU) {
      nz_node = (float)nr.non_zero[n * 2 + 0];
      nz_pod = (float)cr.non_zero[c * 2 + 0];
    } else if (r == DIM_MEMORY) {
      nz_node = (float)nr.non_zero[n * 2 + 1];
      nz_pod = (float)cr.non_zero[c * 2 + 1];
    }
    const float total = __fadd_rn(nz_node, nz_pod);
    float per_dim = 0.0f;
    if (ex.strategy == STRATEGY_RTCR) {
      const float util =
          (alloc == 0.0f)
              ? MAX_NODE_SCORE
              : __fmul_rn(fminf(__fdiv_rn(total, fmaxf(alloc, 1.0f)), 1.0f), MAX_NODE_SCORE);
      per_dim = rtcr_interp(util, ex.shape_x, ex.shape_y, ex.n_shape);
    } else if (!(alloc == 0.0f || total > alloc)) {
      const float num = (ex.strategy == STRATEGY_MOST)
                            ? __fmul_rn(total, MAX_NODE_SCORE)
                            : __fmul_rn(__fsub_rn(alloc, total), MAX_NODE_SCORE);
      per_dim = floorf(__fdiv_rn(num, fmaxf(alloc, 1.0f)));
    }
    const float w = ex.fit_w[r];
    const bool ext_ok = (r < NUM_BASE_DIMS) || (req > 0);
    const bool fit_inc = (w > 0.0f) && (alloc > 0.0f) && ext_ok;
    wsum = __fadd_rn(wsum, fit_inc ? w : 0.0f);
    wscore = __fadd_rn(wscore, fit_inc ? __fmul_rn(per_dim, w) : 0.0f);

    const bool ba_inc = ex.ba_sel[r] && (alloc > 0.0f) && ext_ok;
    if (ba_inc) {
      const float frac = fminf(__fdiv_rn((float)(rq + req), fmaxf(alloc, 1.0f)), 1.0f);
      ba_sum = __fadd_rn(ba_sum, frac);
      ba_n += 1;
    }
  }
  const float fit_score =
      (wsum == 0.0f) ? 0.0f : floorf(__fdiv_rn(wscore, fmaxf(wsum, 1.0f)));
  float ba_score = 0.0f;
  if (ba_n > 0) {
    const float denom = (float)ba_n;
    const float mean = __fdiv_rn(ba_sum, denom);
    float var = 0.0f;
    for (int r = 0; r < R; ++r) {
      const int req = cr.request[c * R + r];
      const int al = nr.allocatable[n * R + r];
      const float alloc = (float)al;
      const bool ext_ok = (r < NUM_BASE_DIMS) || (req > 0);
      if (ex.ba_sel[r] && (alloc > 0.0f) && ext_ok) {
        const int rq = nr.requested[n * R + r];
        const float frac = fminf(__fdiv_rn((float)(rq + req), fmaxf(alloc, 1.0f)), 1.0f);
        const float d = __fsub_rn(frac, mean);
        var = __fadd_rn(var, __fmul_rn(d, d));
      }
    }
    const float sd = __fsqrt_rn(__fdiv_rn(var, denom));
    ba_score = __fmul_rn(__fsub_rn(1.0f, sd), MAX_NODE_SCORE);
  }

  // --- ImageLocality -----------------------------------------------------------
  float img_sum = 0.0f;
  int num_containers = 0;
  const bool nvalid = nr.node_valid[n];
  for (int k = 0; k < cr.CI; ++k) {
    const int id = cr.image_ids[c * cr.CI + k];
    if (id == MISSING) continue;
    num_containers += 1;
    bool present = false;
    for (int i = 0; i < nr.I; ++i) {
      const int img = nr.image_ids[n * nr.I + i];
      if (img == id && nvalid) present = true;
    }
    const int safe = min(max(id, 0), ex.num_ids - 1);
    img_sum = __fadd_rn(img_sum, __fmul_rn(ex.img_scaled[safe], present ? 1.0f : 0.0f));
  }
  const long long mt = (long long)max(num_containers, 1) * MAX_CONTAINER_THRESHOLD;
  const float max_t = (float)(int32_t)(uint32_t)(mt & 0xffffffffLL);
  const float clamped = fminf(fmaxf(img_sum, MIN_THRESHOLD), max_t);
  const float img_score = __fdiv_rn(
      __fmul_rn(MAX_NODE_SCORE, __fsub_rn(clamped, MIN_THRESHOLD)),
      __fsub_rn(max_t, MIN_THRESHOLD));

  // --- outputs -------------------------------------------------------------------
  int b = 0;
  if (nr.live[n] && cr.valid[c]) {
    b = ex.pass_bits;
    if (f_unsched && ex.bit_unsched >= 0) b |= 1 << ex.bit_unsched;
    if (f_name && ex.bit_name >= 0) b |= 1 << ex.bit_name;
    if (f_taint && ex.bit_taint >= 0) b |= 1 << ex.bit_taint;
    if (ex.na_mask[cn] && ex.bit_affinity >= 0) b |= 1 << ex.bit_affinity;
    if (f_ports && ex.bit_ports >= 0) b |= 1 << ex.bit_ports;
    if (f_fit && ex.bit_fit >= 0) b |= 1 << ex.bit_fit;
  }
  bits[cn] = b;
  raw[0 * plane + cn] = (float)prefer_count;
  raw[1 * plane + cn] = ex.na_pref[cn];
  raw[2 * plane + cn] = fit_score;
  raw[3 * plane + cn] = ba_score;
  raw[4 * plane + cn] = img_score;
}

extern "C" int launch_filter_score(
    int C, int N, int R,
    const void* c_valid, const void* c_request, const void* c_non_zero,
    const void* c_node_name_id, const void* c_tol_valid, const void* c_tol_key,
    const void* c_tol_val, const void* c_tol_op, const void* c_tol_effect,
    const void* c_ports, const void* c_ports_ip, const void* c_image_ids,
    int TT, int PP, int CI,
    const void* live, const void* node_valid, const void* node_name_ids,
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
  ClassRows cr{(const uint8_t*)c_valid, (const int32_t*)c_request,
               (const int32_t*)c_non_zero, (const int32_t*)c_node_name_id,
               (const uint8_t*)c_tol_valid, (const int32_t*)c_tol_key,
               (const int32_t*)c_tol_val, (const int32_t*)c_tol_op,
               (const int32_t*)c_tol_effect, (const int32_t*)c_ports,
               (const int32_t*)c_ports_ip, (const int32_t*)c_image_ids,
               TT, PP, CI};
  NodeRows nr{(const uint8_t*)live, (const uint8_t*)node_valid,
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
  const int threads = 256;
  dim3 grid((N + threads - 1) / threads, C);
  filter_score_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      C, N, R, cr, nr, ex, (int32_t*)bits, (float*)raw);
  return (int)cudaGetLastError();
}
