// K23 selector_match: compiled label / node selectors against label sets.
//
// Replaces (JAX package): state/selectors.py requirements_match_matrix
// (:299), label_match_matrix (:345) and node_match_matrix (:357), and with
// them plugins/helpers.py weighted_term_matrix (:35) and
// flat_selector_matrix (:52): requirement sets [U, T, S] (key, op, values
// [V], numeric right-hand side) against objects' label sets [O, L] (keys,
// value ids, numeric values) -> bool[B, O] through the per-pod index.
//
// Rules, exactly those of the plain version:
// - a requirement with op OP_PAD (-1) is true (the AND identity), as is an
//   unknown op code;
// - present = the object has the key (a key < 0 is never present); val = the
//   largest value id among the label columns with the key (keys are unique
//   per object, so at most one column matches), -1 when absent;
// - In: present and val among the values (a value id < 0 never matches);
//   NotIn: absent, or val not among them (an absent key matches);
//   Exists / DoesNotExist: present / absent;
// - Gt / Lt: present and the label's number > / < the right-hand side, in
//   float32; false on NaN (an unparseable value or right-hand side) and on
//   an absent key; the label's number is vals_num when given, else the
//   dictionary's numeric side-table at the value id (NaN for an id < 0);
//   with has_numeric = 0 they are false without reading either;
// - AND over the S requirements of a term;
// - label mode (term_valid null, T = 1): the term's result, false where
//   match_none; node mode: OR over the valid terms (an invalid term matches
//   nothing), true where match_all.
//
// Bound on the card: bytes — the label sets read once, the requirements
// and the index once, the [B, O] result written once (5.2 MB on the
// GangBasic path: 0.00157 ms at 3.35 TB/s, perf/kernel_work.py k23_work);
// the compares stay in registers and shared memory.
//
// Design: one launch a call, no [U, O] matrix in global memory.
//   * The grid is object tiles × chunks of the B result rows, blocks of 256
//     threads: thread t owns object t mod TILE of its tile for the row
//     group t / TILE (TILE 64 or 128).  The plan (kernels/selectors.py
//     ``plan_for``): at most 4 (row, term) items, 128 objects and 256 rows
//     (the GangBasic path's 64 × 2 blocks); at most 32 unique rows, 64
//     objects and every result row (each object evaluated once, 4 row
//     groups); more, 128 objects and 16 rows.
//   * Every load at entry: a thread reads its object's L keys and values
//     (with the numeric side on, their numbers: vals_num, or the side table
//     gathered at the value ids) once, as int4 / float4 where the rows are
//     16-byte aligned, into registers for L <= 16 (label_cap 16,
//     pod_label_cap 8), into shared memory above that.
//   * The rows a block evaluates, in one of three forms the host chooses,
//     each its own instantiation (with all three in one kernel the walk
//     took 17% longer at U = 512 on an H100): every unique row where they fit one
//     stage group (their slots, a row's own index, loaded with them); with
//     no index the chunk's rows themselves; else the chunk's distinct rows
//     — a bitmap of U bits in shared memory (a shared atomicOr a result
//     row) turned by warp 0 into the walk, the rows in increasing order, a
//     slot each.  The first two beat the walk on the rows they serve.  Their requirements (key, op,
//     number, values, term flags, match_all / match_none) are staged into
//     shared memory a group at a time, all loads of a group issued before
//     its stores: one round trip.
//   * The work items are (row, term) pairs, spread over the row groups: an
//     item's verdict is the AND over the term's requirements, each from
//     sixteen independent compares of the key against the labels in
//     registers (the numbers only for Gt / Lt); the op and key are the same
//     for every thread, so no branch diverges.  A warp's 32 verdicts become
//     one ballot word a term; a row's words are the OR of its terms' (none
//     for match_none, all for match_all).
//   * The result written once: a row's bytes of the tile go as 16-byte
//     stores on 16-byte boundaries, 16 objects expanded from the row's
//     ballot words by a multiply; the bytes before the first boundary (a
//     row that does not start on 16 bytes) and after the last (the tail of
//     O) one at a time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define OP_IN 0
#define OP_NOT_IN 1
#define OP_EXISTS 2
#define OP_DOES_NOT_EXIST 3
#define OP_GT 4
#define OP_LT 5
#define OP_PAD (-1)
#define LREG 16
#define FULL_MASK 0xffffffffu
#define THREADS_K 256

struct Reqs {
  const int32_t* key;    // [U, T, S]
  const int32_t* op;     // [U, T, S]
  const int32_t* vals;   // [U, T, S, V]
  const float* num;      // [U, T, S]
  const uint8_t* term_valid;  // [U, T] or null (label mode)
  const uint8_t* match_all;   // [U] or null
  const uint8_t* match_none;  // [U] or null
};

struct Labels {
  const int32_t* keys;   // [O, L]
  const int32_t* vals;   // [O, L]
  const float* vals_num; // [O, L] or null
  const float* numeric;  // [D] or null
  int D;
};

// one object's label set: in registers (REG, L <= 16; columns past L hold
// key -1, never present) or in the block's shared memory, column-major.
// x is the label's number for Gt / Lt (NUM): vals_num, or the side table at
// the value id (NaN for an id < 0), gathered once at entry
template <bool REG>
struct ObjLabels {
  int k[REG ? LREG : 1];
  int v[REG ? LREG : 1];
  float x[REG ? LREG : 1];
  const int* sk;
  const int* sv;
  const float* sx;
  int L, TILE;
};

template <bool REG>
__device__ __forceinline__ void label(const ObjLabels<REG>& ob, int l, int& k, int& v, float& x) {
  if constexpr (REG) {
    k = ob.k[l];
    v = ob.v[l];
    x = ob.x[l];
  } else {
    k = ob.sk[l * ob.TILE];
    v = ob.sv[l * ob.TILE];
    x = ob.sx[l * ob.TILE];
  }
}

// a label's number: vals_num where given, else the side table at the value
// id (NaN for an id < 0)
__device__ __forceinline__ float label_number(const Labels& lb, long long at, int v) {
  if (lb.vals_num != nullptr) return __ldg(lb.vals_num + at);
  return v >= 0 ? __ldg(lb.numeric + min(v, lb.D - 1)) : NAN;
}

// a group of walked rows' requirements, staged in shared memory: TS = T·S
// requirements a row (key, op, number, V values), a row's T term flags and
// its match_all / match_none bits
struct Staged {
  int* key;     // [G][TS]
  int* op;      // [G][TS]
  float* num;   // [G][TS]
  int* vals;    // [G][TS][V]
  uint8_t* tv;  // [G][T]
  uint8_t* fl;  // [G]: 1 match_all, 2 match_none
};

// staged requirement e for this thread's object.  Its op and key are the
// same for every thread of the block, so no branch diverges: the columns
// with the key (present, the largest value id) from sixteen independent
// compares reduced in four accumulators, the values from independent
// loads; the number (Gt / Lt, NUM) only for those ops
template <bool REG, bool NUM>
__device__ __forceinline__ bool requirement_ok(const Staged& st, const ObjLabels<REG>& ob, int V,
                                               int e) {
  const int op = st.op[e];
  if (op == OP_PAD || op < OP_IN || op > OP_LT) return true;
  const int rk = st.key[e];
  bool pa[4] = {false, false, false, false};
  int va[4] = {-1, -1, -1, -1};
  const int n_l = REG ? LREG : ob.L;
#pragma unroll
  for (int l = 0; l < n_l; ++l) {
    int k, v;
    float x;
    label<REG>(ob, l, k, v, x);
    const bool m = k == rk;
    pa[l & 3] |= m;
    va[l & 3] = max(va[l & 3], m ? v : -1);
  }
  const bool present = rk >= 0 && (pa[0] | pa[1] | pa[2] | pa[3]);
  switch (op) {
    case OP_EXISTS:
      return present;
    case OP_DOES_NOT_EXIST:
      return !present;
    case OP_GT:
    case OP_LT: {
      if (!NUM || !present) return false;
      // the largest number of the key's columns, NaN when any is NaN (the
      // plain version's amax)
      float vn = -INFINITY;
#pragma unroll
      for (int l = 0; l < n_l; ++l) {
        int k, v;
        float x;
        label<REG>(ob, l, k, v, x);
        if (k == rk) vn = (isnan(vn) || isnan(x)) ? NAN : fmaxf(vn, x);
      }
      return op == OP_GT ? vn > st.num[e] : vn < st.num[e];
    }
    default:
      break;
  }
  const int val = max(max(va[0], va[1]), max(va[2], va[3]));
  const int* rv = st.vals + (size_t)e * V;
  bool in_vals = false;
  for (int q = 0; q < V; q += 4) {
    bool h = rv[q] == val;
#pragma unroll
    for (int d = 1; d < 4; ++d) h |= q + d < V && rv[q + d] == val;
    in_vals |= h;
  }
  in_vals = in_vals && present && val >= 0;
  return op == OP_IN ? in_vals : !in_vals;
}

// result row b's unique row: index[b] (a negative one wrapped, as torch's),
// or b itself with no index
__device__ __forceinline__ int unique_row(const int32_t* __restrict__ index, int b, int U) {
  int u = index == nullptr ? b : __ldg(index + b);
  return min(max(u < 0 ? u + U : u, 0), U - 1);
}

// stage rows [g0, g0 + ng) of the walk (walk null: the unique rows row0 +
// g0, row0 + g0 + 1, ...) into st, every thread of the block loading: one loop, each
// iteration's loads issued before its stores, so that a group of few rows
// costs one round trip; a row's match flags also kept at its slot.  With
// slots non-null (every unique row staged at once), the chunk's result rows
// get their slot, their unique row, in the same loop.  Ends behind a barrier
__device__ __forceinline__ void stage_rows(const Reqs& r, const Staged& st, const int* walk,
                                           int row0, int g0, int ng, int T, int S, int V,
                                           bool node_mode,
                                           uint8_t* s_flag, int* slots,
                                           const int32_t* __restrict__ index, int b0, int nb,
                                           int U) {
  const int TS = T * S, tid = threadIdx.x;
  auto row = [&](int q) -> long long { return walk == nullptr ? row0 + g0 + q : walk[g0 + q]; };
  int n = max(max(ng * TS * V, ng * TS), max(ng * T, ng));
  if (slots != nullptr) n = max(n, nb);
  for (int e = tid; e < n; e += THREADS_K) {
    const bool req = e < ng * TS, term = node_mode && e < ng * T, whole = e < ng;
    const int qr = req ? e / TS : 0, qv = e < ng * TS * V ? e / (TS * V) : 0;
    const int qt = term ? e / T : 0;
    const long long rs = req ? row(qr) * TS + (e - qr * TS) : 0;
    const int key = req ? __ldg(r.key + rs) : 0;
    const int op = req ? __ldg(r.op + rs) : 0;
    const float num = req ? __ldg(r.num + rs) : 0.0f;
    const int val = e < ng * TS * V ? __ldg(r.vals + row(qv) * TS * V + (e - qv * TS * V)) : 0;
    const uint8_t tv = term ? __ldg(r.term_valid + row(qt) * T + (e - qt * T)) : 0;
    const long long u = whole ? row(e) : 0;
    const int fl = whole ? ((r.match_all != nullptr && __ldg(r.match_all + u) ? 1 : 0) |
                            (r.match_none != nullptr && __ldg(r.match_none + u) ? 2 : 0))
                         : 0;
    const int slot = slots != nullptr && e < nb ? unique_row(index, b0 + e, U) : 0;
    if (req) {
      st.key[e] = key;
      st.op[e] = op;
      st.num[e] = num;
    }
    if (e < ng * TS * V) st.vals[e] = val;
    if (term) st.tv[e] = tv;
    if (whole) {
      st.fl[e] = (uint8_t)fl;
      s_flag[g0 + e] = (uint8_t)fl;
    }
    if (slots != nullptr && e < nb) slots[e] = slot;
  }
  __syncthreads();
}

// the items of staged rows [0, ng): (row q, term t) = item i, q = i / T; the
// row groups take i = rg, rg + R, ...; each item's 32 verdicts of a warp —
// the AND over the term's requirements, none for a term that is not valid
// or a row whose match flags decide it — become one ballot word at
// tw[(slot · T + t) · W + wcol]
template <int TILE, bool REG, bool NUM>
__device__ __forceinline__ void eval_items(const Staged& st, const ObjLabels<REG>& ob, int g0,
                                           int ng, int T, int S, int V, bool node_mode,
                                           uint32_t* s_tw) {
  constexpr int W = TILE / 32, R = THREADS_K / TILE;
  const int tid = threadIdx.x, lane = tid & 31, rg = tid / TILE, wcol = (tid % TILE) >> 5;
  for (int i = rg; i < ng * T; i += R) {
    const int q = i / T, t = i - q * T;
    bool ok = !(st.fl[q] & 3) && (!node_mode || st.tv[i]);
    if (ok) {  // the same for every thread of the block
      const int e0 = i * S;
#pragma unroll 4
      for (int s = 0; s < S; ++s) ok &= requirement_ok<REG, NUM>(st, ob, V, e0 + s);
    }
    const uint32_t bits = __ballot_sync(FULL_MASK, ok);
    if (lane == 0) s_tw[((g0 + q) * T + t) * W + wcol] = bits;
  }
}

// 4 bits -> 4 bytes of 0 / 1, bit e in byte e
__device__ __forceinline__ uint32_t expand4(uint32_t h) {
  return ((h & 0xFu) * 0x00204081u) & 0x01010101u;
}

// 16 of a tile's verdict bits for one row, from bit li on (the row's ballot
// words m[0 .. W))
template <int W>
__device__ __forceinline__ uint32_t bits16(const uint32_t* m, int li) {
  const int w = li >> 5, sh = li & 31;
  uint64_t x = m[w];
  if (w + 1 < W) x |= (uint64_t)m[w + 1] << 32;
  return (uint32_t)(x >> sh) & 0xFFFFu;
}

// walked rows staged a group at a time: as many as 32 KB hold (at least 1,
// at most chunk)
#define STAGE_BYTES (32 * 1024)
static int stage_group(int chunk, int T, int S, int V) {
  const size_t row = (size_t)T * S * (12 + 4 * (size_t)V) + T + 1;
  const size_t g = STAGE_BYTES / row;
  return (int)(g < 1 ? 1 : (g > (size_t)chunk ? chunk : g));
}

// the shared memory's layout, in 4-byte words from smem: need[Uw],
// base[Uw], slot[chunk], walked[chunk], m[chunk][W], tw[chunk][T][W], the
// stage (key, op, num [G·TS], vals [G·TS·V]), then the bytes (flag
// [chunk], tv [G·T], fl [G]), then (labels past 16 columns) keys, values
// and numbers [L][TILE]
struct Layout {
  size_t need, base, slot, walk, m, tw, key, op, num, vals, flag, tv, fl, labels, words;
};

static Layout layout(int U, int chunk, int tile, int L, int T, int S, int V) {
  Layout y;
  const size_t uw = (size_t)(U + 31) / 32, G = stage_group(chunk, T, S, V);
  const size_t TS = (size_t)T * S, W = tile / 32;
  size_t at = 0;
  y.need = at; at += uw;
  y.base = at; at += uw;
  y.slot = at; at += chunk;
  y.walk = at; at += chunk;
  y.m = at; at += (size_t)chunk * W;
  y.tw = at; at += (size_t)chunk * T * W;
  y.key = at; at += G * TS;
  y.op = at; at += G * TS;
  y.num = at; at += G * TS;
  y.vals = at; at += G * TS * V;
  y.flag = at * 4;
  y.tv = y.flag + chunk;
  y.fl = y.tv + G * T;
  at += (chunk + G * T + G + 3) / 4;
  y.labels = at;
  if (L > LREG) at += (size_t)3 * L * tile;
  y.words = at;
  return y;
}

// how a block finds its rows (FORM, chosen on the host: each form its own
// instantiation, so that one form's registers do not weigh on another's)
#define FORM_ALL 0   // every unique row staged at entry (U <= G, U <= chunk)
#define FORM_SELF 1  // no index: the chunk's result rows, each its own slot
#define FORM_WALK 2  // the chunk's distinct rows by a bitmap walk

// grid: (object tiles, chunks of result rows); THREADS_K threads, TILE
// objects: thread t takes object t mod TILE for the row group t / TILE
template <int TILE, bool REG, bool NUM, int FORM>
__global__ void __launch_bounds__(THREADS_K) selector_match_kernel(
    int U, int T, int S, int V, int O, int L, int B, int chunk, int G, int vec4, const Layout y,
    Reqs r, Labels lb, const int32_t* __restrict__ index, uint8_t* __restrict__ out) {
  constexpr int W = TILE / 32;
  extern __shared__ uint32_t smem[];
  __shared__ int s_count;
  const int Uw = (U + 31) >> 5;
  uint32_t* s_need = smem + y.need;        // [Uw] the chunk's rows, a bitmap
  int* s_base = (int*)smem + y.base;       // [Uw] walked rows before word w
  int* s_slot = (int*)smem + y.slot;       // [chunk] a result row's unique row, then slot
  int* s_walk = (int*)smem + y.walk;       // [chunk] a slot's unique row
  uint32_t* s_m = smem + y.m;              // [chunk][W] a row's ballot words
  uint32_t* s_tw = smem + y.tw;            // [chunk][T][W] a term's
  uint8_t* s_flag = (uint8_t*)smem + y.flag;  // [chunk] a slot's match flags
  Staged st;
  st.key = (int*)smem + y.key;
  st.op = (int*)smem + y.op;
  st.num = (float*)smem + y.num;
  st.vals = (int*)smem + y.vals;
  st.tv = (uint8_t*)smem + y.tv;
  st.fl = (uint8_t*)smem + y.fl;
  const int tid = threadIdx.x, lane = tid & 31;
  const int to = tid % TILE, rg = tid / TILE;
  const int o0 = blockIdx.x * TILE, o = o0 + to;
  const int b0 = blockIdx.y * chunk, nb = min(chunk, B - b0);
  const bool node_mode = r.term_valid != nullptr;

  // --- every load at entry: the object's label set (its numbers gathered
  // too, NUM) --------------------------------------------------------------
  ObjLabels<REG> ob;
  ob.L = L;
  ob.TILE = TILE;
  const long long base = (long long)o * L;
  if constexpr (REG) {
#pragma unroll
    for (int q = 0; q < LREG / 4; ++q) {
      if (vec4 && 4 * q < L && o < O) {
        const int4 kv = __ldg(reinterpret_cast<const int4*>(lb.keys + base) + q);
        const int4 vv = __ldg(reinterpret_cast<const int4*>(lb.vals + base) + q);
        ob.k[4 * q] = kv.x; ob.k[4 * q + 1] = kv.y; ob.k[4 * q + 2] = kv.z; ob.k[4 * q + 3] = kv.w;
        ob.v[4 * q] = vv.x; ob.v[4 * q + 1] = vv.y; ob.v[4 * q + 2] = vv.z; ob.v[4 * q + 3] = vv.w;
        if (NUM && lb.vals_num != nullptr) {
          const float4 xv = __ldg(reinterpret_cast<const float4*>(lb.vals_num + base) + q);
          ob.x[4 * q] = xv.x; ob.x[4 * q + 1] = xv.y; ob.x[4 * q + 2] = xv.z;
          ob.x[4 * q + 3] = xv.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ob.x[4 * q + e] = NUM ? label_number(lb, base + 4 * q + e, ob.v[4 * q + e]) : NAN;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int l = 4 * q + e;
          const bool in = l < L && o < O;
          ob.k[l] = in ? __ldg(lb.keys + base + l) : -1;
          ob.v[l] = in ? __ldg(lb.vals + base + l) : -1;
          ob.x[l] = NUM && in ? label_number(lb, base + l, ob.v[l]) : NAN;
        }
      }
    }
  } else {
    int* sk = (int*)smem + y.labels;
    int* sv = sk + (size_t)L * TILE;
    float* sx = (float*)(sv + (size_t)L * TILE);
    if (rg == 0)  // read after the barrier that ends the first staging
      for (int l = 0; l < L; ++l) {
        const bool in = o < O;
        const int v = in ? __ldg(lb.vals + base + l) : -1;
        sk[l * TILE + to] = in ? __ldg(lb.keys + base + l) : -1;
        sv[l * TILE + to] = v;
        sx[l * TILE + to] = NUM && in ? label_number(lb, base + l, v) : NAN;
      }
    ob.sk = sk + to;
    ob.sv = sv + to;
    ob.sx = sx + to;
  }

  int n_slots;
  if constexpr (FORM == FORM_ALL) {
    // --- few unique rows: all of them staged at entry beside the label
    // loads, with the result rows' slots (a row's slot its own index) ------
    stage_rows(r, st, nullptr, 0, 0, U, T, S, V, node_mode, s_flag, s_slot, index, b0, nb, U);
    eval_items<TILE, REG, NUM>(st, ob, 0, U, T, S, V, node_mode, s_tw);
    n_slots = U;
  } else if constexpr (FORM == FORM_SELF) {
    // --- no index: the chunk's result rows are the unique rows b0, b0 + 1,
    // ..., each its own slot, staged G at a time -------------------------
    for (int j = tid; j < nb; j += THREADS_K) s_slot[j] = j;
    for (int g0 = 0; g0 < nb; g0 += G) {
      const int ng = min(G, nb - g0);
      stage_rows(r, st, nullptr, b0, g0, ng, T, S, V, node_mode, s_flag, nullptr, index, b0, nb,
                 U);
      eval_items<TILE, REG, NUM>(st, ob, g0, ng, T, S, V, node_mode, s_tw);
      __syncthreads();
    }
    n_slots = nb;
  } else {
    for (int w = tid; w < Uw; w += THREADS_K) s_need[w] = 0;
    __syncthreads();
    for (int j = tid; j < nb; j += THREADS_K) {
      const int u = unique_row(index, b0 + j, U);
      s_slot[j] = u;
      atomicOr(s_need + (u >> 5), 1u << (u & 31));
    }
    __syncthreads();

    // --- the chunk's distinct rows in increasing order, a slot each (warp
    // 0: the bitmap's words in runs of 32, their counts scanned by
    // shuffles) ------------------------------------------------------------
    if (tid < 32) {
      int run = 0;
      for (int w0 = 0; w0 < Uw; w0 += 32) {
        const int w = w0 + lane;
        const uint32_t word = w < Uw ? s_need[w] : 0u;
        const int c = __popc(word);
        int inc = c;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int v = __shfl_up_sync(FULL_MASK, inc, off);
          if (lane >= off) inc += v;
        }
        int at = run + inc - c;
        if (w < Uw) s_base[w] = at;
        for (uint32_t x = word; x; x &= x - 1) s_walk[at++] = (w << 5) + __ffs(x) - 1;
        run += __shfl_sync(FULL_MASK, inc, 31);
      }
      if (lane == 0) s_count = run;
    }
    __syncthreads();
    for (int j = tid; j < nb; j += THREADS_K) {
      const int u = s_slot[j];
      s_slot[j] = s_base[u >> 5] + __popc(s_need[u >> 5] & ((1u << (u & 31)) - 1u));
    }

    // --- the walked rows, G at a time: staged, then their items ----------
    n_slots = s_count;
    for (int g0 = 0; g0 < n_slots; g0 += G) {
      const int ng = min(G, n_slots - g0);
      stage_rows(r, st, s_walk, 0, g0, ng, T, S, V, node_mode, s_flag, nullptr, index, b0, nb,
                 U);
      eval_items<TILE, REG, NUM>(st, ob, g0, ng, T, S, V, node_mode, s_tw);
      __syncthreads();
    }
  }
  __syncthreads();

  // --- a row's ballot words: the OR of its terms' (match_none none,
  // match_all all) -------------------------------------------------------------
  for (int e = tid; e < n_slots * W; e += THREADS_K) {
    const int q = e / W, w = e - q * W, fl = s_flag[q];
    uint32_t word = 0;
    for (int t = 0; t < T; ++t) word |= s_tw[(q * T + t) * W + w];
    s_m[e] = (fl & 2) ? 0u : (fl & 1) ? ~0u : word;
  }
  __syncthreads();

  // --- the result, written once.  A row's bytes of this tile, [o0, o_end),
  // go as 16-byte stores on 16-byte boundaries, each 16 objects expanded
  // from the row's ballot words; the bytes before the first boundary (a row
  // that does not start on 16 bytes) and after the last (the tail of O) one
  // at a time -------------------------------------------------------------------
  const int o_end = min(o0 + TILE, O);
  constexpr int SEGS = TILE / 16 + 2;  // the 16-byte stores of a row, its head, its tail
  for (int q = tid; q < nb * SEGS; q += THREADS_K) {
    const int j = q / SEGS, seg = q - j * SEGS;
    uint8_t* row = out + (size_t)(b0 + j) * O;
    const uint32_t* m = s_m + s_slot[j] * W;
    const int head = min((int)((16u - ((uintptr_t)(row + o0) & 15u)) & 15u), o_end - o0);
    const int n16 = (o_end - o0 - head) / 16;
    if (seg < n16) {
      const int li = head + 16 * seg;
      const uint32_t h = bits16<W>(m, li);
      uint4 v;
      v.x = expand4(h);
      v.y = expand4(h >> 4);
      v.z = expand4(h >> 8);
      v.w = expand4(h >> 12);
      *reinterpret_cast<uint4*>(row + o0 + li) = v;
    } else if (seg >= SEGS - 2) {
      const int lo = seg == SEGS - 2 ? 0 : head + 16 * n16;
      const int hi = seg == SEGS - 2 ? head : o_end - o0;
      for (int li = lo; li < hi; ++li) row[o0 + li] = (uint8_t)((m[li >> 5] >> (li & 31)) & 1u);
    }
  }
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <int TILE, bool REG, bool NUM>
static int launch_tile(int U, int T, int S, int V, int O, int L, int B, int chunk, int vec4,
                       const Reqs& r, const Labels& lb, const int32_t* index, uint8_t* out,
                       cudaStream_t stream) {
  using Kernel = void (*)(int, int, int, int, int, int, int, int, int, int, const Layout, Reqs,
                          Labels, const int32_t*, uint8_t*);
  static const Kernel forms[3] = {selector_match_kernel<TILE, REG, NUM, FORM_ALL>,
                                  selector_match_kernel<TILE, REG, NUM, FORM_SELF>,
                                  selector_match_kernel<TILE, REG, NUM, FORM_WALK>};
  const int G = stage_group(chunk, T, S, V);
  const int form = U <= G && U <= chunk ? FORM_ALL : index == nullptr ? FORM_SELF : FORM_WALK;
  const Layout y = layout(U, chunk, TILE, L, T, S, V);
  const size_t smem = 4 * y.words;
  if (smem > 48 * 1024) {
    static int set[3] = {0, 0, 0};  // the cap raised once for each instantiation
    if (smem > (size_t)set[form]) {
      cudaError_t e = cudaFuncSetAttribute(forms[form],
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return (int)e;
      set[form] = (int)smem;
    }
  }
  const dim3 grid((unsigned)((O + TILE - 1) / TILE), (unsigned)((B + chunk - 1) / chunk));
  forms[form]<<<grid, THREADS_K, smem, stream>>>(U, T, S, V, O, L, B, chunk, G, vec4, y, r, lb,
                                                 index, out);
  return (int)cudaGetLastError();
}

template <int TILE>
static int launch_plan(bool reg, bool num, int U, int T, int S, int V, int O, int L, int B,
                       int chunk, int vec4, const Reqs& r, const Labels& lb,
                       const int32_t* index, uint8_t* out, cudaStream_t stream) {
  const auto go = reg ? (num ? launch_tile<TILE, true, true> : launch_tile<TILE, true, false>)
                      : (num ? launch_tile<TILE, false, true> : launch_tile<TILE, false, false>);
  return go(U, T, S, V, O, L, B, chunk, vec4, r, lb, index, out, stream);
}

// tile: 64 or 128 objects a block; chunk: result rows a block (>= 1)
extern "C" int launch_selector_match(int U, int T, int S, int V, int O, int L, int B,
                                     int has_numeric, const void* req_key,
                                     const void* req_op, const void* req_vals,
                                     const void* req_num, const void* term_valid,
                                     const void* match_all, const void* match_none,
                                     const void* keys, const void* vals,
                                     const void* vals_num, const void* numeric, int D,
                                     const void* index, void* out, int tile, int chunk,
                                     void* stream) {
  if (U <= 0 || O <= 0 || B <= 0) return 0;
  if ((tile != 64 && tile != 128) || chunk <= 0 || L < 0)
    return (int)cudaErrorInvalidValue;
  Reqs r{(const int32_t*)req_key, (const int32_t*)req_op, (const int32_t*)req_vals,
         (const float*)req_num, (const uint8_t*)term_valid, (const uint8_t*)match_all,
         (const uint8_t*)match_none};
  Labels lb{(const int32_t*)keys, (const int32_t*)vals, (const float*)vals_num,
            (const float*)numeric, D};
  // int4 / float4 label loads where every object's row starts on 16 bytes
  const int vec4 = L % 4 == 0 && aligned16(keys) && aligned16(vals) &&
                   (vals_num == nullptr || aligned16(vals_num));
  // the smaller tile where the larger's shared memory does not fit
  if (tile == 128 && 4 * layout(U, chunk, tile, L, T, S, V).words > 227 * 1024) tile = 64;
  const auto go = tile == 128 ? launch_plan<128> : launch_plan<64>;
  return go(L <= LREG, has_numeric != 0, U, T, S, V, O, L, B, chunk, vec4, r, lb,
            (const int32_t*)index, (uint8_t*)out, (cudaStream_t)stream);
}
