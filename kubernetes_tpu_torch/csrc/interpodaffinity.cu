// K9–K12: InterPodAffinity's count planes and tables for the identity-class
// dedup cycle (and, at identity classes, the full auction); K15: their
// deep-pipeline chain hook; K19: the exact scan's per-pod update.
//
// Replaces (JAX package): plugins/interpodaffinity.py prepare (:197-333,
// with _counts :166-195), filter (:337-364), score (:368-385) + normalize
// (:387-398), update_batch_classes (:676-764), update_batch (:766-864),
// chain_prev (:533-670) and update (:447-530),
// with the ops/segment.py domain gather and scatter-add (:27-97) they are
// built on.
//
// Count state per term group: planes [C, T, N] (the count of matching pods
// in each node's domain) or tables [C, T, D1] (per domain, D1 = D + 1 with
// the trash slot D of nodes without the key); dom [C, T, N] holds each
// node's domain under each term's key, D for an invalid term.  A count
// tensor is a plane exactly when its width is N.
//
// K9 ipa_prepare (three launch functions of this file, one per pass):
//   count:    one thread per (term row, scheduled pod); an integer atomic
//             adds each matching placed pod to its node's domain (the
//             reference builds the same counts through a [C·T, P] × [P, N]
//             matmul against a pod→node one-hot, 268 MB of float32 at
//             P = N = 8192).  Bound: bytes (the match plane read once).
//   gather:   one thread per (term row, node): the table at the node's
//             domain, for the planes form.  Bound: bytes.
//   existing: one thread per (class row, node) over the G index groups:
//             the owner count at the node's domain under the group's key;
//             a matched BLOCK group with an owner blocks, the others add
//             weight · count.  Bound: bytes (node_topo and the planes).
// K10 ipa_filter: one thread per (class row, node); clears the filter's bit
//   of K1's pass-bit plane in place.  Bound: bytes.
// K11 ipa_score: one block per class row, two sweeps: the raw score's max
//   and min over the feasible nodes, then the normalized, floored, weighted
//   score added into K2's total.  Bound: bytes — at C = 4 the four blocks
//   leave the card idle.
// K12 ipa_update: one launch per present term group, one block per
//   (term row) in two halves.  A count row (pending class c, term t) folds
//   the round's matching commits into a shared-memory domain delta and adds
//   it to its table, or to its plane over the nodes of those domains.  A
//   committer row (class k, term t) folds class k's commits the same way
//   and, on every node of a committed domain, ORs the block (required
//   anti-affinity) or adds ±weight · commits into the score of each class
//   its term matches (float atomics of integer values: exact in any order).
//   O(commits · C · T + C · T · N) against the reference's O(C · T · N)
//   one-hot contractions.  Bound: latency (one commit a round on the
//   preferred-affinity suite).
// K15 ipa_chain_prev: a still-in-flight batch's placements folded into this
//   batch's state before the rounds (deep pipeline), in two launch functions:
//   count: one launch per present term group of this batch, one block per
//             term row (c, t): the placed prev pods its term matches fold
//             into a shared-memory domain delta at their node's domain,
//             added to the row's table, or to its plane over the nodes of
//             those domains, and (required affinity) into aff_total.  Nodes
//             without the key count nowhere (the reference zeroes the trash
//             slot).  The reference builds a [B0, N] placement one-hot and
//             contracts it; the node row is read directly here.
//   own:   one launch per term group the prev batch carries with a valid
//             term, one block per prev term (j, t): the term's RAW topology
//             value at the prev pod's node (no domain bucketing, so batches
//             with other domain buckets chain exactly), then every node with
//             that value blocks (required anti-affinity) or gains ±weight in
//             the score of each class row the term matches.  Float atomics
//             of integer values: exact in any order below 2^24.
//   Bound: latency for count (≤ B0 pods a row); bytes for own (node_topo's
//   key column read once per placed prev term).
//
// K19 ipa_update_row: the scan's step update (update, :447-530) — pod i
//   placed on the node K17 wrote to node_row[i] (read on the card; < 0: no
//   change, and every block exits after that one read), at full-batch rows
//   B, both count forms, every present term group in one launch.  Bound:
//   bytes — the domain rows of j's count terms that gain pod i (planes),
//   pod i's own domain rows, and score_dyn / block_dyn only where one of pod
//   i's terms matches j, on the nodes of that term's domain.
//   Design.  A block owns a tile of 4096 nodes (256 threads, four 16-byte
//   vectors each) for a run of R pending rows, R set for about four blocks
//   an SM (R = 2 at B = 512, N = 8192: 256 blocks; picked over 1 and 4
//   rows and 2048-node tiles by timing them on the H100, PERF.md):
//   * flags first: one thread per (row, term) reads the few bytes of row j
//     — whether j's term gains pod i (i matches it, every one of j's terms
//     for required affinity, and pod i's node has the key) and at which
//     domain, and whether pod i's term matches j.  The tables form's point
//     add and the keyed required terms' aff_total mass are done there, once,
//     by the first tile's blocks: one thread per (j, t), no node loop;
//   * pod i's rows once a block: for each of its terms, which of the
//     thread's nodes share the domain of pod i's node, staged in shared
//     memory (one bit per (term, node));
//   * the walk: a row with no flag costs its flag bytes; the planes form's
//     compare-add streams only the count rows that gain pod i (every vector
//     loaded before any is used, the counts read and written only in
//     vectors holding the domain); block_dyn and score_dyn are touched only
//     in rows that one of pod i's terms matches, on the vectors holding
//     nodes of its domain (one vector a row on a hostname step).
//   Exactness: each (j, t, n) cell has one writer, no atomics on the planes;
//   the score adds + hardPodAffinityWeight per required-affinity term, then
//   + the preferred-affinity weights, then − the preferred anti-affinity
//   weights, each group's plane summed in term order, with __fadd_rn /
//   __fsub_rn (integer-valued f32 below 2^24).  The reference rewrites the
//   same [B, T, N] planes with one-hot compares.
//
// Numerics (built with --fmad=false): every score term is an integer-valued
// float32 below 2^24, so sums are exact in any order; the normalization is
// __fdiv_rn(__fmul_rn(100, s − min), max − min), in the reference's order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_NODE_SCORE 100.0f
#define KIND_BLOCK 0
#define KIND_SCORE_REQ 2
#define GROUP_REQ_AFF 0
#define GROUP_REQ_ANTI 1

// --- block reductions (blockDim.x a multiple of 32, at most 1024) ---------------

__device__ __forceinline__ int block_sum_int(int v, int* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffff, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int r = 0;
    for (int w = 0; w < (int)(blockDim.x / 32); ++w) r += scratch[w];
    scratch[0] = r;
  }
  __syncthreads();
  return scratch[0];
}

__device__ __forceinline__ float block_max_float(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffff, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = scratch[0];
    for (int w = 1; w < (int)(blockDim.x / 32); ++w) r = fmaxf(r, scratch[w]);
    scratch[0] = r;
  }
  __syncthreads();
  return scratch[0];
}

__device__ __forceinline__ float block_min_float(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_down_sync(0xffffffff, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = scratch[0];
    for (int w = 1; w < (int)(blockDim.x / 32); ++w) r = fminf(r, scratch[w]);
    scratch[0] = r;
  }
  __syncthreads();
  return scratch[0];
}

// --- K9, count pass ---------------------------------------------------------------

#define COUNT_THREADS 256

__global__ void __launch_bounds__(COUNT_THREADS) ipa_count_kernel(
    int C, int T, int P, int N, int D1,
    const uint8_t* __restrict__ match,     // [C, T, P]
    const int32_t* __restrict__ pod_node,  // [P]
    const uint8_t* __restrict__ pod_valid, // [P]
    const int32_t* __restrict__ dom,       // [C, T, N]
    int32_t* __restrict__ tbl,             // [C, T, D1]
    int32_t* __restrict__ total) {         // [C]
  __shared__ int scratch[COUNT_THREADS / 32];
  const int row = blockIdx.y;  // c * T + t
  const int c = row / T;
  const int D = D1 - 1;
  int mass = 0;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P; p += gridDim.x * blockDim.x) {
    if (!match[(long long)row * P + p] || !pod_valid[p]) continue;
    int n = pod_node[p];
    if (n < 0) continue;
    if (n > N - 1) n = N - 1;  // the reference clips the pod's node row
    const int dv = dom[(long long)row * N + n];
    atomicAdd(&tbl[(long long)row * D1 + dv], 1);
    if (dv < D) mass += 1;
  }
  mass = block_sum_int(mass, scratch);
  if (threadIdx.x == 0 && mass) atomicAdd(&total[c], mass);
}

extern "C" int launch_ipa_count(int C, int T, int P, int N, int D1, const void* match,
                                const void* pod_node, const void* pod_valid,
                                const void* dom, void* tbl, void* total, void* stream) {
  if (C <= 0 || T <= 0 || P <= 0) return 0;
  long long blocks = ((long long)P + COUNT_THREADS - 1) / COUNT_THREADS;
  if (blocks > 256) blocks = 256;
  dim3 grid((unsigned)blocks, C * T);
  ipa_count_kernel<<<grid, COUNT_THREADS, 0, (cudaStream_t)stream>>>(
      C, T, P, N, D1, (const uint8_t*)match, (const int32_t*)pod_node,
      (const uint8_t*)pod_valid, (const int32_t*)dom, (int32_t*)tbl, (int32_t*)total);
  return (int)cudaGetLastError();
}

// --- K9, gather pass (planes) -----------------------------------------------------------

__global__ void ipa_gather_kernel(long long total, int N, int D1,
                                  const int32_t* __restrict__ tbl,  // [R, D1]
                                  const int32_t* __restrict__ dom,  // [R, N]
                                  int32_t* __restrict__ plane) {    // [R, N]
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / N;
    plane[i] = tbl[row * D1 + dom[i]];
  }
}

extern "C" int launch_ipa_gather(int R, int N, int D1, const void* tbl, const void* dom,
                                 void* plane, void* stream) {
  const long long total = (long long)R * N;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  ipa_gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      total, N, D1, (const int32_t*)tbl, (const int32_t*)dom, (int32_t*)plane);
  return (int)cudaGetLastError();
}

// --- K9, existing-pod pass ----------------------------------------------------------------

__global__ void ipa_existing_kernel(int G, int C, int N, int K, int Dw,
                                    const uint8_t* __restrict__ match,      // [G, C]
                                    const float* __restrict__ counts,       // [G, Dw]
                                    const int32_t* __restrict__ slot,       // [G]
                                    const uint8_t* __restrict__ valid,      // [G]
                                    const int32_t* __restrict__ kind,       // [G]
                                    const float* __restrict__ weight,       // [G]
                                    const int32_t* __restrict__ node_topo,  // [N, K]
                                    float hard_weight,
                                    uint8_t* __restrict__ block,            // [C, N]
                                    float* __restrict__ score) {            // [C, N]
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (n >= N) return;
  bool blk = false;
  float s = 0.0f;
  for (int g = 0; g < G; ++g) {
    if (!match[(long long)g * C + c]) continue;
    const int sl = slot[g];
    const int dv = node_topo[(long long)n * K + min(max(sl, 0), K - 1)];
    // MISSING (-1) and domains past the table width have no owners
    const bool has = valid[g] && sl >= 0 && dv >= 0 && dv < Dw;
    const float cnt = has ? counts[(long long)g * Dw + dv] : 0.0f;
    const int k = kind[g];
    if (k == KIND_BLOCK) {
      if (cnt > 0.5f) blk = true;
    } else {
      const float w = (k == KIND_SCORE_REQ) ? hard_weight : weight[g];
      s = __fadd_rn(s, __fmul_rn(w, cnt));
    }
  }
  block[(long long)c * N + n] = blk ? 1 : 0;
  score[(long long)c * N + n] = s;
}

extern "C" int launch_ipa_existing(int G, int C, int N, int K, int Dw, const void* match,
                                   const void* counts, const void* slot, const void* valid,
                                   const void* kind, const void* weight,
                                   const void* node_topo, float hard_weight, void* block,
                                   void* score, void* stream) {
  if (C <= 0 || N <= 0) return 0;
  const int threads = 256;
  dim3 grid((N + threads - 1) / threads, C);
  ipa_existing_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      G, C, N, K, Dw, (const uint8_t*)match, (const float*)counts, (const int32_t*)slot,
      (const uint8_t*)valid, (const int32_t*)kind, (const float*)weight,
      (const int32_t*)node_topo, hard_weight, (uint8_t*)block, (float*)score);
  return (int)cudaGetLastError();
}

// --- K10 ---------------------------------------------------------------------------------

// count of term row `row` at node n: the plane entry, or the table at the
// node's domain (the trash slot included, as the reference's gather reads it)
__device__ __forceinline__ int read_count(const int32_t* cnt, int W, int N, long long row,
                                          int n, int dv) {
  return (W == N) ? cnt[row * N + n] : cnt[row * W + dv];
}

__global__ void ipa_filter_kernel(int C, int N, int D, int bit,
                                  int T1, int W1,
                                  const uint8_t* __restrict__ aff_valid,   // [C, T1] or null
                                  const int32_t* __restrict__ dom_aff,     // [C, T1, N]
                                  const int32_t* __restrict__ aff_cnt,     // [C, T1, W1]
                                  const int32_t* __restrict__ aff_total,   // [C]
                                  const uint8_t* __restrict__ self_match,  // [C]
                                  int T2, int W2,
                                  const int32_t* __restrict__ dom_anti,    // [C, T2, N] or null
                                  const int32_t* __restrict__ anti_cnt,    // [C, T2, W2]
                                  const uint8_t* __restrict__ exist,       // [C, N]
                                  const uint8_t* __restrict__ block_dyn,   // [C, N]
                                  int32_t* __restrict__ bits) {            // [C, N]
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (n >= N) return;
  bool ok = true;
  if (aff_valid) {
    bool keys_all = true, pods_exist = true;
    for (int t = 0; t < T1; ++t) {
      const long long row = (long long)c * T1 + t;
      if (!aff_valid[row]) continue;
      const int dv = dom_aff[row * N + n];
      if (dv >= D) keys_all = false;
      if (read_count(aff_cnt, W1, N, row, n, dv) <= 0) pods_exist = false;
    }
    const bool first_pod = aff_total[c] == 0 && self_match[c];
    ok = keys_all && (pods_exist || first_pod);
  }
  if (dom_anti) {
    for (int t = 0; t < T2; ++t) {
      const long long row = (long long)c * T2 + t;
      const int dv = dom_anti[row * N + n];
      if (dv < D && read_count(anti_cnt, W2, N, row, n, dv) > 0) ok = false;
    }
  }
  const long long cn = (long long)c * N + n;
  if (exist[cn] || block_dyn[cn]) ok = false;
  if (!ok) bits[cn] &= ~(1 << bit);
}

extern "C" int launch_ipa_filter(int C, int N, int D, int bit, int T1, int W1,
                                 const void* aff_valid, const void* dom_aff,
                                 const void* aff_cnt, const void* aff_total,
                                 const void* self_match, int T2, int W2,
                                 const void* dom_anti, const void* anti_cnt,
                                 const void* exist, const void* block_dyn, void* bits,
                                 void* stream) {
  if (C <= 0 || N <= 0) return 0;
  const int threads = 256;
  dim3 grid((N + threads - 1) / threads, C);
  ipa_filter_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      C, N, D, bit, T1, W1, (const uint8_t*)aff_valid, (const int32_t*)dom_aff,
      (const int32_t*)aff_cnt, (const int32_t*)aff_total, (const uint8_t*)self_match, T2,
      W2, (const int32_t*)dom_anti, (const int32_t*)anti_cnt, (const uint8_t*)exist,
      (const uint8_t*)block_dyn, (int32_t*)bits);
  return (int)cudaGetLastError();
}

// --- K11 ---------------------------------------------------------------------------------

#define SCORE_THREADS 1024

struct ScoreGroup {
  int T, W;
  const int32_t* dom;   // [C, T, N] or null (group absent)
  const int32_t* cnt;   // [C, T, W]
  const float* weight;  // [C, T]
};

// Σ_t weight · count over the terms whose domain is live at node n
__device__ __forceinline__ float group_sum(const ScoreGroup& g, int c, int N, int D, int n) {
  float s = 0.0f;
  for (int t = 0; t < g.T; ++t) {
    const long long row = (long long)c * g.T + t;
    const int dv = g.dom[row * N + n];
    float term = 0.0f;
    if (dv < D) term = __fmul_rn((float)read_count(g.cnt, g.W, N, row, n, dv), g.weight[row]);
    s = __fadd_rn(s, term);
  }
  return s;
}

// the raw score of node n: own + score_static + score_dyn
__device__ __forceinline__ float raw_score(const ScoreGroup& paff, const ScoreGroup& panti,
                                           const float* score_static, const float* score_dyn,
                                           int c, int N, int D, int n) {
  float own = 0.0f;
  if (paff.dom) own = __fadd_rn(own, group_sum(paff, c, N, D, n));
  if (panti.dom) own = __fsub_rn(own, group_sum(panti, c, N, D, n));
  const long long cn = (long long)c * N + n;
  return __fadd_rn(__fadd_rn(own, score_static[cn]), score_dyn[cn]);
}

__global__ void __launch_bounds__(SCORE_THREADS) ipa_score_kernel(
    int C, int N, int D, int full, const int32_t* __restrict__ bits, ScoreGroup paff,
    ScoreGroup panti, const float* __restrict__ score_static,
    const float* __restrict__ score_dyn, float weight, float* __restrict__ total) {
  __shared__ float scratch[SCORE_THREADS / 32];
  const int c = blockIdx.x;
  const int32_t* brow = bits + (long long)c * N;
  // sweep 1: max and min of the raw score over the feasible nodes
  float mx = -INFINITY, mn = INFINITY;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    if (brow[n] != full) continue;
    const float v = raw_score(paff, panti, score_static, score_dyn, c, N, D, n);
    mx = fmaxf(mx, v);
    mn = fminf(mn, v);
  }
  mx = block_max_float(mx, scratch);
  mn = block_min_float(mn, scratch);
  const float diff = __fsub_rn(mx, mn);
  const bool ok = isfinite(diff) && diff > 0.0f;
  // sweep 2: normalize, floor, weight, add into the total (−inf off the mask)
  float* trow = total + (long long)c * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    if (brow[n] != full) continue;
    float out = 0.0f;
    if (ok) {
      const float v = raw_score(paff, panti, score_static, score_dyn, c, N, D, n);
      out = __fdiv_rn(__fmul_rn(MAX_NODE_SCORE, __fsub_rn(v, mn)), diff);
    }
    trow[n] = __fadd_rn(trow[n], __fmul_rn(weight, floorf(out)));
  }
}

extern "C" int launch_ipa_score(int C, int N, int D, int full, const void* bits, int T3,
                                int W3, const void* dom_paff, const void* paff_cnt,
                                const void* paff_w, int T4, int W4, const void* dom_panti,
                                const void* panti_cnt, const void* panti_w,
                                const void* score_static, const void* score_dyn,
                                float weight, void* total, void* stream) {
  if (C <= 0 || N <= 0) return 0;
  ScoreGroup paff{T3, W3, (const int32_t*)dom_paff, (const int32_t*)paff_cnt,
                  (const float*)paff_w};
  ScoreGroup panti{T4, W4, (const int32_t*)dom_panti, (const int32_t*)panti_cnt,
                   (const float*)panti_w};
  ipa_score_kernel<<<C, SCORE_THREADS, 0, (cudaStream_t)stream>>>(
      C, N, D, full, (const int32_t*)bits, paff, panti, (const float*)score_static,
      (const float*)score_dyn, weight, (float*)total);
  return (int)cudaGetLastError();
}

// --- K12 ---------------------------------------------------------------------------------

#define UPDATE_THREADS 256

__global__ void __launch_bounds__(UPDATE_THREADS) ipa_update_kernel(
    int group, int B, int C, int T, int N, int D, int planes,
    const uint8_t* __restrict__ commit,     // [B]
    const int32_t* __restrict__ choice,     // [B]
    const int32_t* __restrict__ class_of,   // [B]
    const int32_t* __restrict__ dom,        // [C, T, N]
    const uint8_t* __restrict__ cross3,     // [C, T, C] count cross, or null
    const uint8_t* __restrict__ cross2,     // [C, C] all-terms cross (with row_valid)
    const uint8_t* __restrict__ row_valid,  // [C, T]
    const uint8_t* __restrict__ own_cross,  // [C, T, C]: term (k, t) matches class j
    const float* __restrict__ wt,           // [C, T] or null (use w_scalar)
    float w_scalar, float sign,
    int32_t* __restrict__ cnt,              // [C, T, N] planes or [C, T, D + 1] tables
    int32_t* __restrict__ total,            // [C] or null
    uint8_t* __restrict__ block_dyn,        // [C, N]
    float* __restrict__ score_dyn) {        // [C, N]
  extern __shared__ int delta[];            // [D]: commits per domain of this row
  __shared__ int scratch[UPDATE_THREADS / 32];
  const int rows = C * T;
  const bool own_half = blockIdx.x >= rows;
  const int row = own_half ? blockIdx.x - rows : blockIdx.x;  // c * T + t
  const int c = row / T;
  const int32_t* drow = dom + (long long)row * N;
  for (int d = threadIdx.x; d < D; d += blockDim.x) delta[d] = 0;
  __syncthreads();
  bool any = false;
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    if (!commit[i]) continue;
    const int k = class_of[i];
    bool take;
    if (own_half) {
      take = k == c;  // the committer's own term (c, t)
    } else if (cross3) {
      take = cross3[(long long)row * C + k];
    } else {
      take = cross2[(long long)c * C + k] && row_valid[row];
    }
    if (!take) continue;
    const int n = min(max(choice[i], 0), N - 1);
    const int dv = drow[n];
    if (dv < D) {  // commits on nodes without the key count nowhere
      atomicAdd(&delta[dv], 1);
      any = true;
    }
  }
  if (!__syncthreads_or(any)) return;
  if (!own_half) {
    // the pending row's count: table += delta, or plane += delta[dom]
    int mass = 0;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      const int v = delta[d];
      mass += v;
      if (!planes && v) cnt[(long long)row * (D + 1) + d] += v;
    }
    if (planes) {
      for (int n = threadIdx.x; n < N; n += blockDim.x) {
        const int dv = drow[n];
        if (dv < D) {
          const int v = delta[dv];
          if (v) cnt[(long long)row * N + n] += v;
        }
      }
    }
    if (total) {
      mass = block_sum_int(mass, scratch);
      if (threadIdx.x == 0) atomicAdd(&total[c], mass);
    }
    return;
  }
  // the committers' own term (c, t): block or score the classes it matches
  // on every node of a committed domain
  const float w = wt ? wt[row] : w_scalar;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int dv = drow[n];
    if (dv >= D) continue;
    const int m = delta[dv];
    if (!m) continue;
    for (int j = 0; j < C; ++j) {
      if (!own_cross[(long long)row * C + j]) continue;
      const long long jn = (long long)j * N + n;
      if (group == GROUP_REQ_ANTI) {
        block_dyn[jn] = 1;
      } else {
        atomicAdd(&score_dyn[jn], __fmul_rn(sign, __fmul_rn(w, (float)m)));
      }
    }
  }
}

extern "C" int launch_ipa_update(int group, int B, int C, int T, int N, int D, int planes,
                                 const void* commit, const void* choice,
                                 const void* class_of, const void* dom, const void* cross3,
                                 const void* cross2, const void* row_valid,
                                 const void* own_cross, const void* wt, float w_scalar,
                                 float sign, void* cnt, void* total, void* block_dyn,
                                 void* score_dyn, void* stream) {
  if (B <= 0 || C <= 0 || T <= 0 || D <= 0) return 0;
  const size_t smem = (size_t)D * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ipa_update_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ipa_update_kernel<<<2 * C * T, UPDATE_THREADS, smem, (cudaStream_t)stream>>>(
      group, B, C, T, N, D, planes, (const uint8_t*)commit, (const int32_t*)choice,
      (const int32_t*)class_of, (const int32_t*)dom, (const uint8_t*)cross3,
      (const uint8_t*)cross2, (const uint8_t*)row_valid, (const uint8_t*)own_cross,
      (const float*)wt, w_scalar, sign, (int32_t*)cnt, (int32_t*)total,
      (uint8_t*)block_dyn, (float*)score_dyn);
  return (int)cudaGetLastError();
}

// --- K15 ----------------------------------------------------------------------------

#define CHAIN_THREADS 256

__global__ void __launch_bounds__(CHAIN_THREADS) ipa_chain_count_kernel(
    int B0, int T, int N, int D, int planes,
    const uint8_t* __restrict__ cross,  // [C, T, B0]: term (c, t) matches prev pod j
    const int32_t* __restrict__ rows,   // [B0] prev pod's node row, < 0 = not placed
    const int32_t* __restrict__ dom,    // [C, T, N]
    int32_t* __restrict__ cnt,          // [C, T, N] planes or [C, T, D + 1] tables
    int32_t* __restrict__ total) {      // [C] or null
  extern __shared__ int delta[];        // [D]
  __shared__ int scratch[CHAIN_THREADS / 32];
  const int row = blockIdx.x;           // c * T + t
  const int c = row / T;
  const int32_t* drow = dom + (long long)row * N;
  for (int d = threadIdx.x; d < D; d += blockDim.x) delta[d] = 0;
  __syncthreads();
  bool any = false;
  for (int j = threadIdx.x; j < B0; j += blockDim.x) {
    if (!cross[(long long)row * B0 + j]) continue;
    const int r = rows[j];
    if (r < 0) continue;
    const int dv = drow[min(r, N - 1)];
    if (dv < D) {
      atomicAdd(&delta[dv], 1);
      any = true;
    }
  }
  if (!__syncthreads_or(any)) return;
  int mass = 0;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const int v = delta[d];
    mass += v;
    if (!planes && v) cnt[(long long)row * (D + 1) + d] += v;
  }
  if (planes) {
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const int dv = drow[n];
      if (dv < D) {
        const int v = delta[dv];
        if (v) cnt[(long long)row * N + n] += v;
      }
    }
  }
  if (total) {
    mass = block_sum_int(mass, scratch);
    if (threadIdx.x == 0) atomicAdd(&total[c], mass);
  }
}

extern "C" int launch_ipa_chain_count(int B0, int C, int T, int N, int D, int planes,
                                      const void* cross, const void* rows, const void* dom,
                                      void* cnt, void* total, void* stream) {
  if (B0 <= 0 || C <= 0 || T <= 0 || D <= 0) return 0;
  const size_t smem = (size_t)D * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ipa_chain_count_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ipa_chain_count_kernel<<<C * T, CHAIN_THREADS, smem, (cudaStream_t)stream>>>(
      B0, T, N, D, planes, (const uint8_t*)cross, (const int32_t*)rows,
      (const int32_t*)dom, (int32_t*)cnt, (int32_t*)total);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(CHAIN_THREADS) ipa_chain_own_kernel(
    int T, int C, int N, int K, int missing, int block,
    const uint8_t* __restrict__ mm,          // [B0, T, C]: prev term (j, t) matches class c
    const int32_t* __restrict__ topo_key,    // [B0, T] topology slot of the prev term
    const uint8_t* __restrict__ term_valid,  // [B0, T]
    const int32_t* __restrict__ rows,        // [B0], < 0 = not placed
    const int32_t* __restrict__ node_topo,   // [N, K] raw topology values
    const float* __restrict__ wt,            // [B0, T] or null (use w_scalar)
    float w_scalar, float sign,
    uint8_t* __restrict__ block_dyn,         // [C, N]
    float* __restrict__ score_dyn) {         // [C, N]
  const int jt = blockIdx.x;                 // j * T + t
  const int j = jt / T;
  const int r = rows[j];
  if (r < 0 || !term_valid[jt]) return;
  const int key = min(max(topo_key[jt], 0), K - 1);
  const int v = node_topo[(long long)min(r, N - 1) * K + key];
  if (v == missing) return;                  // the prev pod's node lacks the key
  const uint8_t* m = mm + (long long)jt * C;
  const float w = __fmul_rn(sign, wt ? wt[jt] : w_scalar);
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    if (node_topo[(long long)n * K + key] != v) continue;
    for (int c = 0; c < C; ++c) {
      if (!m[c]) continue;
      const long long cn = (long long)c * N + n;
      if (block) {
        block_dyn[cn] = 1;
      } else {
        atomicAdd(&score_dyn[cn], w);
      }
    }
  }
}

extern "C" int launch_ipa_chain_own(int B0, int T, int C, int N, int K, int missing,
                                    int block, const void* mm, const void* topo_key,
                                    const void* term_valid, const void* rows,
                                    const void* node_topo, const void* wt, float w_scalar,
                                    float sign, void* block_dyn, void* score_dyn,
                                    void* stream) {
  if (B0 <= 0 || T <= 0 || C <= 0 || N <= 0 || K <= 0) return 0;
  ipa_chain_own_kernel<<<B0 * T, CHAIN_THREADS, 0, (cudaStream_t)stream>>>(
      T, C, N, K, missing, block, (const uint8_t*)mm, (const int32_t*)topo_key,
      (const uint8_t*)term_valid, (const int32_t*)rows, (const int32_t*)node_topo,
      (const float*)wt, w_scalar, sign, (uint8_t*)block_dyn, (float*)score_dyn);
  return (int)cudaGetLastError();
}

// --- K19 ----------------------------------------------------------------------------

// one term group of the full-batch aux for K19 (T = 0: the group is absent)
struct RowGroup {
  int T;                      // terms per pod
  int W;                      // count width: N (planes) or D + 1 (tables)
  const int32_t* dom;         // [B, T, N]
  int32_t* cnt;               // [B, T, W]
  const uint8_t* cross;       // [B, T, B]: term (b, t) matches pod j
  const float* wt;            // [B, T] or null (w_scalar)
  float w_scalar;
};

// the four term groups in the reference's order (GROUP_REQ_AFF,
// GROUP_REQ_ANTI, preferred affinity, preferred anti-affinity); a term k
// of pod i counts over the groups' terms in that order
struct RowGroups {
  RowGroup g[4];
};

#define ROW_THREADS 256
#define ROW_ITEMS 4            // vectors a thread: a tile of ROW_THREADS · ROW_ITEMS · VEC nodes
#define ROW_MAX_RUN 8          // pending rows a block walks
#define ROW_TARGET_BLOCKS 528  // four blocks an SM of the H100's 132

template <int VEC>
__device__ __forceinline__ void row_load(const int32_t* p, int (&o)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
    o[0] = __ldg(p);
  }
}

// the first node of vector it of this thread in the block's tile
template <int VEC>
__device__ __forceinline__ int row_node(int n0, int it, int tid) {
  return n0 + (it * ROW_THREADS + tid) * VEC;
}

// planes form: count row (j, t) gains pod i on every node of the tile in
// pod i's node's domain `dat` — the row's domains streamed in vectors
// (every load issued before any is used), the counts read and written
// only in vectors that hold such a node
template <int VEC>
__device__ __forceinline__ void planes_add(const int32_t* __restrict__ drow,
                                           int32_t* __restrict__ crow, int n0, int N,
                                           int tid, int dat) {
  int v[ROW_ITEMS][VEC];
#pragma unroll
  for (int it = 0; it < ROW_ITEMS; ++it) {
    const int nb = row_node<VEC>(n0, it, tid);
    if (nb < N) {
      row_load<VEC>(drow + nb, v[it]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[it][e] = -1;
    }
  }
#pragma unroll
  for (int it = 0; it < ROW_ITEMS; ++it) {
    unsigned hit = 0;
#pragma unroll
    for (int e = 0; e < VEC; ++e) hit |= (v[it][e] == dat ? 1u : 0u) << e;
    if (!hit) continue;
    int32_t* p = crow + row_node<VEC>(n0, it, tid);
    if constexpr (VEC == 4) {
      int4 c = *reinterpret_cast<int4*>(p);
      c.x += hit & 1u; c.y += (hit >> 1) & 1u; c.z += (hit >> 2) & 1u; c.w += (hit >> 3) & 1u;
      *reinterpret_cast<int4*>(p) = c;
    } else {
      p[0] += 1;
    }
  }
}

// grid: (node tiles, runs of R pending rows); dynamic shared memory: pod i's
// same-domain bits of this thread's nodes per term k (u16 [K][ROW_THREADS]),
// pod i's term weights (f32 [K]), and the run's per-row flags — the domain
// at pod i's node of each planes count term that gains pod i, else −1
// (i32 [R][K]), and whether pod i's term k matches the row (u8 [R][K])
template <int VEC>
__global__ void __launch_bounds__(ROW_THREADS) ipa_update_row_kernel(
    int B, int N, int D, int i, int K, int R, const int32_t* __restrict__ node_at,
    const RowGroups gs, const uint8_t* __restrict__ aff_cross_all,  // [B, B]
    const uint8_t* __restrict__ req_aff_valid,                      // [B, T1]
    int32_t* __restrict__ aff_total,                                // [B]
    uint8_t* __restrict__ block_dyn, float* __restrict__ score_dyn) {
  constexpr int TILE = ROW_THREADS * ROW_ITEMS * VEC;
  extern __shared__ __align__(16) unsigned char row_smem[];
  uint16_t* s_same = reinterpret_cast<uint16_t*>(row_smem);
  float* s_w = reinterpret_cast<float*>(s_same + (size_t)K * ROW_THREADS);
  int32_t* s_dat = reinterpret_cast<int32_t*>(s_w + K);
  uint8_t* s_own = reinterpret_cast<uint8_t*>(s_dat + R * K);
  // per row: bit 0 a planes count term gains pod i, bit 1 a term of pod i
  // scores the row, bit 2 a required anti-affinity term of pod i blocks it
  __shared__ int s_row[ROW_MAX_RUN];
  __shared__ int s_mass[ROW_MAX_RUN];

  const int node = __ldg(node_at);
  if (node < 0) return;  // pod i was not placed: the step changes nothing
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TILE;
  const int j0 = blockIdx.y * R;
  const int rows = min(R, B - j0);
  if (tid < ROW_MAX_RUN) {
    s_row[tid] = 0;
    s_mass[tid] = 0;
  }
  __syncthreads();

  // (a) the run's per-row flags, one thread per (row, term), before any
  // plane is touched.  The tables form's point add (and the row's
  // aff_total mass) is done here, once, by the first tile's block.
  for (int x = tid; x < rows * K; x += ROW_THREADS) {
    const int r = x / K, k = x - r * K, j = j0 + r;
    int off = 0;
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
      const RowGroup& g = gs.g[gi];
      if (k >= off && k < off + g.T) {
        const int t = k - off;
        const long long jt = (long long)j * g.T + t;
        // pending pod j's term (j, t) gains pod i where i matches it (every
        // one of j's terms, for required affinity) and pod i's node has the key
        const bool match = gi == GROUP_REQ_AFF
                               ? (aff_cross_all[(long long)j * B + i] && req_aff_valid[jt])
                               : g.cross[jt * B + i] != 0;
        int dat = -1;
        if (match) {
          const int dv = __ldg(g.dom + jt * N + node);
          if (dv < D) dat = dv;
        }
        const bool planes = g.W == N;
        if (dat >= 0) {
          if (planes) {
            atomicOr(&s_row[r], 1);
          } else if (blockIdx.x == 0) {
            g.cnt[jt * g.W + dat] += 1;
          }
          if (gi == GROUP_REQ_AFF) atomicAdd(&s_mass[r], 1);
        }
        s_dat[x] = planes ? dat : -1;
        const bool own = g.cross[((long long)i * g.T + t) * B + j] != 0;
        s_own[x] = own ? 1 : 0;
        if (own) atomicOr(&s_row[r], gi == GROUP_REQ_ANTI ? 4 : 2);
      }
      off += g.T;
    }
  }

  // (b) pod i's rows, read once a block: for each of its terms, which of
  // this thread's nodes share the domain of pod i's node (staged in shared
  // memory, read back by the same thread only)
  int koff = 0;
#pragma unroll
  for (int gi = 0; gi < 4; ++gi) {
    const RowGroup& g = gs.g[gi];
    for (int t = 0; t < g.T; ++t) {
      const long long it_ = (long long)i * g.T + t;
      const int32_t* drow = g.dom + it_ * N;
      const int di = __ldg(drow + node);
      unsigned m = 0;
      if (di < D) {
        int v[ROW_ITEMS][VEC];
#pragma unroll
        for (int it = 0; it < ROW_ITEMS; ++it) {
          const int nb = row_node<VEC>(n0, it, tid);
          if (nb < N) {
            row_load<VEC>(drow + nb, v[it]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[it][e] = -1;
          }
        }
#pragma unroll
        for (int it = 0; it < ROW_ITEMS; ++it)
#pragma unroll
          for (int e = 0; e < VEC; ++e) m |= (v[it][e] == di ? 1u : 0u) << (it * VEC + e);
      }
      s_same[(koff + t) * ROW_THREADS + tid] = (uint16_t)m;
      if (tid == 0) s_w[koff + t] = g.wt ? __ldg(g.wt + it_) : g.w_scalar;
    }
    koff += g.T;
  }
  __syncthreads();
  if (blockIdx.x == 0 && tid < rows && s_mass[tid]) aff_total[j0 + tid] += s_mass[tid];

  // (c) the walk: only the rows a flag names, only the planes they name
  for (int r = 0; r < rows; ++r) {
    const int flags = s_row[r];
    if (!flags) continue;
    const long long j = j0 + r;
    const int32_t* dat_r = s_dat + r * K;
    const uint8_t* own_r = s_own + r * K;
    if (flags & 1) {  // (1, 2, 4) planes: j's count rows that gain pod i
      int off = 0;
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
        const RowGroup& g = gs.g[gi];
        if (g.W == N) {
          for (int t = 0; t < g.T; ++t) {
            const int dat = dat_r[off + t];
            if (dat < 0) continue;
            const long long row = (j * g.T + t) * (long long)N;
            planes_add<VEC>(g.dom + row, g.cnt + row, n0, N, tid, dat);
          }
        }
        off += g.T;
      }
    }
    if (flags & 4) {  // (3) pod i's required anti-affinity terms block j on their domains
      const int off = gs.g[GROUP_REQ_AFF].T;
      unsigned hit = 0;
      for (int t = 0; t < gs.g[GROUP_REQ_ANTI].T; ++t)
        if (own_r[off + t]) hit |= s_same[(off + t) * ROW_THREADS + tid];
      while (hit) {
        const int b = __ffs(hit) - 1;
        hit &= hit - 1;
        block_dyn[j * N + row_node<VEC>(n0, b / VEC, tid) + b % VEC] = 1;
      }
    }
    if (flags & 2) {  // (5) pod i's own terms score j on their domains
      unsigned touch = 0;
      int off = 0;
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
        if (gi != GROUP_REQ_ANTI)
          for (int t = 0; t < gs.g[gi].T; ++t)
            if (own_r[off + t]) touch |= s_same[(off + t) * ROW_THREADS + tid];
        off += gs.g[gi].T;
      }
      if (!touch) continue;
      // every vector's load issued before any is used
      float* srow = score_dyn + j * N;
      float x[ROW_ITEMS][VEC];
#pragma unroll
      for (int it = 0; it < ROW_ITEMS; ++it) {
        if (!((touch >> (it * VEC)) & ((1u << VEC) - 1u))) continue;
        const float* p = srow + row_node<VEC>(n0, it, tid);
        if constexpr (VEC == 4) {
          const float4 f = *reinterpret_cast<const float4*>(p);
          x[it][0] = f.x; x[it][1] = f.y; x[it][2] = f.z; x[it][3] = f.w;
        } else {
          x[it][0] = p[0];
        }
      }
      // + hardPodAffinityWeight per required-affinity term, + each
      // preferred-affinity weight, − each preferred anti-affinity weight:
      // each group's plane summed in term order, then added; an unchanged
      // value keeps its bits (only a −0 could come back as +0)
#pragma unroll
      for (int it = 0; it < ROW_ITEMS; ++it) {
        const unsigned vm = (touch >> (it * VEC)) & ((1u << VEC) - 1u);
        if (!vm) continue;
        float x0[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) x0[e] = x[it][e];
        int o = 0;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) {
          const int T = gs.g[gi].T;
          if (gi != GROUP_REQ_ANTI && T) {
            float pl[VEC];
#pragma unroll
            for (int e = 0; e < VEC; ++e) pl[e] = 0.0f;
            for (int t = 0; t < T; ++t) {
              if (!own_r[o + t]) continue;
              const unsigned m =
                  (s_same[(o + t) * ROW_THREADS + tid] >> (it * VEC)) & ((1u << VEC) - 1u);
              if (!m) continue;
              const float w = s_w[o + t];
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                if ((m >> e) & 1u) pl[e] = __fadd_rn(pl[e], w);
            }
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              if ((vm >> e) & 1u)
                x[it][e] = gi == 3 ? __fsub_rn(x[it][e], pl[e]) : __fadd_rn(x[it][e], pl[e]);
          }
          o += T;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (x[it][e] == x0[e]) x[it][e] = x0[e];
        float* p = srow + row_node<VEC>(n0, it, tid);
        if constexpr (VEC == 4) {
          *reinterpret_cast<float4*>(p) = make_float4(x[it][0], x[it][1], x[it][2], x[it][3]);
        } else {
          p[0] = x[it][0];
        }
      }
    }
  }
}

static bool row_aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

extern "C" int launch_ipa_update_row(
    int B, int N, int D, int i, const void* node_at,
    int T1, int W1, const void* dom_aff, void* aff_cnt, const void* aff_term_cross,
    const void* aff_cross_all, const void* req_aff_valid, void* aff_total, float hard_weight,
    int T2, int W2, const void* dom_anti, void* anti_cnt, const void* anti_cross,
    int T3, int W3, const void* dom_paff, void* paff_cnt, const void* paff_cross,
    const void* paff_weight,
    int T4, int W4, const void* dom_panti, void* panti_cnt, const void* panti_cross,
    const void* panti_weight,
    void* block_dyn, void* score_dyn, void* stream) {
  const int K = T1 + T2 + T3 + T4;
  if (B <= 0 || N <= 0 || K <= 0) return 0;
  RowGroups gs;
  gs.g[GROUP_REQ_AFF] = RowGroup{T1, W1, (const int32_t*)dom_aff, (int32_t*)aff_cnt,
                                 (const uint8_t*)aff_term_cross, nullptr, hard_weight};
  // the block reads only whether a term hits: weight 1
  gs.g[GROUP_REQ_ANTI] = RowGroup{T2, W2, (const int32_t*)dom_anti, (int32_t*)anti_cnt,
                                  (const uint8_t*)anti_cross, nullptr, 1.0f};
  gs.g[2] = RowGroup{T3, W3, (const int32_t*)dom_paff, (int32_t*)paff_cnt,
                     (const uint8_t*)paff_cross, (const float*)paff_weight, 0.0f};
  gs.g[3] = RowGroup{T4, W4, (const int32_t*)dom_panti, (int32_t*)panti_cnt,
                     (const uint8_t*)panti_cross, (const float*)panti_weight, 0.0f};
  // 16-byte vectors where every row of the planes starts on a 16-byte boundary
  bool vec4 = N % 4 == 0 && row_aligned16(score_dyn);
  for (int gi = 0; gi < 4; ++gi) {
    const RowGroup& g = gs.g[gi];
    if (g.T) vec4 = vec4 && row_aligned16(g.dom) && (g.W != N || row_aligned16(g.cnt));
  }
  const int tile = ROW_THREADS * ROW_ITEMS * (vec4 ? 4 : 1);
  const int tiles = (N + tile - 1) / tile;
  // rows a block: about four blocks an SM over the whole grid
  int R = (int)(((long long)B * tiles + ROW_TARGET_BLOCKS - 1) / ROW_TARGET_BLOCKS);
  R = R < 1 ? 1 : (R > ROW_MAX_RUN ? ROW_MAX_RUN : R);
  const size_t smem = (size_t)K * ROW_THREADS * 2 + (size_t)K * 4 + (size_t)R * K * 5;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const void* fn = vec4 ? (const void*)ipa_update_row_kernel<4> : (const void*)ipa_update_row_kernel<1>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(tiles, (B + R - 1) / R);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4) {
    ipa_update_row_kernel<4><<<grid, ROW_THREADS, smem, s>>>(
        B, N, D, i, K, R, (const int32_t*)node_at, gs, (const uint8_t*)aff_cross_all,
        (const uint8_t*)req_aff_valid, (int32_t*)aff_total, (uint8_t*)block_dyn,
        (float*)score_dyn);
  } else {
    ipa_update_row_kernel<1><<<grid, ROW_THREADS, smem, s>>>(
        B, N, D, i, K, R, (const int32_t*)node_at, gs, (const uint8_t*)aff_cross_all,
        (const uint8_t*)req_aff_valid, (int32_t*)aff_total, (uint8_t*)block_dyn,
        (float*)score_dyn);
  }
  return (int)cudaGetLastError();
}
