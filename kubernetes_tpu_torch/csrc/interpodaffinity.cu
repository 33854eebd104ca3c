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
// K10 ipa_filter: clears the filter's bit of K1's pass-bit plane in place,
//   one launch a call.  Bound: latency (a launch and a round trip or two; by
//   bytes, the block planes, each present term's domains and counts, and the
//   bits where they fail).  Design: a thread owns a run of 4 nodes of a row;
//   every load at entry (volatile asm, int4 and 4-byte words), at most one
//   dependent round trip (the tables' counts at the nodes' domains, every
//   term and node together), the verdict in registers, an int4 store only
//   where a bit clears; with no required term, the bits read only where a
//   block fails.
// K11 ipa_score: score + normalize + the weighted floor into K2's total, one
//   launch a call, one pass.  Bound: bytes (the bit plane read once; on
//   feasible nodes the static and dynamic scores, each preferred term's
//   domain and count, and the total read and written).
//   Design.  At most 16 rows (the scan's C = 1, a dedup round's C = 4) a
//   row is split over a thread-block cluster of up to 8 blocks of 1024
//   nodes or more (cudaLaunchKernelEx), a 16-byte vector a thread, every
//   load issued before any is used; above 16 rows (the full auction's
//   C = 512) one block a row, four vectors a thread of up to 512, a
//   vector's values read only where its bits hold a feasible node.  Each thread computes its
//   nodes' raw scores once (the preferred groups' terms in term order, then
//   the static and dynamic scores) and keeps them and the totals in
//   registers; the row's max and min reduce as a pair — warp shuffles, one
//   shared-memory round, one push through distributed shared memory across
//   the cluster (its barrier split: arrived at the start, waited on before
//   the push) — and the total is written from the registers (a slice
//   longer than the registers hold reads its rest again to write it).
//   Nodes off the mask keep their bits; ±inf are the empty partials'
//   identities; a diff not finite or ≤ 0 scores 0.
// K12 ipa_update: update_batch_classes, every present term group in one
//   launch (a by-value plan of the four groups), a grid of (row slots, node
//   tiles): per group C · T count rows (pending class c, term t), then
//   C · T committer rows (class k, term t).  Bound: latency at one commit a
//   round (the preferred-affinity suite), bytes at the full auction's
//   hundreds (the reached rows' domains).
//   Design.  Flags first: a block stages its row's C class bytes (the count
//   cross of its term, or the classes the committer's term matches) and
//   compacts the round's commits once — 16 flags a thread as a 16-byte
//   vector with their classes and nodes loaded at once, a warp-aggregated
//   append — into (class, clamped node) entries; its row's committed
//   domains (a count row: the commits its cross takes; a committer row: its
//   own class's; nodes without the key count nowhere) go into an
//   open-addressed table keyed by domain, sized by the round's commits and
//   at most half full: no domain-sized array, so no domain limit.  A row
//   the round does not reach exits there.  A count row adds aff_total's
//   mass once (required affinity), a table's counts at its committed
//   domains once (no node walk), a plane's on its tile's nodes of those
//   domains (the counts read and written only in vectors that hold one).
//   A committer row compacts its classes j once, then on its tile's nodes
//   of its committed domains ORs the block (required anti-affinity) or adds
//   ±weight · commits into each class's score — by the hit node's thread at
//   most 16 classes, by its warp above that.  At most 16 rows (latency
//   counts) the tile's domains, and a plane row's counts, are loaded with
//   the flags, one vector a thread of 256, every class and node with the
//   commit flags; above (bytes count), a tile of 8192 nodes a block of 512
//   (four vectors a thread), a plane count row's domains loaded with the
//   flags (the round reaches most of them), the rest after the flags.
//   Exactness: each count cell has one writer (its row's tile block); the
//   score adds are float atomics of integer values, exact in any order below
//   2^24, with the group's sign and weight as the reference's; the block is
//   a store of 1.  O(commits · C · T) for the flags against the reference's
//   O(C · T · N) one-hot contractions over every row.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

// --- K10 ---------------------------------------------------------------------------------
// A thread owns a run of FILTER_RUN nodes of one row (blockIdx.y).  With a
// required term every load goes out at entry, before any is tested: the
// run's bits as int4, its exist / block_dyn bytes as one word each, the
// row's flags, and for the first TB terms of each present group the domains
// (and, planes form, the counts) as int4 -- volatile asm loads, which no
// early exit or branch sinks.  Tables form: the count at each node's domain
// is the one dependent load, issued for every term and node of the run
// together, and only where the node's bit is set and no block already fails
// it.  With no required term (the path's batch) only a block fails a node:
// the run loads its two block words, and its bits only where one is set.
// The verdict stays in registers; bits go back as int4 only where a node's
// bit clears.  A run past N's end, or in a row of N not a multiple of 4,
// takes the scalar form: the same loads, one element each, all still at
// entry; terms past the first TB of a group take further passes.  Four
// nodes a thread and 128 threads a block measured faster than 16 nodes or
// 256 threads (PERF.md, the kernel table).
#define FILTER_RUN 4
#define FILTER_THREADS 128

struct FilterArgs {
  int C, N, D, bit;
  int T1, W1;
  const uint8_t* aff_valid;   // [C, T1] or null (no required-affinity group)
  const int32_t* dom_aff;     // [C, T1, N]
  const int32_t* aff_cnt;     // [C, T1, W1]
  const int32_t* aff_total;   // [C]
  const uint8_t* self_match;  // [C]
  int T2, W2;
  const int32_t* dom_anti;    // [C, T2, N] or null
  const int32_t* anti_cnt;    // [C, T2, W2]
  const uint8_t* exist;       // [C, N]
  const uint8_t* block_dyn;   // [C, N]
  int32_t* bits;              // [C, N], updated in place
  int vec;                    // N a multiple of 4 and every array 16-byte aligned
};

// a run's int32 from p: one int4 load (vec), else the first n one at a time
// (0 past n)
__device__ __forceinline__ void filter_ld_i32(const int32_t* p, int (&o)[FILTER_RUN], bool vec,
                                              int n) {
  if (vec) {
    asm volatile("ld.global.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(o[0]), "=r"(o[1]), "=r"(o[2]), "=r"(o[3]) : "l"(p));
  } else {
#pragma unroll
    for (int k = 0; k < FILTER_RUN; ++k) {
      o[k] = 0;
      if (k < n) asm volatile("ld.global.s32 %0, [%1];" : "=r"(o[k]) : "l"(p + k));
    }
  }
}

// a run's bool bytes from p → bit k set where byte k is not 0: one word
// (vec), else the first n bytes one at a time
__device__ __forceinline__ unsigned filter_ld_flags(const uint8_t* p, bool vec, int n) {
  unsigned w = 0u;
  if (vec) {
    asm volatile("ld.global.u32 %0, [%1];" : "=r"(w) : "l"(p));
  } else {
#pragma unroll
    for (int k = 0; k < FILTER_RUN; ++k) {
      unsigned b = 0u;
      if (k < n) asm volatile("ld.global.u8 %0, [%1];" : "=r"(b) : "l"(p + k));
      w |= b << (8 * k);
    }
  }
  unsigned f = 0u;
#pragma unroll
  for (int k = 0; k < FILTER_RUN; ++k)
    if ((w >> (8 * k)) & 0xffu) f |= 1u << k;
  return f;
}

__device__ __forceinline__ unsigned filter_ld_u8(const uint8_t* p) {
  unsigned v;
  asm volatile("ld.global.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int filter_ld_one(const int32_t* p) {
  int v;
  asm volatile("ld.global.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// the run's bits back where `clear` has a node: an int4 (vec), else each
// such node's word
__device__ __forceinline__ void filter_store(int32_t* p, int (&bw)[FILTER_RUN], unsigned clear,
                                             int bit, bool vec) {
#pragma unroll
  for (int k = 0; k < FILTER_RUN; ++k)
    if ((clear >> k) & 1u) bw[k] &= ~(1 << bit);
  if (vec) {
    *reinterpret_cast<int4*>(p) = make_int4(bw[0], bw[1], bw[2], bw[3]);
  } else {
#pragma unroll
    for (int k = 0; k < FILTER_RUN; ++k)
      if ((clear >> k) & 1u) p[k] = bw[k];
  }
}

// up to TB terms [t0, t0 + TB) of one group on a run: domains and counts
// (the node's own, planes form; at its domain, tables form)
template <int TB>
struct FilterTerms {
  int dom[TB][FILTER_RUN];
  int cnt[TB][FILTER_RUN];
  unsigned valid;  // bit t: term t0 + t takes part
};

template <int TB>
__device__ __forceinline__ void filter_terms_load(FilterTerms<TB>& g, const int32_t* dom,
                                                  const int32_t* cnt, int T, int W, int N,
                                                  int c, int t0, int n0, bool vec, int n) {
#pragma unroll
  for (int t = 0; t < TB; ++t) {
    if (t0 + t >= T) break;
    const long long row = (long long)c * T + t0 + t;
    filter_ld_i32(dom + row * N + n0, g.dom[t], vec, n);
    if (W == N) filter_ld_i32(cnt + row * N + n0, g.cnt[t], vec, n);
  }
}

// tables form: the counts at the domains of the nodes in `need`, every load
// issued before any is used (a domain of D or more reads nothing: no key)
template <int TB>
__device__ __forceinline__ void filter_terms_counts(FilterTerms<TB>& g, const int32_t* cnt,
                                                    int T, int W, int N, int D, int c, int t0,
                                                    unsigned need) {
  if (W == N) return;
#pragma unroll
  for (int t = 0; t < TB; ++t) {
    if (t0 + t >= T) break;
    const int32_t* crow = cnt + ((long long)c * T + t0 + t) * W;
#pragma unroll
    for (int k = 0; k < FILTER_RUN; ++k)
      g.cnt[t][k] = ((need >> k) & 1u) && ((g.valid >> t) & 1u) && g.dom[t][k] < D
                        ? __ldg(crow + g.dom[t][k]) : 0;
  }
}

// one pass over terms [t0, t0 + TB) of both groups: loads (the first pass's
// were issued at entry), then the tables' counts, then the verdict bits
template <int TB>
__device__ __forceinline__ void filter_terms_pass(const FilterArgs& a, int c, int t0,
                                                  unsigned need, FilterTerms<TB>& fa,
                                                  FilterTerms<TB>& fn, unsigned& unkeyed,
                                                  unsigned& empty, unsigned& blocked) {
  if (a.dom_aff) filter_terms_counts<TB>(fa, a.aff_cnt, a.T1, a.W1, a.N, a.D, c, t0, need);
  if (a.dom_anti) filter_terms_counts<TB>(fn, a.anti_cnt, a.T2, a.W2, a.N, a.D, c, t0, need);
#pragma unroll
  for (int t = 0; t < TB; ++t) {
#pragma unroll
    for (int k = 0; k < FILTER_RUN; ++k) {
      if (a.dom_aff && t0 + t < a.T1 && ((fa.valid >> t) & 1u)) {
        if (fa.dom[t][k] >= a.D) unkeyed |= 1u << k;
        if (fa.cnt[t][k] <= 0) empty |= 1u << k;
      }
      if (a.dom_anti && t0 + t < a.T2 && fn.dom[t][k] < a.D && fn.cnt[t][k] > 0)
        blocked |= 1u << k;
    }
  }
}

// the run of nodes [n0, n0 + n) of row c: vector loads and stores where
// `vec`, else one element at a time
template <int TB>
__device__ __forceinline__ void filter_run(const FilterArgs& a, int c, int n0, bool vec, int n) {
  const long long at = (long long)c * a.N + n0;
  int bw[FILTER_RUN];
  if (!a.dom_aff && !a.dom_anti) {
    // no required term: only a block fails a node; the bits where one does
    const unsigned fb = filter_ld_flags(a.exist + at, vec, n) |
                        filter_ld_flags(a.block_dyn + at, vec, n);
    if (!fb) return;
    filter_ld_i32(a.bits + at, bw, vec, n);
    unsigned clear = 0u;
#pragma unroll
    for (int k = 0; k < FILTER_RUN; ++k)
      if (((fb >> k) & 1u) && ((bw[k] >> a.bit) & 1)) clear |= 1u << k;
    if (clear) filter_store(a.bits + at, bw, clear, a.bit, vec);
    return;
  }
  filter_ld_i32(a.bits + at, bw, vec, n);
  const unsigned ex = filter_ld_flags(a.exist + at, vec, n);
  const unsigned bd = filter_ld_flags(a.block_dyn + at, vec, n);
  int total = 0;
  unsigned self = 0u;
  FilterTerms<TB> fa, fn;
  fa.valid = fn.valid = (1u << TB) - 1u;
  if (a.dom_aff) {
    total = filter_ld_one(a.aff_total + c);
    self = filter_ld_u8(a.self_match + c);
    unsigned v[TB];
#pragma unroll
    for (int t = 0; t < TB; ++t)
      v[t] = t < a.T1 ? filter_ld_u8(a.aff_valid + (long long)c * a.T1 + t) : 0u;
    filter_terms_load<TB>(fa, a.dom_aff, a.aff_cnt, a.T1, a.W1, a.N, c, 0, n0, vec, n);
    fa.valid = 0u;
#pragma unroll
    for (int t = 0; t < TB; ++t) fa.valid |= (v[t] ? 1u : 0u) << t;
  }
  if (a.dom_anti)
    filter_terms_load<TB>(fn, a.dom_anti, a.anti_cnt, a.T2, a.W2, a.N, c, 0, n0, vec, n);

  // the nodes whose bit is set; of them, those no block fails already are
  // the ones the terms decide
  unsigned set = 0u;
#pragma unroll
  for (int k = 0; k < FILTER_RUN; ++k) set |= (unsigned)((bw[k] >> a.bit) & 1) << k;
  const unsigned need = set & ~(ex | bd);
  unsigned unkeyed = 0u, empty = 0u, blocked = 0u;
  if (need) {
    filter_terms_pass<TB>(a, c, 0, need, fa, fn, unkeyed, empty, blocked);
    const int tmax = max(a.dom_aff ? a.T1 : 0, a.dom_anti ? a.T2 : 0);
    for (int t0 = TB; t0 < tmax; t0 += TB) {
      if (a.dom_aff) {
        filter_terms_load<TB>(fa, a.dom_aff, a.aff_cnt, a.T1, a.W1, a.N, c, t0, n0, vec, n);
        fa.valid = 0u;
#pragma unroll
        for (int t = 0; t < TB; ++t)
          if (t0 + t < a.T1 && __ldg(a.aff_valid + (long long)c * a.T1 + t0 + t))
            fa.valid |= 1u << t;
      }
      if (a.dom_anti)
        filter_terms_load<TB>(fn, a.dom_anti, a.anti_cnt, a.T2, a.W2, a.N, c, t0, n0, vec, n);
      filter_terms_pass<TB>(a, c, t0, need, fa, fn, unkeyed, empty, blocked);
    }
  }
  // required affinity: every valid term keyed, and matched or the first pod
  // of its series; no required anti-affinity match; no block
  unsigned fail = blocked;
  if (a.dom_aff) fail |= unkeyed | ((total == 0 && self) ? 0u : empty);
  const unsigned clear = (set & (ex | bd)) | (need & fail);
  if (clear) filter_store(a.bits + at, bw, clear, a.bit, vec);
}

template <int TB>
__global__ void __launch_bounds__(FILTER_THREADS) ipa_filter_kernel(const FilterArgs a) {
  const int c = blockIdx.y;
  const int n0 = (blockIdx.x * FILTER_THREADS + threadIdx.x) * FILTER_RUN;
  if (n0 >= a.N) return;
  const int n = min(FILTER_RUN, a.N - n0);
  filter_run<TB>(a, c, n0, a.vec && n == FILTER_RUN, n);
}

extern "C" int launch_ipa_filter(int C, int N, int D, int bit, int T1, int W1,
                                 const void* aff_valid, const void* dom_aff,
                                 const void* aff_cnt, const void* aff_total,
                                 const void* self_match, int T2, int W2,
                                 const void* dom_anti, const void* anti_cnt,
                                 const void* exist, const void* block_dyn, void* bits,
                                 void* stream) {
  if (C <= 0 || N <= 0) return 0;
  if (C > 65535) return (int)cudaErrorInvalidValue;
  FilterArgs a;
  a.C = C; a.N = N; a.D = D; a.bit = bit;
  a.T1 = T1; a.W1 = W1;
  a.aff_valid = (const uint8_t*)aff_valid; a.dom_aff = (const int32_t*)dom_aff;
  a.aff_cnt = (const int32_t*)aff_cnt; a.aff_total = (const int32_t*)aff_total;
  a.self_match = (const uint8_t*)self_match;
  a.T2 = T2; a.W2 = W2;
  a.dom_anti = (const int32_t*)dom_anti; a.anti_cnt = (const int32_t*)anti_cnt;
  a.exist = (const uint8_t*)exist; a.block_dyn = (const uint8_t*)block_dyn;
  a.bits = (int32_t*)bits;
  a.vec = N % 4 == 0 && aligned16(exist) && aligned16(block_dyn) && aligned16(bits)
          && (!dom_aff || (aligned16(dom_aff) && (W1 != N || aligned16(aff_cnt))))
          && (!dom_anti || (aligned16(dom_anti) && (W2 != N || aligned16(anti_cnt))));
  const long long runs = (N + FILTER_RUN - 1) / FILTER_RUN;
  const dim3 grid((unsigned)((runs + FILTER_THREADS - 1) / FILTER_THREADS), (unsigned)C);
  // two terms a pass where a present group has more than one
  if ((dom_aff && T1 > 1) || (dom_anti && T2 > 1))
    ipa_filter_kernel<2><<<grid, FILTER_THREADS, 0, (cudaStream_t)stream>>>(a);
  else
    ipa_filter_kernel<1><<<grid, FILTER_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// --- K11 ---------------------------------------------------------------------------------

#define SCORE_THREADS 512  // at most: a block of the one-block-a-row form
#define SCORE_CLUSTER 8    // blocks a row at most (a thread-block cluster)

struct ScoreGroup {
  int T, W;
  const int32_t* dom;   // [C, T, N] or null (group absent)
  const int32_t* cnt;   // [C, T, W]
  const float* weight;  // [C, T]
};

// the call, a by-value kernel parameter: CL blocks a row (a cluster when
// CL > 1), block r of a row taking the nodes [r S, (r + 1) S)
struct ScoreArgs {
  int C, N, D, full, S, CL;
  const int32_t* bits;         // [C, N]
  ScoreGroup paff, panti;
  const float* score_static;   // [C, N]
  const float* score_dyn;      // [C, N]
  float weight;
  float* total;                // [C, N]
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

template <int VEC>
__device__ __forceinline__ void ld_i32(const int32_t* p, int (&o)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
    o[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void ld_f32(const float* p, float (&o)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
    o[0] = __ldg(p);
  }
}

// s + Σ_t weight · count over the group's terms whose domain is live at
// each node of the vectors in `use` (bit it), added to `s` term by term in
// term order; each term's loads are issued for every vector before any is
// used
template <int VEC, int ITEMS>
__device__ __forceinline__ void group_sums(const ScoreGroup& g, int c, int N, int D,
                                           const int (&nb)[ITEMS], unsigned use,
                                           float (&s)[ITEMS][VEC]) {
  for (int t = 0; t < g.T; ++t) {
    const long long row = (long long)c * g.T + t;
    const int32_t* drow = g.dom + row * N;
    const float w = __ldg(g.weight + row);
    int dv[ITEMS][VEC], ct[ITEMS][VEC];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      if ((use >> it) & 1u) {
        ld_i32<VEC>(drow + nb[it], dv[it]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) dv[it][e] = D;
      }
    }
    if (g.W == N) {
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        if ((use >> it) & 1u) {
          ld_i32<VEC>(g.cnt + row * N + nb[it], ct[it]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) ct[it][e] = 0;
        }
      }
    } else {
#pragma unroll
      for (int it = 0; it < ITEMS; ++it)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          ct[it][e] = dv[it][e] < D ? __ldg(g.cnt + row * g.W + dv[it][e]) : 0;
    }
#pragma unroll
    for (int it = 0; it < ITEMS; ++it)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float term = dv[it][e] < D ? __fmul_rn((float)ct[it][e], w) : 0.0f;
        s[it][e] = __fadd_rn(s[it][e], term);
      }
  }
}

// ITEMS vectors of this thread (vector it at v0 + it · nt + tid of the
// block's slice): their nodes `nb` and the raw scores `x` of the vectors
// read, → the feasible nodes (bit it · VEC + e).  The split form
// (ITEMS = 1, latency counts) issues every load before any is used and
// reads the totals with them; the one-block-a-row form (ITEMS > 1, bytes
// count) reads a vector's values only where its bits hold a feasible node,
// and its totals only to write them.
template <int VEC, int ITEMS>
__device__ __forceinline__ unsigned score_chunk(const ScoreArgs& a, int c, int lo, int nvec,
                                                int v0, float (&x)[ITEMS][VEC],
                                                float (&tot)[ITEMS][VEC], int (&nb)[ITEMS]) {
  constexpr bool only_feasible = ITEMS > 1;
  constexpr unsigned VMASK = (1u << VEC) - 1u;
  const size_t rowoff = (size_t)c * a.N;
  int b[ITEMS][VEC];
  unsigned live = 0;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int v = v0 + it * (int)blockDim.x + (int)threadIdx.x;
    nb[it] = lo + v * VEC;
    if (v < nvec) {
      live |= 1u << it;
      ld_i32<VEC>(a.bits + rowoff + nb[it], b[it]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) b[it][e] = ~a.full;
    }
  }
  unsigned fm = 0;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (b[it][e] == a.full) fm |= 1u << (it * VEC + e);
  unsigned use = 0;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
    if (only_feasible ? ((fm >> (it * VEC)) & VMASK) != 0u : ((live >> it) & 1u) != 0u)
      use |= 1u << it;
  float st[ITEMS][VEC], dy[ITEMS][VEC];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    if ((use >> it) & 1u) {
      ld_f32<VEC>(a.score_static + rowoff + nb[it], st[it]);
      ld_f32<VEC>(a.score_dyn + rowoff + nb[it], dy[it]);
      if (!only_feasible) ld_f32<VEC>(a.total + rowoff + nb[it], tot[it]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) st[it][e] = dy[it][e] = 0.0f;
    }
  }
  // own (+ the preferred-affinity sum, − the preferred anti-affinity sum),
  // then + static, + dynamic; 0 + the first sum is that sum (it starts at
  // +0 and so is never −0)
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
#pragma unroll
    for (int e = 0; e < VEC; ++e) x[it][e] = 0.0f;
  if (a.paff.dom) group_sums<VEC, ITEMS>(a.paff, c, a.N, a.D, nb, use, x);
  if (a.panti.dom) {
    float sn[ITEMS][VEC];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it)
#pragma unroll
      for (int e = 0; e < VEC; ++e) sn[it][e] = 0.0f;
    group_sums<VEC, ITEMS>(a.panti, c, a.N, a.D, nb, use, sn);
#pragma unroll
    for (int it = 0; it < ITEMS; ++it)
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[it][e] = __fsub_rn(x[it][e], sn[it][e]);
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
#pragma unroll
    for (int e = 0; e < VEC; ++e) x[it][e] = __fadd_rn(__fadd_rn(x[it][e], st[it][e]), dy[it][e]);
  return fm;
}

// total + weight · floor(100 (v − mn) / diff) on feasible nodes (0 unless
// diff is finite and positive); the other nodes keep their bits.  The
// one-block-a-row form reads its totals here, every vector's before any is
// used.
template <int VEC, int ITEMS>
__device__ __forceinline__ void score_write(const ScoreArgs& a, int c, unsigned fm, float mn,
                                            float diff, bool ok, const float (&x)[ITEMS][VEC],
                                            float (&tot)[ITEMS][VEC], const int (&nb)[ITEMS]) {
  constexpr unsigned VMASK = (1u << VEC) - 1u;
  float* trow = a.total + (size_t)c * a.N;
  if (ITEMS > 1) {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it)
      if ((fm >> (it * VEC)) & VMASK) ld_f32<VEC>(trow + nb[it], tot[it]);
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    if (!((fm >> (it * VEC)) & VMASK)) continue;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (!((fm >> (it * VEC + e)) & 1u)) continue;
      const float out =
          ok ? __fdiv_rn(__fmul_rn(MAX_NODE_SCORE, __fsub_rn(x[it][e], mn)), diff) : 0.0f;
      tot[it][e] = __fadd_rn(tot[it][e], __fmul_rn(a.weight, floorf(out)));
    }
    float* p = trow + nb[it];
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(tot[it][0], tot[it][1], tot[it][2], tot[it][3]);
    } else {
      p[0] = tot[it][0];
    }
  }
}

// grid: C rows of CL blocks (a cluster when CL > 1)
template <int VEC, int ITEMS>
__global__ void __launch_bounds__(SCORE_THREADS) ipa_score_kernel(const ScoreArgs a) {
  __shared__ float s_wmax[SCORE_THREADS / 32], s_wmin[SCORE_THREADS / 32];
  __shared__ float s_pmax[SCORE_CLUSTER], s_pmin[SCORE_CLUSTER];  // by block rank
  const int CL = a.CL;
  if (CL > 1) cluster_arrive_relaxed();  // this block runs; waited on before the push
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x / CL, rank = blockIdx.x % CL;
  const int lo = min(rank * a.S, a.N), nvec = (min(lo + a.S, a.N) - lo) / VEC;
  const int span = ITEMS * nt;  // vectors a thread block keeps in registers

  // --- the one read: raw scores (and totals) kept in registers ------------
  float x[ITEMS][VEC], tot[ITEMS][VEC];
  int nb[ITEMS];
  const unsigned fm = score_chunk<VEC, ITEMS>(a, c, lo, nvec, 0, x, tot, nb);
  float mx = -INFINITY, mn = INFINITY;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if ((fm >> (it * VEC + e)) & 1u) {
        mx = fmaxf(mx, x[it][e]);
        mn = fminf(mn, x[it][e]);
      }
  // the rest of a slice longer than the registers hold (read again to write)
  for (int v0 = span; v0 < nvec; v0 += span) {
    float xr[ITEMS][VEC], tr[ITEMS][VEC];
    int nr[ITEMS];
    const unsigned f = score_chunk<VEC, ITEMS>(a, c, lo, nvec, v0, xr, tr, nr);
#pragma unroll
    for (int it = 0; it < ITEMS; ++it)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if ((f >> (it * VEC + e)) & 1u) {
          mx = fmaxf(mx, xr[it][e]);
          mn = fminf(mn, xr[it][e]);
        }
  }

  // --- max and min, paired: warp shuffles, one shared round, the cluster --
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
  }
  if (lane == 0) {
    s_wmax[warp] = mx;
    s_wmin[warp] = mn;
  }
  __syncthreads();
  mx = -INFINITY;
  mn = INFINITY;
  for (int w = 0; w < (nt >> 5); ++w) {
    mx = fmaxf(mx, s_wmax[w]);
    mn = fminf(mn, s_wmin[w]);
  }
  if (CL > 1) {
    cluster_wait_acquire();  // every block of the cluster runs
    // lane q of warp 0 pushes the block's pair into block q; one cluster
    // barrier later every block holds the row's (and none reads another's
    // shared memory after it)
    if (warp == 0 && lane < CL) {
      cg::cluster_group cluster = cg::this_cluster();
      *cluster.map_shared_rank(&s_pmax[rank], lane) = mx;
      *cluster.map_shared_rank(&s_pmin[rank], lane) = mn;
    }
    __syncwarp();
    cluster_arrive_release();
    cluster_wait_acquire();
    mx = -INFINITY;
    mn = INFINITY;
    for (int q = 0; q < CL; ++q) {
      mx = fmaxf(mx, s_pmax[q]);
      mn = fminf(mn, s_pmin[q]);
    }
  }
  const float diff = __fsub_rn(mx, mn);
  const bool ok = isfinite(diff) && diff > 0.0f;

  // --- the write, from registers ------------------------------------------
  score_write<VEC, ITEMS>(a, c, fm, mn, diff, ok, x, tot, nb);
  for (int v0 = span; v0 < nvec; v0 += span) {
    float xr[ITEMS][VEC], tr[ITEMS][VEC];
    int nr[ITEMS];
    const unsigned f = score_chunk<VEC, ITEMS>(a, c, lo, nvec, v0, xr, tr, nr);
    score_write<VEC, ITEMS>(a, c, f, mn, diff, ok, xr, tr, nr);
  }
}

template <int VEC, int ITEMS>
static int launch_score(const ScoreArgs& a, int threads, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.C * a.CL));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.CL > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, ipa_score_kernel<VEC, ITEMS>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int launch_ipa_score(int C, int N, int D, int full, const void* bits, int T3,
                                int W3, const void* dom_paff, const void* paff_cnt,
                                const void* paff_w, int T4, int W4, const void* dom_panti,
                                const void* panti_cnt, const void* panti_w,
                                const void* score_static, const void* score_dyn,
                                float weight, void* total, void* stream) {
  if (C <= 0 || N <= 0) return 0;
  ScoreArgs a;
  a.C = C; a.N = N; a.D = D; a.full = full;
  a.bits = (const int32_t*)bits;
  a.paff = ScoreGroup{T3, W3, (const int32_t*)dom_paff, (const int32_t*)paff_cnt,
                      (const float*)paff_w};
  a.panti = ScoreGroup{T4, W4, (const int32_t*)dom_panti, (const int32_t*)panti_cnt,
                       (const float*)panti_w};
  a.score_static = (const float*)score_static;
  a.score_dyn = (const float*)score_dyn;
  a.weight = weight;
  a.total = (float*)total;
  // 16-byte vectors where every row of every plane read by node starts on a
  // 16-byte boundary (a table is read by domain, one word at a time)
  bool vec4 = N % 4 == 0 && aligned16(bits) && aligned16(score_static) &&
              aligned16(score_dyn) && aligned16(total);
  if (a.paff.dom) vec4 = vec4 && aligned16(dom_paff) && (W3 != N || aligned16(paff_cnt));
  if (a.panti.dom) vec4 = vec4 && aligned16(dom_panti) && (W4 != N || aligned16(panti_cnt));
  const int vec = vec4 ? 4 : 1;
  // at most 16 rows (the scan's C = 1, a dedup round's C = 4) a row is split
  // over up to 8 blocks of 1024 nodes or more, a vector a thread; above that
  // the rows fill the card: one block a row, four vectors a thread of 512
  // (on the H100 faster than two a thread of 1024, which spill more under
  // their 64-register cap; PERF.md)
  const bool split = C <= 16;
  const int items = split ? 1 : 4;
  int cl = 1;
  if (split)
    while (cl < SCORE_CLUSTER && (long long)cl * 1024 < N) cl <<= 1;
  const int S = ((N + cl - 1) / cl + vec - 1) / vec * vec;
  int threads = ((S / vec + items - 1) / items + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > SCORE_THREADS ? SCORE_THREADS : threads);
  a.S = S;
  a.CL = cl;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4) return split ? launch_score<4, 1>(a, threads, s) : launch_score<4, 4>(a, threads, s);
  return split ? launch_score<1, 1>(a, threads, s) : launch_score<1, 4>(a, threads, s);
}

// --- K12 ---------------------------------------------------------------------------------

#define UPDATE_THREADS 512  // at most: the one-tile-a-row form
#define UPDATE_EMPTY -1
#define UPDATE_FEW_CLASSES 16  // a committer row's classes written by the hit node's thread

// one term group of the class view (T = 0: the group is absent)
struct UpdateGroup {
  int T, W;              // terms a row, count width: N (planes) or D + 1 (tables)
  const int32_t* dom;    // [C, T, N]
  int32_t* cnt;          // [C, T, W]
  const uint8_t* cross;  // [C, T, C] count cross; null: the all-terms cross × row validity
  const uint8_t* own;    // [C, T, C]: the committer's term (k, t) matches class j
  const float* wt;       // [C, T] or null (w_scalar)
  float w_scalar;
  int slot0;             // the group's first row slot: C · T count rows, then C · T committer rows
};

// the call, a by-value kernel parameter
struct UpdatePlan {
  UpdateGroup g[4];           // GROUP_REQ_AFF, GROUP_REQ_ANTI, preferred affinity, preferred anti
  const uint8_t* cross_all;   // [C, C]
  const uint8_t* row_valid;   // [C, T1]
  int32_t* aff_total;         // [C]
  uint8_t* block_dyn;         // [C, N]
  float* score_dyn;           // [C, N]
  const uint8_t* commit;      // [B]
  const int32_t* choice;      // [B] node rows
  const long long* class_of;  // [B] class rows (the auction's int64 index, read as it is)
  int B, C, N, D;
  int CH;                     // commits compacted a pass (16 a thread)
  int lgH;                    // log2 of the domain table's slots
};

// this thread's `cnt` entries appended after the warp's lower lanes' (one
// shared atomic a warp) → its first slot; every lane calls it
__device__ __forceinline__ int warp_append(int cnt, int* counter) {
  const int lane = threadIdx.x & 31;
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  int base = 0;
  if (lane == 31) base = atomicAdd(counter, incl);
  base = __shfl_sync(0xffffffffu, base, 31);
  return base + incl - cnt;
}

// the committed domains of a row: an open-addressed table (2^lg slots, at
// most half of them used) of domain → commits
__device__ __forceinline__ unsigned dom_slot(int d, int lg) {
  return ((unsigned)d * 0x9E3779B1u) >> (32 - lg);
}

__device__ __forceinline__ void table_add(int* key, int* val, int lg, int d) {
  const unsigned m = (1u << lg) - 1u;
  for (unsigned h = dom_slot(d, lg);; h = (h + 1u) & m) {
    const int k = atomicCAS(&key[h], UPDATE_EMPTY, d);
    if (k == UPDATE_EMPTY || k == d) {
      atomicAdd(&val[h], 1);
      return;
    }
  }
}

__device__ __forceinline__ int table_get(const int* key, const int* val, int lg, int d) {
  const unsigned m = (1u << lg) - 1u;
  for (unsigned h = dom_slot(d, lg);; h = (h + 1u) & m) {
    const int k = key[h];
    if (k == d) return val[h];
    if (k == UPDATE_EMPTY) return 0;
  }
}

// the commits [base, base + 16 nt): each thread's 16 flags (a 16-byte vector
// where aligned), compacted into (class, clamped node) entries; with `spec`
// (latency counts) every class and node is loaded with the flags, else only
// the committed ones'
__device__ __forceinline__ void compact_commits(const UpdatePlan& p, int base, bool spec,
                                                int* s_nc, int* s_ek, int* s_en) {
  const int i0 = base + (int)threadIdx.x * 16;
  unsigned fl = 0;
  int kk[16], nn[16];
  if (i0 < p.B) {
    if (i0 + 16 <= p.B && aligned16(p.commit + i0)) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p.commit + i0));
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if ((w[e >> 2] >> (8 * (e & 3))) & 0xffu) fl |= 1u << e;
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (i0 + e < p.B && p.commit[i0 + e]) fl |= 1u << e;
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const bool in = i0 + e < p.B && (spec || ((fl >> e) & 1u));
      kk[e] = in ? (int)__ldg(p.class_of + i0 + e) : -1;
      nn[e] = in ? __ldg(p.choice + i0 + e) : 0;
    }
  }
  int o = warp_append(__popc(fl), s_nc);
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if ((fl >> e) & 1u) {
      s_ek[o] = kk[e];
      s_en[o] = min(max(nn[e], 0), p.N - 1);
      ++o;
    }
}

template <int VEC, int ITEMS, int NT>
__device__ __forceinline__ void load_tile(const int32_t* drow, int n0, int N,
                                          int (&dv)[ITEMS][VEC]) {
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int nb = n0 + (it * NT + (int)threadIdx.x) * VEC;
    if (nb < N) {
      ld_i32<VEC>(drow + nb, dv[it]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) dv[it][e] = INT_MAX;
    }
  }
}

// grid: (row slots, node tiles of NT · ITEMS · VEC nodes).
// Dynamic shared memory: the row's C flag bytes (rounded to 16), the
// compacted commits' classes and nodes (CH each), the domain table's keys
// and counts (2^lgH each), the committer row's class list (C).
template <int VEC, int ITEMS, int NT>
__global__ void __launch_bounds__(NT, 1024 / NT) ipa_update_kernel(const UpdatePlan p) {
  constexpr int TILE = NT * ITEMS * VEC;
  constexpr bool SMALL = ITEMS == 1;  // the form of at most 16 rows (latency counts)
  extern __shared__ __align__(16) unsigned char upd_smem[];
  __shared__ int s_nc, s_nj;
  __shared__ int s_red[NT / 32];
  const int C = p.C, N = p.N, D = p.D;
  uint8_t* s_flag = upd_smem;
  int* s_ek = reinterpret_cast<int*>(upd_smem + ((C + 15) & ~15));
  int* s_en = s_ek + p.CH;
  int* s_key = s_en + p.CH;
  int* s_val = s_key + (1 << p.lgH);
  int* s_j = s_val + (1 << p.lgH);
  const int tid = threadIdx.x;

  // the row slot → group, half, class row c and term t
  int gi = 0;
#pragma unroll
  for (int q = 1; q < 4; ++q)
    if (p.g[q].T && (int)blockIdx.x >= p.g[q].slot0) gi = q;
  UpdateGroup G = p.g[0];
  if (gi == 1) G = p.g[1];
  if (gi == 2) G = p.g[2];
  if (gi == 3) G = p.g[3];
  const int T = G.T;
  const int local = blockIdx.x - G.slot0;
  const bool owner = local >= C * T;  // a committer row
  const int rt = owner ? local - C * T : local;  // c · T + t
  const int c = rt / T;
  const bool planes = G.W == N;
  const int n0 = blockIdx.y * TILE;
  if (!owner && !planes && blockIdx.y) return;  // a table row is one block's
  if (!owner && gi == GROUP_REQ_AFF && !__ldg(p.row_valid + rt)) return;
  const int32_t* drow = G.dom + (size_t)rt * N;

  // (a) flags first: the row's class bytes staged (the count cross of its
  // term, or the classes the committer's term matches), the tile's domains
  // prefetched where latency counts (C <= 16) and on a plane's count row
  // (which the full auction's round reaches on most rows)
  const uint8_t* frow = owner ? G.own + (size_t)rt * C
                              : (G.cross ? G.cross + (size_t)rt * C : p.cross_all + (size_t)c * C);
  if ((C & 15) == 0 && aligned16(frow)) {
    for (int x = tid; x < C / 16; x += NT)
      reinterpret_cast<uint4*>(s_flag)[x] = __ldg(reinterpret_cast<const uint4*>(frow) + x);
  } else {
    for (int x = tid; x < C; x += NT) s_flag[x] = __ldg(frow + x);
  }
  const bool prefetch = SMALL || (!owner && planes);
  int dv[ITEMS][VEC], cv[ITEMS][VEC];
  if (prefetch && (owner || planes)) load_tile<VEC, ITEMS, NT>(drow, n0, N, dv);
  // at most 16 rows a plane's count row reads its tile's counts with them
  // too (written back only in the vectors that gain)
  if (SMALL && !owner && planes) load_tile<VEC, ITEMS, NT>(G.cnt + (size_t)rt * N, n0, N, cv);
  if (tid == 0) {
    s_nc = 0;
    s_nj = 0;
  }
  __syncthreads();

  // (b) the commits compacted once, and the row's committed domains into the
  // table: a count row takes the commits its cross names, a committer row
  // its own class's; commits on nodes without the key count nowhere
  int lg = p.lgH, mine = 0;
  auto take_entries = [&](int nc) {
    for (int e = tid; e < nc; e += NT) {
      const int k = s_ek[e];
      if (k < 0 || k >= C || !(owner ? k == c : s_flag[k] != 0)) continue;
      const int d = __ldg(drow + s_en[e]);
      if (d < D) {
        table_add(s_key, s_val, lg, d);
        ++mine;
      }
    }
  };
  if (p.B <= p.CH) {  // one pass: the table sized by the round's commits
    compact_commits(p, 0, SMALL, &s_nc, s_ek, s_en);
    __syncthreads();
    const int nc = s_nc;
    if (nc == 0) return;
    lg = 1;
    while ((1 << lg) < 2 * nc && lg < p.lgH) ++lg;
    for (int h = tid; h < (1 << lg); h += NT) {
      s_key[h] = UPDATE_EMPTY;
      s_val[h] = 0;
    }
    __syncthreads();
    take_entries(nc);
  } else {
    for (int h = tid; h < (1 << lg); h += NT) {
      s_key[h] = UPDATE_EMPTY;
      s_val[h] = 0;
    }
    for (int base = 0; base < p.B; base += p.CH) {
      __syncthreads();
      compact_commits(p, base, SMALL, &s_nc, s_ek, s_en);
      __syncthreads();
      take_entries(s_nc);
      __syncthreads();
      if (tid == 0) s_nc = 0;
    }
  }
  if (!__syncthreads_or(mine)) return;  // the round does not reach this row

  if (!owner) {
    // (c) a count row: aff_total's mass once a row, a table's adds at the
    // committed domains, a plane's on the tile's nodes of those domains
    if (gi == GROUP_REQ_AFF && blockIdx.y == 0) {
      const int m = block_sum_int(mine, s_red);
      if (tid == 0) atomicAdd(p.aff_total + c, m);
    }
    if (!planes) {
      int32_t* crow = G.cnt + (size_t)rt * G.W;
      for (int h = tid; h < (1 << lg); h += NT) {
        const int k = s_key[h];
        if (k != UPDATE_EMPTY) crow[k] += s_val[h];
      }
      return;
    }
    if (!prefetch) load_tile<VEC, ITEMS, NT>(drow, n0, N, dv);
    int32_t* crow = G.cnt + (size_t)rt * N;
    int m[ITEMS][VEC];
    unsigned vm[ITEMS];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      vm[it] = 0;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        m[it][e] = dv[it][e] < D ? table_get(s_key, s_val, lg, dv[it][e]) : 0;
        if (m[it][e]) vm[it] |= 1u << e;
      }
    }
    // above 16 rows every hit vector's counts loaded now, before any is written
    if (!SMALL) {
#pragma unroll
      for (int it = 0; it < ITEMS; ++it)
        if (vm[it]) ld_i32<VEC>(crow + n0 + (it * NT + tid) * VEC, cv[it]);
    }
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      if (!vm[it]) continue;
      int32_t* q = crow + n0 + (it * NT + tid) * VEC;
      if constexpr (VEC == 4) {
        *reinterpret_cast<int4*>(q) = make_int4(cv[it][0] + m[it][0], cv[it][1] + m[it][1],
                                                cv[it][2] + m[it][2], cv[it][3] + m[it][3]);
      } else {
        q[0] = cv[it][0] + m[it][0];
      }
    }
    return;
  }

  // (d) a committer row: the classes its term matches compacted once, then
  // on the tile's nodes of its committed domains the block (required
  // anti-affinity) or ±weight · commits into each such class's score (float
  // atomics of integer values: exact in any order below 2^24)
  for (int x0 = 0; x0 < C; x0 += 16 * NT) {
    const int x = x0 + tid * 16;
    unsigned fl = 0;
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (x + e < C && s_flag[x + e]) fl |= 1u << e;
    int o = warp_append(__popc(fl), &s_nj);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if ((fl >> e) & 1u) s_j[o++] = x + e;
  }
  __syncthreads();
  const int nj = s_nj;
  if (nj == 0) return;
  if (!prefetch) load_tile<VEC, ITEMS, NT>(drow, n0, N, dv);
  const bool block = gi == GROUP_REQ_ANTI;
  const float w = block ? 0.0f : (G.wt ? __ldg(G.wt + rt) : G.w_scalar);
  const float sign = gi == 3 ? -1.0f : 1.0f;
  int m[ITEMS][VEC];
  unsigned vm[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    vm[it] = 0;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      m[it][e] = dv[it][e] < D ? table_get(s_key, s_val, lg, dv[it][e]) : 0;
      if (m[it][e]) vm[it] |= 1u << e;
    }
  }
  auto put = [&](int j, int n, int mv) {
    const size_t jn = (size_t)j * N + n;
    if (block) {
      p.block_dyn[jn] = 1;
    } else {
      atomicAdd(p.score_dyn + jn, __fmul_rn(sign, __fmul_rn(w, (float)mv)));
    }
  };
  if (nj <= UPDATE_FEW_CLASSES) {  // the hit node's thread writes its classes
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      if (!vm[it]) continue;
      const int nb = n0 + (it * NT + tid) * VEC;
      for (int jj = 0; jj < nj; ++jj) {
        const int j = s_j[jj];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if ((vm[it] >> e) & 1u) put(j, nb + e, m[it][e]);
      }
    }
  } else {  // the warp writes a hit vector's classes together
    const int lane = tid & 31;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      unsigned lanes = __ballot_sync(0xffffffffu, vm[it] != 0u);
      while (lanes) {
        const int src = __ffs(lanes) - 1;
        lanes &= lanes - 1u;
        const int nb = __shfl_sync(0xffffffffu, n0 + (it * NT + tid) * VEC, src);
        const unsigned hm = __shfl_sync(0xffffffffu, vm[it], src);
        int mv[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) mv[e] = __shfl_sync(0xffffffffu, m[it][e], src);
        for (int jj = lane; jj < nj; jj += 32) {
          const int j = s_j[jj];
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            if ((hm >> e) & 1u) put(j, nb + e, mv[e]);
        }
      }
    }
  }
}

extern "C" int launch_ipa_update(
    int B, int C, int N, int D, const void* commit, const void* choice, const void* class_of,
    int T1, int W1, const void* dom_aff, void* aff_cnt, const void* aff_term_cross,
    const void* aff_cross_all, const void* req_aff_valid, void* aff_total, float hard_weight,
    int T2, int W2, const void* dom_anti, void* anti_cnt, const void* anti_cross,
    int T3, int W3, const void* dom_paff, void* paff_cnt, const void* paff_cross,
    const void* paff_weight,
    int T4, int W4, const void* dom_panti, void* panti_cnt, const void* panti_cross,
    const void* panti_weight,
    void* block_dyn, void* score_dyn, void* stream) {
  if (B <= 0 || C <= 0 || N <= 0 || D <= 0) return 0;
  UpdatePlan p;
  p.g[GROUP_REQ_AFF] = UpdateGroup{T1, W1, (const int32_t*)dom_aff, (int32_t*)aff_cnt, nullptr,
                                   (const uint8_t*)aff_term_cross, nullptr, hard_weight, 0};
  p.g[GROUP_REQ_ANTI] = UpdateGroup{T2, W2, (const int32_t*)dom_anti, (int32_t*)anti_cnt,
                                    (const uint8_t*)anti_cross, (const uint8_t*)anti_cross,
                                    nullptr, 0.0f, 0};
  p.g[2] = UpdateGroup{T3, W3, (const int32_t*)dom_paff, (int32_t*)paff_cnt,
                       (const uint8_t*)paff_cross, (const uint8_t*)paff_cross,
                       (const float*)paff_weight, 0.0f, 0};
  p.g[3] = UpdateGroup{T4, W4, (const int32_t*)dom_panti, (int32_t*)panti_cnt,
                       (const uint8_t*)panti_cross, (const uint8_t*)panti_cross,
                       (const float*)panti_weight, 0.0f, 0};
  p.cross_all = (const uint8_t*)aff_cross_all;
  p.row_valid = (const uint8_t*)req_aff_valid;
  p.aff_total = (int32_t*)aff_total;
  p.block_dyn = (uint8_t*)block_dyn;
  p.score_dyn = (float*)score_dyn;
  p.commit = (const uint8_t*)commit;
  p.choice = (const int32_t*)choice;
  p.class_of = (const long long*)class_of;
  p.B = B; p.C = C; p.N = N; p.D = D;
  long long slots = 0;
  bool vec4 = N % 4 == 0;
  for (int gi = 0; gi < 4; ++gi) {
    UpdateGroup& g = p.g[gi];
    g.slot0 = (int)slots;
    if (!g.T) continue;
    slots += 2LL * C * g.T;
    vec4 = vec4 && aligned16(g.dom) && (g.W != N || aligned16(g.cnt));
  }
  if (slots == 0) return 0;
  if (slots > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // at most 16 rows a vector a thread and tiles of 1024 nodes (latency
  // counts); above, a tile of 8192 nodes (four vectors a thread of 512):
  // each block's flags and table serve the whole row at N = 8192
  const bool small = C <= 16;
  const int nt = small ? 256 : UPDATE_THREADS;
  p.CH = B < 16 * nt ? B : 16 * nt;
  // the table holds at most min(B, D) domains, at most half full
  const long long most = B < D ? B : D;
  p.lgH = 1;
  while ((1LL << p.lgH) < 2 * most) ++p.lgH;
  const size_t smem = (size_t)((C + 15) & ~15) + 8 * (size_t)p.CH +
                      8 * ((size_t)1 << p.lgH) + 4 * (size_t)C;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int vec = vec4 ? 4 : 1;
  const int items = small ? 1 : 4;
  const void* fn = vec4 ? (small ? (const void*)ipa_update_kernel<4, 1, 256>
                                 : (const void*)ipa_update_kernel<4, 4, UPDATE_THREADS>)
                        : (small ? (const void*)ipa_update_kernel<1, 1, 256>
                                 : (const void*)ipa_update_kernel<1, 4, UPDATE_THREADS>);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tile = nt * items * vec;
  dim3 grid((unsigned)slots, (unsigned)((N + tile - 1) / tile));
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4) {
    if (small) ipa_update_kernel<4, 1, 256><<<grid, nt, smem, s>>>(p);
    else ipa_update_kernel<4, 4, UPDATE_THREADS><<<grid, nt, smem, s>>>(p);
  } else {
    if (small) ipa_update_kernel<1, 1, 256><<<grid, nt, smem, s>>>(p);
    else ipa_update_kernel<1, 4, UPDATE_THREADS><<<grid, nt, smem, s>>>(p);
  }
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
  bool vec4 = N % 4 == 0 && aligned16(score_dyn);
  for (int gi = 0; gi < 4; ++gi) {
    const RowGroup& g = gs.g[gi];
    if (g.T) vec4 = vec4 && aligned16(g.dom) && (g.W != N || aligned16(g.cnt));
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
