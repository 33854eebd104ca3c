// K4 auction_resolve_commit: one round's propose/resolve auction to its
// fixpoint, then the scatter-add commit of the winners' requests.
//
// Replaces (JAX package): framework/runtime.py _batch_assign_dedup —
// the `pbody` while_loop (:898-925) and `apply_dyn` (:929-939).  Each
// unresolved pod bids for its nominated row while that row is unused, else
// for the first still-unused finite entry of its class's candidate list;
// every contested node goes to the bidder with the smallest serial position;
// winners mark their node used; losers bid again; pods with no bid left drop
// out.  The loop ends when no pod is unresolved.
//
// Design: one persistent block, one thread per pod (B <= 1024).
//   * `used` is a bitmap in shared memory (N/8 bytes).  The per-node
//     minimum bidder position is double-buffered: iteration t resolves in
//     buffer t & 1 and resets, in buffer (t + 1) & 1, the entries its
//     bidders touched in iteration t - 1 — no reset pass, two barriers an
//     iteration (after the bids; the loop condition after the wins).  Both
//     buffers live in shared memory up to N = SMEM_MAX_N (64 KB at
//     N = 8192), in global scratch above it (the 131072 tier).
//   * The resolve is warp-aggregated: __match_any_sync groups a warp's
//     bidders by node and __reduce_min_sync takes each group's smallest
//     position, so a warp issues one atomicMin per distinct node, not one
//     per bidder.
//   * Each pod keeps a cursor into its class list: `used` only grows, so the
//     first usable entry never moves back and a pod's scans total O(K).  The
//     list comes through a window of WINDOW registers (the node, or -1 for a
//     -inf entry), loaded WINDOW entries at a time with independent loads,
//     and the window's entries are tested against `used` all at once (a
//     bit mask, its lowest bit the bid): a pod that must skip many taken
//     nodes pays one latency per WINDOW entries, not two dependent loads
//     and a shared read per entry.
//   * The one-class closed form, for a common prefix.  Suppose that at the
//     start of an iteration no unresolved pod can take its nominated row
//     (nom_ok && !used[nom] fails for each) and the usable entries of every
//     unresolved pod's list (finite, unused, in list order) begin with the
//     same m entries e_0 .. e_{m-1}.  Then every unresolved pod bids e_0;
//     the smallest position wins it and e_0 becomes used; nothing else
//     changes `used` (there is no other bid), and no nominated row becomes
//     usable (`used` only grows).  So the next iteration is the same
//     situation with e_1 and the remaining pods, and so on for m
//     iterations: the pod of rank r by position takes e_r for r < m, and
//     the others stay unresolved with e_0 .. e_{m-1} used.  When every pod
//     has one class (one list) m is the list's usable length or the pod
//     count, so one step ends the round: the pod of rank r takes e_r and the
//     pods past the list's usable entries drop in the iteration after.  The
//     kernel tries the form at the first iteration and whenever the
//     iteration before resolved exactly one pod (a contention chain,
//     where every pod bids the same node; a short or failed try backs off
//     exponentially): one scan numbers the usable entries of a reference
//     list (the class of the last winner, at first the smallest class),
//     the list of each pod of another class is walked against them by a
//     warp (32 entries a step, coalesced, 32 * SPAN of them loaded at once:
//     a thread per pod would read 32 rows a load), a block-wide minimum
//     gives m, and one scan over positions ranks the pods
//     (positions must be distinct and in [0, B), as the caller's
//     permutation is; otherwise the kernel stays in the loop).  One
//     identical-pod round (NorthStar: 512 pods, one list) then resolves in
//     one iteration instead of 512, and a chain of distinct but agreeing
//     lists (the heterogeneous backlog's C = 512 rounds) in a few.
// Bound on the card: latency — dependent iterations of two block barriers;
// the bytes moved (candidate lists, pod rows, the committed rows of
// requested / non_zero) are tens of kilobytes.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define MAX_B 1024
#define SMEM_MAX_N 24576
#define WINDOW 8
#define SPAN 16
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ bool bit_get(const uint32_t* bm, int i) {
  return (bm[i >> 5] >> (i & 31)) & 1u;
}

// Exclusive prefix sum of one int a thread over the block (blockDim.x a
// multiple of 32); *total gets the block's sum.  `wsum` is 32 ints of shared
// scratch; the closing barrier lets the caller reuse it at once.
__device__ __forceinline__ int block_excl_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, w, o);
      if (lane >= o) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  const int before = warp ? wsum[warp - 1] : 0;
  *total = wsum[nw - 1];
  __syncthreads();
  return before + x - v;
}

template <bool SMEM_MINPOS>
__global__ void __launch_bounds__(1024, 1)
auction_kernel(int B, int N, int K, int R,
               const float* __restrict__ cand_val,      // [C, K]
               const int32_t* __restrict__ cand_idx,    // [C, K]
               const int32_t* __restrict__ class_of,    // [B]
               const int32_t* __restrict__ pos_of,      // [B]
               const uint8_t* __restrict__ unresolved0, // [B]
               const int32_t* __restrict__ nom,         // [B] clipped row
               const uint8_t* __restrict__ nom_ok,      // [B]
               const int32_t* __restrict__ request,     // [B, R]
               const int32_t* __restrict__ pod_nz,      // [B, 2]
               int32_t* __restrict__ requested,         // [N, R] in/out
               int32_t* __restrict__ node_nz,           // [N, 2] in/out
               int32_t* __restrict__ minpos_g,          // [2, N] scratch (global form)
               uint8_t* __restrict__ commit_out,        // [B] bool
               int32_t* __restrict__ choice_out,        // [B]
               int32_t* __restrict__ iters_out) {       // [2] or null
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int by_pos[MAX_B];   // prefix form: the pod at each position
  __shared__ int rank_of[MAX_B];  // prefix form: each pod's rank by position
  __shared__ int entry[MAX_B];    // prefix form: the reference's r-th usable entry
  __shared__ int walk_from[MAX_B];  // prefix form: where each pod's walk starts (-1: none)
  __shared__ int wsum[32];
  __shared__ int s_ref;           // prefix form: the reference class
  __shared__ int s_m;

  const int words = (N + 31) >> 5;
  uint32_t* used = smem;
  int32_t* mp = SMEM_MINPOS ? (int32_t*)(smem + words) : minpos_g;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  for (int w = tid; w < words; w += nt) used[w] = 0u;
  for (int j = tid; j < 2 * N; j += nt) mp[j] = INT_MAX;
  for (int p = tid; p < MAX_B; p += nt) by_pos[p] = -1;
  if (tid == 0) s_ref = INT_MAX;
  const bool pod = tid < B;
  bool unres = pod && unresolved0[tid];
  const int c = pod ? class_of[tid] : 0;
  const int pos = pod ? pos_of[tid] : 0;
  const bool nomok = pod && nom_ok[tid];
  const int nomrow = pod ? nom[tid] : 0;
  const float* cv = cand_val + (long long)c * K;
  const int32_t* ci = cand_idx + (long long)c * K;
  // the window: list entries wstart .. wstart + held - 1; the cursor is wstart + off
  int wnd[WINDOW], wstart = 0, held = 0, off = 0;
  // the first usable entry at or after the cursor (the cursor moves to it),
  // or -1 when the list has none left
  auto first_usable = [&]() -> int {
    while (true) {
      if (off == held) {  // the window is used up: the next WINDOW entries
        if (wstart + held >= K) return -1;
        wstart += held;
        off = 0;
        held = min(WINDOW, K - wstart);
        float val[WINDOW];
#pragma unroll
        for (int q = 0; q < WINDOW; ++q) {  // every load before any is used
          const int j = min(wstart + q, K - 1);
          val[q] = __ldg(cv + j);
          wnd[q] = __ldg(ci + j);
        }
#pragma unroll
        for (int q = 0; q < WINDOW; ++q)
          if (q >= held || !(val[q] > -INFINITY)) wnd[q] = -1;
      }
      unsigned usable = 0u;
#pragma unroll
      for (int q = 0; q < WINDOW; ++q)
        if (q >= off && wnd[q] >= 0 && !bit_get(used, wnd[q])) usable |= 1u << q;
      if (usable) {
        off = __ffs(usable) - 1;
        int node = 0;
#pragma unroll
        for (int q = 0; q < WINDOW; ++q)
          if (q == off) node = wnd[q];
        return node;
      }
      off = held;
    }
  };
  int prev_prop = -1, it = 0, steps = 0, n_prev = 0;
  int next_try = 0, gap = 1;  // the prefix form's back-off
  bool try_prefix = true, commit = false;
  int choice = 0;
  __syncthreads();
  if (unres) atomicMin(&s_ref, c);

  int n_unres;
  while ((n_unres = __syncthreads_count(unres)) > 0) {
    const int par = it & 1;
    int32_t* cur = mp + (size_t)par * N;
    // the other buffer's entries of iteration it - 1 (read before the
    // barrier above) back to "no bid"
    if (prev_prop >= 0) mp[(size_t)(par ^ 1) * N + prev_prop] = INT_MAX;
    prev_prop = -1;
    const bool chain = it == 0 || n_prev - n_unres == 1;
    n_prev = n_unres;
    ++it;
    if (try_prefix && chain && it > next_try) {
      // --- the prefix form (see the header) ------------------------------------
      const int ref = s_ref;  // (its writers ran before the barrier above)
      int m = 0;
      if (!__syncthreads_or(unres && nomok && !bit_get(used, nomrow))) {
        const float* lv = cand_val + (long long)ref * K;
        const int32_t* li = cand_idx + (long long)ref * K;
        int carry = 0, tot;
        for (int j0 = 0; j0 < K && carry < n_unres; j0 += nt) {  // the reference's usable entries
          const int j = j0 + tid;
          const bool ok = j < K && lv[j] > -INFINITY && !bit_get(used, li[j]);
          const int r = carry + block_excl_scan(ok, wsum, &tot);
          if (ok && r < MAX_B) entry[r] = li[j];
          carry += tot;
        }
        if (tid == 0) s_m = min(carry, n_unres);
        __syncthreads();
        // how far each pod's usable entries agree with them: the reference's
        // own class agrees throughout; another class's list is walked by a
        // warp, 32 entries a step, SPAN entries loaded at once
        if (pod) walk_from[tid] = (unres && c != ref) ? wstart + off : -1;
        const bool walks = __syncthreads_or(unres && c != ref);
        const int lim = s_m;
        const unsigned below = (1u << lane) - 1u;
        for (int p = tid >> 5; walks && p < B; p += nt >> 5) {
          const int start = walk_from[p];
          if (start < 0) continue;
          const long long row = (long long)class_of[p] * K;
          int agree = 0;
          bool done = false;
          for (int j0 = start; !done && agree < lim && j0 < K; j0 += 32 * SPAN) {
            // every load issued before any is used (a load that waits on
            // the one before it would pay one latency an entry)
            float val[SPAN];
            int node[SPAN];
#pragma unroll
            for (int q = 0; q < SPAN; ++q) {
              const int j = min(j0 + 32 * q + lane, K - 1);
              val[q] = __ldg(cand_val + row + j);
              node[q] = __ldg(cand_idx + row + j);
            }
#pragma unroll
            for (int q = 0; q < SPAN; ++q)
              if (j0 + 32 * q + lane >= K || !(val[q] > -INFINITY)) node[q] = -1;
            // the chunks' usable masks and checks are independent of one
            // another but for the running usable count: all reads first
            unsigned lm[SPAN];
#pragma unroll
            for (int q = 0; q < SPAN; ++q)
              lm[q] = __ballot_sync(FULL_MASK, node[q] >= 0 && !bit_get(used, node[q]));
            int base = agree, first_bad = -1;
#pragma unroll
            for (int q = 0; q < SPAN; ++q) {
              const int u = base + __popc(lm[q] & below);  // this entry's usable index
              const bool live = (lm[q] >> lane) & 1u;
              const unsigned bad = __ballot_sync(FULL_MASK, live && u < lim && node[q] != entry[u]);
              if (bad && first_bad < 0)
                first_bad = base + __popc(lm[q] & ((1u << (__ffs(bad) - 1)) - 1u));
              base += __popc(lm[q]);
            }
            done = first_bad >= 0;
            agree = min(done ? first_bad : base, lim);
          }
          if (lane == 0 && agree < lim) atomicMin(&s_m, agree);
        }
        __syncthreads();
        m = s_m;
        if (m > 0) {
          bool bad = false;
          if (unres) bad = pos < 0 || pos >= B || atomicExch(&by_pos[pos], tid) != -1;
          if (__syncthreads_or(bad)) {
            try_prefix = false;  // positions not a permutation: the loop only
            m = 0;
          } else {
            carry = 0;
            for (int p0 = 0; p0 < B; p0 += nt) {  // rank by position
              const int p = p0 + tid;
              const int who = p < B ? by_pos[p] : -1;
              const int r = carry + block_excl_scan(who >= 0, wsum, &tot);
              if (who >= 0) rank_of[who] = r;
              carry += tot;
            }
            __syncthreads();
            if (unres) {
              by_pos[pos] = -1;
              const int r = rank_of[tid];
              if (r < m) {
                commit = true;
                choice = entry[r];
                atomicOr(&used[choice >> 5], 1u << (choice & 31));
                unres = false;
              }
            }
          }
        }
      }
      if (m > 1) gap = 1;
      if (m <= 1) {  // as much as a plain iteration, or less: back off
        next_try = it + gap;
        gap = min(2 * gap, 64);
      }
      if (m > 0) {
        ++steps;
        continue;
      }
    }
    // --- propose (reads `used`) ---------------------------------------------
    bool has_bid = false;
    int prop = 0;
    if (unres) {
      if (nomok && !bit_get(used, nomrow)) {
        has_bid = true;
        prop = nomrow;
      } else {
        prop = first_usable();
        has_bid = prop >= 0;
      }
    }
    const bool bidder = unres && has_bid;
    // --- resolve: one atomicMin per distinct node per warp --------------------
    const unsigned peers = __match_any_sync(FULL_MASK, bidder ? prop : -1);
    const int gmin = __reduce_min_sync(peers, bidder ? pos : INT_MAX);
    if (bidder && lane == __ffs(peers) - 1) atomicMin(&cur[prop], gmin);
    __syncthreads();
    const bool win = bidder && cur[prop] == pos;
    if (win) {
      commit = true;
      choice = prop;
      atomicOr(&used[prop >> 5], 1u << (prop & 31));
      s_ref = c;  // any winner's class will do as the next reference
    }
    unres = unres && !win && has_bid;
    prev_prop = bidder ? prop : -1;
  }

  // --- commit: scatter-add the winners' requests (one winner per node) ----------
  if (pod) {
    commit_out[tid] = commit ? 1u : 0u;
    choice_out[tid] = commit ? choice : 0;
    if (commit) {
      for (int r = 0; r < R; ++r)
        atomicAdd(&requested[(long long)choice * R + r], request[tid * R + r]);
      atomicAdd(&node_nz[(long long)choice * 2 + 0], pod_nz[tid * 2 + 0]);
      atomicAdd(&node_nz[(long long)choice * 2 + 1], pod_nz[tid * 2 + 1]);
    }
  }
  if (iters_out && tid == 0) {
    iters_out[0] = it;
    iters_out[1] = steps;
  }
}

// int32 words of global scratch the launch needs for N nodes (0: the
// minimum lives in shared memory)
extern "C" long long auction_scratch_words(int N) {
  return N <= SMEM_MAX_N ? 0 : 2LL * N;
}

template <bool SMEM_MINPOS>
static int launch(int B, int N, int K, int R, const void* cand_val, const void* cand_idx,
                  const void* class_of, const void* pos_of, const void* unresolved0,
                  const void* nom, const void* nom_ok, const void* request,
                  const void* pod_nz, void* requested, void* node_nz, void* minpos,
                  void* commit_out, void* choice_out, void* iters_out,
                  cudaStream_t stream) {
  const int threads = ((B + 31) / 32) * 32;
  const size_t smem = (size_t)((N + 31) / 32) * 4 + (SMEM_MINPOS ? (size_t)N * 8 : 0);
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        auction_kernel<SMEM_MINPOS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  auction_kernel<SMEM_MINPOS><<<1, threads, smem, stream>>>(
      B, N, K, R, (const float*)cand_val, (const int32_t*)cand_idx,
      (const int32_t*)class_of, (const int32_t*)pos_of, (const uint8_t*)unresolved0,
      (const int32_t*)nom, (const uint8_t*)nom_ok, (const int32_t*)request,
      (const int32_t*)pod_nz, (int32_t*)requested, (int32_t*)node_nz, (int32_t*)minpos,
      (uint8_t*)commit_out, (int32_t*)choice_out, (int32_t*)iters_out);
  return (int)cudaGetLastError();
}

extern "C" int launch_auction(int B, int N, int K, int R, const void* cand_val,
                              const void* cand_idx, const void* class_of,
                              const void* pos_of, const void* unresolved0,
                              const void* nom, const void* nom_ok,
                              const void* request, const void* pod_nz,
                              void* requested, void* node_nz, void* minpos,
                              void* commit_out, void* choice_out, void* iters_out,
                              void* stream) {
  if (B < 1 || B > MAX_B || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (N <= SMEM_MAX_N)
    return launch<true>(B, N, K, R, cand_val, cand_idx, class_of, pos_of, unresolved0,
                        nom, nom_ok, request, pod_nz, requested, node_nz, minpos,
                        commit_out, choice_out, iters_out, (cudaStream_t)stream);
  if (minpos == nullptr) return (int)cudaErrorInvalidValue;
  return launch<false>(B, N, K, R, cand_val, cand_idx, class_of, pos_of, unresolved0, nom,
                       nom_ok, request, pod_nz, requested, node_nz, minpos, commit_out,
                       choice_out, iters_out, (cudaStream_t)stream);
}
