// K4 auction_resolve_commit: one round's propose/resolve auction to its
// fixpoint, then the scatter-add commit of the winners' requests.
//
// Replaces (JAX package): framework/runtime.py _batch_assign_dedup —
// the `pbody` while_loop (:898-925) and `apply_dyn` (:929-939).  Each
// unresolved pod bids for the first still-unused feasible entry of its
// class's candidate list (or its nominated row); every contested node goes
// to the bidder with the smallest serial position; winners mark their node
// used; losers bid again; pods with no candidate left drop out.  The loop
// ends when no pod is unresolved.
//
// Design: one persistent block, one thread per pod (B ≤ 1024).  The `used`
// node set is a bitmap in shared memory (N/8 bytes: 16 KiB at N = 131072).
// The per-node minimum bidder position is global scratch reached with
// atomicMin; only the entries bid on in an iteration are touched, and each
// is reset by its bidders before the atomics (reset, barrier, atomicMin,
// barrier, read), so the scratch needs no initialisation.  Each pod keeps a
// cursor into its class list: `used` only grows, so the first usable entry
// never moves back and a pod's scans total O(K) per round — with identical
// pods the fixpoint takes up to B iterations, which would otherwise cost
// O(B·K) each.  Bound on the card: latency — B dependent iterations of a
// few block barriers; the bytes moved (candidate lists, pod rows, the
// committed rows of requested/non_zero) are tens of kilobytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

__device__ __forceinline__ bool bit_get(const uint32_t* bm, int i) {
  return (bm[i >> 5] >> (i & 31)) & 1u;
}

__global__ void auction_kernel(int B, int N, int K, int R,
                               const float* __restrict__ cand_val,   // [C, K]
                               const int32_t* __restrict__ cand_idx, // [C, K]
                               const int32_t* __restrict__ class_of, // [B]
                               const int32_t* __restrict__ pos_of,   // [B]
                               const uint8_t* __restrict__ unresolved0, // [B]
                               const int32_t* __restrict__ nom,      // [B] clipped row
                               const uint8_t* __restrict__ nom_ok,   // [B]
                               const int32_t* __restrict__ request,  // [B, R]
                               const int32_t* __restrict__ pod_nz,   // [B, 2]
                               int32_t* __restrict__ requested,      // [N, R] in/out
                               int32_t* __restrict__ node_nz,        // [N, 2] in/out
                               int32_t* __restrict__ minpos,         // [N] scratch
                               int32_t* __restrict__ commit_out,     // [B]
                               int32_t* __restrict__ choice_out) {   // [B]
  extern __shared__ uint32_t used[];
  const int words = (N + 31) / 32;
  const int tid = threadIdx.x;
  for (int w = tid; w < words; w += blockDim.x) used[w] = 0u;
  const bool pod = tid < B;
  bool unres = pod && unresolved0[tid];
  const int c = pod ? class_of[tid] : 0;
  const int pos = pod ? pos_of[tid] : 0;
  const float* cv = cand_val + (long long)c * K;
  const int32_t* ci = cand_idx + (long long)c * K;
  int cursor = 0;
  bool commit = false;
  int choice = 0;
  __syncthreads();

  while (__syncthreads_or(unres)) {
    // --- propose (reads `used`) ---------------------------------------------
    bool has_bid = false;
    int prop = 0;
    if (unres) {
      if (nom_ok[tid] && !bit_get(used, nom[tid])) {
        prop = nom[tid];
        has_bid = true;
      } else {
        while (cursor < K) {
          if (!(cv[cursor] > -INFINITY)) {  // −inf tail: no candidate left
            cursor = K;
            break;
          }
          if (!bit_get(used, ci[cursor])) break;
          ++cursor;
        }
        has_bid = cursor < K;
        prop = has_bid ? ci[cursor] : 0;
      }
    }
    const bool bidder = unres && has_bid;
    // --- resolve: smallest serial position wins each contested node ------------
    if (bidder) minpos[prop] = INT32_MAX;
    __syncthreads();
    if (bidder) atomicMin(&minpos[prop], pos);
    __syncthreads();
    const bool win = bidder && (minpos[prop] == pos);
    if (win) {
      commit = true;
      choice = prop;
      atomicOr(&used[prop >> 5], 1u << (prop & 31));
    }
    unres = unres && !win && has_bid;
    __syncthreads();
  }

  // --- commit: scatter-add the winners' requests (one winner per node) ----------
  if (pod) {
    commit_out[tid] = commit ? 1 : 0;
    choice_out[tid] = commit ? choice : 0;
    if (commit) {
      for (int r = 0; r < R; ++r)
        atomicAdd(&requested[(long long)choice * R + r], request[tid * R + r]);
      atomicAdd(&node_nz[(long long)choice * 2 + 0], pod_nz[tid * 2 + 0]);
      atomicAdd(&node_nz[(long long)choice * 2 + 1], pod_nz[tid * 2 + 1]);
    }
  }
}

extern "C" int launch_auction(int B, int N, int K, int R, const void* cand_val,
                              const void* cand_idx, const void* class_of,
                              const void* pos_of, const void* unresolved0,
                              const void* nom, const void* nom_ok,
                              const void* request, const void* pod_nz,
                              void* requested, void* node_nz, void* minpos,
                              void* commit_out, void* choice_out, void* stream) {
  if (B > 1024) return (int)cudaErrorInvalidValue;
  const int threads = ((B + 31) / 32) * 32;
  const size_t smem = (size_t)((N + 31) / 32) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  auction_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      B, N, K, R, (const float*)cand_val, (const int32_t*)cand_idx,
      (const int32_t*)class_of, (const int32_t*)pos_of,
      (const uint8_t*)unresolved0, (const int32_t*)nom, (const uint8_t*)nom_ok,
      (const int32_t*)request, (const int32_t*)pod_nz, (int32_t*)requested,
      (int32_t*)node_nz, (int32_t*)minpos, (int32_t*)commit_out,
      (int32_t*)choice_out);
  return (int)cudaGetLastError();
}
