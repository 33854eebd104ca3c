// K24–K26: DynamicResources' device half — the claim filter, the tight-pack
// score and the device assume of the chips a placed pod's claims take.
//
// Replaces (JAX package): dra/plugin.py DynamicResourcesPlugin.filter
// (:109) and filter_row (:117); _score_plane (:127) through score (:137) and
// score_row (:142), with normalize (:147), floored and weighted by
// framework/runtime.py run_scores (:206-218); update (:152), update_batch
// (:157) and update_batch_classes (:163).
//
// Inputs per row c (a pod, or a class row): demand[c], the chips the pod's
// pending claims need; pinned[c], the node row an allocated claim pins it
// to (below 0: none); blocked[c], an unresolvable claim.  Per node n:
// cap[n], the chips its ResourceSlices publish; free[n] = cap − allocated,
// carried through an engine's rounds or steps (may be negative where a
// slice shrank under allocated claims).
//
// K24 dra_filter_bits: one thread per (row, node); clears DynamicResources'
//   bit of K1's pass-bit plane where free[n] < demand[c], the row is pinned
//   to another node, or the row is blocked.  Bound: bytes (the plane's
//   failing words written; demand / pinned / blocked and free read once).
// K25 dra_score_into: a thread takes 4 consecutive nodes of RPT rows (RPT
//   the fewest of 1, 2, 4, 8 that keep the grid to one wave of the card:
//   1 at C = 64, N = 8192, 4 at C = 512; one node of one row a thread
//   where 4-node threads would leave the card under 256 threads an SM, as
//   on the scan's one row).  At entry it issues the nodes' cap and free as
//   int4 once for all its rows and each row's demand and bit words as
//   int4; then a row's totals as a float4 only where one of its bit words
//   is full (most entries of a claim round are infeasible: loading every
//   total at entry measured slower at C = 64 and 512 and no faster
//   anywhere).  On each feasible entry (all `full` bits set) it adds
//   w · raw into K2's total and stores a float4 where any of the four is
//   feasible (the others written back as loaded), where raw is the
//   reference's float32 arithmetic in its order:
//     used = (cap − free) + demand, raw = floor(used · 100 / max(cap, 1)),
//     clipped to [0, 100]; 0 where demand ≤ 0 or cap ≤ 0.
//   Each step is one correctly rounded float32 operation (__fsub_rn,
//   __fadd_rn, __fmul_rn, __fdiv_rn; --fmad=false -prec-div=true): the
//   operands are integers below 2^24, so used and used · 100 are exact and
//   only the division rounds, as in the reference.  A reciprocal form
//   (used · 100 · (1 / cap)) moves the floor at 25 (used, cap) pairs with
//   cap ≤ 256 (the first: used = cap = 61 gives 99), a divide-first form
//   ((used / cap) · 100) at 4 (the first: used 53, cap 100 gives 52).  The
//   normalize is the identity on feasible nodes (the raw score is already
//   0..100 and integral), so no row reduction.  Infeasible entries keep the
//   total's −inf.  Bound: bytes (bits and total read, total written).
// K26 dra_take: one thread per pod; a committed pod (the auction's commit
//   mask; the scan's pod when its node is ≥ 0) takes its row's demand (its
//   class row's: class_of is the auction's int64 index, read as it is)
//   from free[node] with an integer atomicSub.  The reference sums the
//   round's demands per node in float32 (an einsum) and casts back: equal
//   to the integer sum below 2^24 chips a node, so the atomics' order
//   cannot change a result.  Bound: latency (≤ B threads, a few hundred
//   bytes).

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void dra_filter_bits_kernel(int C, int N, const int32_t* __restrict__ demand,
                                       const int32_t* __restrict__ pinned,
                                       const uint8_t* __restrict__ blocked,
                                       const int32_t* __restrict__ free_, int bit,
                                       int32_t* __restrict__ bits) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)C * N) return;
  const int c = (int)(k / N);
  const int n = (int)(k - (long long)c * N);
  const int pin = pinned[c];
  const bool ok = free_[n] >= demand[c] && (pin < 0 || n == pin) && !blocked[c];
  if (!ok) bits[k] &= ~(1 << bit);
}

// K25: V (4, or 1 on a small grid) consecutive nodes of RPT rows a thread
#define SCORE_THREADS 128
#define SCORE_VEC 4
#define SCORE_WAVE (132 * 2048)  // threads an H100 holds at once: one wave
#define SCORE_SMALL (132 * 256)  // fewer 4-node threads: one node a thread

// the reference's raw score of one entry from the node's (cap, cap - free)
__device__ __forceinline__ float dra_raw(int d, int cp, float held) {
  if (!(d > 0 && cp > 0)) return 0.0f;
  const float capf = (float)cp;
  const float used = __fadd_rn(held, (float)d);
  const float q = __fdiv_rn(__fmul_rn(used, 100.0f), fmaxf(capf, 1.0f));
  return fminf(fmaxf(floorf(q), 0.0f), 100.0f);
}

template <int RPT, int V>
__global__ void __launch_bounds__(SCORE_THREADS)
dra_score_into_kernel(int C, int N, int vec, const int32_t* __restrict__ bits, int full,
                      const int32_t* __restrict__ cap, const int32_t* __restrict__ free_,
                      const int32_t* __restrict__ demand, float weight,
                      float* __restrict__ total) {
  const int n = V * (blockIdx.x * SCORE_THREADS + threadIdx.x);
  if (n >= N) return;
  const int c0 = blockIdx.y * RPT;
  // node n + j is one where j < left (no min / max: see csrc/preempt.cu K28)
  const int left = N - n;
  const bool v4 = V == SCORE_VEC && vec && left >= SCORE_VEC;
  // every load at entry: the nodes' cap and free once, each row's demand
  // and bit words
  int cp[SCORE_VEC], fr[SCORE_VEC], bw[RPT][SCORE_VEC], d[RPT];
  float tt[RPT][SCORE_VEC];
  if (v4) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(cap + n));
    const int4 f = __ldg(reinterpret_cast<const int4*>(free_ + n));
    cp[0] = a.x; cp[1] = a.y; cp[2] = a.z; cp[3] = a.w;
    fr[0] = f.x; fr[1] = f.y; fr[2] = f.z; fr[3] = f.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      cp[j] = j < left ? __ldg(cap + n + j) : 0;
      fr[j] = j < left ? __ldg(free_ + n + j) : 0;
    }
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int c = c0 + k;
    const long long g = (long long)c * N + n;
    d[k] = c < C ? __ldg(demand + c) : 0;
    if (c < C && v4) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(bits + g));
      bw[k][0] = w.x; bw[k][1] = w.y; bw[k][2] = w.z; bw[k][3] = w.w;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const bool in = c < C && j < left;
        bw[k][j] = in ? __ldg(bits + g + j) : ~full;
      }
    }
  }
  // the totals only where a bit word is full: most entries of a claim
  // round are infeasible, and their totals need no read
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const long long g = (long long)(c0 + k) * N + n;
    bool any = false;
#pragma unroll
    for (int j = 0; j < V; ++j) any |= bw[k][j] == full;
    if (any && v4) {
      const float4 x = *reinterpret_cast<const float4*>(total + g);
      tt[k][0] = x.x; tt[k][1] = x.y; tt[k][2] = x.z; tt[k][3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) tt[k][j] = bw[k][j] == full ? total[g + j] : 0.0f;
    }
  }
  float held[SCORE_VEC];
#pragma unroll
  for (int j = 0; j < V; ++j) held[j] = __fsub_rn((float)cp[j], (float)fr[j]);
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const long long g = (long long)(c0 + k) * N + n;
    bool any = false;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (bw[k][j] != full) continue;
      any = true;
      tt[k][j] = __fadd_rn(tt[k][j], __fmul_rn(weight, dra_raw(d[k], cp[j], held[j])));
    }
    if (!any) continue;
    if (v4) {  // the infeasible entries stored back as loaded
      *reinterpret_cast<float4*>(total + g) = make_float4(tt[k][0], tt[k][1], tt[k][2], tt[k][3]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (bw[k][j] == full) total[g + j] = tt[k][j];
    }
  }
}

__global__ void dra_take_kernel(int B, int N, const uint8_t* __restrict__ commit,
                                const int32_t* __restrict__ choice,
                                const long long* __restrict__ class_of,
                                const int32_t* __restrict__ demand,
                                int32_t* __restrict__ free_) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  if (commit != nullptr && !commit[b]) return;
  const int node = choice[b];
  if (node < 0 || node >= N) return;
  const int d = demand[class_of != nullptr ? (int)class_of[b] : b];
  if (d != 0) atomicSub(&free_[node], d);
}

extern "C" int launch_dra_filter_bits(int C, int N, const void* demand, const void* pinned,
                                      const void* blocked, const void* free_, int bit,
                                      void* bits, void* stream) {
  const long long work = (long long)C * N;
  if (work <= 0) return 0;
  const int threads = 256;
  const long long blocks = (work + threads - 1) / threads;
  dra_filter_bits_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      C, N, (const int32_t*)demand, (const int32_t*)pinned, (const uint8_t*)blocked,
      (const int32_t*)free_, bit, (int32_t*)bits);
  return (int)cudaGetLastError();
}

template <int RPT, int V>
static int launch_score(int C, int N, int vec, const void* bits, int full, const void* cap,
                        const void* free_, const void* demand, float weight, void* total,
                        cudaStream_t st) {
  const long long gy = ((long long)C + RPT - 1) / RPT;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const long long per = (long long)V * SCORE_THREADS;
  const dim3 grid((unsigned)((N + per - 1) / per), (unsigned)gy);
  dra_score_into_kernel<RPT, V><<<grid, SCORE_THREADS, 0, st>>>(
      C, N, vec, (const int32_t*)bits, full, (const int32_t*)cap, (const int32_t*)free_,
      (const int32_t*)demand, weight, (float*)total);
  return (int)cudaGetLastError();
}

// (rows a thread, nodes a thread): 4 nodes of the fewest of 1, 2, 4, 8 rows
// that keep the grid to one wave; one node of one row a thread where 4-node
// threads would give the card fewer than 256 an SM (the scan's one row)
static void score_plan(int C, int N, int* rows, int* nodes) {
  const long long vecs = (N + SCORE_VEC - 1) / SCORE_VEC;
  *nodes = (long long)C * vecs < SCORE_SMALL ? 1 : SCORE_VEC;
  int rpt = 1;
  while (*nodes == SCORE_VEC && rpt < 8 && ((long long)C + rpt - 1) / rpt * vecs > SCORE_WAVE)
    rpt *= 2;
  *rows = rpt;
}

extern "C" int launch_dra_score_into(int C, int N, const void* bits, int full,
                                     const void* cap, const void* free_, const void* demand,
                                     float weight, void* total, void* stream) {
  if (C < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if ((long long)C * N == 0) return 0;
  const int vec = (N % SCORE_VEC == 0 && (uintptr_t)bits % 16 == 0
                   && (uintptr_t)total % 16 == 0 && (uintptr_t)cap % 16 == 0
                   && (uintptr_t)free_ % 16 == 0) ? 1 : 0;
  cudaStream_t st = (cudaStream_t)stream;
  int rows, nodes;
  score_plan(C, N, &rows, &nodes);
  if (nodes == 1)
    return launch_score<1, 1>(C, N, vec, bits, full, cap, free_, demand, weight, total,
                              st);
  switch (rows) {
    case 1:
      return launch_score<1, 4>(C, N, vec, bits, full, cap, free_, demand, weight,
                                total, st);
    case 2:
      return launch_score<2, 4>(C, N, vec, bits, full, cap, free_, demand, weight,
                                total, st);
    case 4:
      return launch_score<4, 4>(C, N, vec, bits, full, cap, free_, demand, weight,
                                total, st);
    default:
      return launch_score<8, 4>(C, N, vec, bits, full, cap, free_, demand, weight,
                                total, st);
  }
}

// K25's plan, for kernel_work.k25_plan: out[0] rows a thread, out[1] nodes
extern "C" int dra_score_plan(int C, int N, int* out) {
  score_plan(C, N, &out[0], &out[1]);
  return 0;
}

extern "C" int launch_dra_take(int B, int N, const void* commit, const void* choice,
                               const void* class_of, const void* demand, void* free_,
                               void* stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  const int blocks = (B + threads - 1) / threads;
  dra_take_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      B, N, (const uint8_t*)commit, (const int32_t*)choice, (const long long*)class_of,
      (const int32_t*)demand, (int32_t*)free_);
  return (int)cudaGetLastError();
}
