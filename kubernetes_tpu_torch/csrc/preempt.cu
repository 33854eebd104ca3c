// K27 priority_prefix, K28 candidate_fit, K29 candidate_dense: preemption's
// candidate mask, "would pod b fit node n with every lower-priority pod on n
// evicted".
//
// Replaces (JAX package): whatif/dryrun.py candidate_mask_device (:31-96),
// which TPUScheduler's "cand" program (scheduler.py:1019-1028) runs after
// the static filters.  Its levels branch (:56-74) scatter-adds every bound
// pod's request into a [K+1, N, R] per-priority-level table, takes an
// exclusive prefix over the levels and gathers each batch pod's threshold row;
// its dense branch (:75-94, more than K distinct priorities) contracts
// B x P x N x R.
//
// The float32 order is the reference's, bit for bit:
//   * a level's total on a node is the sum of its pods' requests in
//     ascending pod-row order, starting from 0 (XLA:CPU's scatter-add walks
//     the updates in order);
//   * the prefix over the levels is XLA:CPU's cumsum, which is not left to
//     right: a blocked scan of base 16 -- an inclusive running sum inside
//     each block of 16 levels, the block totals summed left to right, and
//     each element of block j > 0 plus the totals of blocks 0..j-1 (K <= 256
//     keeps the totals' own scan to one block);
//   * the fit is (alloc - requested) first, then + freed, each one correctly
//     rounded operation (the library builds with --fmad=false).
// A float atomicAdd would sum in arrival order, so no kernel here uses one:
// one lane owns each sum and adds its node's pods in row order.  K27 and K29
// gather their nodes' pods themselves, in row order, in their one launch:
// no sort.
//
// K27: the whole call in one launch, no sort, each output element written
//   once.  A block owns a tile of 64 nodes (one block an SM).  It streams
//   the pod tier in ascending row order, PREFIX_CHUNK rows a chunk and 16
//   consecutive rows a thread (K29's 16-byte loads, the next chunk's issued
//   before this one is placed), and gathers the valid bound pods of its tile
//   (a node past N counts at N - 1, as the reference clips it) into a list
//   that keeps their row order: each thread's count, a warp scan, a scan of
//   the warps' totals.  The list grows across chunks; when it holds
//   PREFIX_CAP entries (and once at the end) it is flushed: each entry's
//   priority and requests loaded at once, its bucket found once by
//   lower_bound over the levels in shared memory, its requests converted
//   once; then warp w walks the list for channels w and w + 16 -- per group
//   of 32 entries each lane loads one entry, the entries of each node come
//   together as a mask (__match_any_sync), and each lane takes its nodes'
//   entries low bit first by shuffle -- adding with __fadd_rn into the
//   level totals, in registers for a window of at most 4 levels (the path's
//   2 live levels), else in shared memory.  So every (level, node, channel)
//   total is summed in ascending pod-row order from 0, however many rounds
//   a node's pods take.  Only the live levels are kept: Lw = the levels
//   below i32-max, plus the first i32-max pad (a pod at i32-max lands
//   there).  Where Lw levels do not fit shared memory (the plan's window
//   W, a multiple of 16), the levels go in windows: each re-walks the list
//   (re-streams the tier if the list overflowed a round) and the scan's
//   carry passes between windows through shared memory.  Then each
//   element's carry into each live 16-level block is computed once, and
//   each (output vector, block) pair -- a node's 4 channels or 4 nodes'
//   counts as a 16-byte store, a scalar where R or N is not a multiple of
//   4 -- runs XLA:CPU's blocked recurrence from registers and writes its
//   block's rows once, coalesced across the warp; the rows past the last
//   live level follow from the same recurrence (each adds 0.0).  Nothing
//   the kernel writes is read back.  Bound: bytes (the [K+1, N, R+1] output
//   written once, ~38 MB at N = 8192, R = 8, K = 128); each block re-reads
//   the tier's node and valid columns from L2, 5 bytes a row.
// K28: per (batch pod b, node n) the threshold row tb = searchsorted(levels,
//   priority_b) of prefix / prefix_cnt, the fit over R, has-victims (count >
//   0) and the static bits (bits & mask == mask; K1's plane, zero on dead
//   nodes and padding rows).  A block owns a tile of 128 nodes and a group
//   of 128 batch rows (two blocks an SM: one wave at B = 512).  At
//   entry each thread issues its rows' static bits -- 16 consecutive nodes
//   a row, four 16-byte loads -- and the block's cp.async copies of the
//   tile's alloc / requested rows, transposed to [R][tile + 4] as they land.
//   Each row's tb is found once (lower_bound over the levels in shared
//   memory) and flagged in a shared array over the K + 1 rows; warp 0 gives
//   the group's distinct thresholds slots in ascending order (as many as
//   fit_plan's shared memory holds, more on fewer channels).  Each slot's
//   threshold rows of the tile come in by cp.async, and the block computes,
//   in place, free[slot][r][n] = (float(alloc) - float(requested)) +
//   prefix[tb][n][r] -- exactly the value the reference compares -- and the
//   slot's has-victims bits, a 16-bit word a thread's chunk.  Then each
//   thread takes a row and its 16 nodes: the row's requests as floats from
//   shared memory into registers, channels whose request is 0 skipped
//   (the reference's req == 0), each other channel's 16 free values in four
//   16-byte shared loads (the chunk order rotated so a quarter warp hits 8
//   bank groups), one compare a node -- a row whose slot and requests equal
//   the last staged row the thread tested reuses its fit bits (on the path
//   every row asks the same); the 16 answers as one 16-byte store.
//   A row whose threshold found no slot (more distinct thresholds in a
//   group than slots: the 128-level check case) reads its threshold row
//   from global memory in 16-byte vectors against the staged base -- the
//   same arithmetic.  No 64-bit divide, and no branch holds a load back.
//   Rows or nodes that break a 16-byte boundary (N not a multiple of 16)
//   take scalar loads and stores.  Bound: bytes (the [B, N] bits read and
//   the mask written once); the tile's node and threshold rows are L2
//   reads, once for every 128 batch rows.
// K29: the whole call in one launch, no sort.  A block takes a tile of 32
//   nodes (one a lane) and a slice of batch rows (KB a thread, one warp's
//   rows interleaved with the next's; KB = 8, 4 or 2 as R <= 4, 8 or 16, so
//   the sums and counts stay in registers).  It streams the pod tier in
//   ascending row order in chunks of 4096 rows, 16 consecutive rows a
//   thread (16-byte loads of the nodes and the valid flags), and gathers
//   the valid pods bound to its tile stably: each thread's count of them, a
//   warp scan, a scan of the warps' totals, so pod i of the list is the
//   i-th in row order; their rows, then (an entry a thread) their
//   priorities and requests as float go to shared memory, 1024 a round.
//   Each warp then walks the list 32 entries at a time: the entries of each
//   node as a bit mask (__match_any_sync over the entries' nodes, the
//   leader of each set writing it for that node's lane), and each lane
//   takes its node's entries low bit first, adding the requests of those
//   below each of its rows' priorities with __fadd_rn.  Chunks, rounds and
//   groups come in row order, so every (row, node) sum is in ascending
//   pod-row order from 0 whatever the node holds -- a node with more pods
//   than a chunk or a round included.  Then the fit as K28, every load
//   issued before the first compare.  Two blocks an SM (registers bounded
//   to 128 a thread): a chunk's barriers and loads leave the SM idle
//   unless another block has work.  Bound: bytes (the pod tier, the node
//   rows and the batch rows read once, the mask written once); each block
//   re-reads the tier's node and valid columns from L2, 5 bytes a row.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define BLOCK_BASE 16  // XLA:CPU's cumulative-sum rewrite base
#define MAX_LEVELS 256
#define MAX_R 16

__device__ __forceinline__ int lower_bound(const int32_t* lv, int K, int32_t x) {
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lv[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// a 4-byte cp.async from global to shared memory; cp_async_wait waits for
// this thread's copies
__device__ __forceinline__ void cp_async4(int* dst, const int32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// --- the pod tier, as K27 and K29 stream it ------------------------------------------------
#define DENSE_PPT 16  // consecutive tier rows a thread loads
#define FULL_MASK 0xffffffffu

// DENSE_PPT rows from r0: their nodes (−1 past the tier) and their valid
// bits; 16-byte loads where the tier's arrays allow
__device__ __forceinline__ void load_pods(const uint8_t* __restrict__ valid,
                                          const int32_t* __restrict__ node, int P,
                                          long long r0, int vec, int (&nd)[DENSE_PPT],
                                          unsigned& vm) {
  vm = 0u;
  if (vec && r0 + DENSE_PPT <= P) {
    const int4* np = reinterpret_cast<const int4*>(node + r0);
#pragma unroll
    for (int q = 0; q < DENSE_PPT / 4; ++q) {
      const int4 v = __ldg(np + q);
      nd[4 * q] = v.x; nd[4 * q + 1] = v.y; nd[4 * q + 2] = v.z; nd[4 * q + 3] = v.w;
    }
    const uint4 vv = __ldg(reinterpret_cast<const uint4*>(valid + r0));
    const unsigned w[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int j = 0; j < DENSE_PPT; ++j)
      if ((w[j >> 2] >> (8 * (j & 3))) & 0xffu) vm |= 1u << j;
  } else {
#pragma unroll
    for (int j = 0; j < DENSE_PPT; ++j) {
      const long long r = r0 + j;
      nd[j] = r < P ? __ldg(node + r) : -1;
      if (r < P && __ldg(valid + r)) vm |= 1u << j;
    }
  }
}

// --- K27 ---------------------------------------------------------------------
// A block: PREFIX_TILE nodes (two a lane), PREFIX_THREADS threads, one block
// an SM; the tier in chunks of PREFIX_CHUNK rows, the gathered list flushed
// every PREFIX_CAP entries.  Dynamic shared memory: tot f32[W][R+1][TILE]
// (the window's level totals), exb f32[W/16 + 1][R+1][TILE] (the scan's
// carry into each of the window's live 16-level blocks, then past them),
// then the list's requests f32[CAP][R], rows i32[CAP], levels i16[CAP] and
// nodes u8[CAP].  A 32-node tile (two blocks an SM) and a 128-node tile
// both measured slower than 64 (PERF.md, the kernel table).
#define PREFIX_TILE 64
#define PREFIX_WARPS 16
#define PREFIX_THREADS (PREFIX_WARPS * 32)
#define PREFIX_CHUNK (PREFIX_THREADS * DENSE_PPT)
#define PREFIX_CAP 1024
#define PREFIX_MAX_SMEM (200 * 1024)  // dynamic bytes
#define PREFIX_REG_LEVELS 4           // a window this small sums in registers

static size_t prefix_list_bytes(int R) {
  return (size_t)PREFIX_CAP * (4 * (size_t)R + 4 + 2 + 1);
}

// the window (levels a pass keeps in shared memory, a multiple of 16, at
// most K rounded up) and the dynamic shared memory for R requests and K
// levels; cudaErrorInvalidValue where not even 16 levels fit
static int prefix_plan(int R, int K, int* window, size_t* smem) {
  const size_t per_level = (size_t)PREFIX_TILE * (R + 1) * 4, list = prefix_list_bytes(R);
  const int k16 = K > BLOCK_BASE ? (K + BLOCK_BASE - 1) / BLOCK_BASE * BLOCK_BASE : BLOCK_BASE;
  int w = 0;
  for (int c = BLOCK_BASE; c <= k16; c += BLOCK_BASE)
    if (list + (size_t)(c + c / BLOCK_BASE + 1) * per_level <= PREFIX_MAX_SMEM) w = c;
  if (!w) return (int)cudaErrorInvalidValue;
  *window = w;
  *smem = list + (size_t)(w + w / BLOCK_BASE + 1) * per_level;
  return 0;
}

struct PrefixList {
  float* tot;
  float* exb;
  float* req;
  int32_t* row;
  int16_t* lvl;
  uint8_t* node;
};

// the list's entries [0, len): each one's priority and requests loaded at
// once (two entries a thread, every load issued before the first store),
// its bucket by lower_bound over the Lw live levels (−1 where the reference
// drops it, a bucket of K), its requests converted once
template <int RB>
__device__ __forceinline__ void prefix_load_list(const PrefixList& s, int len, int R, int K,
                                                 int Lw, const int32_t* lv,
                                                 const int32_t* __restrict__ pprio,
                                                 const int32_t* __restrict__ preq) {
  for (int e0 = 0; e0 < len; e0 += 2 * PREFIX_THREADS) {
    int32_t pr[2], q[2][RB];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = e0 + u * PREFIX_THREADS + threadIdx.x;
      const long long row = e < len ? s.row[e] : 0;
      pr[u] = e < len ? __ldg(pprio + row) : 0;
#pragma unroll
      for (int r = 0; r < RB; ++r) q[u][r] = (e < len && r < R) ? __ldg(preq + row * R + r) : 0;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = e0 + u * PREFIX_THREADS + threadIdx.x;
      if (e >= len) continue;
      const int b = lower_bound(lv, Lw, pr[u]);
      s.lvl[e] = (int16_t)(b < K ? b : -1);
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < R) s.req[e * R + r] = __int2float_rn(q[u][r]);
    }
  }
}

__device__ __forceinline__ float* prefix_cell(const PrefixList& s, int C1, int l, int ch, int h) {
  return s.tot + ((size_t)l * C1 + ch) * PREFIX_TILE + h;
}

// the window's levels [w0, w0 + wn) of the list's entries [0, len) into tot:
// warp w owns channels w and w + 16 (the count is channel R), lane j nodes j,
// j + 32, ...  Per group of 32 entries each lane loads one entry (its level
// and the warp's channels' values) and the entries of each node come
// together as a mask (__match_any_sync); then, for as long as any lane has
// an entry left, each lane takes its node's next one, low bit first, by
// shuffle from the lane that loaded it -- so each sum is in list order,
// which is row order, and a node holding the whole group costs 32 shuffle
// rounds, not 32 trips to shared memory.  A window of at most
// PREFIX_REG_LEVELS levels sums in registers (loaded from tot, stored
// back); a wider one adds into tot directly.
__device__ __forceinline__ void prefix_walk(const PrefixList& s, int len, int R, int w0,
                                            int wn, unsigned (*s_mask)[PREFIX_TILE]) {
  constexpr int HN = PREFIX_TILE / 32;  // nodes a lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, C1 = R + 1;
  if (warp >= C1) return;
  const bool two = warp + PREFIX_WARPS < C1;  // a second channel
  const int ch1 = two ? warp + PREFIX_WARPS : warp;
  const bool reg = wn <= PREFIX_REG_LEVELS;
  float acc[PREFIX_REG_LEVELS][HN][2];
#pragma unroll
  for (int q = 0; q < PREFIX_REG_LEVELS; ++q)
#pragma unroll
    for (int hh = 0; hh < HN; ++hh) {
      const int h = lane + 32 * hh;
      acc[q][hh][0] = reg && q < wn ? *prefix_cell(s, C1, q, warp, h) : 0.0f;
      acc[q][hh][1] = reg && q < wn && two ? *prefix_cell(s, C1, q, ch1, h) : 0.0f;
    }
  for (int g = 0; g < len; g += 32) {
#pragma unroll
    for (int hh = 0; hh < HN; ++hh) s_mask[warp][lane + 32 * hh] = 0u;
    __syncwarp();
    const int e = g + lane;
    int key = -1, my_l = 0;
    float my0 = 0.0f, my1 = 0.0f;
    if (e < len) {
      const int l = s.lvl[e] - w0;
      if (l >= 0 && l < wn) {
        key = s.node[e];
        my_l = l;
        my0 = warp < R ? s.req[e * R + warp] : 1.0f;
        my1 = ch1 < R ? s.req[e * R + ch1] : 1.0f;
      }
    }
    const unsigned peers = __match_any_sync(FULL_MASK, key);
    if (key >= 0 && lane == __ffs(peers) - 1) s_mask[warp][key] = peers;
    __syncwarp();
#pragma unroll
    for (int hh = 0; hh < HN; ++hh) {
      const int h = lane + 32 * hh;
      unsigned mk = s_mask[warp][h];
      while (__any_sync(FULL_MASK, mk != 0u)) {
        const bool has = mk != 0u;
        const int j = has ? __ffs(mk) - 1 : lane;
        mk &= mk - 1u;
        const int l = __shfl_sync(FULL_MASK, my_l, j);
        const float v0 = __shfl_sync(FULL_MASK, my0, j);
        const float v1 = __shfl_sync(FULL_MASK, my1, j);
        if (!has) continue;
        if (reg) {
#pragma unroll
          for (int q = 0; q < PREFIX_REG_LEVELS; ++q) {
            if (q != l) continue;
            acc[q][hh][0] = __fadd_rn(acc[q][hh][0], v0);
            if (two) acc[q][hh][1] = __fadd_rn(acc[q][hh][1], v1);
          }
        } else {
          float* a0 = prefix_cell(s, C1, l, warp, h);
          *a0 = __fadd_rn(*a0, v0);
          if (two) {
            float* a1 = prefix_cell(s, C1, l, ch1, h);
            *a1 = __fadd_rn(*a1, v1);
          }
        }
      }
    }
    __syncwarp();
  }
  if (reg) {
#pragma unroll
    for (int q = 0; q < PREFIX_REG_LEVELS; ++q)
#pragma unroll
      for (int hh = 0; hh < HN; ++hh) {
        if (q >= wn) continue;
        *prefix_cell(s, C1, q, warp, lane + 32 * hh) = acc[q][hh][0];
        if (two) *prefix_cell(s, C1, q, ch1, lane + 32 * hh) = acc[q][hh][1];
      }
  }
}

// one output vector's rows of one 16-level block b: WIDTH elements (channels
// ch0.. of node h, dc = 1, dh = 0; or channel R of nodes h.., dc = 0, dh = 1)
// at out (row 0) + t * rs.  XLA:CPU's blocked recurrence from registers:
// an inclusive run inside the block, plus the carry into the block (b > 0);
// a live block reads its levels below Lw from tot and its carry from exb, a
// block past the live levels adds 0.0 and takes the carry past them.  Row 0
// (zero) by block 0.
template <int WIDTH>
__device__ __forceinline__ void prefix_block_rows(const PrefixList& s, float* __restrict__ out,
                                                  long long rs, int C1, int h, int ch0, int dc,
                                                  int dh, int K, int Lw, int w0, int b,
                                                  int b_lo, int b_live) {
  const bool live = b < b_live;
  float excl[WIDTH], x[BLOCK_BASE][WIDTH];
#pragma unroll
  for (int k = 0; k < WIDTH; ++k)
    excl[k] = s.exb[((size_t)(min(b, b_live) - b_lo) * C1 + ch0 + k * dc) * PREFIX_TILE + h +
                    k * dh];
  if (!live) {
    // the carry past the live levels, then one block of zeros each
    for (int d = b_live; d < b; ++d)
#pragma unroll
      for (int k = 0; k < WIDTH; ++k) excl[k] = __fadd_rn(excl[k], 0.0f);
  }
  const int len = min(BLOCK_BASE, K - b * BLOCK_BASE);
#pragma unroll
  for (int i = 0; i < BLOCK_BASE; ++i) {
    const int level = b * BLOCK_BASE + i;
    const bool in = live && i < len && level < Lw;
#pragma unroll
    for (int k = 0; k < WIDTH; ++k)
      x[i][k] = in ? s.tot[((size_t)(level - w0) * C1 + ch0 + k * dc) * PREFIX_TILE + h + k * dh]
                   : 0.0f;
  }
  if (b == 0) {
    if constexpr (WIDTH == 4)
      *reinterpret_cast<float4*>(out) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    else
      out[0] = 0.0f;
  }
  float run[WIDTH];
#pragma unroll
  for (int i = 0; i < BLOCK_BASE; ++i) {
    if (i >= len) break;
    float y[WIDTH];
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) {
      run[k] = i == 0 ? x[i][k] : __fadd_rn(run[k], x[i][k]);
      y[k] = b == 0 ? run[k] : __fadd_rn(run[k], excl[k]);
    }
    float* at = out + (long long)(b * BLOCK_BASE + i + 1) * rs;
    if constexpr (WIDTH == 4)
      *reinterpret_cast<float4*>(at) = make_float4(y[0], y[1], y[2], y[3]);
    else
      at[0] = y[0];
  }
}

template <int RB>
__global__ void __launch_bounds__(PREFIX_THREADS, 1)
priority_prefix_kernel(int N, int R, int K, int P, int W, int vec,
                       const uint8_t* __restrict__ pvalid, const int32_t* __restrict__ pnode,
                       const int32_t* __restrict__ pprio, const int32_t* __restrict__ preq,
                       const int32_t* __restrict__ levels, float* __restrict__ prefix,
                       float* __restrict__ prefix_cnt) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t lv[MAX_LEVELS];
  __shared__ int s_wsum[2][PREFIX_WARPS];  // the warps' gathered counts, by chunk parity
  __shared__ unsigned s_mask[PREFIX_WARPS][PREFIX_TILE];
  const int C1 = R + 1;
  PrefixList s;
  s.tot = reinterpret_cast<float*>(smem);
  s.exb = s.tot + (size_t)W * C1 * PREFIX_TILE;
  s.req = s.exb + (size_t)(W / BLOCK_BASE + 1) * C1 * PREFIX_TILE;
  s.row = reinterpret_cast<int32_t*>(s.req + (size_t)PREFIX_CAP * R);
  s.lvl = reinterpret_cast<int16_t*>(s.row + PREFIX_CAP);
  s.node = reinterpret_cast<uint8_t*>(s.lvl + PREFIX_CAP);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * PREFIX_TILE;
  for (int i = tid; i < K; i += PREFIX_THREADS) lv[i] = levels[i];
  __syncthreads();
  // the buckets a pod can take: the levels below i32-max and the first pad
  const int Lw = min(K, lower_bound(lv, K, INT_MAX) + 1);

  // the output vectors: (node, 4 channels) of prefix and (4 nodes) of
  // prefix_cnt where 16-byte stores line up, else one element
  const bool al = ((uintptr_t)prefix & 15u) == 0 && ((uintptr_t)prefix_cnt & 15u) == 0;
  const bool vreq = al && R % 4 == 0, vcnt = al && N % 4 == 0;
  const int nreq = vreq ? PREFIX_TILE * R / 4 : PREFIX_TILE * R;
  const int items = nreq + (vcnt ? PREFIX_TILE / 4 : PREFIX_TILE);

  bool listed = false;  // the whole list stayed in shared memory (no overflow)
  int len = 0;
  for (int w0 = 0; w0 == 0 || w0 < Lw; w0 += W) {
    const int wn = max(0, min(W, Lw - w0));
    const bool last = w0 + W >= Lw;
    for (int i = tid; i < wn * C1 * PREFIX_TILE; i += PREFIX_THREADS) s.tot[i] = 0.0f;
    __syncthreads();
    if (listed) {
      prefix_walk(s, len, R, w0, wn, s_mask);
    } else if (wn > 0) {
      // stream the tier: the tile's pods in row order, flushed a round at a time
      bool overflow = false;
      len = 0;
      int nd[DENSE_PPT];
      unsigned vm;
      load_pods(pvalid, pnode, P, (long long)tid * DENSE_PPT, vec, nd, vm);
      for (long long c0 = 0, parity = 0; c0 < P; c0 += PREFIX_CHUNK, parity ^= 1) {
        unsigned fm = 0u, loc[DENSE_PPT / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < DENSE_PPT; ++j) {
          const int l = min(nd[j], N - 1) - n0;
          if (((vm >> j) & 1u) && nd[j] >= 0 && l >= 0 && l < PREFIX_TILE) {
            fm |= 1u << j;
            loc[j >> 2] |= (unsigned)l << (8 * (j & 3));
          }
        }
        if (c0 + PREFIX_CHUNK < P)  // the next chunk's rows, in flight while this one's placed
          load_pods(pvalid, pnode, P, c0 + PREFIX_CHUNK + (long long)tid * DENSE_PPT, vec, nd,
                    vm);
        const int mine = __popc(fm);
        int incl = mine;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(FULL_MASK, incl, off);
          if (lane >= off) incl += y;
        }
        if (lane == 31) s_wsum[parity][warp] = incl;
        __syncthreads();
        int first = incl - mine, total = 0;
#pragma unroll
        for (int w = 0; w < PREFIX_WARPS; ++w) {
          const int sw = s_wsum[parity][w];
          if (w < warp) first += sw;
          total += sw;
        }
        for (int base = 0; base < total;) {
          const int take = min(total - base, PREFIX_CAP - len);
          int idx = first;
#pragma unroll
          for (int j = 0; j < DENSE_PPT; ++j) {
            if (!((fm >> j) & 1u)) continue;
            if (idx >= base && idx < base + take) {
              s.row[len + idx - base] = (int32_t)(c0 + tid * DENSE_PPT + j);
              s.node[len + idx - base] = (uint8_t)((loc[j >> 2] >> (8 * (j & 3))) & 0xffu);
            }
            ++idx;
          }
          len += take;
          base += take;
          if (len == PREFIX_CAP) {  // a full round: load, walk, start the list again
            __syncthreads();
            prefix_load_list<RB>(s, len, R, K, Lw, lv, pprio, preq);
            __syncthreads();
            prefix_walk(s, len, R, w0, wn, s_mask);
            __syncthreads();
            len = 0;
            overflow = true;
          }
        }
      }
      if (len > 0) {
        __syncthreads();
        prefix_load_list<RB>(s, len, R, K, Lw, lv, pprio, preq);
        __syncthreads();
        prefix_walk(s, len, R, w0, wn, s_mask);
      }
      listed = !overflow;
    }
    __syncthreads();
    // the window's 16-level blocks: [b_lo, b_live) hold live levels; on the
    // last window every block up to K follows.  First each element's carry
    // into each live block (exb), then each (output vector, block) writes
    // its rows.
    const int b_lo = w0 / BLOCK_BASE;
    const int b_live = (w0 + wn + BLOCK_BASE - 1) / BLOCK_BASE;
    const int b_hi = last ? (K + BLOCK_BASE - 1) / BLOCK_BASE : (w0 + W) / BLOCK_BASE;
    for (int i = tid; i < C1 * PREFIX_TILE; i += PREFIX_THREADS) {
      const int ch = i / PREFIX_TILE, h = i % PREFIX_TILE;
      const size_t at = (size_t)ch * PREFIX_TILE + h, step = (size_t)C1 * PREFIX_TILE;
      // the carry into this window: the last window's carry past its blocks
      float e = w0 == 0 ? 0.0f : s.exb[(size_t)(W / BLOCK_BASE) * step + at];
      for (int b = b_lo; b < b_live; ++b) {
        s.exb[(size_t)(b - b_lo) * step + at] = e;
        float run = 0.0f;
        for (int q = 0; q < BLOCK_BASE && b * BLOCK_BASE + q < K; ++q) {
          const int level = b * BLOCK_BASE + q;
          const float x = level < Lw ? s.tot[(size_t)(level - w0) * step + at] : 0.0f;
          run = q == 0 ? x : __fadd_rn(run, x);
        }
        e = b == 0 ? run : __fadd_rn(e, run);
      }
      s.exb[(size_t)(b_live - b_lo) * step + at] = e;
      if (!last) s.exb[(size_t)(W / BLOCK_BASE) * step + at] = e;
    }
    __syncthreads();
    const int nb = max(b_hi - b_lo, 1);  // K = 0: block 0 writes row 0
    for (int it = tid; it < items * nb; it += PREFIX_THREADS) {
      const int v = it % items, b = b_lo + it / items;
      if (v < nreq) {
        const int f = vreq ? 4 * v : v;
        const int h = f / max(R, 1), ch0 = f % max(R, 1);
        if (n0 + h >= N) continue;
        float* out = prefix + (long long)(n0 + h) * R + ch0;
        if (vreq)
          prefix_block_rows<4>(s, out, (long long)N * R, C1, h, ch0, 1, 0, K, Lw, w0, b, b_lo,
                               b_live);
        else
          prefix_block_rows<1>(s, out, (long long)N * R, C1, h, ch0, 1, 0, K, Lw, w0, b, b_lo,
                               b_live);
      } else {
        const int h = vcnt ? 4 * (v - nreq) : v - nreq;
        if (n0 + h >= N) continue;
        if (vcnt)
          prefix_block_rows<4>(s, prefix_cnt + n0 + h, N, C1, h, R, 0, 1, K, Lw, w0, b, b_lo,
                               b_live);
        else
          prefix_block_rows<1>(s, prefix_cnt + n0 + h, N, C1, h, R, 0, 1, K, Lw, w0, b, b_lo,
                               b_live);
      }
    }
    __syncthreads();
  }
}

// --- K28 ---------------------------------------------------------------------
// A block: a tile of FIT_TILE nodes x FIT_GROUP batch rows, FIT_THREADS
// threads; thread (p, t) takes rows p, p + FIT_RP, ... of the group and the
// tile's nodes [16t, 16t + 16).
#define FIT_THREADS 256
#define FIT_GROUP 128         // batch rows a block: 256 blocks at B = 512, N = 8192
#define FIT_NPT 16            // consecutive nodes a thread
#define FIT_TPR 8             // threads a row
#define FIT_TILE (FIT_NPT * FIT_TPR)
#define FIT_RP (FIT_THREADS / FIT_TPR)  // rows a pass
#define FIT_SMEM (40 * 1024)  // dynamic shared bytes: the tile's rows and the slots

// K28's plan for R channels: the slots (the distinct threshold rows of a
// group staged in shared memory; more go to the overflow path) and the
// dynamic shared bytes -- base and requested [R][FIT_TILE + 4] each, then
// per slot free [R][FIT_TILE + 4], the counts [FIT_TILE] and their masks
// [FIT_TPR]
static int fit_plan(int R, int* slots, size_t* smem) {
  const size_t ntp = FIT_TILE + 4;
  const size_t fixed = 8 * (size_t)R * ntp;
  const size_t per = 4 * (size_t)R * ntp + 4 * FIT_TILE + 4 * FIT_TPR;
  const size_t s = fixed >= FIT_SMEM ? 0 : (FIT_SMEM - fixed) / per;
  *slots = (int)(s < FIT_GROUP ? s : FIT_GROUP);
  *smem = fixed + (size_t)*slots * per;
  return 0;
}

// the 16-byte pattern of 4 answers (nibble ``m`` of a thread's mask): a
// byte 0 / 1 each
__device__ __forceinline__ uint32_t fit_bytes(uint32_t m) {
  return ((m & 0xfu) * 0x00204081u) & 0x01010101u;
}

template <int RB>
__global__ void __launch_bounds__(FIT_THREADS, 2)
candidate_fit_kernel(int B, int N, int R, int K, int slots, int vec,
                     const float* __restrict__ prefix, const float* __restrict__ prefix_cnt,
                     const int32_t* __restrict__ levels, const int32_t* __restrict__ priority,
                     const int32_t* __restrict__ request, const int32_t* __restrict__ alloc,
                     const int32_t* __restrict__ requested, const int32_t* __restrict__ bits,
                     int32_t mask, uint8_t* __restrict__ out) {
  constexpr int NT = FIT_TILE, NTP = NT + 4, TPR = FIT_TPR, RP = FIT_RP;
  constexpr int RPT = FIT_GROUP / RP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_base = reinterpret_cast<float*>(smem);                  // [R][NTP]
  int32_t* s_rq = reinterpret_cast<int32_t*>(s_base + R * NTP);    // [R][NTP]
  float* s_free = reinterpret_cast<float*>(s_rq + R * NTP);        // [slots][R][NTP]
  float* s_cnt = s_free + (size_t)slots * R * NTP;                 // [slots][NT]
  uint32_t* s_cm = reinterpret_cast<uint32_t*>(s_cnt + slots * NT);  // [slots][TPR]
  __shared__ int32_t s_lv[MAX_LEVELS];
  __shared__ int s_slot[MAX_LEVELS + 1];  // a threshold's flag, then its slot
  __shared__ int s_stb[FIT_GROUP];        // a slot's threshold row
  __shared__ int s_rtb[FIT_GROUP], s_rslot[FIT_GROUP];
  __shared__ float s_req[FIT_GROUP * RB];
  __shared__ int s_nslots;

  const int tid = threadIdx.x, t = tid % TPR, p = tid / TPR;
  const int n0 = blockIdx.x * NT, b0 = blockIdx.y * FIT_GROUP;
  const int h0 = t * FIT_NPT, n = n0 + h0;
  // this thread's nodes below N: node n + e is one where e < left.  No
  // min / max here: ptxas for sm_90a folded "min(16, N - n) == 16" into the
  // predicate of a VIMNMX and took the 16-byte path on part chunks
  const int left = N - n;
  const bool vbits = (vec & 1) && left >= FIT_NPT;

  // every row's static bits, all issued before anything waits
  int32_t w[RPT][FIT_NPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int b = b0 + p + k * RP;
    const long long g = (long long)b * N + n;
    if (b < B && vbits && (g & 3) == 0) {
      const int4* src = reinterpret_cast<const int4*>(bits + g);
#pragma unroll
      for (int q = 0; q < FIT_NPT / 4; ++q) {
        const int4 v = __ldg(src + q);
        w[k][4 * q] = v.x; w[k][4 * q + 1] = v.y; w[k][4 * q + 2] = v.z; w[k][4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < FIT_NPT; ++e) w[k][e] = (b < B && e < left) ? __ldg(bits + g + e) : 0;
    }
  }
  // the tile's node rows, transposed into [R][NTP] as they land
  const long long nr0 = (long long)n0 * R;
  for (int f = tid; f < NT * R; f += FIT_THREADS) {
    const int h = f / R, r = f - h * R;
    if (n0 + h < N) {
      cp_async4(reinterpret_cast<int*>(s_base + r * NTP + h), alloc + nr0 + f);
      cp_async4(s_rq + r * NTP + h, requested + nr0 + f);
    }
  }
  for (int i = tid; i < K; i += FIT_THREADS) s_lv[i] = __ldg(levels + i);
  for (int i = tid; i <= K; i += FIT_THREADS) s_slot[i] = 0;
  for (int i = tid; i < FIT_GROUP * RB; i += FIT_THREADS) {
    const int row = i / RB, r = i - row * RB, b = b0 + row;
    s_req[i] = (b < B && r < R) ? __int2float_rn(__ldg(request + (long long)b * R + r)) : 0.0f;
  }
  const bool has_row = tid < FIT_GROUP && b0 + tid < B;
  const int32_t prio = has_row ? __ldg(priority + b0 + tid) : 0;
  __syncthreads();
  // each row's threshold once; the group's distinct thresholds flagged
  if (has_row) {
    const int tb = lower_bound(s_lv, K, prio);
    s_rtb[tid] = tb;
    s_slot[tb] = 1;
  }
  __syncthreads();
  // warp 0 gives the flagged thresholds slots in ascending order; past
  // ``slots`` a threshold gets -1 (its rows take the overflow path)
  if (tid < 32) {
    int run = 0;
    for (int base = 0; base <= K; base += 32) {
      const int i = base + tid;
      const int f = i <= K ? s_slot[i] : 0;
      const unsigned bal = __ballot_sync(FULL_MASK, f);
      const int idx = run + __popc(bal & ((1u << tid) - 1u));
      if (f) {
        s_slot[i] = idx < slots ? idx : -1;
        if (idx < slots) s_stb[idx] = i;
      }
      run += __popc(bal);
    }
    if (tid == 0) s_nslots = min(run, slots);
  }
  __syncthreads();
  const int ns = s_nslots;
  if (has_row) s_rslot[tid] = s_slot[s_rtb[tid]];
  // the slots' threshold rows of the tile: prefix transposed, the counts
  for (int s = 0; s < ns; ++s) {
    const long long row = (long long)s_stb[s] * N + n0;
    const float* pr = prefix + row * R;
    for (int f = tid; f < NT * R; f += FIT_THREADS) {
      const int h = f / R, r = f - h * R;
      if (n0 + h < N)
        cp_async4(reinterpret_cast<int*>(s_free + ((size_t)s * R + r) * NTP + h),
                  reinterpret_cast<const int32_t*>(pr + f));
    }
    for (int h = tid; h < NT; h += FIT_THREADS)
      if (n0 + h < N)
        cp_async4(reinterpret_cast<int*>(s_cnt + s * NT + h),
                  reinterpret_cast<const int32_t*>(prefix_cnt + row + h));
  }
  cp_async_wait();
  __syncthreads();
  // free = (float(alloc) - float(requested)) + prefix[tb], in place: the
  // value the fit compares against, one correctly rounded step each
  for (int i = tid; i < R * NT; i += FIT_THREADS) {
    const int r = i / NT, h = i % NT;
    if (n0 + h >= N) continue;
    const int at = r * NTP + h;
    const float base = __fsub_rn(__int2float_rn(reinterpret_cast<const int32_t*>(s_base)[at]),
                                 __int2float_rn(s_rq[at]));
    s_base[at] = base;
    for (int s = 0; s < ns; ++s) {
      float* fp = s_free + (size_t)s * R * NTP + at;
      *fp = __fadd_rn(base, *fp);
    }
  }
  // the slots' has-victims bits, a 16-node word a thread's chunk
  for (int i = tid; i < ns * TPR; i += FIT_THREADS) {
    const int s = i / TPR, c = i - s * TPR;
    uint32_t m = 0u;
#pragma unroll
    for (int e = 0; e < FIT_NPT; ++e) {
      const int h = c * FIT_NPT + e;
      if (n0 + h < N && s_cnt[s * NT + h] > 0.0f) m |= 1u << e;
    }
    s_cm[s * TPR + c] = m;
  }
  __syncthreads();

  // the fit: a row and 16 nodes a thread; a staged row's free values in
  // 16-byte shared loads, the 8 threads of a quarter warp on 8 distinct
  // bank groups (the chunk order rotated by t / 2)
  // A staged row whose slot and requests equal the last staged row this
  // thread tested takes that row's fit bits (the same inputs give the same
  // compares): on the path every row of a group asks the same
  const int rot = (t >> 1) & 3;
  int memo_slot = -1;
  float memo_q[RB];
  uint32_t memo_fail = 0u;
#pragma unroll
  for (int r = 0; r < RB; ++r) memo_q[r] = 0.0f;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int row = p + k * RP, b = b0 + row;
    if (b >= B) continue;
    uint32_t ok = 0u;
#pragma unroll
    for (int e = 0; e < FIT_NPT; ++e)
      if (e < left && (w[k][e] & mask) == mask) ok |= 1u << e;
    if (ok) {
      float q[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) q[r] = s_req[row * RB + r];  // 0 past R
      const int slot = s_rslot[row];
      uint32_t fail = 0u, cm = 0u;
      bool same = slot >= 0 && slot == memo_slot;
#pragma unroll
      for (int r = 0; r < RB; ++r) same = same && q[r] == memo_q[r];
      if (same) {
        cm = s_cm[slot * TPR + t];
        fail = memo_fail;
      } else if (slot >= 0) {
        cm = s_cm[slot * TPR + t];
        const float* fr = s_free + (size_t)slot * R * NTP + h0;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (q[r] == 0.0f) continue;
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            const int c = (qq + rot) & 3;
            const float4 f = *reinterpret_cast<const float4*>(fr + r * NTP + 4 * c);
            const uint32_t m = (uint32_t)!(q[r] <= f.x) | (uint32_t)!(q[r] <= f.y) << 1
                               | (uint32_t)!(q[r] <= f.z) << 2 | (uint32_t)!(q[r] <= f.w) << 3;
            fail |= m << (4 * c);
          }
        }
        memo_slot = slot;
        memo_fail = fail;
#pragma unroll
        for (int r = 0; r < RB; ++r) memo_q[r] = q[r];
      } else {
        // overflow: the threshold row from global memory, 16-byte loads
        // where its rows allow, against the staged base
        const long long rowb = (long long)s_rtb[row] * N + n;
        if (vbits && (vec & 2) && (rowb & 3) == 0) {
#pragma unroll
          for (int q4 = 0; q4 < FIT_NPT / 4; ++q4) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(prefix_cnt + rowb) + q4);
            cm |= ((uint32_t)(v.x > 0.0f) | (uint32_t)(v.y > 0.0f) << 1
                   | (uint32_t)(v.z > 0.0f) << 2 | (uint32_t)(v.w > 0.0f) << 3) << (4 * q4);
          }
        } else {
#pragma unroll
          for (int e = 0; e < FIT_NPT; ++e)
            if (e < left && __ldg(prefix_cnt + rowb + e) > 0.0f) cm |= 1u << e;
        }
        const bool v4 = (vec & 2) && R == RB && (RB & 3) == 0;
#pragma unroll
        for (int e = 0; e < FIT_NPT; ++e) {
          if (e >= left) continue;
          const float* pe = prefix + (rowb + e) * R;
          float pv[RB];
          if (v4) {
#pragma unroll
            for (int j = 0; j < RB / 4; ++j) {
              const float4 v = __ldg(reinterpret_cast<const float4*>(pe) + j);
              pv[4 * j] = v.x; pv[4 * j + 1] = v.y; pv[4 * j + 2] = v.z; pv[4 * j + 3] = v.w;
            }
          } else {
#pragma unroll
            for (int r = 0; r < RB; ++r) pv[r] = (r < R && q[r] != 0.0f) ? __ldg(pe + r) : 0.0f;
          }
#pragma unroll
          for (int r = 0; r < RB; ++r)
            if (q[r] != 0.0f && !(q[r] <= __fadd_rn(s_base[r * NTP + h0 + e], pv[r])))
              fail |= 1u << e;
        }
      }
      ok &= cm & ~fail;
    }
    // the 16 answers: one 16-byte store where the row allows
    const long long g = (long long)b * N + n;
    uint8_t* o = out + g;
    if (vbits && (g & 15) == 0) {
      *reinterpret_cast<uint4*>(o) =
          make_uint4(fit_bytes(ok), fit_bytes(ok >> 4), fit_bytes(ok >> 8), fit_bytes(ok >> 12));
    } else if (vbits && (g & 3) == 0) {
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4)
        reinterpret_cast<uint32_t*>(o)[q4] = fit_bytes(ok >> (4 * q4));
    } else {
#pragma unroll
      for (int e = 0; e < FIT_NPT; ++e)
        if (e < left) o[e] = (uint8_t)((ok >> e) & 1u);
    }
  }
}

// --- K29 ---------------------------------------------------------------------
// A block: DENSE_TILE nodes (one a lane) x DENSE_WARPS * KB batch rows (warp w
// takes rows w, w + DENSE_WARPS, ...); it streams the pod tier in chunks of
// DENSE_CHUNK rows, DENSE_PPT consecutive rows a thread, and gathers the
// tile's pods in row order into shared memory, DENSE_CAP a round.
#define DENSE_TILE 32
#define DENSE_WARPS 8
#define DENSE_CHUNK (DENSE_WARPS * 32 * DENSE_PPT)
#define DENSE_CAP 1024

// batch rows a thread carries: KB * (RB + 1) registers of sums and counts
template <int RB>
struct DenseRows {
  static constexpr int value = RB <= 4 ? 8 : (RB <= 8 ? 4 : 2);
};

template <int RB>
__global__ void __launch_bounds__(DENSE_WARPS * 32, 2)
candidate_dense_kernel(int B, int N, int R, int P, int vec,
                       const uint8_t* __restrict__ pvalid, const int32_t* __restrict__ pnode,
                       const int32_t* __restrict__ pprio, const int32_t* __restrict__ preq,
                       const int32_t* __restrict__ priority, const int32_t* __restrict__ request,
                       const int32_t* __restrict__ alloc, const int32_t* __restrict__ requested,
                       const int32_t* __restrict__ bits, int32_t mask,
                       uint8_t* __restrict__ out) {
  constexpr int KB = DenseRows<RB>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_req = reinterpret_cast<float*>(smem);                 // [DENSE_CAP][R]
  int32_t* s_prio = reinterpret_cast<int32_t*>(s_req + DENSE_CAP * R);  // [DENSE_CAP]
  int32_t* s_row = s_prio + DENSE_CAP;                                  // [DENSE_CAP]
  uint8_t* s_node = reinterpret_cast<uint8_t*>(s_row + DENSE_CAP);      // [DENSE_CAP]
  __shared__ int s_wsum[2][DENSE_WARPS];  // the warps' gathered counts, by chunk parity
  __shared__ unsigned s_mask[DENSE_WARPS][32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * DENSE_TILE, n = n0 + lane;
  const int b0 = blockIdx.y * (DENSE_WARPS * KB);
  int32_t thr[KB];
  float freed[KB][RB];
  int cnt[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const int b = b0 + warp + DENSE_WARPS * k;
    thr[k] = b < B ? __ldg(priority + b) : INT_MIN;  // a row past B counts nothing
    cnt[k] = 0;
#pragma unroll
    for (int r = 0; r < RB; ++r) freed[k][r] = 0.0f;
  }

  for (long long c0 = 0, parity = 0; c0 < P; c0 += DENSE_CHUNK, parity ^= 1) {
    int nd[DENSE_PPT];
    unsigned vm;
    load_pods(pvalid, pnode, P, c0 + (long long)tid * DENSE_PPT, vec, nd, vm);
    // this thread's pods of the tile, then their places in the chunk's
    // row-ordered list: a warp scan of the counts, then the warps' totals
    unsigned fm = 0u;
#pragma unroll
    for (int j = 0; j < DENSE_PPT; ++j)
      if (((vm >> j) & 1u) && nd[j] >= n0 && nd[j] < n0 + DENSE_TILE) fm |= 1u << j;
    const int mine = __popc(fm);
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_wsum[parity][warp] = incl;
    __syncthreads();
    int first = incl - mine, total = 0;
#pragma unroll
    for (int w = 0; w < DENSE_WARPS; ++w) {
      const int sw = s_wsum[parity][w];
      if (w < warp) first += sw;
      total += sw;
    }
    for (int rb = 0; rb < total; rb += DENSE_CAP) {
      // the round's list: each thread places its pods' rows and nodes
      int idx = first;
#pragma unroll
      for (int j = 0; j < DENSE_PPT; ++j) {
        if (!((fm >> j) & 1u)) continue;
        if (idx >= rb && idx < rb + DENSE_CAP) {
          s_row[idx - rb] = tid * DENSE_PPT + j;  // the row, past c0
          s_node[idx - rb] = (uint8_t)(nd[j] - n0);
        }
        ++idx;
      }
      __syncthreads();
      // their priorities and requests, an entry a thread, every load of an
      // entry issued before its first store
      const int m = min(DENSE_CAP, total - rb);
      for (int e = tid; e < m; e += DENSE_WARPS * 32) {
        const long long row = c0 + s_row[e];
        const int32_t pr = __ldg(pprio + row);
        int32_t q[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) q[r] = r < R ? __ldg(preq + row * R + r) : 0;
        s_prio[e] = pr;
#pragma unroll
        for (int r = 0; r < RB; ++r)
          if (r < R) s_req[e * R + r] = __int2float_rn(q[r]);
      }
      __syncthreads();
      // each lane sums its node's pods in list order: per group of 32
      // entries, the entries of each node as a mask (the group leader of
      // equal nodes writes it to that node's lane), walked low bit first
      for (int g = 0; g < m; g += 32) {
        s_mask[warp][lane] = 0u;
        __syncwarp();
        const int e = g + lane;
        const int ne = e < m ? (int)s_node[e] : -1;
        const unsigned peers = __match_any_sync(FULL_MASK, ne);
        if (ne >= 0 && lane == __ffs(peers) - 1) s_mask[warp][ne] = peers;
        __syncwarp();
        unsigned mk = s_mask[warp][lane];
        while (mk) {
          const int ei = g + __ffs(mk) - 1;
          mk &= mk - 1u;
          const int32_t pr = s_prio[ei];
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            if (!(pr < thr[k])) continue;
            ++cnt[k];
#pragma unroll
            for (int r = 0; r < RB; ++r)
              if (r < R) freed[k][r] = __fadd_rn(freed[k][r], s_req[ei * R + r]);
          }
        }
        __syncwarp();
      }
      __syncthreads();
    }
  }

  if (n >= N) return;
  // the fit: the node's free room once, then each row's request, every
  // load issued before the first compare
  float base[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r)
    base[r] = r < R ? __fsub_rn(__int2float_rn(__ldg(alloc + (long long)n * R + r)),
                                __int2float_rn(__ldg(requested + (long long)n * R + r)))
                    : 0.0f;
  int32_t sb[KB], rq[KB][RB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const int b = b0 + warp + DENSE_WARPS * k;
    sb[k] = b < B ? __ldg(bits + (long long)b * N + n) : 0;
#pragma unroll
    for (int r = 0; r < RB; ++r)
      rq[k][r] = (b < B && r < R) ? __ldg(request + (long long)b * R + r) : 0;
  }
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const int b = b0 + warp + DENSE_WARPS * k;
    if (b >= B) continue;
    bool ok = (sb[k] & mask) == mask && cnt[k] > 0;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float q = __int2float_rn(rq[k][r]);  // 0 past R
      if (q != 0.0f && !(q <= __fadd_rn(base[r], freed[k][r]))) ok = false;
    }
    out[(long long)b * N + n] = ok ? 1 : 0;
  }
}

template <int RB>
static int launch_prefix(int N, int R, int K, int P, const void* pod_valid, const void* pod_node,
                         const void* pod_prio, const void* pod_req, const void* levels,
                         void* prefix, void* prefix_cnt, cudaStream_t stream) {
  int window;
  size_t smem;
  const int e = prefix_plan(R, K, &window, &smem);
  if (e) return e;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t a = cudaFuncSetAttribute(priority_prefix_kernel<RB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               PREFIX_MAX_SMEM);
    if (a != cudaSuccess) return (int)a;
    attr_set = true;
  }
  const int vec = ((uintptr_t)pod_valid % 16 == 0 && (uintptr_t)pod_node % 16 == 0) ? 1 : 0;
  priority_prefix_kernel<RB><<<(N + PREFIX_TILE - 1) / PREFIX_TILE, PREFIX_THREADS, smem,
                               stream>>>(
      N, R, K, P, window, vec, (const uint8_t*)pod_valid, (const int32_t*)pod_node,
      (const int32_t*)pod_prio, (const int32_t*)pod_req, (const int32_t*)levels,
      (float*)prefix, (float*)prefix_cnt);
  return (int)cudaGetLastError();
}

extern "C" int launch_priority_prefix(int N, int R, int K, int P, const void* pod_valid,
                                      const void* pod_node, const void* pod_prio,
                                      const void* pod_req, const void* levels, void* prefix,
                                      void* prefix_cnt, void* stream) {
  if (K < 0 || K > MAX_LEVELS || R < 0 || R > MAX_R || N < 0 || P < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (R <= 4)
    return launch_prefix<4>(N, R, K, P, pod_valid, pod_node, pod_prio, pod_req, levels, prefix,
                            prefix_cnt, st);
  if (R <= 8)
    return launch_prefix<8>(N, R, K, P, pod_valid, pod_node, pod_prio, pod_req, levels, prefix,
                            prefix_cnt, st);
  return launch_prefix<16>(N, R, K, P, pod_valid, pod_node, pod_prio, pod_req, levels, prefix,
                           prefix_cnt, st);
}

// K27's plan, for the CPU mirror's copy (kernel_work.k27_plan): out[0] the
// window in levels, out[1] the dynamic shared memory in bytes
extern "C" int priority_prefix_plan(int R, int K, int* out) {
  int window;
  size_t smem;
  const int e = prefix_plan(R, K, &window, &smem);
  if (e) return e;
  out[0] = window;
  out[1] = (int)smem;
  return 0;
}

template <int RB>
static int launch_fit(int B, int N, int R, int K, const void* prefix, const void* prefix_cnt,
                      const void* levels, const void* priority, const void* request,
                      const void* alloc, const void* requested, const void* bits, int mask,
                      void* out, cudaStream_t stream) {
  int slots;
  size_t smem;
  const int e = fit_plan(R, &slots, &smem);
  if (e) return e;
  const long long gy = ((long long)B + FIT_GROUP - 1) / FIT_GROUP;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t a = cudaFuncSetAttribute(candidate_fit_kernel<RB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               FIT_SMEM);
    if (a != cudaSuccess) return (int)a;
    attr_set = true;
  }
  const int vec = (((uintptr_t)bits % 16 == 0 && (uintptr_t)out % 16 == 0) ? 1 : 0)
                  | (((uintptr_t)prefix % 16 == 0 && (uintptr_t)prefix_cnt % 16 == 0) ? 2 : 0);
  const dim3 grid((unsigned)((N + FIT_TILE - 1) / FIT_TILE), (unsigned)gy);
  candidate_fit_kernel<RB><<<grid, FIT_THREADS, smem, stream>>>(
      B, N, R, K, slots, vec, (const float*)prefix, (const float*)prefix_cnt,
      (const int32_t*)levels, (const int32_t*)priority, (const int32_t*)request,
      (const int32_t*)alloc, (const int32_t*)requested, (const int32_t*)bits, (int32_t)mask,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int launch_candidate_fit(int B, int N, int R, int K, const void* prefix,
                                    const void* prefix_cnt, const void* levels,
                                    const void* priority, const void* request,
                                    const void* alloc, const void* requested,
                                    const void* bits, int mask, void* out, void* stream) {
  if (K < 0 || K > MAX_LEVELS || R < 0 || R > MAX_R || B < 0 || N < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (R <= 4)
    return launch_fit<4>(B, N, R, K, prefix, prefix_cnt, levels, priority, request, alloc,
                         requested, bits, mask, out, st);
  if (R <= 8)
    return launch_fit<8>(B, N, R, K, prefix, prefix_cnt, levels, priority, request, alloc,
                         requested, bits, mask, out, st);
  return launch_fit<16>(B, N, R, K, prefix, prefix_cnt, levels, priority, request, alloc,
                        requested, bits, mask, out, st);
}

// K28's plan, for the CPU mirror's copy (kernel_work.k28_plan): out[0] the
// slots, out[1] the dynamic shared memory in bytes
extern "C" int candidate_fit_plan(int R, int* out) {
  if (R < 0 || R > MAX_R) return (int)cudaErrorInvalidValue;
  int slots;
  size_t smem;
  fit_plan(R, &slots, &smem);
  out[0] = slots;
  out[1] = (int)smem;
  return 0;
}

template <int RB>
static int launch_dense(int B, int N, int R, int P, const void* pod_valid,
                        const void* pod_node, const void* pod_prio, const void* pod_req,
                        const void* priority, const void* request, const void* alloc,
                        const void* requested, const void* bits, int mask, void* out,
                        cudaStream_t stream) {
  constexpr int TB = DENSE_WARPS * DenseRows<RB>::value;
  const long long gy = ((long long)B + TB - 1) / TB;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)DENSE_CAP * (4 * R + 9);
  static bool attr_set = false;
  if (smem > 48 * 1024 && !attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        candidate_dense_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)((size_t)DENSE_CAP * (4 * MAX_R + 9)));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int vec = ((uintptr_t)pod_valid % 16 == 0 && (uintptr_t)pod_node % 16 == 0) ? 1 : 0;
  const dim3 grid((unsigned)((N + DENSE_TILE - 1) / DENSE_TILE), (unsigned)gy);
  candidate_dense_kernel<RB><<<grid, DENSE_WARPS * 32, smem, stream>>>(
      B, N, R, P, vec, (const uint8_t*)pod_valid, (const int32_t*)pod_node,
      (const int32_t*)pod_prio, (const int32_t*)pod_req, (const int32_t*)priority,
      (const int32_t*)request, (const int32_t*)alloc, (const int32_t*)requested,
      (const int32_t*)bits, (int32_t)mask, (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int launch_candidate_dense(int B, int N, int R, int P, const void* pod_valid,
                                      const void* pod_node, const void* pod_prio,
                                      const void* pod_req, const void* priority,
                                      const void* request, const void* alloc,
                                      const void* requested, const void* bits, int mask,
                                      void* out, void* stream) {
  if (R < 0 || R > MAX_R || B < 0 || N < 0 || P < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (R <= 4)
    return launch_dense<4>(B, N, R, P, pod_valid, pod_node, pod_prio, pod_req, priority,
                           request, alloc, requested, bits, mask, out, st);
  if (R <= 8)
    return launch_dense<8>(B, N, R, P, pod_valid, pod_node, pod_prio, pod_req, priority,
                           request, alloc, requested, bits, mask, out, st);
  return launch_dense<16>(B, N, R, P, pod_valid, pod_node, pod_prio, pod_req, priority,
                          request, alloc, requested, bits, mask, out, st);
}
