"""K27 ``priority_prefix``, K28 ``candidate_fit``, K29 ``candidate_dense``:
preemption's candidate mask (CUDA: csrc/preempt.cu).

Replaces the JAX package's whatif/dryrun.py ``candidate_mask_device``
(:31-96, ROADMAP Queue B B15): bool[B, N], "pod b would resource-fit node n
with every lower-priority pod on n evicted", ANDed with the static filters.
With ``levels`` (the sorted scheduled-pod priorities, padded with i32-max to
K = 128) K27 builds the exclusive prefix over the levels of the per-level
request totals, ``prefix f32[K+1, N, R]`` and ``prefix_cnt f32[K+1, N]``
(row t: the totals over levels strictly below t), and K28 gathers each batch
pod's threshold row and tests the fit; without levels (more than K distinct
priorities) K29 sums, per (pod, node), the requests of the node's pods below
the pod's priority.

The float32 sums follow the reference's order bit for bit (csrc/preempt.cu
has the details): a level's total in ascending pod-row order from 0 (the
plain version's ``index_add_`` on the CPU walks its index in order, as
XLA:CPU's scatter does), and the prefix over the levels in XLA:CPU's
cumulative-sum order, a blocked scan of base 16 (``blocked_cumsum``) — not
left to right.  The dense form's reference is a float32 einsum, whose order
is XLA's dot; K29 sums in row order, which equals it wherever the sums are
exact.

The static filters come in as K1's pass-bit plane (``static_bits i32[B,
N]``, zero on dead nodes and padding rows) and the OR of the static
plugins' bits (``static_mask``); a row passes where every masked bit is set.

CPU tensors take the plain versions; CUDA tensors launch the kernels.  K27
and K29 build nothing outside their one launch: each block streams the pod
tier in row order, a chunk at a time, gathers the valid pods bound to its
tile of nodes into a list that keeps their row order (``PREFIX_CAP`` /
``DENSE_CAP`` entries a round), and one lane sums each node's entries of
that list in list order — so each node's pods are visited in ascending row
order, as ``node_segments`` orders them, with no sort.  K27 keeps its live
levels' totals in shared memory (in windows of ``kernel_work.k27_plan``
levels where they do not fit) and writes each output element once.  K28
takes a tile of ``FIT_TILE`` nodes × ``FIT_GROUP`` batch rows a block:
each row's threshold is found once, the group's distinct threshold rows
are staged once as the free values the fit compares (``kernel_work.
k28_plan`` slots; a row past them reads its threshold row from global
memory), and a thread tests 16 nodes of a row, its static bits in 16-byte
loads and its answers in one 16-byte store.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import LAUNCHES, bind, ptr, require_cuda, require_dtype, stream_of
from .build import check, load

# XLA:CPU rewrites a cumulative sum longer than this into a blocked scan
CUMSUM_BASE = 16
# the kernels keep the levels in shared memory and scan the block totals in
# one block: K ≤ 16 · 16
MAX_LEVELS = 256
MAX_R = 16
# K29's layout (csrc/preempt.cu): nodes a block, pod rows a chunk, gathered
# pods a round
DENSE_TILE = 32
DENSE_CHUNK = 4096
DENSE_CAP = 1024
# K28's: nodes a block, batch rows a block, nodes a thread, dynamic shared
# bytes a block (the staged rows and the threshold slots)
FIT_TILE = 128
FIT_GROUP = 128
FIT_NPT = 16
FIT_SMEM = 40 * 1024
# K27's: nodes a block, pod rows a chunk, gathered pods a round
PREFIX_TILE = 64
PREFIX_CHUNK = 8192
PREFIX_CAP = 1024


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 cumulative sum over axis 0 in XLA:CPU's order: for
    more than 16 rows, an inclusive running sum inside each block of 16
    rows, the block totals scanned the same way, and each row of block j > 0
    plus the scanned totals of blocks 0..j−1."""
    k = x.shape[0]
    if k <= CUMSUM_BASE:
        out = torch.empty_like(x)
        acc = x[0].clone()
        out[0] = acc
        for i in range(1, k):
            acc = acc + x[i]
            out[i] = acc
        return out
    nb = -(-k // CUMSUM_BASE)
    pad = nb * CUMSUM_BASE - k
    xp = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) if pad else x
    inb = torch.stack([blocked_cumsum(xp[j * CUMSUM_BASE:(j + 1) * CUMSUM_BASE])
                       for j in range(nb)])
    totals = blocked_cumsum(inb[:, -1])
    out = inb.clone()
    for j in range(1, nb):
        out[j] = inb[j] + totals[j - 1]
    return out.reshape((nb * CUMSUM_BASE,) + tuple(x.shape[1:]))[:k]


def priority_prefix_plain(pod_valid, pod_node, pod_priority, pod_request, levels,
                          n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the reference's level table (pods scattered at
    (bucket, node); invalid and unbound pods in the overflow bucket K), then
    the exclusive prefix over levels 0..K−1."""
    k = levels.shape[0]
    valid = pod_valid & (pod_node >= 0)
    nrow = pod_node.long().clamp(0, n - 1)
    bucket = torch.searchsorted(levels, pod_priority, right=False)
    bucket = torch.where(valid, bucket, k)
    w = valid.to(torch.float32)
    contrib = torch.cat([pod_request.to(torch.float32) * w[:, None], w[:, None]], dim=1)
    r = pod_request.shape[1]
    table = torch.zeros(((k + 1) * n, r + 1), dtype=torch.float32,
                        device=pod_request.device)
    table.index_add_(0, bucket * n + nrow, contrib)
    table = table.reshape(k + 1, n, r + 1)
    scan = torch.cat([torch.zeros_like(table[:1]), blocked_cumsum(table[:k])])
    return scan[..., :r].contiguous(), scan[..., r].contiguous()


def _static_ok(static_bits, static_mask: int) -> torch.Tensor:
    return (static_bits & static_mask) == static_mask


def _fits(request, allocatable, requested, freed) -> torch.Tensor:
    """bool[B, N]: every dimension's request is 0 or ≤ (alloc − requested) +
    freed, in float32 (the reference's order)."""
    req = request.to(torch.float32)[:, None, :]
    free_base = allocatable.to(torch.float32)[None] - requested.to(torch.float32)[None]
    return ((req == 0) | (req <= free_base + freed)).all(dim=-1)


def candidate_fit_plain(prefix, prefix_cnt, levels, priority, request, allocatable,
                        requested, static_bits, static_mask: int) -> torch.Tensor:
    """The plain version of K28: the threshold rows gathered, the fit, the
    victims and the static bits."""
    tb = torch.searchsorted(levels, priority, right=False)
    fits = _fits(request, allocatable, requested, prefix[tb])
    return fits & (prefix_cnt[tb] > 0) & _static_ok(static_bits, static_mask)


def candidate_dense_plain(pod_valid, pod_node, pod_priority, pod_request, priority,
                          request, allocatable, requested, static_bits,
                          static_mask: int) -> torch.Tensor:
    """The plain version of K29: per (batch pod, node), the requests of the
    node's pods below the pod's priority summed in ascending pod-row order
    (``index_add_`` over the (pod, scheduled pod) pairs in row-major
    order)."""
    b, n = static_bits.shape
    lower = pod_valid[None, :] & (pod_node >= 0)[None, :] \
        & (pod_priority[None, :] < priority[:, None])
    bi, pi = lower.nonzero(as_tuple=True)
    at = bi * n + pod_node.long()[pi]
    r = pod_request.shape[1]
    freed = torch.zeros((b * n, r), dtype=torch.float32, device=pod_request.device)
    freed.index_add_(0, at, pod_request.to(torch.float32)[pi])
    cnt = torch.zeros(b * n, dtype=torch.float32, device=pod_request.device)
    cnt.index_add_(0, at, torch.ones_like(at, dtype=torch.float32))
    fits = _fits(request, allocatable, requested, freed.reshape(b, n, r))
    return fits & (cnt.reshape(b, n) > 0) & _static_ok(static_bits, static_mask)


def node_segments(pod_valid, pod_node, n: int):
    """(perm i64[P], offsets i64[N+1]): the rows of the valid, bound pods
    sorted stably by node (ascending row within a node); node n's pods are
    perm[offsets[n]:offsets[n+1]]."""
    key = torch.where(pod_valid & (pod_node >= 0), pod_node.long(), n)
    sorted_key, perm = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        sorted_key, torch.arange(n + 1, dtype=torch.long, device=key.device))
    return perm.contiguous(), offsets.contiguous()


_FNS = {}


def _fn(name: str, spec: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = bind(load("preempt"), name, spec)
    return fn


def _i32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as contiguous int32: itself (no torch op) where it already is."""
    return (x if x.dtype == torch.int32 else x.to(torch.int32)).contiguous()


def priority_prefix(pod_valid: torch.Tensor, pod_node: torch.Tensor,
                    pod_priority: torch.Tensor, pod_request: torch.Tensor,
                    levels: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (prefix f32[K+1, N, R], prefix_cnt f32[K+1, N]): row t holds the
    request totals and pod counts, per node, over the priority levels
    strictly below t.  CPU tensors take the plain version; CUDA tensors
    launch K27 — one launch, and no other device work where the tier is
    already int32 (as the snapshot holds it)."""
    if not pod_request.is_cuda:
        return priority_prefix_plain(pod_valid, pod_node, pod_priority, pod_request,
                                     levels, n)
    name = "priority_prefix"
    node, prio, req, levels = map(_i32, (pod_node, pod_priority, pod_request, levels))
    dev = require_cuda(name, pod_valid, node, prio, req, levels)
    require_dtype(name, torch.bool, pod_valid)
    k, r = levels.shape[0], req.shape[1]
    if r > MAX_R:
        raise ValueError(f"{name}: at most {MAX_R} resource dimensions")
    if k > MAX_LEVELS:
        raise ValueError(f"{name}: at most {MAX_LEVELS} levels")
    p = req.shape[0]
    if pod_valid.shape != (p,) or node.shape != (p,) or prio.shape != (p,):
        raise ValueError(f"{name}: inconsistent pod tier shapes")
    prefix = torch.empty((k + 1, n, r), dtype=torch.float32, device=dev)
    prefix_cnt = torch.empty((k + 1, n), dtype=torch.float32, device=dev)
    err = _fn("launch_priority_prefix", "iiii" + "p" * 8)(
        n, r, k, p, ptr(pod_valid), ptr(node), ptr(prio), ptr(req), ptr(levels),
        ptr(prefix), ptr(prefix_cnt), stream_of(dev))
    check(err, name)
    LAUNCHES[name] += 1
    return prefix, prefix_cnt


def _batch_side(name, priority, request, allocatable, requested, static_bits):
    t = [priority.to(torch.int32).contiguous(), request.to(torch.int32).contiguous(),
         allocatable.contiguous(), requested.contiguous(),
         static_bits.to(torch.int32).contiguous()]
    require_cuda(name, *t)
    require_dtype(name, torch.int32, *t)
    b, n = t[4].shape
    r = t[1].shape[1]
    if t[0].shape != (b,) or t[1].shape != (b, r) or t[2].shape != (n, r) \
            or t[3].shape != (n, r):
        raise ValueError(f"{name}: inconsistent shapes")
    return t, b, n, r


def candidate_fit(prefix: torch.Tensor, prefix_cnt: torch.Tensor, levels: torch.Tensor,
                  priority: torch.Tensor, request: torch.Tensor, allocatable: torch.Tensor,
                  requested: torch.Tensor, static_bits: torch.Tensor,
                  static_mask: int) -> torch.Tensor:
    """→ bool[B, N] from K27's prefix: the fit with the threshold row's
    freed requests, at least one victim, the static bits.  CPU tensors take
    the plain version; CUDA tensors launch K28."""
    if not prefix.is_cuda:
        return candidate_fit_plain(prefix, prefix_cnt, levels, priority, request,
                                   allocatable, requested, static_bits, static_mask)
    name = "candidate_fit"
    (prio, req, alloc, used, bits), b, n, r = _batch_side(
        name, priority, request, allocatable, requested, static_bits)
    levels = levels.to(torch.int32).contiguous()
    prefix, prefix_cnt = prefix.contiguous(), prefix_cnt.contiguous()
    k = levels.shape[0]
    if prefix.shape != (k + 1, n, r) or prefix_cnt.shape != (k + 1, n):
        raise ValueError(f"{name}: inconsistent prefix shapes")
    require_dtype(name, torch.float32, prefix, prefix_cnt)
    if r > MAX_R:
        raise ValueError(f"{name}: at most {MAX_R} resource dimensions")
    if k > MAX_LEVELS:
        raise ValueError(f"{name}: at most {MAX_LEVELS} levels")
    out = torch.empty((b, n), dtype=torch.bool, device=prefix.device)
    dev = require_cuda(name, prefix, prefix_cnt, levels, out)
    err = _fn("launch_candidate_fit", "iiii" + "p" * 8 + "i" + "pp")(
        b, n, r, k, ptr(prefix), ptr(prefix_cnt), ptr(levels), ptr(prio), ptr(req),
        ptr(alloc), ptr(used), ptr(bits), int(static_mask), ptr(out), stream_of(dev))
    check(err, name)
    LAUNCHES[name] += 1
    return out


def candidate_dense(pod_valid: torch.Tensor, pod_node: torch.Tensor,
                    pod_priority: torch.Tensor, pod_request: torch.Tensor,
                    priority: torch.Tensor, request: torch.Tensor,
                    allocatable: torch.Tensor, requested: torch.Tensor,
                    static_bits: torch.Tensor, static_mask: int) -> torch.Tensor:
    """→ bool[B, N] without levels: per (batch pod, node) the requests of the
    node's pods below the pod's priority, the fit, at least one victim, the
    static bits.  CPU tensors take the plain version; CUDA tensors launch
    K29 — one launch and no other device work, so every input must already
    be contiguous and of the snapshot's dtype (bool validity, int32 else)."""
    if not pod_request.is_cuda:
        return candidate_dense_plain(pod_valid, pod_node, pod_priority, pod_request,
                                     priority, request, allocatable, requested,
                                     static_bits, static_mask)
    name = "candidate_dense"
    t = (pod_node, pod_priority, pod_request, priority, request, allocatable, requested,
         static_bits)
    dev = require_cuda(name, pod_valid, *t)
    require_dtype(name, torch.bool, pod_valid)
    require_dtype(name, torch.int32, *t)
    p = pod_valid.shape[0]
    b, n = static_bits.shape
    r = request.shape[1]
    if pod_node.shape != (p,) or pod_priority.shape != (p,) or pod_request.shape != (p, r) \
            or priority.shape != (b,) or request.shape != (b, r) \
            or allocatable.shape != (n, r) or requested.shape != (n, r):
        raise ValueError(f"{name}: inconsistent shapes")
    if r > MAX_R:
        raise ValueError(f"{name}: at most {MAX_R} resource dimensions")
    out = torch.empty((b, n), dtype=torch.bool, device=dev)
    err = _fn("launch_candidate_dense", "iiii" + "p" * 9 + "i" + "pp")(
        b, n, r, p, ptr(pod_valid), ptr(pod_node), ptr(pod_priority), ptr(pod_request),
        ptr(priority), ptr(request), ptr(allocatable), ptr(requested), ptr(static_bits),
        int(static_mask), ptr(out), stream_of(dev))
    check(err, name)
    LAUNCHES[name] += 1
    return out
