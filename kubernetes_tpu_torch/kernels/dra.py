"""K24 ``dra_filter_bits``, K25 ``dra_score_into`` and K26 ``dra_take``:
DynamicResources' device half (CUDA: csrc/dra.cu).

Replaces the JAX package's dra/plugin.py ``DynamicResourcesPlugin`` —
``filter`` (:109) and ``filter_row`` (:117), ``_score_plane`` (:127)
through ``score`` / ``score_row`` (:137, :142) with ``normalize`` (:147)
floored and weighted in ``run_scores`` (framework/runtime.py :206-218),
``update`` (:152), ``update_batch`` (:157) and ``update_batch_classes``
(:163) — the DRA half of ROADMAP Queue B B14.  The plain versions compute
what the reference computes, in its float32 order; K25's floor is one of
the floor sites where a reordered float32 division would move a binding
(csrc/dra.cu says where).  CPU tensors take the plain versions; CUDA
tensors launch the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import LAUNCHES, bind, ptr, require_cuda, require_dtype, stream_of
from .build import check, load

# --- K24 dra_filter_bits ----------------------------------------------------------


def dra_filter_plane(demand, pinned, blocked, free) -> torch.Tensor:
    """bool[C, N], the reference's filter: free[n] ≥ demand[c], the node is
    the row's pin (or the row has none), and the row is not blocked."""
    cols = torch.arange(free.shape[0], device=free.device)
    fits = free[None, :] >= demand[:, None]
    pin_ok = (pinned[:, None] < 0) | (cols[None, :] == pinned[:, None])
    return fits & pin_ok & ~blocked[:, None]


def dra_filter_bits_plain(bits, bit: int, demand, pinned, blocked, free):
    """The plain version: clear ``bit`` of ``bits`` (in place) where the
    filter fails."""
    fail = ~dra_filter_plane(demand, pinned, blocked, free)
    bits &= torch.where(fail, ~(1 << bit), -1).to(torch.int32)
    return bits


_FNS = {}


def _fn(name: str, spec: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = bind(load("dra"), name, spec)
    return fn


def dra_filter_bits(bits: torch.Tensor, bit: int, demand: torch.Tensor,
                    pinned: torch.Tensor, blocked: torch.Tensor,
                    free: torch.Tensor) -> torch.Tensor:
    """Write DynamicResources' filter into the pass-bit plane ``bits``
    i32[C, N] in place: K1 seeds ``bit`` as passing (the filter's plane
    with no claim); this clears it where the row's claims do not fit.
    demand / pinned i32[C], blocked bool[C], free i32[N].  CPU tensors take
    the plain version; CUDA tensors launch K24."""
    if not bits.is_cuda:
        return dra_filter_bits_plain(bits, bit, demand, pinned, blocked, free)
    c, n = bits.shape
    ins = [t.contiguous() for t in (demand, pinned, blocked, free)]
    if not bits.is_contiguous():
        raise ValueError("dra_filter_bits: bits must be contiguous (updated in place)")
    dev = require_cuda("dra_filter_bits", bits, *ins)
    require_dtype("dra_filter_bits", torch.int32, bits, ins[0], ins[1], ins[3])
    require_dtype("dra_filter_bits", torch.bool, ins[2])
    if ins[0].shape != (c,) or ins[1].shape != (c,) or ins[2].shape != (c,) \
            or ins[3].shape != (n,) or not 0 <= bit < 31:
        raise ValueError("dra_filter_bits: inconsistent shapes")
    err = _fn("launch_dra_filter_bits", "iipppp" + "ip" + "p")(
        c, n, *map(ptr, ins), int(bit), ptr(bits), stream_of(dev))
    check(err, "dra_filter_bits")
    LAUNCHES["dra_filter_bits"] += 1
    return bits


# --- K25 dra_score_into -------------------------------------------------------------


def dra_raw_plane(cap, free, demand) -> torch.Tensor:
    """f32[C, N], the reference's ``_score_plane``: post-placement chip
    utilization × 100, floored and clipped to [0, 100], in its float32
    order ((cap − free) + demand, × 100, ÷ max(cap, 1)); 0 for a row
    without demand or a node without inventory."""
    capf = cap.to(torch.float32)[None, :]
    used = capf - free.to(torch.float32)[None, :] + demand.to(torch.float32)[:, None]
    raw = torch.floor(used * 100.0 / torch.clamp(capf, min=1.0))
    raw = torch.clamp(raw, 0.0, 100.0)
    return torch.where((demand[:, None] > 0) & (cap[None, :] > 0), raw, 0.0)


def dra_normalize(scores, mask):
    """The reference's normalize: the raw score is already 0..MAX_NODE_SCORE."""
    return torch.where(mask, scores, 0.0)


def dra_score_into_plain(bits, full: int, total, cap, free, demand, weight: float):
    """The plain version: ``total`` += weight · floor(normalize(raw)) on the
    feasible entries (all ``full`` bits set), in place."""
    mask = bits == full
    norm = dra_normalize(dra_raw_plane(cap, free, demand), mask)
    total.add_(torch.where(mask, float(weight) * torch.floor(norm), 0.0))
    return total


def dra_score_into(bits: torch.Tensor, full: int, total: torch.Tensor, cap: torch.Tensor,
                   free: torch.Tensor, demand: torch.Tensor, weight: float) -> torch.Tensor:
    """Add DynamicResources' weighted score into ``total`` f32[C, N] in place
    and return it.  bits i32[C, N] pass bits (``full`` = every filter
    passes), cap / free i32[N], demand i32[C].  CPU tensors take the plain
    version; CUDA tensors launch K25."""
    if not total.is_cuda:
        return dra_score_into_plain(bits, full, total, cap, free, demand, weight)
    c, n = bits.shape
    ins = [t.contiguous() for t in (bits, cap, free, demand)]
    if not total.is_contiguous():
        raise ValueError("dra_score_into: total must be contiguous (updated in place)")
    dev = require_cuda("dra_score_into", *ins, total)
    require_dtype("dra_score_into", torch.int32, *ins)
    require_dtype("dra_score_into", torch.float32, total)
    if total.shape != (c, n) or ins[1].shape != (n,) or ins[2].shape != (n,) \
            or ins[3].shape != (c,):
        raise ValueError("dra_score_into: inconsistent shapes")
    err = _fn("launch_dra_score_into", "iipipppfp" + "p")(
        c, n, ptr(ins[0]), int(full), ptr(ins[1]), ptr(ins[2]), ptr(ins[3]),
        float(weight), ptr(total), stream_of(dev))
    check(err, "dra_score_into")
    LAUNCHES["dra_score_into"] += 1
    return total


# --- K26 dra_take ----------------------------------------------------------------------


def dra_take_plain(free, choice, demand, commit=None, class_of=None):
    """The plain version: free[choice[b]] −= demand[class_of[b]] for every
    committed pod b (``commit``; without it, every b whose choice is ≥ 0),
    in place — the reference's float32 per-node sum is this integer sum
    below 2^24 chips."""
    n = free.shape[0]
    choice = choice.reshape(-1).long()
    take = (choice >= 0) & (choice < n)
    if commit is not None:
        take &= commit.reshape(-1)
    rows = torch.arange(choice.shape[0], device=free.device) if class_of is None \
        else class_of.long()
    d = torch.where(take, demand.reshape(-1)[rows], 0).to(free.dtype)
    free.index_add_(0, torch.where(take, choice, 0), -d)
    return free


def dra_take(free: torch.Tensor, choice: torch.Tensor, demand: torch.Tensor,
             commit: Optional[torch.Tensor] = None,
             class_of: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Take each committed pod's chips from ``free`` i32[N] in place and
    return it.  choice i32[B] node rows; demand i32[C] per row (pod b's row
    is ``class_of[b]``, an int64 index, or b without it); commit bool[B]
    (None: the pods whose choice is ≥ 0 — the scan's one pod, its node
    written on the card by K17).  CPU tensors take the plain version; CUDA
    tensors launch K26."""
    if not free.is_cuda:
        return dra_take_plain(free, choice, demand, commit, class_of)
    b = choice.numel()
    ins = [choice.reshape(-1).to(torch.int32).contiguous(), demand.contiguous()]
    opt = [None if t is None else t.reshape(-1).contiguous() for t in (commit, class_of)]
    if opt[1] is not None:  # the auction's int64 class index, read as it is
        opt[1] = opt[1].to(torch.int64)
    if not free.is_contiguous():
        raise ValueError("dra_take: free must be contiguous (updated in place)")
    dev = require_cuda("dra_take", free, *ins, *(t for t in opt if t is not None))
    require_dtype("dra_take", torch.int32, free, *ins)
    if opt[0] is not None:
        require_dtype("dra_take", torch.bool, opt[0])
    if free.dim() != 1 or any(t is not None and t.shape != (b,) for t in opt) \
            or (opt[1] is None and ins[1].shape[0] < b):
        raise ValueError("dra_take: inconsistent shapes")
    err = _fn("launch_dra_take", "iipppppp")(
        b, free.shape[0], 0 if opt[0] is None else ptr(opt[0]), ptr(ins[0]),
        0 if opt[1] is None else ptr(opt[1]), ptr(ins[1]), ptr(free), stream_of(dev))
    check(err, "dra_take")
    LAUNCHES["dra_take"] += 1
    return free
