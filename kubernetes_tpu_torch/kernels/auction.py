"""K4 ``auction_resolve_commit``: one round's propose/resolve auction to its
fixpoint plus the scatter-add commit (CUDA: csrc/auction.cu).

Replaces the JAX package's ``pbody`` while_loop (framework/runtime.py
:898-925) and ``apply_dyn`` (:929-939) in ``_batch_assign_dedup``.  The
round's head/solo rules (:880-893) are evaluated in torch by the caller and
arrive as ``unresolved0``.  Works IN PLACE on ``requested`` / ``non_zero``
(the caller passes its working copies).
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, bind, ptr, require_cuda, require_dtype, stream_of
from .build import check, load


def auction_resolve_commit_plain(cand_val, cand_idx, class_of, pos_of,
                                 unresolved0, nom, nom_ok, request, pod_nz,
                                 requested, node_nz, count_iters: bool = False):
    """The plain torch version: the reference's vectorized iteration — every
    unresolved pod proposes its first unused candidate (or its nominated
    row), the smallest serial position wins each node — until no pod is
    unresolved; then the winners' requests are added to their rows.
    ``count_iters`` adds i32[2]: the iterations, and 0 (no prefix form)."""
    b = class_of.shape[0]
    n = requested.shape[0]
    dev = requested.device
    cv = cand_val[class_of.long()]  # [B, K]
    ci = cand_idx[class_of.long()].long()
    nom = nom.long()
    arange_b = torch.arange(b, device=dev)
    unresolved = unresolved0.clone()
    used = torch.zeros(n, dtype=torch.bool, device=dev)
    commit = torch.zeros(b, dtype=torch.bool, device=dev)
    choice = torch.zeros(b, dtype=torch.int64, device=dev)
    pos = pos_of.long()
    iters = 0
    while bool(unresolved.any()):
        iters += 1
        ok = (cv > float("-inf")) & ~used[ci]
        first = torch.argmax(ok.to(torch.int8), dim=1)
        prop = ci[arange_b, first]
        has_cand = ok.any(dim=1)
        take_nom = nom_ok & ~used[nom]
        prop = torch.where(take_nom, nom, prop)
        has_bid = torch.where(take_nom, True, has_cand)
        bidder = unresolved & has_bid
        posb = torch.where(bidder, pos, b)
        minpos = torch.full((n,), b, dtype=torch.int64, device=dev).scatter_reduce(
            0, prop, posb, reduce="amin", include_self=True)
        win = bidder & (minpos[prop] == posb)
        commit = commit | win
        choice = torch.where(win, prop, choice)
        used[prop[win]] = True
        unresolved = unresolved & ~win & has_bid
    rows = choice
    add = commit[:, None]
    requested.index_add_(0, rows, torch.where(add, request, 0).to(requested.dtype))
    node_nz.index_add_(0, rows, torch.where(add, pod_nz, 0).to(node_nz.dtype))
    if count_iters:
        return commit, choice.to(torch.int32), torch.tensor([iters, 0], dtype=torch.int32)
    return commit, choice.to(torch.int32)


_FN = None
_SCRATCH = None


def _fn():
    global _FN, _SCRATCH
    if _FN is None:
        lib = load("auction")
        _SCRATCH = bind(lib, "auction_scratch_words", "i")
        _SCRATCH.restype = ctypes.c_longlong
        _FN = bind(lib, "launch_auction", "iiii" + "p" * 16)
    return _FN


def auction_resolve_commit(cand_val, cand_idx, class_of, pos_of, unresolved0,
                           nom, nom_ok, request, pod_nz, requested, node_nz,
                           count_iters: bool = False):
    """→ (commit bool[B], choice i32[B]); ``requested`` i32[N, R] and
    ``node_nz`` i32[N, 2] gain the winners' requests in place.  CPU tensors
    take the plain version; CUDA tensors launch K4.  ``count_iters`` adds a
    third output, i32[2] on the inputs' device: the fixpoint's iterations
    and how many of them were steps of the one-class closed form's prefix
    form (the plain version has none) — never asked for on the scheduler's
    path, so it costs no sync."""
    if not requested.is_cuda:
        return auction_resolve_commit_plain(
            cand_val, cand_idx, class_of, pos_of, unresolved0, nom, nom_ok,
            request, pod_nz, requested, node_nz, count_iters)
    b = class_of.shape[0]
    n, r = requested.shape
    k = cand_idx.shape[1]
    ins = [cand_val.contiguous(), cand_idx.to(torch.int32).contiguous(),
           class_of.to(torch.int32).contiguous(), pos_of.to(torch.int32).contiguous(),
           unresolved0.contiguous(), nom.to(torch.int32).contiguous(),
           nom_ok.contiguous(), request.contiguous(), pod_nz.contiguous()]
    dev = require_cuda("auction_resolve_commit", *ins, requested, node_nz)
    name = "auction_resolve_commit"
    require_dtype(name, torch.float32, ins[0])
    require_dtype(name, torch.bool, ins[4], ins[6])
    require_dtype(name, torch.int32, ins[7], ins[8], requested, node_nz)
    if cand_val.shape != cand_idx.shape or request.shape != (b, r) \
            or pod_nz.shape != (b, 2) or node_nz.shape != (n, 2):
        raise ValueError(f"{name}: inconsistent shapes")
    if not 0 < b <= 1024:
        raise ValueError(f"auction_resolve_commit: B={b} must be in 1..1024 (one block)")
    fn = _fn()
    words = int(_SCRATCH(n))
    minpos = torch.empty((words,), dtype=torch.int32, device=dev) if words else None
    iters = torch.zeros((2,), dtype=torch.int32, device=dev) if count_iters else None
    commit = torch.empty((b,), dtype=torch.bool, device=dev)
    choice = torch.empty((b,), dtype=torch.int32, device=dev)
    err = fn(b, n, k, r, *map(ptr, ins), ptr(requested), ptr(node_nz),
             ptr(minpos) if words else 0, ptr(commit), ptr(choice),
             ptr(iters) if count_iters else 0, stream_of(dev))
    check(err, "auction_resolve_commit")
    LAUNCHES["auction_resolve_commit"] += 1
    if count_iters:
        return commit, choice, iters
    return commit, choice
