"""K4 ``auction_resolve_commit``: one round's propose/resolve auction to its
fixpoint plus the scatter-add commit (CUDA: csrc/auction.cu).

Replaces the JAX package's ``pbody`` while_loop (framework/runtime.py
:898-925) and ``apply_dyn`` (:929-939) in ``_batch_assign_dedup``.  The
round's head/solo rules (:880-893) are evaluated in torch by the caller and
arrive as ``unresolved0``.  Works IN PLACE on ``requested`` / ``non_zero``
(the caller passes its working copies).
"""

from __future__ import annotations

import torch

from . import LAUNCHES, bind, ptr, require_cuda, require_dtype, stream_of
from .build import check, load


def auction_resolve_commit_plain(cand_val, cand_idx, class_of, pos_of,
                                 unresolved0, nom, nom_ok, request, pod_nz,
                                 requested, node_nz):
    """The plain torch version: the reference's vectorized iteration — every
    unresolved pod proposes its first unused candidate (or its nominated
    row), the smallest serial position wins each node — until no pod is
    unresolved; then the winners' requests are added to their rows."""
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
    while bool(unresolved.any()):
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
    return commit, choice.to(torch.int32)


_FN = None


def _fn():
    global _FN
    if _FN is None:
        _FN = bind(load("auction"), "launch_auction", "iiii" + "p" * 15)
    return _FN


def auction_resolve_commit(cand_val, cand_idx, class_of, pos_of, unresolved0,
                           nom, nom_ok, request, pod_nz, requested, node_nz):
    """→ (commit bool[B], choice i32[B]); ``requested`` i32[N, R] and
    ``node_nz`` i32[N, 2] gain the winners' requests in place.  CPU tensors
    take the plain version; CUDA tensors launch K4."""
    if not requested.is_cuda:
        return auction_resolve_commit_plain(
            cand_val, cand_idx, class_of, pos_of, unresolved0, nom, nom_ok,
            request, pod_nz, requested, node_nz)
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
    if b > 1024:
        raise ValueError(f"auction_resolve_commit: B={b} exceeds one block (1024)")
    minpos = torch.empty((n,), dtype=torch.int32, device=dev)
    commit = torch.empty((b,), dtype=torch.int32, device=dev)
    choice = torch.empty((b,), dtype=torch.int32, device=dev)
    err = _fn()(b, n, k, r, *map(ptr, ins), ptr(requested), ptr(node_nz),
                ptr(minpos), ptr(commit), ptr(choice), stream_of(dev))
    check(err, "auction_resolve_commit")
    LAUNCHES["auction_resolve_commit"] += 1
    return commit.to(torch.bool), choice
