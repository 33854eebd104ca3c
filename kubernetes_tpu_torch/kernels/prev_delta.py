"""K13: the fused cycle's nominated reservations and in-flight resource delta
(CUDA: csrc/prev_delta.cu).

Replaces the JAX package's scheduler.py ``_build_jitted.reserve_nominated``
(:889-895) and ``apply_prev_delta`` (:897-916, ROADMAP Queue B B2): the
nominated pods' requests are added into ``requested`` at their nominated
node rows (a bundle whose ``nz`` rows are zero: ``non_zero`` stays as it
is), and each still-in-flight batch's request rows into ``requested`` /
``non_zero`` at the node rows its device-resident decision chose, before
this batch's prepare and assignment; rows below 0 add nothing.  Up to three
bundles: the nominated rows, then two in-flight batches (depth 3), oldest
first.  The adds are int32, so their order changes no bit.

Out of place: the dynamic state starts as an alias of the snapshot's
``requested`` / ``non_zero_requested`` (``initial_dynamic_state``), and the
next dispatch's row-scatter starts from that snapshot, so the result is a
new pair of arrays.  CPU tensors take the plain version (``index_add_``
into copies); CUDA tensors launch K13 once for all bundles, which writes
the new arrays from the old ones with the adds folded in (no separate
copy).  A bundle's ``nz`` may be None (the nominated pods: ``non_zero``
stays as it is), so no zero rows are made for it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import LAUNCHES, bind, ptr, require_cuda, require_dtype, stream_of
from .build import check, load

# the nominated rows and at most two in-flight batches (pipeline_depth ≤ 3)
MAX_BUNDLES = 3


def prev_delta_apply_plain(requested, non_zero, bundles):
    """The plain version: per bundle, the masked request rows added at the
    clipped node rows (the reference's ``.at[rows].add``); a bundle whose
    ``nz`` is None adds nothing to ``non_zero``."""
    req = requested.clone()
    nz = non_zero.clone()
    n = req.shape[0]
    for rows, b_req, b_nz in bundles:
        ok = (rows >= 0)[:, None]
        at = rows.long().clamp(0, n - 1)
        req.index_add_(0, at, torch.where(ok, b_req, 0).to(req.dtype))
        if b_nz is not None:
            nz.index_add_(0, at, torch.where(ok, b_nz, 0).to(nz.dtype))
    return req, nz


def prev_delta_apply(requested: torch.Tensor, non_zero: torch.Tensor,
                     bundles: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                             Optional[torch.Tensor]]]):
    """→ (requested i32[N, R], non_zero i32[N, 2]): new arrays, the inputs
    with every bundle's ``(rows i32[B0], req i32[B0, R], nz i32[B0, 2] or
    None)`` added at its rows ≥ 0 (rows ≥ N on row N − 1).  CPU tensors take
    the plain version; CUDA tensors launch K13 once for every bundle."""
    bundles = list(bundles)
    if len(bundles) > MAX_BUNDLES:
        raise ValueError(f"prev_delta_apply: at most {MAX_BUNDLES} bundles")
    if not requested.is_cuda:
        return prev_delta_apply_plain(requested, non_zero, bundles)
    if not bundles:
        return requested.clone(), non_zero.clone()
    n, r = requested.shape
    requested, non_zero = requested.contiguous(), non_zero.contiguous()
    args = []
    for rows, b_req, b_nz in bundles:
        part = [rows.to(torch.int32).contiguous(), b_req.contiguous(),
                None if b_nz is None else b_nz.contiguous()]
        b0 = part[0].shape[0]
        if part[1].shape != (b0, r) or (part[2] is not None and part[2].shape != (b0, 2)):
            raise ValueError("prev_delta_apply: inconsistent bundle shapes")
        args.append(part)
    given = [t for p in args for t in p if t is not None]
    dev = require_cuda("prev_delta_apply", requested, non_zero, *given)
    require_dtype("prev_delta_apply", torch.int32, requested, non_zero, *given)
    if non_zero.shape != (n, 2):
        raise ValueError("prev_delta_apply: non_zero must be [N, 2]")
    req = torch.empty_like(requested)
    nz = torch.empty_like(non_zero)
    flat = []
    for p in args + [None] * (MAX_BUNDLES - len(args)):
        flat += [0, 0, 0, 0] if p is None else \
            [p[0].shape[0], *(0 if t is None else ptr(t) for t in p)]
    err = _fn("launch_prev_delta", "ippp" * MAX_BUNDLES + "ii" + "pppp" + "p")(
        *flat, n, r, ptr(requested), ptr(non_zero), ptr(req), ptr(nz), stream_of(dev))
    check(err, "prev_delta_apply")
    LAUNCHES["prev_delta_apply"] += 1
    return req, nz


_FNS = {}


def _fn(name: str, spec: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = bind(load("prev_delta"), name, spec)
    return fn
