"""K21 ``cosched_score_into``: Coscheduling's anchor-slice score added into
the cycle's weighted total (CUDA: csrc/cosched.cu).

Replaces the JAX package's gang/coscheduling.py ``CoschedulingPlugin.score``
(:100) with its ``default_normalize`` (plugins/helpers.py :58), floored and
weighted in ``run_scores`` (framework/runtime.py :206-218) — the gang half
of ROADMAP Queue B B14.  The plain version computes exactly that: the 0/1
match plane, normalized over the feasible nodes, floored, weighted.  The
kernel uses its closed form: on a feasible node the term is
``w · 100 · [anchor[c] ≥ 0 ∧ slice_dom[n] = anchor[c]]`` (a row whose
anchor slice holds no feasible node scores 0 on every feasible node, which
are all non-matches), with no row reduction; infeasible entries keep the
total's −inf.  CPU tensors take the plain version; CUDA tensors launch K21.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, bind, ptr, require_cuda, require_dtype, stream_of
from .build import check, load
from ..framework.interface import MAX_NODE_SCORE
from ..plugins.helpers import default_normalize


def cosched_match_plane(anchor: torch.Tensor, slice_dom: torch.Tensor) -> torch.Tensor:
    """The reference's raw score: f32[C, N] 1 where node n lies in row c's
    anchor slice (anchor ≥ 0), else 0."""
    match = (anchor[:, None] == slice_dom[None, :]) & (anchor[:, None] >= 0)
    return match.to(torch.float32)


def cosched_score_into_plain(bits, full: int, total, anchor, slice_dom, weight: float):
    """The plain version: ``total`` += weight · floor(default_normalize(match))
    on the feasible entries (all ``full`` bits set), in place."""
    mask = bits == full
    norm = default_normalize(cosched_match_plane(anchor, slice_dom), mask)
    total.add_(torch.where(mask, float(weight) * torch.floor(norm), 0.0))
    return total


_FN = None


def _fn():
    global _FN
    if _FN is None:
        _FN = bind(load("cosched"), "launch_cosched_score_into", "iipippfpp")
    return _FN


def cosched_score_into(bits: torch.Tensor, full: int, total: torch.Tensor,
                       anchor: torch.Tensor, slice_dom: torch.Tensor, weight: float):
    """Add Coscheduling's weighted term into ``total`` f32[C, N] in place and
    return it.  bits i32[C, N] pass bits (``full`` = every filter passes),
    anchor i32[C] (−2 / −1: no anchor), slice_dom i32[N] (−1: no slice).
    CPU tensors take the plain version; CUDA tensors launch K21."""
    if not total.is_cuda:
        return cosched_score_into_plain(bits, full, total, anchor, slice_dom, weight)
    c, n = bits.shape
    anchor = anchor.to(torch.int32).contiguous()
    slice_dom = slice_dom.to(torch.int32).contiguous()
    bits = bits.contiguous()
    if not total.is_contiguous():
        raise ValueError("cosched_score_into: total must be contiguous (updated in place)")
    dev = require_cuda("cosched_score_into", bits, total, anchor, slice_dom)
    require_dtype("cosched_score_into", torch.int32, bits, anchor, slice_dom)
    require_dtype("cosched_score_into", torch.float32, total)
    if total.shape != (c, n) or anchor.shape != (c,) or slice_dom.shape != (n,):
        raise ValueError("cosched_score_into: inconsistent shapes")
    add = float(weight) * float(MAX_NODE_SCORE)
    err = _fn()(c, n, ptr(bits), int(full), ptr(anchor), ptr(slice_dom), add, ptr(total),
                stream_of(dev))
    check(err, "cosched_score_into")
    LAUNCHES["cosched_score_into"] += 1
    return total
