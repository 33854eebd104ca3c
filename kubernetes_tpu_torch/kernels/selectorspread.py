"""K32 ``selector_spread_score``: SelectorSpread's score added into the
cycle's weighted total (CUDA: csrc/selectorspread.cu).

Replaces the JAX package's plugins/selectorspread.py ``score_row`` (:109)
and its vmapped ``score`` (:134) — ROADMAP Queue B B13 — floored and
weighted in ``run_scores`` (framework/runtime.py :206-218).  For each row c
of ``[C, N]``, over the row's mask (every filter bit set): ``max_c`` and
``max_z`` the maxima of ``counts`` and ``zone_counts`` (0 off the mask);
``node = (max_c − counts) · 100 / max(max_c, 1)`` (100 when ``max_c`` is 0),
``zone`` the same over the zone counts; ``blended = 0.33333334 · node +
0.6666667 · zone`` where the node has a zone and ``max_z > 0``, else
``node``; then ``weight · floor(blended)`` added into ``total`` on the
masked cells.  The constants are the reference's: ``1 − 2/3`` taken in
double and rounded to float32 (0.33333334, not ``1 − 0.6666667f``), and
2/3 rounded to float32.  The blend is one fused multiply-add,
``fma(0.33333334, node, 0.6666667 · zone)``: XLA:CPU contracts the
reference's ``a · node + b · zone`` so (a separate product and sum flip
the floor of about 3 in a million blends).  CPU tensors take the plain version; CUDA tensors
launch K32: at most 16 rows (the exact scan's one row) a row split across a
thread-block cluster in one pass, above that one block a row.
"""

from __future__ import annotations

import numpy as np
import torch

from . import LAUNCHES, bind, ptr, require_cuda, require_dtype, stream_of
from .build import check, load
from ..framework.interface import MAX_NODE_SCORE
from ..ops.fma import fma32

ZONE_WEIGHTING = 2.0 / 3.0  # selector_spread.go zoneWeighting
# the reference's float32 constants: (1 − 2/3) in double, then rounded
W_NODE = float(np.float32(1.0 - ZONE_WEIGHTING))
W_ZONE = float(np.float32(ZONE_WEIGHTING))


def selector_spread_score_plain(mask, counts, zone_counts, has_zone):
    """The reference's score planes f32[C, N] (before the weight): the
    masked row maxima, the invert, the zone blend, the floor."""
    max_c = torch.where(mask, counts, 0.0).amax(dim=-1, keepdim=True)
    max_z = torch.where(mask, zone_counts, 0.0).amax(dim=-1, keepdim=True)
    s = float(MAX_NODE_SCORE)
    node = torch.where(max_c > 0, (max_c - counts) * s / torch.clamp(max_c, min=1.0), s)
    zone = torch.where(max_z > 0, (max_z - zone_counts) * s / torch.clamp(max_z, min=1.0), s)
    w_node = torch.tensor(W_NODE, dtype=torch.float32, device=counts.device)
    w_zone = torch.tensor(W_ZONE, dtype=torch.float32, device=counts.device)
    blended = torch.where(has_zone[None, :] & (max_z > 0),
                          fma32(w_node.expand_as(node), node, w_zone * zone), node)
    return torch.floor(blended)


def selector_spread_score_into_plain(bits, full: int, total, counts, zone_counts,
                                     has_zone, weight: float):
    """The plain version: ``total`` += weight · score on the feasible
    entries (all ``full`` bits set), in place."""
    mask = bits == full
    score = selector_spread_score_plain(mask, counts, zone_counts, has_zone)
    total.add_(torch.where(mask, float(weight) * score, 0.0))
    return total


_FN = None


def _fn():
    global _FN
    if _FN is None:
        _FN = bind(load("selectorspread"), "launch_selector_spread_score", "iipipppfp" + "p")
    return _FN


def selector_spread_score(bits: torch.Tensor, full: int, total: torch.Tensor,
                          counts: torch.Tensor, zone_counts: torch.Tensor,
                          has_zone: torch.Tensor, weight: float):
    """Add SelectorSpread's weighted term into ``total`` f32[C, N] in place
    and return it.  bits i32[C, N] pass bits (``full`` = every filter
    passes), counts / zone_counts f32[C, N], has_zone bool[N].  CPU tensors
    take the plain version; CUDA tensors launch K32."""
    if not total.is_cuda:
        return selector_spread_score_into_plain(bits, full, total, counts, zone_counts,
                                                has_zone, weight)
    c, n = bits.shape
    bits = bits.contiguous()
    counts, zone_counts = counts.contiguous(), zone_counts.contiguous()
    has_zone = has_zone.contiguous()
    if not total.is_contiguous():
        raise ValueError("selector_spread_score: total must be contiguous (updated in place)")
    dev = require_cuda("selector_spread_score", bits, total, counts, zone_counts, has_zone)
    require_dtype("selector_spread_score", torch.int32, bits)
    require_dtype("selector_spread_score", torch.float32, total, counts, zone_counts)
    require_dtype("selector_spread_score", torch.bool, has_zone)
    if total.shape != (c, n) or counts.shape != (c, n) or zone_counts.shape != (c, n) \
            or has_zone.shape != (n,):
        raise ValueError("selector_spread_score: inconsistent shapes")
    err = _fn()(c, n, ptr(bits), int(full), ptr(counts), ptr(zone_counts), ptr(has_zone),
                float(weight), ptr(total), stream_of(dev))
    check(err, "selector_spread_score")
    LAUNCHES["selector_spread_score"] += 1
    return total
