"""K2 ``normalize_combine``: normalize each raw score plane and combine them
into the weighted total (CUDA: csrc/normalize_combine.cu).

Replaces the JAX package's ``run_scores`` sum (framework/runtime.py:206-218)
as ``_batch_assign_dedup.dense_rep`` (:857-867) applies it per round:
``total = Σ_plugin weight · floor(normalize(raw))`` with −inf where the
node is infeasible, plus the row's feasible-node count.  The feasibility
mask is "every filter bit set" of K1's bit plane.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..plugins.helpers import default_normalize
from . import LAUNCHES, bind, ptr, require_cuda, require_dtype, stream_of
from .build import check, load

KIND_IDENTITY = 0
KIND_DEFAULT = 1
KIND_DEFAULT_REVERSED = 2


@dataclass
class CombinePlan:
    """Per raw plane: its normalization kind and plugin weight; plus the
    pass-through plugins' constant contribution on every feasible node."""

    kinds: Tuple[int, ...]
    weights: Tuple[float, ...]
    const_add: float

    def vectors(self, device):
        """(kinds i32[P], weights f32[P]) on ``device``, uploaded once per
        device."""
        cache = self.__dict__.setdefault("_vectors", {})
        key = str(device)
        if key not in cache:
            cache[key] = (torch.tensor(self.kinds, dtype=torch.int32, device=device),
                          torch.tensor(self.weights, dtype=torch.float32, device=device))
        return cache[key]


def normalize_combine_plain(bits, full: int, raw, plan: CombinePlan):
    """The plain torch version: the plugins' normalizers, then the sum."""
    mask = bits == full
    total = torch.zeros(bits.shape, dtype=torch.float32, device=bits.device)
    for p, (kind, w) in enumerate(zip(plan.kinds, plan.weights)):
        x = raw[p]
        if kind == KIND_DEFAULT:
            x = default_normalize(x, mask)
        elif kind == KIND_DEFAULT_REVERSED:
            x = default_normalize(x, mask, reverse=True)
        total = total + float(w) * torch.floor(x)
    total = total + float(plan.const_add)
    total = torch.where(mask, total, float("-inf"))
    return total, mask.sum(dim=1, dtype=torch.int32)


_FN = None


def _fn():
    global _FN
    if _FN is None:
        _FN = bind(load("normalize_combine"), "launch_normalize_combine",
                   "iiipipppfppp")
    return _FN


def normalize_combine(bits, full: int, raw, plan: CombinePlan):
    """→ (total f32[C, N], feasible count i32[C]).  CPU tensors take the
    plain version; CUDA tensors launch K2."""
    if not bits.is_cuda:
        return normalize_combine_plain(bits, full, raw, plan)
    c, n = bits.shape
    p = raw.shape[0]
    dev = bits.device
    kinds, weights = plan.vectors(dev)
    bits, raw = bits.contiguous(), raw.contiguous()
    require_cuda("normalize_combine", bits, raw, kinds, weights)
    require_dtype("normalize_combine", torch.int32, bits)
    require_dtype("normalize_combine", torch.float32, raw)
    if raw.shape[1:] != bits.shape or len(plan.kinds) != p:
        raise ValueError("normalize_combine: inconsistent shapes")
    total = torch.empty((c, n), dtype=torch.float32, device=dev)
    feas = torch.empty((c,), dtype=torch.int32, device=dev)
    err = _fn()(c, n, p, ptr(bits), int(full), ptr(raw), ptr(kinds),
                ptr(weights), float(plan.const_add), ptr(total), ptr(feas),
                stream_of(dev))
    check(err, "normalize_combine")
    LAUNCHES["normalize_combine"] += 1
    return total, feas
