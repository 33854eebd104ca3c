"""K2 ``normalize_combine``: normalize each raw score plane and combine them
into the weighted total (CUDA: csrc/normalize_combine.cu).

Replaces the JAX package's ``run_scores`` sum (framework/runtime.py:206-218)
as ``_batch_assign_dedup.dense_rep`` (:857-867) applies it per round:
``total = Σ_plugin weight · floor(normalize(raw))`` with −inf where the
node is infeasible, plus the row's feasible-node count.  The feasibility
mask is "every filter bit set" of K1's bit plane.

One launch a call at every C.  The kernel reads each plane once into
registers (above 16 rows only where the bits hold a feasible node); a row
goes to a thread-block cluster of up to 8 blocks, whose per-plane maxima
and feasible counts meet through distributed shared memory before every
block writes its nodes' totals.  The plan (kinds, weights, ``const_add``
and the full bit mask) is a kernel parameter.  The float order is the
plain version's: each term ``weight · floor(norm)`` added in plane order
from 0, then ``const_add``; the row maximum is order-free and the count an
integer.

Packed mode (``packed=True``): the extender rounds' ``compute_packed``
(runtime.py:225) — the plane alone, −inf where the filter bits miss
``full``, written in the same single pass with no feasible count.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from ..plugins.helpers import default_normalize
from . import LAUNCHES, ptr, require_cuda, require_dtype, stream_of
from .build import check, load

KIND_IDENTITY = 0
KIND_DEFAULT = 1
KIND_DEFAULT_REVERSED = 2
# the kernel takes the plan by value, at most this many planes
MAX_PLANES = 8


@dataclass
class CombinePlan:
    """Per raw plane: its normalization kind and plugin weight; plus the
    pass-through plugins' constant contribution on every feasible node."""

    kinds: Tuple[int, ...]
    weights: Tuple[float, ...]
    const_add: float

    def packed(self, full: int) -> "_Plan":
        """The kernel's by-value plan for this plan and ``full``, built once
        per mask."""
        cache = self.__dict__.setdefault("_packed", {})
        if full not in cache:
            if len(self.kinds) > MAX_PLANES:
                raise ValueError(f"normalize_combine: at most {MAX_PLANES} planes")
            cache[full] = _Plan((ctypes.c_int * MAX_PLANES)(*self.kinds),
                                (ctypes.c_float * MAX_PLANES)(*self.weights),
                                float(self.const_add), int(full))
        return cache[full]


class _Plan(ctypes.Structure):
    """csrc/normalize_combine.cu's ``CombinePlan``."""

    _fields_ = [("kind", ctypes.c_int * MAX_PLANES), ("weight", ctypes.c_float * MAX_PLANES),
                ("const_add", ctypes.c_float), ("full", ctypes.c_int)]


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
        fn = load("normalize_combine").launch_normalize_combine
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, _Plan,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def normalize_combine(bits, full: int, raw, plan: CombinePlan, packed: bool = False):
    """→ (total f32[C, N], feasible count i32[C]); with ``packed`` the total
    alone (K2's packed mode).  CPU tensors take the plain version; CUDA
    tensors launch K2."""
    if not bits.is_cuda:
        total, feas = normalize_combine_plain(bits, full, raw, plan)
        return total if packed else (total, feas)
    c, n = bits.shape
    p = raw.shape[0]
    dev = bits.device
    bits, raw = bits.contiguous(), raw.contiguous()
    require_cuda("normalize_combine", bits, raw)
    require_dtype("normalize_combine", torch.int32, bits)
    require_dtype("normalize_combine", torch.float32, raw)
    if raw.shape[1:] != bits.shape or len(plan.kinds) != p:
        raise ValueError("normalize_combine: inconsistent shapes")
    total = torch.empty((c, n), dtype=torch.float32, device=dev)
    feas = None if packed else torch.empty((c,), dtype=torch.int32, device=dev)
    err = _fn()(c, n, p, ptr(bits), plan.packed(full), ptr(raw), ptr(total),
                None if feas is None else ptr(feas), stream_of(dev))
    check(err, "normalize_combine")
    if packed:
        LAUNCHES["normalize_combine_packed"] += 1
        return total
    LAUNCHES["normalize_combine"] += 1
    return total, feas
