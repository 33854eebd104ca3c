"""K1 ``filter_score_planes``: the dedup cycle's per-plugin filter bits and raw
score planes over ``[C, N]`` (CUDA: csrc/filter_score.cu).

Replaces the JAX package's per-round plane build in
framework/runtime.py ``_batch_assign_dedup.dense_rep`` (:852-867) for the
main-path plugins.  Output: ``bits i32[C, N]`` — bit k set when filter
plugin k (the framework's filter order) passes, with ``live_nodes`` and the
class's valid flag folded in, so the feasibility mask is "all bits set";
a kernel filter the profile does not run has no bit — and ``raw f32[5, C,
N]``: TaintToleration, NodeAffinity, Fit (under the profile's scoring
strategy: LeastAllocated, MostAllocated or RequestedToCapacityRatio with
its shape points), BalancedAllocation, ImageLocality.  NodeAffinity's
planes come in precomputed (selector matching, ROADMAP B4) and
ImageLocality's per-id spread-scaled sizes too (small scatters,
plugins/trivial.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..framework.interface import DynamicState
from ..plugins.noderesources import (
    STRATEGY_CODE,
    BalancedAllocationPlugin,
    FitPlugin,
    fit_filter,
)
from ..plugins.tainttoleration import TaintTolerationPlugin
from ..plugins.trivial import (
    NodeNamePlugin,
    NodePortsPlugin,
    NodeUnschedulablePlugin,
    image_locality_plane,
)
from ..state.dictionary import ID_UNSCHEDULABLE_TAINT, ID_WILDCARD_IP
from ..state.encoding import live_nodes
from . import LAUNCHES, bind, ptr, require_cuda, require_dtype, stream_of
from .build import check, load

RAW_PLANES = ("TaintToleration", "NodeAffinity", "NodeResourcesFit",
              "NodeResourcesBalancedAllocation", "ImageLocality")

# the six filter plugins the kernel evaluates, by framework name
KERNEL_FILTERS = ("NodeUnschedulable", "NodeName", "TaintToleration",
                  "NodeAffinity", "NodePorts", "NodeResourcesFit")

# the PodBatch rows K1 (and its plain version) reads, in launch order
ROW_FIELDS = ("valid", "request", "non_zero", "node_name_id", "tol_valid", "tol_key",
              "tol_val", "tol_op", "tol_effect", "ports", "ports_ip", "image_ids")


def pod_row(batch, i: int) -> SimpleNamespace:
    """Pod i's rows of ``batch`` that K1 reads (views) — the exact scan's
    one-row input, without a whole PodBatch per step."""
    return SimpleNamespace(**{f: getattr(batch, f)[i:i + 1] for f in ROW_FIELDS})


@dataclass
class FilterScorePlan:
    """Static per-framework inputs: the Fit / BalancedAllocation plugin
    objects (their weight and selection vectors, Fit's strategy and shape
    points; None when the profile does not score with the plugin: its
    plane is then all 0), the bit position of each kernel filter in the
    framework's filter order (absent: the profile does not run it), the OR
    of the bits K1 sets on every live node of a valid row (the pass-through
    filters', and the dynamic filters' as seeds), and the bit of each
    dynamic filter that its own kernel writes afterwards."""

    fit: Optional[FitPlugin]
    balanced: Optional[BalancedAllocationPlugin]
    bit_of: dict  # KERNEL_FILTERS name → bit
    pass_bits: int
    dynamic_bits: dict = field(default_factory=dict)  # plugin name → bit

    @property
    def strategy(self) -> int:
        """Fit's strategy code (STRATEGY_CODE; LeastAllocated without Fit)."""
        return STRATEGY_CODE[self.fit.strategy] if self.fit is not None else 0

    def vectors(self, device, r: int = 8):
        """(Fit weights f32[R], BalancedAllocation selection bool[R], Fit's
        shape points x and y f32[S]) on ``device``, uploaded once per
        device; zero weights and no selection for an absent plugin."""
        cache = self.__dict__.setdefault("_vectors", {})
        key = str(device)
        if key not in cache:
            if self.fit is not None:
                fit = self.fit
                weights = fit.weights
            else:  # only the default shape points are read: a valid launch
                fit = FitPlugin()
                weights = np.zeros(r, np.float32)
            sel = self.balanced.sel if self.balanced is not None else np.zeros(r, bool)
            cache[key] = tuple(torch.from_numpy(np.ascontiguousarray(v)).to(device)
                               for v in (weights, sel, fit.shape_x, fit.shape_y))
        return cache[key]


def filter_score_planes_plain(rep, snap, dyn: DynamicState, na_mask, na_pref,
                              img_scaled, plan: FilterScorePlan):
    """The plain torch version: the plugins' own filter/score programs."""
    filt = {
        "NodeUnschedulable": NodeUnschedulablePlugin().filter(rep, snap, dyn),
        "NodeName": NodeNamePlugin().filter(rep, snap, dyn),
        "TaintToleration": TaintTolerationPlugin().filter(rep, snap, dyn),
        "NodeAffinity": na_mask,
        "NodePorts": NodePortsPlugin().filter(rep, snap, dyn),
        "NodeResourcesFit": fit_filter(rep, snap, dyn),
    }
    c, n = rep.valid.shape[0], snap.num_nodes
    bits = torch.full((c, n), plan.pass_bits, dtype=torch.int32, device=snap.device)
    for name in KERNEL_FILTERS:
        if name in plan.bit_of:
            plane = filt[name].expand(c, n).to(torch.int32)
            bits = bits | (plane << plan.bit_of[name])
    live = live_nodes(snap)[None, :] & rep.valid[:, None]
    bits = torch.where(live, bits, 0)
    zero = torch.zeros((c, n), dtype=torch.float32, device=snap.device)
    raw = torch.stack([
        TaintTolerationPlugin().score(rep, snap, dyn),
        na_pref.to(torch.float32),
        plan.fit.score(rep, snap, dyn) if plan.fit is not None else zero,
        plan.balanced.score(rep, snap, dyn) if plan.balanced is not None else zero,
        image_locality_plane(rep.image_ids, snap, img_scaled),
    ])
    return bits, raw


_FN = None


def _fn():
    global _FN
    if _FN is None:
        _FN = bind(load("filter_score"), "launch_filter_score",
                   "iii" + "p" * 12 + "iii" + "p" * 13 + "iii" + "ppp" + "i"
                   + "pp" + "i" * 9 + "ippi" + "pp" + "p")
    return _FN


def filter_score_planes(rep, snap, dyn: DynamicState, na_mask, na_pref,
                        img_scaled, plan: FilterScorePlan):
    """→ (bits i32[C, N], raw f32[5, C, N]).  CPU tensors take the plain
    version; CUDA tensors launch K1 (one launch, no other device work)."""
    if not snap.node_valid.is_cuda:
        return filter_score_planes_plain(rep, snap, dyn, na_mask, na_pref,
                                         img_scaled, plan)
    c, n = rep.valid.shape[0], snap.num_nodes
    r = snap.allocatable.shape[1]
    dev = snap.device
    cls = [getattr(rep, f).contiguous() for f in ROW_FIELDS]
    # live_nodes (node_valid & node_ready) is folded in by the kernel
    nodes = [snap.node_ready, snap.node_valid, snap.node_name_ids, snap.unschedulable,
             snap.allocatable, dyn.requested, dyn.non_zero, snap.taint_keys,
             snap.taint_vals, snap.taint_effects, snap.ports, snap.ports_ip,
             snap.image_ids]
    nodes = [t.contiguous() for t in nodes]
    fit_w, ba_sel, shape_x, shape_y = plan.vectors(dev, r)
    na_mask = na_mask.contiguous()
    na_pref = na_pref.to(torch.float32).contiguous()
    img_scaled = img_scaled.contiguous()
    require_cuda("filter_score_planes", *cls, *nodes, na_mask, na_pref,
                 img_scaled, fit_w, ba_sel, shape_x, shape_y)
    name = "filter_score_planes"
    require_dtype(name, torch.bool, cls[0], cls[4], nodes[0], nodes[1], nodes[3],
                  na_mask, ba_sel)
    require_dtype(name, torch.int32, *cls[1:4], *cls[5:], *nodes[2:3], *nodes[4:])
    require_dtype(name, torch.float32, na_pref, img_scaled, fit_w, shape_x, shape_y)
    if rep.request.shape[1] != r or fit_w.shape[0] != r or ba_sel.shape[0] != r \
            or na_mask.shape != (c, n) or na_pref.shape != (c, n) \
            or shape_x.shape != shape_y.shape or shape_x.shape[0] < 2:
        raise ValueError(f"{name}: inconsistent shapes")
    bits = torch.empty((c, n), dtype=torch.int32, device=dev)
    raw = torch.empty((5, c, n), dtype=torch.float32, device=dev)
    b = plan.bit_of
    err = _fn()(
        c, n, r, *map(ptr, cls),
        rep.tol_valid.shape[1], rep.ports.shape[1], rep.image_ids.shape[1],
        *map(ptr, nodes),
        snap.taint_keys.shape[1], snap.ports.shape[1], snap.image_ids.shape[1],
        ptr(na_mask), ptr(na_pref), ptr(img_scaled), img_scaled.shape[0],
        ptr(fit_w), ptr(ba_sel),
        *(b.get(k, -1) for k in KERNEL_FILTERS), plan.pass_bits,
        ID_UNSCHEDULABLE_TAINT, ID_WILDCARD_IP,
        plan.strategy, ptr(shape_x), ptr(shape_y), shape_x.shape[0],
        ptr(bits), ptr(raw), stream_of(dev))
    check(err, "filter_score_planes")
    LAUNCHES["filter_score_planes"] += 1
    return bits, raw
