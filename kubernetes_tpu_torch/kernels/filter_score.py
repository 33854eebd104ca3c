"""K1 ``filter_score_planes``: the dedup cycle's per-plugin filter bits and raw
score planes over ``[C, N]`` (CUDA: csrc/filter_score.cu).

Replaces the JAX package's per-round plane build in
framework/runtime.py ``_batch_assign_dedup.dense_rep`` (:852-867) for the
main-path plugins.  Output: ``bits i32[C, N]`` — bit k set when filter
plugin k (the framework's filter order) passes, with ``live_nodes`` and the
class's valid flag folded in, so the feasibility mask is "all bits set" —
and ``raw f32[5, C, N]``: TaintToleration, NodeAffinity, Fit,
BalancedAllocation, ImageLocality.  NodeAffinity's planes come in
precomputed (selector matching, ROADMAP B4) and ImageLocality's per-id
spread-scaled sizes too (small scatters, plugins/trivial.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace

import torch

from ..framework.interface import DynamicState
from ..plugins.noderesources import BalancedAllocationPlugin, FitPlugin, fit_filter
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
    objects (their weight and selection vectors), the bit position of each
    kernel filter in the framework's filter order, the OR of the bits K1
    sets on every live node of a valid row (the pass-through filters', and
    the dynamic filters' as seeds), and the bit of each dynamic filter that
    its own kernel writes afterwards."""

    fit: FitPlugin
    balanced: BalancedAllocationPlugin
    bit_of: dict  # KERNEL_FILTERS name → bit
    pass_bits: int
    dynamic_bits: dict = field(default_factory=dict)  # plugin name → bit

    def vectors(self, device):
        """(Fit weights f32[R], BalancedAllocation selection bool[R]) on
        ``device``, uploaded once per device."""
        cache = self.__dict__.setdefault("_vectors", {})
        key = str(device)
        if key not in cache:
            cache[key] = (torch.from_numpy(self.fit.weights).to(device),
                          torch.from_numpy(self.balanced.sel).to(device))
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
        plane = filt[name].expand(c, n).to(torch.int32)
        bits = bits | (plane << plan.bit_of[name])
    live = live_nodes(snap)[None, :] & rep.valid[:, None]
    bits = torch.where(live, bits, 0)
    raw = torch.stack([
        TaintTolerationPlugin().score(rep, snap, dyn),
        na_pref.to(torch.float32),
        plan.fit.score(rep, snap, dyn),
        plan.balanced.score(rep, snap, dyn),
        image_locality_plane(rep.image_ids, snap, img_scaled),
    ])
    return bits, raw


_FN = None


def _fn():
    global _FN
    if _FN is None:
        _FN = bind(load("filter_score"), "launch_filter_score",
                   "iii" + "p" * 12 + "iii" + "p" * 13 + "iii" + "ppp" + "i"
                   + "pp" + "i" * 9 + "pp" + "p")
    return _FN


def filter_score_planes(rep, snap, dyn: DynamicState, na_mask, na_pref,
                        img_scaled, plan: FilterScorePlan):
    """→ (bits i32[C, N], raw f32[5, C, N]).  CPU tensors take the plain
    version; CUDA tensors launch K1."""
    if not snap.node_valid.is_cuda:
        return filter_score_planes_plain(rep, snap, dyn, na_mask, na_pref,
                                         img_scaled, plan)
    c, n = rep.valid.shape[0], snap.num_nodes
    r = snap.allocatable.shape[1]
    dev = snap.device
    cls = [getattr(rep, f).contiguous() for f in ROW_FIELDS]
    live = live_nodes(snap).contiguous()
    nodes = [live, snap.node_valid, snap.node_name_ids, snap.unschedulable,
             snap.allocatable, dyn.requested, dyn.non_zero, snap.taint_keys,
             snap.taint_vals, snap.taint_effects, snap.ports, snap.ports_ip,
             snap.image_ids]
    nodes = [t.contiguous() for t in nodes]
    fit_w, ba_sel = plan.vectors(dev)
    na_mask = na_mask.contiguous()
    na_pref = na_pref.to(torch.float32).contiguous()
    img_scaled = img_scaled.contiguous()
    require_cuda("filter_score_planes", *cls, *nodes, na_mask, na_pref,
                 img_scaled, fit_w, ba_sel)
    name = "filter_score_planes"
    require_dtype(name, torch.bool, cls[0], cls[4], nodes[0], nodes[1], nodes[3],
                  na_mask, ba_sel)
    require_dtype(name, torch.int32, *cls[1:4], *cls[5:], *nodes[2:3], *nodes[4:])
    require_dtype(name, torch.float32, na_pref, img_scaled, fit_w)
    if rep.request.shape[1] != r or fit_w.shape[0] != r or ba_sel.shape[0] != r \
            or na_mask.shape != (c, n) or na_pref.shape != (c, n):
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
        b["NodeUnschedulable"], b["NodeName"], b["TaintToleration"],
        b["NodeAffinity"], b["NodePorts"], b["NodeResourcesFit"], plan.pass_bits,
        ID_UNSCHEDULABLE_TAINT, ID_WILDCARD_IP, ptr(bits), ptr(raw), stream_of(dev))
    check(err, "filter_score_planes")
    LAUNCHES["filter_score_planes"] += 1
    return bits, raw
