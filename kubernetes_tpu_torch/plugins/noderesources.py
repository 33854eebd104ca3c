"""NodeResourcesFit + BalancedAllocation as batched tensor programs (plain torch).

Reference: pkg/scheduler/framework/plugins/noderesources/
  fit.go:255-328      fitsRequest — per-dim ``request ≤ allocatable − requested``
  least_allocated.go:29-57   Σ_r w_r·(cap−req)·100/cap / Σw     (non-zero requests)
  most_allocated.go          Σ_r w_r·req·100/cap / Σw
  requested_to_capacity_ratio.go   piecewise-linear shape over utilization
  balanced_allocation.go:90-140    (1 − std(fractions)) · 100   (true requests)

Numerics follow the JAX package's programs operation for operation (the
floors make one ulp a possible binding change): float32 throughout,
``(alloc − total) * 100 / max(alloc, 1)`` and ``total * 100 / max(alloc,
1)`` as multiply then divide, RequestedToCapacityRatio's interpolation as
``jnp.interp`` computes it (``rtcr_interp``), and sums over the resource
axis in ascending dimension order.  Under the default weights only cpu and
memory carry weight, so the sums add at most two non-zero terms and the
order cannot change them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..framework.events import ActionType, ClusterEvent, EventResource
from ..framework.interface import MAX_NODE_SCORE, DynamicState, Plugin
from ..ops.fma import fma32
from ..state import units

LEAST_ALLOCATED = "LeastAllocated"
MOST_ALLOCATED = "MostAllocated"
REQUESTED_TO_CAPACITY_RATIO = "RequestedToCapacityRatio"
# the strategy's code in K1's plan (kernels/filter_score.py)
STRATEGY_CODE = {LEAST_ALLOCATED: 0, MOST_ALLOCATED: 1, REQUESTED_TO_CAPACITY_RATIO: 2}


def fit_filter(batch, snap, dyn: DynamicState):
    """bool[B, N] — per-dim fit incl. extended resources (fit.go:255-328).

    A zero request always fits (the reference skips zero-valued resources even on
    overcommitted nodes).
    """
    free = snap.allocatable[None, :, :] - dyn.requested[None, :, :]  # [1, N, R]
    req = batch.request[:, None, :]  # [B, 1, R]
    return ((req == 0) | (req <= free)).all(dim=-1)  # [B, N]


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in ascending index order."""
    total = x[..., 0]
    for k in range(1, x.shape[-1]):
        total = total + x[..., k]
    return total


def rtcr_interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` as jax computes it in float32: the segment
    index ``i = clip(searchsorted(xp, x, side="right"), 1, P − 1)`` by its
    binary search (ceil(log2(P + 1)) halvings of [0, P), moving left while
    ``x < xp[mid]``), then ``fp[i−1] + (delta / dx) · df`` — ``fp[i−1]``
    where ``|dx|`` is at most ``spacing(eps)`` — and ``fp[0]`` / ``fp[−1]``
    left / right of the points."""
    p = xp.shape[0]
    low = torch.zeros(x.shape, dtype=torch.long, device=x.device)
    high = torch.full(x.shape, p, dtype=torch.long, device=x.device)
    for _ in range(int(np.ceil(np.log2(p + 1)))):
        mid = (low + high) // 2
        go_left = x < xp[mid.clamp(max=p - 1)]
        low, high = torch.where(go_left, low, mid), torch.where(go_left, mid, high)
    i = high.clamp(1, p - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= _DX_EPS
    # XLA:CPU contracts ``fp[i−1] + q·df`` into one fused multiply-add
    f = torch.where(dx0, fp[i - 1], fma32(delta / torch.where(dx0, 1.0, dx), df, fp[i - 1]))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


# np.spacing(np.finfo(float32).eps): jnp.interp's flat-segment threshold
_DX_EPS = float(np.spacing(np.finfo(np.float32).eps))


def _base_dims():
    return {"cpu": units.DIM_CPU, "memory": units.DIM_MEMORY,
            "ephemeral-storage": units.DIM_EPHEMERAL, "pods": units.DIM_PODS}


class FitPlugin(Plugin):
    name = "NodeResourcesFit"
    dynamic = True

    def __init__(self, strategy: str = LEAST_ALLOCATED,
                 resources: Optional[Dict[str, int]] = None,
                 num_resource_dims: int = 8,
                 extended_index: Optional[Dict[str, int]] = None,
                 shape: Optional[Sequence[Tuple[int, int]]] = None):
        """resources: resource name → weight (default {"cpu": 1, "memory": 1}).
        shape: RequestedToCapacityRatio (utilization%, score) points."""
        if strategy not in STRATEGY_CODE:
            raise ValueError(f"unknown NodeResourcesFit strategy {strategy!r}")
        self.strategy = strategy
        resources = resources or {"cpu": 1, "memory": 1}
        w = np.zeros(num_resource_dims, dtype=np.float32)
        base = _base_dims()
        for name, weight in resources.items():
            if name in base:
                w[base[name]] = weight
            elif extended_index and name in extended_index:
                w[extended_index[name]] = weight
        self.weights = w
        if shape is None:
            # defaults for RequestedToCapacityRatio (utilization 0 → score 0,
            # utilization 100 → score 10 — apis/config defaults)
            shape = [(0, 0), (100, 10)]
        self.shape_x = np.asarray([p[0] for p in shape], dtype=np.float32)
        self.shape_y = np.asarray(
            [p[1] * (MAX_NODE_SCORE // 10) for p in shape], dtype=np.float32)

    def events_to_register(self):
        return [
            ClusterEvent(EventResource.POD, ActionType.DELETE),
            ClusterEvent(EventResource.NODE, ActionType.ADD | ActionType.UPDATE_NODE_ALLOCATABLE),
        ]

    def filter(self, batch, snap, dyn: DynamicState, aux=None):
        return fit_filter(batch, snap, dyn)

    def score(self, batch, snap, dyn: DynamicState, aux=None, mask=None):
        dev = snap.allocatable.device
        w = torch.from_numpy(self.weights).to(dev)  # [R]
        alloc = snap.allocatable.float()  # [N, R]
        # every strategy uses *non-zero* requests for cpu/memory
        # (resource_allocation.go useRequested=false → NonZeroRequested)
        nz_req = dyn.requested.float().clone()
        nz_req[:, units.DIM_CPU] = dyn.non_zero[:, 0].float()
        nz_req[:, units.DIM_MEMORY] = dyn.non_zero[:, 1].float()
        pod_req = batch.request.float()
        pod_nz = pod_req.clone()
        pod_nz[:, units.DIM_CPU] = batch.non_zero[:, 0].float()
        pod_nz[:, units.DIM_MEMORY] = batch.non_zero[:, 1].float()

        # floor mirrors the reference's per-resource int64 division
        # (leastRequestedScore / mostRequestedScore)
        total = nz_req[None, :, :] + pod_nz[:, None, :]  # [B, N, R]
        a = alloc[None]
        over = (a == 0) | (total > a)
        if self.strategy == LEAST_ALLOCATED:
            per_dim = torch.where(over, 0.0, torch.floor(
                (a - total) * float(MAX_NODE_SCORE) / torch.clamp(a, min=1.0)))
        elif self.strategy == MOST_ALLOCATED:
            per_dim = torch.where(over, 0.0, torch.floor(
                total * float(MAX_NODE_SCORE) / torch.clamp(a, min=1.0)))
        else:  # RequestedToCapacityRatio: piecewise-linear over utilization %
            util = torch.where(
                a == 0, 100.0,
                torch.clamp(total / torch.clamp(a, min=1.0), max=1.0) * 100.0)
            per_dim = rtcr_interp(util, torch.from_numpy(self.shape_x).to(dev),
                                  torch.from_numpy(self.shape_y).to(dev))
        # include a dim iff weighted and allocatable non-zero; extended dims also
        # require the pod to request them (resource_allocation.go:84-95)
        included = (w[None, None, :] > 0) & (a > 0)
        is_ext = torch.arange(alloc.shape[-1], device=dev) >= units.NUM_BASE_DIMS
        included = included & (~is_ext[None, None, :] | (pod_req[:, None, :] > 0))
        wsum = _ordered_sum(torch.where(included, w[None, None, :], 0.0))  # [B, N]
        total_score = _ordered_sum(
            torch.where(included, per_dim * w[None, None, :], 0.0))
        return torch.where(
            wsum == 0, 0.0, torch.floor(total_score / torch.clamp(wsum, min=1.0)))

    def normalize(self, scores, mask):
        return scores  # already 0..100


class BalancedAllocationPlugin(Plugin):
    name = "NodeResourcesBalancedAllocation"
    dynamic = True

    def __init__(self, resources: Optional[Dict[str, int]] = None,
                 num_resource_dims: int = 8,
                 extended_index: Optional[Dict[str, int]] = None):
        resources = resources or {"cpu": 1, "memory": 1}
        sel = np.zeros(num_resource_dims, dtype=bool)
        base = _base_dims()
        for name in resources:
            if name in base:
                sel[base[name]] = True
            elif extended_index and name in extended_index:
                sel[extended_index[name]] = True
        self.sel = sel

    def score(self, batch, snap, dyn: DynamicState, aux=None, mask=None):
        """(1 − std(utilization fractions)) · 100 (balanced_allocation.go:90-140;
        uses TRUE requests, useRequested=true).  Mean and variance are built
        by hand in the reference's order, not with torch.std."""
        dev = snap.allocatable.device
        sel = torch.from_numpy(self.sel).to(dev)
        alloc = snap.allocatable.float()  # [N, R]
        total = (dyn.requested[None, :, :] + batch.request[:, None, :]).float()
        is_ext = torch.arange(alloc.shape[-1], device=dev) >= units.NUM_BASE_DIMS
        a = alloc[None]
        included = sel[None, None, :] & (a > 0)
        included = included & (~is_ext[None, None, :] | (batch.request[:, None, :] > 0))
        frac = torch.clamp(total / torch.clamp(a, min=1.0), max=1.0)  # [B, N, R]
        n_inc = included.sum(dim=-1, dtype=torch.int32)  # [B, N]
        denom = torch.clamp(n_inc, min=1).float()
        mean = _ordered_sum(torch.where(included, frac, 0.0)) / denom
        d = frac - mean[..., None]
        var = _ordered_sum(torch.where(included, d * d, 0.0))
        std = torch.sqrt(var / denom)
        score = (1.0 - std) * float(MAX_NODE_SCORE)
        return torch.where(n_inc == 0, 0.0, score)

    def normalize(self, scores, mask):
        return scores
