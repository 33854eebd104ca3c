"""Shared device helpers for the plugin tensor programs.

Selector-vs-object matrices go through the batched evaluators in
state/selectors.py (unique-selector dedup; K23 on the card, its plain
broadcast compares on the CPU).
"""

from __future__ import annotations

import torch

from ..framework.interface import MAX_NODE_SCORE
from ..kernels.selectors import _as
from ..state.selectors import (
    label_match_matrix,
    node_match_matrix,
    requirements_match_matrix,
)


def label_selector_matrix(cs, node_keys, node_vals, numeric, vals_num=None):
    """CompiledLabelSelectors (batch B) × label sets [N, L] → bool[B, N]."""
    return label_match_matrix(cs, node_keys, node_vals, vals_num=vals_num, numeric=numeric)


def node_selector_matrix(cns, node_keys, node_vals, numeric, vals_num=None):
    """CompiledNodeSelectors (batch B) × node label sets [N, L] → bool[B, N].

    OR over valid terms, AND over each term's requirements; match_all rows → True.
    """
    return node_match_matrix(cns, node_keys, node_vals, vals_num=vals_num, numeric=numeric)


def weighted_term_matrix(req_key, req_op, req_vals, req_num, term_valid, weight,
                         node_keys, node_vals, numeric, vals_num=None):
    """Preferred-term arrays [B, T, ...] × nodes [N, L] → f32[B, N] summed weights
    of matching terms (nodeaffinity/node_affinity.go Score).  The terms are
    summed in ascending term order (the weights are integers, so any order
    gives the same sum below 2^24)."""
    dev = node_keys.device
    b, t, s = req_key.shape[0], req_key.shape[1], req_key.shape[2]
    match = requirements_match_matrix(
        _as(req_key, dev).reshape(b * t, s),
        _as(req_op, dev).reshape(b * t, s),
        _as(req_vals, dev).reshape(b * t, s, -1),
        _as(req_num, dev).reshape(b * t, s),
        node_keys, node_vals, vals_num=vals_num, numeric=numeric,
    ).reshape(b, t, -1)  # [B, T, N]
    w = _as(weight, dev)[:, :, None]
    on = match & _as(term_valid, dev)[:, :, None]
    total = torch.zeros((b, match.shape[-1]), dtype=torch.float32, device=dev)
    for k in range(t):
        total = total + torch.where(on[:, k], w[:, k], 0.0)
    return total


def flat_selector_matrix(cs, b, t, keys, vals, numeric):
    """Flattened CompiledLabelSelectors (batch b·t, row-major) × label sets
    [P, L] → bool[b, t, P]."""
    return label_match_matrix(cs, keys, vals, numeric=numeric).reshape(b, t, -1)


def default_normalize(scores, mask, reverse: bool = False):
    """framework.DefaultNormalizeScore: scale per-pod row to [0, MaxNodeScore] by
    the row max over feasible nodes; reverse flips (max - score)."""
    neg = torch.where(mask, scores, float("-inf"))
    row_max = neg.amax(dim=-1, keepdim=True)  # [B, 1]
    row_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
    zero_max = row_max == 0
    # floor before the reverse: the reference computes score*max/maxCount with
    # int64 division, then maxPriority − score
    scaled = torch.floor(
        scores * float(MAX_NODE_SCORE) / torch.where(zero_max, 1.0, row_max))
    if reverse:
        return torch.where(zero_max, float(MAX_NODE_SCORE),
                           float(MAX_NODE_SCORE) - scaled)
    return torch.where(zero_max, 0.0, scaled)


def node_tensor(node_row, device) -> torch.Tensor:
    """A placed pod's node row as the i32[1] tensor the scan's update
    kernels read (an int, or a tensor already on the device)."""
    if isinstance(node_row, torch.Tensor):
        return node_row.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([int(node_row)], dtype=torch.int32, device=device)
