"""K20 ``gang_all_or_nothing``: the in-batch all-or-nothing mask of gang
scheduling (CUDA: csrc/gang.cu).

Replaces the JAX package's gang/device.py ``gang_all_or_nothing`` (:17,
ROADMAP Queue B B6), which the fused cycle runs after the assignment
engine: every member of a gang segment with any unplaced member is
withdrawn (−1), so a partly placed gang never reaches the binding cycle.
CPU tensors take the plain version; CUDA tensors launch K20 (one block
over the batch, integer shared-memory counts).
"""

from __future__ import annotations

import torch

from . import LAUNCHES, bind, ptr, require_cuda, require_dtype, stream_of
from .build import check, load


def gang_all_or_nothing_plain(node_row: torch.Tensor, gang_seg: torch.Tensor) -> torch.Tensor:
    """The plain version, the reference's segment sum: unplaced members
    summed per segment (a float32 one-hot contraction there, an index_add_
    here), gathered back, and every member of a segment with a miss set
    to −1."""
    b = node_row.shape[0]
    member = gang_seg >= 0
    # solos/padding land in an overflow bucket that never feeds back
    seg = torch.where(member, gang_seg, b).long()
    missed = (member & (node_row < 0)).to(torch.float32)
    miss_per_gang = torch.zeros(b + 1, dtype=torch.float32,
                                device=node_row.device).index_add_(0, seg, missed)
    incomplete = miss_per_gang[seg] > 0.5
    return torch.where(member & incomplete, -1, node_row)


_FN = None


def _fn():
    global _FN
    if _FN is None:
        _FN = bind(load("gang"), "launch_gang_all_or_nothing", "ipppp")
    return _FN


def gang_all_or_nothing(node_row: torch.Tensor, gang_seg: torch.Tensor) -> torch.Tensor:
    """→ i32[B]: ``node_row`` with every member of an incomplete gang at −1.

    node_row: i32[B] assigned node row per pod (−1 = unschedulable).
    gang_seg: i32[B] per-pod gang segment id in [0, B), −1 for pods that
        are not gang members (padding rows too).  An all(−1) gang_seg is
        the identity.

    CPU tensors take the plain version; CUDA tensors launch K20."""
    if not node_row.is_cuda:
        return gang_all_or_nothing_plain(node_row, gang_seg)
    node_row = node_row.to(torch.int32).contiguous()
    gang_seg = gang_seg.to(torch.int32).contiguous()
    dev = require_cuda("gang_all_or_nothing", node_row, gang_seg)
    require_dtype("gang_all_or_nothing", torch.int32, node_row, gang_seg)
    if node_row.dim() != 1 or gang_seg.shape != node_row.shape:
        raise ValueError("gang_all_or_nothing: node_row and gang_seg must be [B]")
    out = torch.empty_like(node_row)
    err = _fn()(node_row.shape[0], ptr(node_row), ptr(gang_seg), ptr(out), stream_of(dev))
    check(err, "gang_all_or_nothing")
    LAUNCHES["gang_all_or_nothing"] += 1
    return out
