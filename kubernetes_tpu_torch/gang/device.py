"""In-batch gang all-or-nothing over segment sums (plain torch; ROADMAP
Queue B item B6 queues its kernel).

Reference: the JAX package's gang/device.py gang_all_or_nothing (:17).
"""

from __future__ import annotations

import torch


def gang_all_or_nothing(node_row: torch.Tensor, gang_seg: torch.Tensor) -> torch.Tensor:
    """Mask every member of a gang with ANY unplaced member to -1.

    node_row: i32[B] assigned node row per pod (-1 = unschedulable).
    gang_seg: i32[B] per-pod gang segment id in [0, B), -1 for pods that
        are not gang members (including padding rows).  An all(-1)
        gang_seg is a no-op.
    """
    b = node_row.shape[0]
    member = gang_seg >= 0
    # solos/padding land in an overflow bucket that never feeds back
    seg = torch.where(member, gang_seg, b).long()
    missed = (member & (node_row < 0)).to(torch.float32)
    miss_per_gang = torch.zeros(b + 1, dtype=torch.float32,
                                device=node_row.device).index_add_(0, seg, missed)
    incomplete = miss_per_gang[seg] > 0.5
    return torch.where(member & incomplete, -1, node_row)
