"""K22 ``diag_pack``: the diagnosis bits and the cycle's one [3, B] result
(CUDA: csrc/diag_pack.cu).

Replaces the JAX package's framework/runtime.py ``diagnose_bits``
(:237-255) and the fused program's ``pack_diag`` (scheduler.py:918-930) —
ROADMAP Queue B B7: for each filter k, does it leave row c any node; the
pod's class row gathered; packed with the node rows (after the gang mask)
and the engine's round count into the int32 [3, B] array the host fetches
once per cycle.  CPU tensors take the plain version; CUDA tensors launch
K22 (one block per class row).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import LAUNCHES, bind, ptr, require_cuda, require_dtype, stream_of
from .build import check, load

MAX_FILTERS = 31  # the bitmask is one int32 per pod


def diagnose_bits_plain(plane: torch.Tensor, n_filters: int) -> torch.Tensor:
    """bool[C, K] from a pass-bit plane: does filter k leave row c ANY node
    (the bits already fold in live nodes and row validity)."""
    shifts = torch.arange(n_filters, dtype=torch.int32, device=plane.device)
    return ((plane[:, :, None] >> shifts) & 1).any(dim=1)


def pack_diag_plain(bits: torch.Tensor, node_row: torch.Tensor, rounds: int) -> torch.Tensor:
    """[3, B] i32 from bool[B, K] diagnosis bits: node_row; the bitmask (bit
    k = filter k leaves the pod a feasible node); the engine's rounds."""
    n_filters = bits.shape[1]
    shifts = torch.arange(n_filters, dtype=torch.int32, device=bits.device)
    packed = (bits.to(torch.int32) << shifts[None, :]).sum(dim=1, dtype=torch.int32)
    rrow = torch.full_like(packed, int(rounds))
    return torch.stack([node_row.to(torch.int32), packed, rrow])


def diag_pack_plain(plane, n_filters: int, class_of, node_row, rounds: int):
    """The plain version: diagnose the plane's rows, gather each pod's class
    row (``class_of`` None: row b is pod b), pack."""
    bits = diagnose_bits_plain(plane, n_filters)
    if class_of is not None:
        bits = bits[class_of.long()]
    return pack_diag_plain(bits, node_row, rounds)


_FN = None


def _fn():
    global _FN
    if _FN is None:
        _FN = bind(load("diag_pack"), "launch_diag_pack", "iiipippipp")
    return _FN


def diag_pack(plane: torch.Tensor, n_filters: int, class_of: Optional[torch.Tensor],
              node_row: torch.Tensor, rounds: int) -> torch.Tensor:
    """→ i32[3, B]: node_row, the diagnosis bitmask of each pod's class row
    of the pass-bit ``plane`` i32[C, N], and ``rounds``.  ``class_of``
    i32/i64[B] maps pods to rows (None: C = B, row b is pod b).  CPU
    tensors take the plain version; CUDA tensors launch K22."""
    if n_filters > MAX_FILTERS:
        raise NotImplementedError("diag_pack: more than 31 filter plugins")
    if not plane.is_cuda:
        return diag_pack_plain(plane, n_filters, class_of, node_row, rounds)
    c, n = plane.shape
    b = node_row.shape[0]
    plane = plane.contiguous()
    node_row = node_row.to(torch.int32).contiguous()
    cls = [] if class_of is None else [class_of.to(torch.int32).contiguous()]
    dev = require_cuda("diag_pack", plane, node_row, *cls)
    require_dtype("diag_pack", torch.int32, plane)
    if class_of is None and c != b:
        raise ValueError("diag_pack: without class_of the plane needs one row per pod")
    if cls and cls[0].shape != (b,):
        raise ValueError("diag_pack: class_of must be [B]")
    out = torch.empty((3, b), dtype=torch.int32, device=dev)
    err = _fn()(c, n, b, ptr(plane), int(n_filters), ptr(cls[0]) if cls else 0,
                ptr(node_row), int(rounds), ptr(out), stream_of(dev))
    check(err, "diag_pack")
    LAUNCHES["diag_pack"] += 1
    return out
