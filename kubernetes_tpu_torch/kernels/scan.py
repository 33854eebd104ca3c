"""K17 ``scan_select_assume``: one step of the exact serial scan — select pod
i's node from its folded row and assume it (CUDA: csrc/scan.cu).

Replaces the JAX package's greedy_assign step (framework/runtime.py:358-393)
with ``select_host`` (:299-308) and the resource half of
``_apply_dynamic`` (:434-438).  The row is K1's pass bits and K2's total
for pod i, with the dynamic plugins' filters and scores folded in; the
node and the feasible count go to ``node_row[i]`` / ``feasible_count[i]``
on the device, where the next kernels of the step read them, so a step
needs no read on the host.

Keyed mode (``noise``, the step's uniform row from K33): the reference's
``select_host`` with a key (:305-308) — the largest noise among the tied
maxima, the first row on equal noise, every row a tie when none is
feasible; the nominated path and the infeasible rule are unchanged.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, bind, ptr, require_cuda, require_dtype, stream_of
from .build import check, load


def scan_select_assume_plain(bits, full: int, total, i: int, nominated, valid, request,
                             pod_nz, requested, node_nz, node_row, feasible_count,
                             noise=None):
    """The plain torch version (no read on the host): the row's feasible
    count, the first maximum of the masked total (row 0 when nothing is
    feasible), the nominated row when it is feasible, −1 out for an
    infeasible or padding pod; the placed pod's request added at its node.
    Updates ``requested``, ``node_nz``, ``node_row`` and
    ``feasible_count`` in place."""
    n = bits.shape[-1]
    mask = bits.reshape(n) == full
    cnt = mask.sum(dtype=torch.int32)
    masked = torch.where(mask, total.reshape(n), float("-inf"))
    if noise is None:
        best = torch.argmax(masked)
    else:
        ties = masked == masked.max()
        best = torch.argmax(torch.where(ties, noise.reshape(n), -1.0))
    nom = nominated[i:i + 1].long()
    nomc = nom.clamp(0, n - 1)
    nom_ok = (nom >= 0) & mask.index_select(0, nomc)
    node = torch.where(nom_ok, nomc, best.view(1))
    feasible = cnt > 0
    node = torch.where(feasible, node, 0)
    placed = feasible & valid[i:i + 1]
    node_row[i:i + 1] = torch.where(placed, node, -1).to(node_row.dtype)
    feasible_count[i:i + 1] = cnt.to(feasible_count.dtype)
    requested.index_add_(0, node, torch.where(placed[:, None], request[i:i + 1], 0)
                         .to(requested.dtype))
    node_nz.index_add_(0, node, torch.where(placed[:, None], pod_nz[i:i + 1], 0)
                       .to(node_nz.dtype))


_FN = None


def _fn():
    global _FN
    if _FN is None:
        _FN = bind(load("scan"), "launch_scan_select", "iiii" + "p" * 11 + "p")
    return _FN


def scan_select_assume(bits, full: int, total, i: int, nominated, valid, request, pod_nz,
                       requested, node_nz, node_row, feasible_count, noise=None):
    """Pod i's step: ``bits`` i32[1, N] and ``total`` f32[1, N] its row;
    ``nominated`` i32[B], ``valid`` bool[B], ``request`` i32[B, R],
    ``pod_nz`` i32[B, 2] the batch's rows; ``requested`` i32[N, R] and
    ``node_nz`` i32[N, 2] the dynamic state and ``node_row`` /
    ``feasible_count`` i32[B] the scan's outputs, all updated in place;
    ``noise`` f32[N] the step's draw (keyed mode) or None.
    CPU tensors take the plain version; CUDA tensors launch K17."""
    if not bits.is_cuda:
        return scan_select_assume_plain(bits, full, total, i, nominated, valid, request,
                                        pod_nz, requested, node_nz, node_row, feasible_count,
                                        noise)
    n = bits.shape[-1]
    b, r = request.shape
    ins = [bits, total, nominated, valid, request, pod_nz]
    outs = [requested, node_nz, node_row, feasible_count]
    dev = require_cuda("scan_select_assume", *ins, *outs)
    require_dtype("scan_select_assume", torch.int32, bits, nominated, request, pod_nz,
                  *outs)
    require_dtype("scan_select_assume", torch.float32, total)
    if noise is not None:
        require_cuda("scan_select_assume", bits, noise)
        require_dtype("scan_select_assume", torch.float32, noise)
        if noise.numel() != n:
            raise ValueError("scan_select_assume: the noise row must be [N]")
    require_dtype("scan_select_assume", torch.bool, valid)
    if bits.numel() != n or total.numel() != n or requested.shape != (n, r) \
            or node_nz.shape != (n, 2) or node_row.shape != (b,) \
            or feasible_count.shape != (b,) or not 0 <= i < b:
        raise ValueError("scan_select_assume: inconsistent shapes")
    err = _fn()(n, r, int(full), int(i), *map(ptr, ins), *map(ptr, outs),
                None if noise is None else ptr(noise), stream_of(dev))
    check(err, "scan_select_assume")
    LAUNCHES["scan_select_assume" if noise is None else "scan_select_keyed"] += 1
