"""K30 ``fork_masks`` and K31 ``fork_add_rows``: the counterfactual snapshot
forks (CUDA: csrc/fork.cu).

Replace the JAX package's whatif/fork.py ``apply_fork`` (:73-129, ROADMAP
Queue B B16), which whatif/engine.py vmaps over K stacked payloads
(:370-390): K copies of the live snapshot, each with one fork's change.

* K30 ``fork_masks`` — node-remove, victim-mask (pods, their requests,
  their claim chips) and the affinity-table mask, for K forks in one
  launch: each block owns one output tile of one fork (node rows, a piece
  of ``pod_valid`` or of ``aff_counts``), stages the fork's entries that
  land in it, and writes each element of the tile once, copied from its
  base with the entries applied.
* K31 ``fork_add_rows`` — the node-add: each fork's captured template rows
  written into its own ``[K, N, ...]`` copy of the twenty node arrays.  A
  pad (``ok`` false) writes nothing, so a real add wins over a pad at its
  row (the reference lets a later pad at row 0 undo the add: ROADMAP Queue
  C).

CPU tensors take the plain versions; CUDA tensors launch the kernels (a
failed build or launch raises).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import LAUNCHES, bind, ptr, require_cuda, require_dtype, stream_of
from .build import check, load

# the kernel's table holds at most this many arrays (csrc MAX_ARRAYS)
MAX_ARRAYS = 24


def _per_fork(a: torch.Tensor, k: int, base_dim: int) -> torch.Tensor:
    """A fresh ``[K, ...]`` copy of ``a``: ``a`` is shared by the forks
    (``base_dim`` dims) or already one per fork (a leading K axis)."""
    if a.dim() == base_dim:
        return a.unsqueeze(0).expand(k, *a.shape).clone()
    return a.clone()


def fork_masks_plain(node_valid, requested, non_zero, claim_allocated, pod_valid,
                     pod_request, pod_non_zero, aff_counts, vic_pod_rows, vic_node_rows,
                     aff_rows, aff_vals, del_rows, vic_claim_chips=None):
    """The plain version: the reference's masked scatters per fork, on a
    flattened ``[K·rows]`` index (``index_add_`` of the deltas, a count for
    the scatter-max masks)."""
    k = vic_pod_rows.shape[0]
    n = requested.shape[-2]
    p = pod_valid.shape[0]
    g, d = aff_counts.shape
    fork = torch.arange(k, device=vic_pod_rows.device)[:, None]
    nv = _per_fork(node_valid, k, 1)
    req = _per_fork(requested, k, 2)
    nz = _per_fork(non_zero, k, 2)
    pv = _per_fork(pod_valid, k, 1)
    aff = _per_fork(aff_counts, k, 2)
    # node-remove: a scatter-max of "ok" over the clipped rows
    ok_d = del_rows >= 0
    dead = torch.zeros(k * n, dtype=torch.int32, device=nv.device).index_add_(
        0, (fork * n + del_rows.long().clamp(0, n - 1)).reshape(-1),
        ok_d.to(torch.int32).reshape(-1))
    nv = nv & ~(dead.view(k, n) > 0)
    # victim-mask
    ok_v = vic_pod_rows >= 0
    prow = vic_pod_rows.long().clamp(0, p - 1)
    nrow = (fork * n + vic_node_rows.long().clamp(0, n - 1)).reshape(-1)
    hit = torch.zeros(k * p, dtype=torch.int32, device=pv.device).index_add_(
        0, (fork * p + prow).reshape(-1), ok_v.to(torch.int32).reshape(-1))
    pv = pv & ~(hit.view(k, p) > 0)
    okc = ok_v.reshape(-1, 1)
    r = req.shape[-1]
    req = req.reshape(k * n, r).index_add_(
        0, nrow, torch.where(okc, -pod_request[prow.reshape(-1)], 0)).view(k, n, r)
    nz = nz.reshape(k * n, 2).index_add_(
        0, nrow, torch.where(okc, -pod_non_zero[prow.reshape(-1)], 0)).view(k, n, 2)
    # affinity mask: −1.0 per contribution (integer counts: exact in any
    # order); an empty table (G or D of 0) takes none, as the reference's
    # scatter drops them
    if g * d:
        ok_a = aff_rows >= 0
        cell = (fork * (g * d) + aff_rows.long().clamp(0, g - 1) * d
                + aff_vals.long().clamp(0, d - 1)).reshape(-1)
        aff = aff.reshape(-1).index_add_(0, cell, -ok_a.to(aff.dtype).reshape(-1)).view(k, g, d)
    claim = None
    if vic_claim_chips is not None:
        claim = _per_fork(claim_allocated, k, 1).reshape(-1).index_add_(
            0, nrow, torch.where(ok_v, -vic_claim_chips, 0).reshape(-1).to(torch.int32)
        ).view(k, n)
    return nv, pv, req, nz, aff, claim


_FNS = {}


def _fn(name: str, spec: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = bind(load("fork"), name, spec)
    return fn


def fork_masks(node_valid: torch.Tensor, requested: torch.Tensor, non_zero: torch.Tensor,
               claim_allocated: Optional[torch.Tensor], pod_valid: torch.Tensor,
               pod_request: torch.Tensor, pod_non_zero: torch.Tensor,
               aff_counts: torch.Tensor, vic_pod_rows: torch.Tensor,
               vic_node_rows: torch.Tensor, aff_rows: torch.Tensor, aff_vals: torch.Tensor,
               del_rows: torch.Tensor, vic_claim_chips: Optional[torch.Tensor] = None):
    """→ K forked copies ``(node_valid bool[K, N], pod_valid bool[K, P],
    requested i32[K, N, R], non_zero i32[K, N, 2], aff_counts f32[K, G, D],
    claim_allocated i32[K, N] or None)``.

    The node arrays (``node_valid``, ``requested``, ``non_zero``,
    ``claim_allocated``) are the live ``[N, ...]`` arrays shared by every
    fork, or K31's ``[K, N, ...]`` outputs (one per fork); ``pod_valid``,
    ``pod_request``, ``pod_non_zero`` and ``aff_counts`` are the live
    arrays.  The payload: ``vic_pod_rows`` / ``vic_node_rows`` i32[K, V],
    ``aff_rows`` / ``aff_vals`` i32[K, A], ``del_rows`` i32[K, D], each −1
    padded; ``vic_claim_chips`` i32[K, V] or None (then no claim_allocated
    output).  The inputs are not modified.

    CPU tensors take the plain version; CUDA tensors launch K30."""
    if not vic_pod_rows.is_cuda:
        return fork_masks_plain(node_valid, requested, non_zero, claim_allocated, pod_valid,
                                pod_request, pod_non_zero, aff_counts, vic_pod_rows,
                                vic_node_rows, aff_rows, aff_vals, del_rows, vic_claim_chips)
    k = vic_pod_rows.shape[0]
    per_fork = requested.dim() == 3
    n, r = requested.shape[-2:]
    p = pod_valid.shape[0]
    g, d = aff_counts.shape
    chips = vic_claim_chips is not None
    i32 = [t.to(torch.int32).contiguous() for t in (vic_pod_rows, vic_node_rows, aff_rows,
                                                   aff_vals, del_rows)]
    vic_c = vic_claim_chips.to(torch.int32).contiguous() if chips else None
    base = [t.contiguous() for t in (node_valid, requested, non_zero, pod_valid, pod_request,
                                     pod_non_zero, aff_counts)]
    claim_in = claim_allocated.contiguous() if chips else None
    dev = require_cuda("fork_masks", *i32, *base, *([vic_c, claim_in] if chips else []))
    require_dtype("fork_masks", torch.int32, base[1], base[2], base[4], base[5],
                  *([claim_in] if chips else []))
    require_dtype("fork_masks", torch.bool, base[0], base[3])
    require_dtype("fork_masks", torch.float32, base[6])
    lead = (k,) if per_fork else ()
    if base[0].shape != lead + (n,) or base[2].shape != lead + (n, 2) \
            or (chips and claim_in.shape != lead + (n,)) or base[4].shape != (p, r) \
            or base[5].shape != (p, 2) or i32[1].shape != i32[0].shape \
            or i32[3].shape != i32[2].shape or (chips and vic_c.shape != i32[0].shape) \
            or any(t.dim() != 2 or t.shape[0] != k for t in i32):
        raise ValueError("fork_masks: inconsistent shapes")
    nv = torch.empty((k, n), dtype=torch.bool, device=dev)
    pv = torch.empty((k, p), dtype=torch.bool, device=dev)
    req = torch.empty((k, n, r), dtype=torch.int32, device=dev)
    nz = torch.empty((k, n, 2), dtype=torch.int32, device=dev)
    aff = torch.empty((k, g, d), dtype=torch.float32, device=dev)
    claim = torch.empty((k, n), dtype=torch.int32, device=dev) if chips else None
    err = _fn("launch_fork_masks", "iiiiiiiiii" + "p" * 21)(
        k, n, p, r, g, d, i32[0].shape[1], i32[2].shape[1], i32[4].shape[1], int(per_fork),
        ptr(base[0]), ptr(base[1]), ptr(base[2]), ptr(claim_in) if chips else None,
        ptr(base[3]), ptr(base[6]), ptr(base[4]), ptr(base[5]), ptr(i32[0]), ptr(i32[1]),
        ptr(vic_c) if chips else None, ptr(i32[2]), ptr(i32[3]), ptr(i32[4]),
        ptr(nv), ptr(pv), ptr(req), ptr(nz), ptr(aff), ptr(claim) if chips else None,
        stream_of(dev))
    check(err, "fork_masks")
    LAUNCHES["fork_masks"] += 1
    return nv, pv, req, nz, aff, claim


def fork_add_rows_plain(arrays: Sequence[torch.Tensor], rows: torch.Tensor, ok: torch.Tensor,
                        vals: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The plain version: each array copied K times, then each fork's real
    adds (``ok``) copied into their rows of its copy; pads write nothing."""
    k, m = rows.shape
    out = []
    sel = ok.reshape(-1)
    n = arrays[0].shape[0]
    flat = (torch.arange(k, device=rows.device)[:, None] * n
            + rows.long().clamp(0, n - 1)).reshape(-1)[sel]
    for a, v in zip(arrays, vals):
        o = _per_fork(a, k, a.dim()).reshape(k * n, *a.shape[1:])
        o[flat] = v.reshape(k * m, *a.shape[1:])[sel]
        out.append(o.view(k, *a.shape))
    return tuple(out)


def fork_add_rows(arrays: Sequence[torch.Tensor], rows: torch.Tensor, ok: torch.Tensor,
                  vals: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """→ one ``[K, N, ...]`` array per input ``[N, ...]`` array: fork k's
    copy holds ``vals[a][k, j]`` at row ``rows[k, j]`` for every ``j`` with
    ``ok[k, j]``, the live row everywhere else.

    rows: i32[K, M] template rows per fork (pads point anywhere);
    ok: bool[K, M] real add (True) or pad (False);
    vals: one ``[K, M, ...]`` payload per array.

    CPU tensors take the plain version; CUDA tensors launch K31 once."""
    arrays, vals = list(arrays), list(vals)
    if len(arrays) != len(vals):
        raise ValueError("fork_add_rows: one payload per array")
    if not rows.is_cuda:
        return fork_add_rows_plain(arrays, rows, ok, vals)
    if len(arrays) > MAX_ARRAYS:
        raise ValueError(f"fork_add_rows: more than {MAX_ARRAYS} arrays")
    k, m = rows.shape
    n = arrays[0].shape[0]
    rows = rows.to(torch.int32).contiguous()
    ok = ok.to(torch.bool).contiguous()
    src = [a.contiguous() for a in arrays]
    val = [v.contiguous() for v in vals]
    dev = require_cuda("fork_add_rows", rows, ok, *src, *val)
    if ok.shape != rows.shape:
        raise ValueError("fork_add_rows: rows and ok must be [K, M]")
    row_bytes = []
    for a, v in zip(src, val):
        if a.shape[0] != n or v.shape != (k, m) + tuple(a.shape[1:]) or a.dtype != v.dtype:
            raise ValueError("fork_add_rows: inconsistent shapes or dtypes")
        row_bytes.append(a[0].numel() * a.element_size() if n else 0)
    out = [torch.empty((k,) + tuple(a.shape), dtype=a.dtype, device=dev) for a in src]
    na = len(src)
    table = [(ctypes.c_void_p * na)(*[ptr(t) for t in group]) for group in (src, out, val)]
    rb = (ctypes.c_longlong * na)(*row_bytes)
    err = _fn("launch_fork_add_rows", "ipppp" + "liippp")(
        na, *[ctypes.addressof(t) for t in table], ctypes.addressof(rb), n, k, m,
        ptr(rows), ptr(ok), stream_of(dev))
    check(err, "fork_add_rows")
    LAUNCHES["fork_add_rows"] += 1
    return tuple(out)
