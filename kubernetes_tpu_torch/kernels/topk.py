"""K3 ``topk_rows``: per row, the first K entries ordered by (value
descending, column ascending) — −inf entries last, by column
(CUDA: csrc/topk_rows.cu).

Replaces ``jax.lax.top_k`` at framework/runtime.py:875.  The dedup
auction is exact only under that tie order (runtime.py:766-767), so the
plain version is a stable descending sort, never ``torch.topk`` (which
promises no order among ties).
"""

from __future__ import annotations

import torch

from . import LAUNCHES, bind, ptr, require_cuda, stream_of
from .build import check, load


def topk_rows_plain(eff: torch.Tensor, k: int):
    """The plain torch version: a stable descending sort, first k columns."""
    vals, idx = torch.sort(eff, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


_FN = None
_MAX_K = None


def _fn():
    global _FN, _MAX_K
    if _FN is None:
        lib = load("topk_rows")
        _MAX_K = int(bind(lib, "topk_max_k", "")())
        _FN = bind(lib, "launch_topk_rows", "iiipppp")
    return _FN


def topk_rows(eff: torch.Tensor, k: int):
    """→ (values f32[C, k], columns i32[C, k]).  CPU tensors take the plain
    version; CUDA tensors launch K3 once: a radix select of each row's k-th
    key, then a sort of the k selected entries (0 < k <= min(N, 1024); the
    scheduler's k = min(B, N) <= 1024)."""
    if not eff.is_cuda:
        return topk_rows_plain(eff, k)
    c, n = eff.shape
    eff = eff.contiguous()
    dev = require_cuda("topk_rows", eff)
    if eff.dtype != torch.float32:
        raise ValueError("topk_rows: eff must be float32")
    fn = _fn()
    if not 0 < k <= min(n, _MAX_K) or c < 1:
        raise ValueError(f"topk_rows: need C >= 1 and 0 < k <= min(N, {_MAX_K}), "
                         f"got C={c}, k={k}, N={n}")
    vals = torch.empty((c, k), dtype=torch.float32, device=dev)
    cols = torch.empty((c, k), dtype=torch.int32, device=dev)
    check(fn(c, n, k, ptr(eff), ptr(cols), ptr(vals), stream_of(dev)), "topk_rows")
    LAUNCHES["topk_rows"] += 1
    return vals, cols
