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
_CHUNK = None


def _fn():
    global _FN, _CHUNK
    if _FN is None:
        lib = load("topk_rows")
        _CHUNK = int(bind(lib, "topk_chunk", "")())
        _FN = bind(lib, "launch_topk_pass", "iippiiippp")
    return _FN


def topk_rows(eff: torch.Tensor, k: int):
    """→ (values f32[C, k], columns i32[C, k]).  CPU tensors take the plain
    version; CUDA tensors launch K3 once per pass: each pass keeps the best
    k of every CHUNK survivors, so it shrinks the survivors only while
    k <= CHUNK / 2 (the scheduler's k = min(B, N) <= 1024)."""
    if not eff.is_cuda:
        return topk_rows_plain(eff, k)
    c, n = eff.shape
    if not 0 < k <= n:
        raise ValueError(f"topk_rows: need 0 < k <= N, got k={k}, N={n}")
    eff = eff.contiguous()
    dev = require_cuda("topk_rows", eff)
    if eff.dtype != torch.float32:
        raise ValueError("topk_rows: eff must be float32")
    fn = _fn()
    if k > _CHUNK // 2:
        raise ValueError(f"topk_rows: k={k} exceeds half the chunk size {_CHUNK}")
    stream = stream_of(dev)
    cand, length = None, n
    while True:
        nchunks = -(-length // _CHUNK)
        out = torch.empty((c, nchunks * k), dtype=torch.int32, device=dev)
        last = nchunks == 1
        vals = torch.empty((c, k), dtype=torch.float32, device=dev) if last else None
        err = fn(c, n, ptr(eff), 0 if cand is None else ptr(cand), length, k,
                 nchunks, ptr(out), ptr(vals) if last else 0, stream)
        check(err, "topk_rows")
        LAUNCHES["topk_rows"] += 1
        if last:
            return vals, out
        cand, length = out, nchunks * k
