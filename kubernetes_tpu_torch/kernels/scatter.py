"""K16: the deferred snapshot row-scatter (CUDA: csrc/scatter_rows.cu).

Replaces the JAX package's state/encoding.py ``apply_scatter`` (:168) and
``_scatter_rows`` (:883) (ROADMAP Queue B B1): every array of one group
(node, pod or affinity-group rows) gets its dirty rows from the payload and
keeps the rest.  Out of place, as the reference (which does not donate:
an in-flight batch still holds the previous snapshot).

The payload's row list is padded to a power of two by repeating a row with
equal values, so duplicate rows are harmless in any write order.  CPU
tensors take the plain version (``index_copy`` per array); CUDA tensors
launch K16 once for the whole group: tiles of one array's rows sized to
fill the card, 16-byte vectors where the row bytes and pointers allow
(narrow rows as a run of rows), each thread's loads issued before its
first store, each output byte written once.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import LAUNCHES, bind, ptr, require_cuda, stream_of
from .build import check, load

# the kernel's table holds at most this many arrays (csrc MAX_ARRAYS)
MAX_ARRAYS = 24


def scatter_rows_plain(arrays: Sequence[torch.Tensor], rows: torch.Tensor,
                       vals: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The plain version: ``a.index_copy(0, rows, v)`` per array."""
    rows = rows.long()
    return tuple(a.index_copy(0, rows, v) for a, v in zip(arrays, vals))


def scatter_rows(arrays: Sequence[torch.Tensor], rows: torch.Tensor,
                 vals: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """→ new arrays, one per input array (all with the same leading row
    count): row ``rows[j]`` from ``vals[a][j]``, every other row from
    ``arrays[a]``.  CPU tensors take the plain version; CUDA tensors launch
    K16 once for the group (``rows`` read as int64: the encoder's payload
    is int64, so that is no copy on the path)."""
    arrays, vals = list(arrays), list(vals)
    if len(arrays) != len(vals):
        raise ValueError("scatter_rows: one payload per array")
    if not rows.is_cuda:
        return scatter_rows_plain(arrays, rows, vals)
    if len(arrays) > MAX_ARRAYS:
        raise ValueError(f"scatter_rows: more than {MAX_ARRAYS} arrays in a group")
    n_rows = arrays[0].shape[0]
    k = rows.shape[0]
    rows = rows.to(torch.int64).contiguous()
    src = [a.contiguous() for a in arrays]
    val = [v.contiguous() for v in vals]
    dev = require_cuda("scatter_rows", rows, *src, *val)
    row_bytes = []
    for a, v in zip(src, val):
        if a.shape[0] != n_rows or v.shape[0] != k or a.shape[1:] != v.shape[1:] \
                or a.dtype != v.dtype:
            raise ValueError("scatter_rows: inconsistent shapes or dtypes")
        row_bytes.append(a[0].numel() * a.element_size() if n_rows else 0)
    out = [torch.empty_like(a) for a in src]
    n = len(src)
    table = [(ctypes.c_void_p * n)(*[ptr(t) for t in group]) for group in (src, out, val)]
    rb = (ctypes.c_longlong * n)(*row_bytes)
    err = _fn("launch_scatter_rows", "ipppp" + "lpi" + "p")(
        n, *[ctypes.addressof(t) for t in table], ctypes.addressof(rb), n_rows,
        ptr(rows), k, stream_of(dev))
    check(err, "scatter_rows")
    LAUNCHES["scatter_rows"] += 1
    return tuple(out)


_FNS = {}


def _fn(name: str, spec: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = bind(load("scatter_rows"), name, spec)
    return fn
