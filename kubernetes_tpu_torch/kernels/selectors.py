"""K23 ``selector_match``: compiled label / node selectors against label
sets (CUDA: csrc/selector_match.cu).

Replaces the JAX package's state/selectors.py ``requirements_match_matrix``
(:299), ``label_match_matrix`` (:345) and ``node_match_matrix`` (:357) —
ROADMAP Queue B B4, with plugins/helpers.py ``weighted_term_matrix`` (:35)
and ``flat_selector_matrix`` (:52), which call them.  Requirement sets
``[U, T, S]`` (key, op, values ``[V]``, numeric right-hand side) against
label sets ``[O, L]`` → ``bool[B, O]`` through the per-pod ``index``.

The plain version is the reference's broadcast compare.  The kernel is one
launch a call over object tiles × chunks of the result rows (``plan_for``):
a thread reads its object's label set once into registers; the block
stages the rows it needs — every unique row, the chunk's rows, or the
chunk's distinct rows — into shared memory in one round of loads; its row
groups evaluate (row, term) items, each verdict of a warp one ballot word
in shared memory; the result is written once, 16 objects a 16-byte store.
No ``[U, O]`` matrix goes through global memory.
The compiled selector arrays are uploaded once per batch
(``framework/podbatch.batch_to_device``): on the card the wrapper takes
device tensors only and uploads nothing.  CPU tensors take the plain
version; CUDA tensors launch K23.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import LAUNCHES, bind, ptr, require_cuda, require_dtype, stream_of
from .build import check, load
from ..state.dictionary import MISSING

OP_IN = 0
OP_NOT_IN = 1
OP_EXISTS = 2
OP_DOES_NOT_EXIST = 3
OP_GT = 4
OP_LT = 5
OP_PAD = -1


def _as(a, device) -> torch.Tensor:
    """A compiled-selector field as a tensor on ``device`` (the plain
    version also takes the host numpy of a compiled batch)."""
    if torch.is_tensor(a):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _op_select(req_op, present, in_vals, gt, lt):
    """Pick each requirement's result by op code via a where-chain."""
    picked = torch.where(
        req_op == OP_IN, present & in_vals,
        torch.where(
            req_op == OP_NOT_IN, (~present) | (~in_vals),  # absent key matches
            torch.where(
                req_op == OP_EXISTS, present,
                torch.where(
                    req_op == OP_DOES_NOT_EXIST, ~present,
                    torch.where(req_op == OP_GT, gt,
                                torch.where(req_op == OP_LT, lt, True)),
                ),
            ),
        ),
    )
    return torch.where(req_op == OP_PAD, True, picked)


def requirements_match_plain(req_key, req_op, req_vals, req_num, keys, vals,
                             vals_num=None, numeric=None, has_numeric: bool = True):
    """Requirement sets [U, S] (values [U, S, V]) × label sets [O, L] →
    bool[U, O]: AND over each row's requirements (the reference's broadcast
    compare).  ``vals_num`` f32[O, L] gives each label's number for Gt / Lt;
    when None the numbers come from the dictionary's ``numeric`` side-table;
    ``has_numeric=False`` skips the numeric path."""
    dev = keys.device
    rk = _as(req_key, dev)[:, :, None, None]  # [U, S, 1, 1]
    km = (keys[None, None, :, :] == rk) & (rk >= 0)  # [U, S, O, L]
    present = km.any(dim=-1)  # [U, S, O]
    # label keys are unique per object → at most one L column matches
    miss = torch.full((), MISSING, dtype=vals.dtype, device=dev)
    val = torch.where(km, vals[None, None, :, :], miss).amax(dim=-1)  # [U, S, O]
    rv = _as(req_vals, dev)
    in_vals = ((rv[:, :, None, :] == val[:, :, :, None])
               & (val[:, :, :, None] >= 0)).any(dim=-1)  # [U, S, O]
    if has_numeric:
        if vals_num is None:
            safe = vals.clamp(0, numeric.shape[0] - 1).long()
            vals_num = torch.where(vals >= 0, numeric[safe],
                                   torch.tensor(float("nan"), device=dev))
        ninf = torch.tensor(float("-inf"), device=dev)
        vn = torch.where(km, vals_num[None, None, :, :], ninf).amax(dim=-1)
        rn = _as(req_num, dev)[:, :, None]
        gt = present & (vn > rn)
        lt = present & (vn < rn)
    else:
        gt = lt = torch.zeros_like(present)
    ok = _op_select(_as(req_op, dev)[:, :, None], present, in_vals, gt, lt)
    return ok.all(dim=1)  # [U, O]


def selector_match_plain(req_key, req_op, req_vals, req_num, term_valid, match_all,
                         match_none, keys, vals, vals_num=None, numeric=None,
                         has_numeric: bool = True, index=None):
    """The plain version of K23 (see ``selector_match``)."""
    dev = keys.device
    u, t, s = req_key.shape
    per_term = requirements_match_plain(
        _as(req_key, dev).reshape(u * t, s), _as(req_op, dev).reshape(u * t, s),
        _as(req_vals, dev).reshape(u * t, s, -1), _as(req_num, dev).reshape(u * t, s),
        keys, vals, vals_num=vals_num, numeric=numeric,
        has_numeric=has_numeric).reshape(u, t, -1)  # [U, T, O]
    if term_valid is None:
        m = per_term[:, 0]
    else:
        m = (per_term & _as(term_valid, dev)[:, :, None]).any(dim=1)
    if match_all is not None:
        m = _as(match_all, dev)[:, None] | m
    if match_none is not None:
        m = m & ~_as(match_none, dev)[:, None]
    return m if index is None else m[_as(index, dev).long()]


def plan_for(u: int, t: int) -> tuple:
    """(objects a block, result rows a block) for U unique rows of T terms,
    blocks of 256 threads whose row groups share a tile's (row, term)
    items: at most 4 items, 128 objects and 256 rows (two row groups, one
    item or two each: 128 blocks at O = 8192, B = 512); at most 32 unique
    rows, 64 objects and every row (four row groups; each object evaluated
    once); more, 128 objects and 16 rows (a block's items bounded by its
    chunk's rows, many blocks)."""
    if u * t <= 4:
        return (128, 256)
    return (64, 512) if u <= 32 else (128, 16)


_FN = None


def _fn():
    global _FN
    if _FN is None:
        _FN = bind(load("selector_match"), "launch_selector_match",
                   "iiiiiiii" + "ppppppp" + "pppp" + "i" + "pp" + "ii" + "p")
    return _FN


def _dev_tensor(name: str, a, dev, dtype) -> torch.Tensor:
    """A selector field already on the card (uploaded with its batch)."""
    if not torch.is_tensor(a) or a.device != dev:
        raise ValueError(f"selector_match: {name} must be a tensor on {dev} "
                         "(compiled selectors go to the device with their batch)")
    require_dtype("selector_match", dtype, a)
    return a.contiguous()


def _ptr_or_null(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else ptr(t)


def selector_match(req_key, req_op, req_vals, req_num, term_valid, match_all, match_none,
                   keys: torch.Tensor, vals: torch.Tensor,
                   vals_num: Optional[torch.Tensor] = None,
                   numeric: Optional[torch.Tensor] = None, has_numeric: bool = True,
                   index=None) -> torch.Tensor:
    """→ bool[B, O]: compiled selectors against label sets.

    req_key / req_op i32[U, T, S], req_vals i32[U, T, S, V], req_num
    f32[U, T, S]; keys / vals i32[O, L] (−1 padded), vals_num f32[O, L] or
    None (then the numbers come from ``numeric`` f32[D] at the value ids).
    ``term_valid`` bool[U, T] None selects label mode (T = 1: the term's AND
    is the row's result); otherwise node mode (OR over the valid terms).
    ``match_all`` bool[U] rows are True, ``match_none`` bool[U] rows False.
    ``index`` i32[B] maps rows of the result to unique rows (None: B = U).
    CPU tensors take the plain version; CUDA tensors launch K23."""
    if not keys.is_cuda:
        return selector_match_plain(req_key, req_op, req_vals, req_num, term_valid,
                                    match_all, match_none, keys, vals, vals_num,
                                    numeric, has_numeric, index)
    dev = keys.device
    keys = keys.contiguous()
    vals = vals.contiguous()
    require_cuda("selector_match", keys, vals)
    require_dtype("selector_match", torch.int32, keys, vals)
    o, lab = keys.shape
    rk = _dev_tensor("req_key", req_key, dev, torch.int32)
    u, t, s = rk.shape
    rop = _dev_tensor("req_op", req_op, dev, torch.int32)
    rv = _dev_tensor("req_vals", req_vals, dev, torch.int32)
    rn = _dev_tensor("req_num", req_num, dev, torch.float32)
    v = rv.shape[3] if rv.dim() == 4 else 0
    if rop.shape != (u, t, s) or rn.shape != (u, t, s) or rv.shape[:3] != (u, t, s):
        raise ValueError("selector_match: inconsistent requirement shapes")
    if term_valid is None and t != 1:
        raise ValueError("selector_match: label mode takes one term per row")
    opt = {}
    for name, a, shape in (("term_valid", term_valid, (u, t)), ("match_all", match_all, (u,)),
                           ("match_none", match_none, (u,))):
        if a is not None:
            opt[name] = _dev_tensor(name, a, dev, torch.bool)
            if opt[name].shape != shape:
                raise ValueError(f"selector_match: {name} must be {shape}")
    vn = nt = None
    d = 0
    if has_numeric:
        if vals_num is not None:
            vn = _dev_tensor("vals_num", vals_num, dev, torch.float32)
            if vn.shape != (o, lab):
                raise ValueError("selector_match: vals_num must match keys")
        elif numeric is not None:
            nt = _dev_tensor("numeric", numeric, dev, torch.float32)
            d = nt.shape[0]
            if d == 0:
                raise ValueError("selector_match: empty numeric side-table")
        else:
            raise ValueError("selector_match: Gt / Lt need vals_num or numeric")
    idx = None
    b = u
    if index is not None:
        if not torch.is_tensor(index) or index.device != dev:
            raise ValueError(f"selector_match: index must be a tensor on {dev}")
        idx = index.to(torch.int32).contiguous()
        b = idx.shape[0]
    out = torch.empty((b, o), dtype=torch.bool, device=dev)
    if u == 0 or o == 0 or b == 0:
        return out
    tile, chunk = plan_for(u, t)
    err = _fn()(u, t, s, v, o, lab, b, int(bool(has_numeric)), ptr(rk), ptr(rop), ptr(rv),
                ptr(rn), _ptr_or_null(opt.get("term_valid")),
                _ptr_or_null(opt.get("match_all")), _ptr_or_null(opt.get("match_none")),
                ptr(keys), ptr(vals), _ptr_or_null(vn), _ptr_or_null(nt), d,
                _ptr_or_null(idx), ptr(out), tile, chunk, stream_of(dev))
    check(err, "selector_match")
    LAUNCHES["selector_match"] += 1
    return out
