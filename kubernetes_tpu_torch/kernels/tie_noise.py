"""K33 ``tie_noise``: the keyed engines' threefry tie noise (CUDA:
csrc/tie_noise.cu, the rounds in csrc/threefry.cuh), three entries, one
thread an element.

Replaces the JAX package's ``jax.random`` draws in framework/runtime.py:
``greedy_assign``'s per-step keys (``jax.random.split(key, b)``, :397),
``select_host``'s uniform row (:307), and ``batch_assign``'s ``[B, N]``
plane (``uniform(key, (b, N)) * 0.5`` added to the scores where the mask
holds, :546-548, :588-589).  The scan's steps (:421) draw their rows
inside K17's keyed pass (kernels/scan.py), from the keys ``tie_split``
makes.  The plain versions are ops/prng.py's threefry2x32, bit for bit
equal to ``jax.random`` under ``jax_threefry_partitionable=True``.

Keys on the device are int32 ``[b, 2]`` tensors holding the uint32 words'
bits.  CPU tensors take the plain versions; CUDA tensors launch K33.  Each
entry counts its own launches (``LAUNCHES["tie_split"]``, ``["tie_plane"]``,
``["tie_row"]``) and ``LAUNCHES["tie_noise"]`` their sum.
"""

from __future__ import annotations

import torch

from ..ops import prng
from . import LAUNCHES, bind, ptr, require_cuda, require_dtype, stream_of
from .build import check, load


def _as_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 uint32 values → the same bits as int32."""
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def key_rows(key, device) -> torch.Tensor:
    """One key as an int32 [1, 2] key table on ``device`` (``tie_row``'s
    input for a draw straight from the key, as ``select_host`` makes)."""
    words = torch.tensor([list(prng.key_of(key))], dtype=torch.int64)
    return _as_i32(words).to(device)


def tie_split_plain(key, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.split(key, n)`` as int32 [n, 2] bits."""
    return _as_i32(prng.split(key, n, device=device))


def tie_plane_plain(key, bits: torch.Tensor, full: int, total: torch.Tensor) -> torch.Tensor:
    """``total`` + 0.5 · uniform(key, total.shape) where ``bits == full``, in
    place (off the mask ``total`` is −inf and stays so)."""
    noise = prng.uniform(key, total.shape, device=total.device) * 0.5
    total.copy_(torch.where(bits == full, total + noise, total))
    return total


def tie_row_plain(keys: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """uniform(keys[k], (n,)): the row drawn under key row k."""
    return prng.uniform(keys[k].to(torch.int64) & prng.MASK32, (n,), device=keys.device)


_FNS = {}


def _fn(name: str, spec: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = bind(load("tie_noise"), name, spec)
    return fn


def _count(entry: str) -> None:
    LAUNCHES[entry] += 1
    LAUNCHES["tie_noise"] += 1


def tie_split(key, n: int, device) -> torch.Tensor:
    """→ int32[n, 2]: the batch's step keys ``split(key, n)`` on ``device``.
    A CPU device takes the plain version; a CUDA device launches K33."""
    device = torch.device(device)
    if device.type != "cuda":
        return tie_split_plain(key, n, device=device)
    k0, k1 = prng.key_of(key)
    keys = torch.empty((n, 2), dtype=torch.int32, device=device)
    err = _fn("launch_tie_split", "uuipp")(k0, k1, n, ptr(keys), stream_of(device))
    check(err, "tie_split")
    _count("tie_split")
    return keys


def tie_plane(key, bits: torch.Tensor, full: int, total: torch.Tensor) -> torch.Tensor:
    """Add the full auction's tie noise to ``total`` f32[B, N] in place where
    ``bits`` i32[B, N] has every filter bit (the reference's ``eff``).  CPU
    tensors take the plain version; CUDA tensors launch K33."""
    if not total.is_cuda:
        return tie_plane_plain(key, bits, full, total)
    dev = require_cuda("tie_plane", bits, total)
    require_dtype("tie_plane", torch.int32, bits)
    require_dtype("tie_plane", torch.float32, total)
    if bits.shape != total.shape:
        raise ValueError("tie_plane: bits and total must have one shape")
    k0, k1 = prng.key_of(key)
    err = _fn("launch_tie_plane", "uulippp")(k0, k1, total.numel(), int(full), ptr(bits),
                                             ptr(total), stream_of(dev))
    check(err, "tie_plane")
    _count("tie_plane")
    return total


def tie_row(keys: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """→ f32[n]: the uniform row under key row k of ``keys`` int32[b, 2]
    (``select_host``'s draw: ``key_rows(key)`` and k = 0).  CPU tensors
    take the plain version; CUDA tensors launch K33."""
    if not keys.is_cuda:
        return tie_row_plain(keys, k, n)
    dev = require_cuda("tie_row", keys)
    require_dtype("tie_row", torch.int32, keys)
    if keys.dim() != 2 or keys.shape[1] != 2 or not 0 <= k < keys.shape[0]:
        raise ValueError("tie_row: keys must be [b, 2] and 0 <= k < b")
    noise = torch.empty((n,), dtype=torch.float32, device=dev)
    err = _fn("launch_tie_row", "pipp")(ptr(keys), int(k), int(n), ptr(noise), stream_of(dev))
    check(err, "tie_row")
    _count("tie_row")
    return noise
