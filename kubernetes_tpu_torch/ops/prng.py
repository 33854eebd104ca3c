"""JAX's threefry2x32 random bits in plain torch: the keyed tie noise of the
scheduler's engines, bit for bit.

The reference draws its tie noise with ``jax.random`` (framework/
runtime.py: ``select_host`` :307, ``greedy_assign``'s per-step keys :397,
``batch_assign``'s ``[B, N]`` plane :548) under
``jax_threefry_partitionable=True`` (the default of jax 0.9).  There:

* a key is two uint32 words; ``PRNGKey(s)`` is ``[0, s]`` for 0 ≤ s < 2³²;
* ``split(key, n)[i]`` is both output words of ``threefry2x32(key, 0, i)``;
* ``uniform(key, shape)``, flattened, at index j is
  ``bitcast_f32(((x0 ^ x1) >> 9) | 0x3F800000) − 1.0`` with
  ``(x0, x1) = threefry2x32(key, 0, j)`` (for j < 2³²).

Threefry-2x32 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", 2011) is 20 rounds of add / rotate / xor in four groups of five, with
rotations (13, 15, 26, 6) and (17, 29, 16, 24) alternating, the key
schedule ``(k0, k1, k0 ^ k1 ^ 0x1BD11BDA)`` injected after every group with
the group index added to word 1.  torch's uint32 support is partial, so
the words ride int64 tensors masked to 32 bits.  K33
(kernels/tie_noise.py) computes the same bits on the card.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

MASK32 = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key: Sequence[int], x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words ``(x0, x1)`` (int64 tensors holding
    uint32 values) under ``key`` (two ints) → the two output words, int64."""
    k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for g in range(5):
        for r in ROTATIONS[g % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & MASK32
    return x0, x1


def key_of(key) -> Tuple[int, int]:
    """A key as two Python ints: a pair, a (2,) tensor or array of uint32."""
    if isinstance(key, torch.Tensor):
        key = key.to(torch.int64).tolist()
    k0, k1 = (int(v) & MASK32 for v in key)
    return k0, k1


def prng_key(seed: int) -> Tuple[int, int]:
    """The reference's ``jax.random.PRNGKey(seed)`` for 0 ≤ seed < 2³²."""
    return 0, int(seed) & MASK32


def _counters(n: int, start: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    j = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return j >> 32, j & MASK32


def split(key, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.split(key, n)`` → int64[n, 2] (uint32 values)."""
    hi, lo = _counters(n, 0, device)
    x0, x1 = threefry2x32(key_of(key), hi, lo)
    return torch.stack([x0, x1], dim=1)


def bits_to_uniform(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """The float32 in [0, 1) of one 32-bit draw ``x0 ^ x1``: its top 23 bits
    as the mantissa of a number in [1, 2), minus 1 (exact)."""
    w = (((x0 ^ x1) >> 9) | 0x3F800000).to(torch.int32)
    return w.view(torch.float32) - 1.0


def uniform(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1))."""
    n = 1
    for s in shape:
        n *= int(s)
    hi, lo = _counters(n, 0, device)
    x0, x1 = threefry2x32(key_of(key), hi, lo)
    return bits_to_uniform(x0, x1).reshape(tuple(shape))


__all__ = ["threefry2x32", "split", "uniform", "prng_key", "key_of", "bits_to_uniform"]
