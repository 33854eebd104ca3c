"""The port's threefry2x32 (ops/prng.py) and K33's plain versions
(kernels/tie_noise.py) against ``jax.random`` (exact).

* ``split(key, n)`` equals ``jax.random.split`` word for word, and
  ``uniform(key, shape)`` equals ``jax.random.uniform``'s float32 bits, for
  the keys PRNGKey(0), PRNGKey(7), PRNGKey(2³² − 1), a key with both words
  set and keys drawn from a split, at odd shapes, a 2-d shape and more than
  2¹⁶ elements (jax 0.9's default ``jax_threefry_partitionable=True``).
* K33's plain entries: the step keys of a batch, the full auction's
  ``[B, N]`` plane (``where(mask, total + 0.5 · uniform, −inf)``, the
  reference's ``eff``) and a step's row equal the same draws through JAX.
* ``convert.key_from_jax`` carries a JAX key's data over.

Tolerance: exact (uint32 words, float32 bits).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.convert import key_from_jax
from kubernetes_tpu_torch.kernels.tie_noise import tie_plane, tie_row, tie_split
from kubernetes_tpu_torch.ops import prng

SEEDS = [0, 7, 2**32 - 1]


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def test_partitionable_threefry_is_the_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split_equal_jax(seed):
    jkey = jax.random.PRNGKey(seed)
    assert prng.prng_key(seed) == tuple(int(w) for w in np.asarray(jkey))
    for n in (1, 3, 512, 1001):
        want = np.asarray(jax.random.split(jkey, n)).astype(np.int64)
        assert np.array_equal(prng.split(prng.prng_key(seed), n).numpy(), want), n


@pytest.mark.parametrize("shape", [(1,), (5,), (3, 17), (7, 129), (70_001,)])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bits_equal_jax(seed, shape):
    want = _bits(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    got = prng.uniform(prng.prng_key(seed), shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    assert np.array_equal(got.view(np.uint32), want)


def test_uniform_from_split_and_raw_keys_equal_jax():
    """Keys with high words set: the split keys of PRNGKey(7) and a raw key
    with both words at 2³² − 1."""
    keys = jax.random.split(jax.random.PRNGKey(7), 6)
    tkeys = prng.split((0, 7), 6)
    for k in (0, 3, 5):
        want = _bits(jax.random.uniform(keys[k], (4096,)))
        assert np.array_equal(prng.uniform(tkeys[k], (4096,)).numpy().view(np.uint32), want)
    raw = jax.random.wrap_key_data(np.array([2**32 - 1, 2**32 - 1], np.uint32),
                                   impl="threefry2x32")
    want = _bits(jax.random.uniform(raw, (3, 33)))
    got = prng.uniform((2**32 - 1, 2**32 - 1), (3, 33)).numpy()
    assert np.array_equal(got.view(np.uint32), want)


def test_tie_noise_plain_entries_equal_jax():
    """K33's three entries on the CPU (their plain versions) against the
    reference's draws: greedy_assign's ``split(key, b)``, a step's
    ``uniform(keys[k], (N,))`` and batch_assign's noised plane."""
    jkey = jax.random.PRNGKey(7)
    b, n = 12, 64
    keys = tie_split((0, 7), b, "cpu")
    assert keys.dtype == torch.int32 and keys.shape == (b, 2)
    want_keys = np.asarray(jax.random.split(jkey, b))
    assert np.array_equal(keys.numpy().view(np.uint32), want_keys)
    for k in (0, 5, b - 1):
        want = _bits(jax.random.uniform(jnp.asarray(want_keys[k]), (n,)))
        assert np.array_equal(tie_row(keys, k, n).numpy().view(np.uint32), want)
    rng = np.random.default_rng(3)
    scores = rng.integers(0, 300, size=(b, n)).astype(np.float32)
    mask = rng.random((b, n)) < 0.7
    full = 5
    bits = np.where(mask, full, 1).astype(np.int32)
    total = torch.from_numpy(np.where(mask, scores, -np.inf).astype(np.float32))
    noise = jax.random.uniform(jkey, (b, n)) * 0.5
    want = jnp.where(jnp.asarray(mask), jnp.asarray(scores) + noise, -jnp.inf)
    got = tie_plane((0, 7), torch.from_numpy(bits), full, total)
    assert got is total
    assert np.array_equal(total.numpy().view(np.uint32), _bits(want))


def test_key_from_jax():
    for seed in SEEDS:
        key = key_from_jax(np.asarray(jax.random.PRNGKey(seed)))
        assert key.shape == (2,) and key.dtype == torch.uint32
        assert prng.key_of(key) == prng.prng_key(seed)
