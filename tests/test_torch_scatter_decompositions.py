"""K16's Hopper decomposition, mirrored in numpy, against the JAX package
(exact).

The CUDA kernel runs only on the card; this mirror walks an array group in
the kernel's own order and with its own split, so that the decomposition —
not only the function — is held against the reference on the CPU.  K16
``scatter_rows`` (the reference's ``apply_scatter`` / ``_scatter_rows``,
state/encoding.py:168-181, 883-891): each array is cut by
``kernel_work.k16_plan`` into tiles of contiguous rows, a block a tile; a
tile moves 16-byte vectors, 4-byte words or bytes, as the row bytes and the
pointers' alignment allow; rows narrower than a vector go as a run of rows
(each dirty row's bytes patched into the old array's vector); a narrow
array's last vector, where the array ends inside it, goes byte by byte; a
block first marks which payload entry writes each of its rows (a scan of
the payload rows, pads repeating a row with equal values), then writes
every output byte exactly once, from the payload or from the old array.  A
vector's row is its byte offset times the launcher's reciprocal
(``__umulhi``), which the mirror computes the same way and holds to the
true quotient.

Problems: the node, pod and affinity groups of a small encoder (the
cluster of ``tests/test_torch_spread.py``) with a payload padded by repeated
rows, and with ``k`` = 0, against ``apply_scatter``; synthetic groups whose
dirty rows sit on tile edges with N not a multiple of the tile, with a bool
row, a 12-byte row, 3-byte rows and the narrow 1-, 2-, 4- and 8-byte rows,
against the reference's ``_scatter_rows``; each under the kernel's own
tiles and under small tiles, 16-byte aligned, only 4-byte aligned and
unaligned.  Each group also runs through the port's plain version
(``scatter_rows`` at ``device="cpu"``).

Tolerance: exact (every byte).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.state.encoding import _AFF_ARRAYS, _NODE_ARRAYS, _POD_ARRAYS
from kubernetes_tpu.state.encoding import PendingScatter as JPending
from kubernetes_tpu.state.encoding import _scatter_rows as j_scatter_rows
from kubernetes_tpu.state.encoding import apply_scatter as j_apply_scatter
from kubernetes_tpu_torch.kernels.scatter import scatter_rows, scatter_rows_plain
from kubernetes_tpu_torch.perf.kernel_work import (
    K16_MAX_TILE_ROWS,
    K16_THREADS,
    K16_UNROLL,
    k16_plan,
    k16_work,
)

from tests.test_torch_spread import _spread_problem

# (tile vectors, max tile rows): the kernel's, and small enough that the
# small problems span many tiles
TILES = {"kernel": (K16_THREADS * K16_UNROLL, K16_MAX_TILE_ROWS), "small": (8, 16)}
# (16-byte aligned, 4-byte aligned): the three pointers of an array
ALIGNS = {"aligned16": (True, True), "aligned4": (False, True), "unaligned": (False, False)}


# --- the mirror ---------------------------------------------------------------------------


def _row_of(o, rb: int, magic: int):
    """csrc/scatter_rows.cu ``row_of``: the row of byte offset ``o`` (an int
    or an array of offsets below 2^32)."""
    if rb == 1:
        return o
    return (np.asarray(o, np.uint64) * np.uint64(magic)) >> np.uint64(32)


def k16_mirror(a: np.ndarray, rows: np.ndarray, v: np.ndarray, tiles=TILES["kernel"],
               align=ALIGNS["aligned16"], slot_order: int = 1) -> np.ndarray:
    """One array through K16's blocks → the new array.  A block's whole
    vectors are loaded from the old array first (the kernel's loads before
    the slot map), then each vector holding a dirty row takes the payload's
    bytes — a whole vector where a row is whole vectors, the dirty rows'
    bytes of a run of narrow rows; a last partial vector goes byte by byte.
    ``slot_order`` 1 scans the payload rows forward, −1 backward (which
    duplicate a block keeps)."""
    n = a.shape[0]
    rb = a.itemsize * (int(np.prod(a.shape[1:])) if a.ndim > 1 else 1)
    src = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
    val = np.ascontiguousarray(v).view(np.uint8).reshape(-1)
    dst = np.zeros_like(src)
    written = np.zeros(src.size, np.int64)
    vec, tr, blocks = k16_plan(rb, n, *align, tile_vectors=tiles[0], max_tile_rows=tiles[1])
    magic = 0 if rb <= 1 or tr == 1 else ((1 << 32) + rb - 1) // rb
    for blk in range(blocks):
        r0 = blk * tr
        nr = min(tr, n - r0)
        base, nbytes = r0 * rb, nr * rb
        whole = nbytes // vec
        assert base % vec == 0  # a tile starts on a vector
        slot = np.full(nr, -1)
        scan = np.arange(rows.shape[0])[::slot_order]
        hit = (rows[scan] >= r0) & (rows[scan] < r0 + nr)
        slot[rows[scan][hit] - r0] = scan[hit]
        offs = np.arange(whole) * vec
        row = _row_of(offs, rb, magic).astype(np.int64)
        assert np.array_equal(row, offs // rb)  # the reciprocal is exact here
        x = src[base: base + whole * vec].reshape(whole, vec).copy()
        if rb % vec == 0:  # whole vectors a row
            for i in np.flatnonzero(slot[row] >= 0):
                at = slot[row[i]] * rb + offs[i] - row[i] * rb
                x[i] = val[at: at + vec]
        else:  # a run of vec / rb rows
            assert vec % rb == 0
            run = row[:, None] + np.arange(vec // rb)[None, :]
            for i, e in np.argwhere(slot[run] >= 0):
                s = slot[run[i, e]]
                x[i, e * rb: (e + 1) * rb] = val[s * rb: (s + 1) * rb]
        dst[base: base + whole * vec] = x.reshape(-1)
        written[base: base + whole * vec] += 1
        for q in range(whole * vec, nbytes):  # the array ends inside this vector
            r = int(_row_of(q, rb, magic))
            assert r == q // rb
            s = slot[r]
            dst[base + q] = val[s * rb + q - r * rb] if s >= 0 else src[base + q]
            written[base + q] += 1
    assert rb == 0 or (written == 1).all()  # each output byte written exactly once
    return dst.view(a.dtype).reshape(a.shape)


# --- the problems --------------------------------------------------------------------------


def _payload(rng, names, arrays, n_rows, dirty, k):
    """(rows i64[k], values): ``dirty`` sorted dirty rows padded to ``k`` by
    repeating the first, as the encoder's payload; new values on the dirty
    rows, a pad carrying its row's value."""
    rows = np.sort(rng.choice(n_rows, size=dirty, replace=False)).astype(np.int64)
    padded = np.concatenate([rows, np.full(k - dirty, rows[0] if dirty else 0, np.int64)])
    vals = []
    for x in arrays:
        v = np.asarray(x)[padded].copy()
        if v.dtype == bool:
            v[:dirty] = ~v[:dirty]
        else:
            v[:dirty] = v[:dirty] + np.asarray(1, v.dtype)
        v[dirty:] = v[0] if dirty else v[dirty:]
        vals.append(v)
    return padded, vals


@pytest.fixture(scope="module")
def encoder_groups():
    """The node, pod and affinity groups of a small encoder (the JAX
    snapshot), each with a payload of dirty rows padded to 8 rows."""
    p = _spread_problem(3, 0)
    dsnap = p["dsnap"]
    rng = np.random.default_rng(16)
    out = {}
    for group, names, dirty in (("node", _NODE_ARRAYS, 5), ("pod", _POD_ARRAYS, 3),
                                ("affinity", _AFF_ARRAYS, 2)):
        arrays = [np.array(getattr(dsnap, k)) for k in names]
        out[group] = (names, arrays, *_payload(rng, names, arrays, arrays[0].shape[0],
                                                dirty, 8))
    return dsnap, out


def _groups_through(dsnap, out, empty: bool):
    """The reference's apply_scatter over the three groups (with empty row
    lists where ``empty``) → {name: array}."""
    def pair(g):
        names, arrays, rows, vals = out[g]
        if empty:
            return jnp.zeros(0, jnp.int32), tuple(jnp.asarray(x[:0]) for x in arrays)
        return jnp.asarray(rows.astype(np.int32)), tuple(map(jnp.asarray, vals))

    upd = JPending(node_rows=pair("node"), pod_rows=pair("pod"), aff_rows=pair("affinity"))
    new = jax.jit(j_apply_scatter)(dsnap, upd)
    return {k: np.asarray(getattr(new, k)) for k in _NODE_ARRAYS + _POD_ARRAYS + _AFF_ARRAYS}


@pytest.mark.parametrize("empty", [False, True], ids=["payload", "k0"])
@pytest.mark.parametrize("align", list(ALIGNS))
@pytest.mark.parametrize("tiles", list(TILES))
def test_k16_encoder_groups_equal_apply_scatter(encoder_groups, tiles, align, empty):
    dsnap, out = encoder_groups
    want = _groups_through(dsnap, out, empty)
    moved = False
    for group, (names, arrays, rows, vals) in out.items():
        if empty:
            rows, vals = rows[:0], [v[:0] for v in vals]
        got_plain = scatter_rows_plain([torch.from_numpy(x) for x in arrays],
                                       torch.from_numpy(rows),
                                       [torch.from_numpy(v) for v in vals])
        for order in (1, -1):
            for k, x, v in zip(names, arrays, vals):
                got = k16_mirror(x, rows, v, TILES[tiles], ALIGNS[align], order)
                assert np.array_equal(got, want[k], equal_nan=got.dtype.kind == "f"), (group, k)
        for k, x, g in zip(names, arrays, got_plain):
            assert np.array_equal(g.numpy(), want[k], equal_nan=x.dtype.kind == "f"), (group, k)
            moved |= not np.array_equal(want[k], x, equal_nan=x.dtype.kind == "f")
    assert moved != empty


def _synthetic(n: int, seed: int):
    """A group of n rows: bool, bool × 3 (3-byte rows), int16 (2 bytes), int32
    (4), float32 × 2 (8), int32 × 3 (12 bytes), int32 × 4 (16), float32 × 12
    (48), int32 × 6 (24)."""
    rng = np.random.default_rng(seed)
    return [rng.random(n) < 0.5, rng.random((n, 3)) < 0.5,
            rng.integers(-9, 9, n).astype(np.int16),
            rng.integers(-99, 99, n).astype(np.int32),
            rng.random((n, 2)).astype(np.float32),
            rng.integers(-99, 99, (n, 3)).astype(np.int32),
            rng.integers(-99, 99, (n, 4)).astype(np.int32),
            rng.random((n, 12)).astype(np.float32),
            rng.integers(-99, 99, (n, 6)).astype(np.int32)]


def _edge_rows(arrays, n: int, tiles) -> np.ndarray:
    """Dirty rows on every tile edge of every array's plan (the first and
    last row of each tile) and the last row."""
    at = {n - 1, 0}
    for x in arrays:
        rb = x.itemsize * (int(np.prod(x.shape[1:])) if x.ndim > 1 else 1)
        _v, tr, blocks = k16_plan(rb, n, tile_vectors=tiles[0], max_tile_rows=tiles[1])
        for b in range(blocks):
            at |= {b * tr, min(b * tr + tr, n) - 1}
    return np.array(sorted(r for r in at if 0 <= r < n), np.int64)


@pytest.mark.parametrize("align", list(ALIGNS))
@pytest.mark.parametrize("tiles", list(TILES))
@pytest.mark.parametrize("n", [37, 203, 4099])
def test_k16_tile_edges_and_narrow_rows_equal_scatter_rows(n, tiles, align):
    arrays = _synthetic(n, n)
    edges = _edge_rows(arrays, n, TILES[tiles])
    k = 1 << int(np.ceil(np.log2(edges.size + 1)))
    rows = np.concatenate([edges, np.full(k - edges.size, edges[0], np.int64)])
    vals = []
    for x in arrays:
        v = x[rows].copy()
        v[: edges.size] = ~v[: edges.size] if v.dtype == bool else v[: edges.size] + 1
        v[edges.size:] = v[0]
        vals.append(v)
    want = [np.asarray(w) for w in jax.jit(j_scatter_rows)(
        tuple(map(jnp.asarray, arrays)), jnp.asarray(rows.astype(np.int32)),
        tuple(map(jnp.asarray, vals)))]
    plain = scatter_rows_plain([torch.from_numpy(x) for x in arrays], torch.from_numpy(rows),
                               [torch.from_numpy(v) for v in vals])
    for i, (x, v) in enumerate(zip(arrays, vals)):
        got = k16_mirror(x, rows, v, TILES[tiles], ALIGNS[align])
        ref = x.copy()
        ref[rows] = v  # numpy's row set (pads repeat equal values)
        assert np.array_equal(got, ref), i
        assert np.array_equal(plain[i].numpy(), ref), i
        assert np.array_equal(want[i], ref), i
        assert not np.array_equal(got, x)


@pytest.mark.parametrize("tiles", list(TILES))
def test_k16_reference_holds_bool_and_12_byte_rows(tiles):
    """The reference's own _scatter_rows on a bool row and a 12-byte row
    (int32 × 3) at a size that is no multiple of any tile."""
    n = 1001
    rng = np.random.default_rng(3)
    arrays = [rng.random(n) < 0.5, rng.integers(-99, 99, (n, 3)).astype(np.int32)]
    edges = _edge_rows(arrays, n, TILES[tiles])
    rows = np.concatenate([edges, np.full(4, edges[-1], np.int64)])
    vals = [np.where(np.arange(rows.size) < edges.size, ~arrays[0][rows], arrays[0][rows]),
            arrays[1][rows] + (np.arange(rows.size) < edges.size)[:, None].astype(np.int32)]
    vals[0][edges.size:] = vals[0][edges.size - 1]
    vals[1][edges.size:] = vals[1][edges.size - 1]
    want = jax.jit(j_scatter_rows)(tuple(map(jnp.asarray, arrays)),
                                   jnp.asarray(rows.astype(np.int32)),
                                   tuple(map(jnp.asarray, vals)))
    got = scatter_rows([torch.from_numpy(x) for x in arrays], torch.from_numpy(rows),
                       [torch.from_numpy(v) for v in vals])
    for i, (x, v) in enumerate(zip(arrays, vals)):
        for align in ALIGNS.values():
            assert np.array_equal(k16_mirror(x, rows, v, TILES[tiles], align),
                                  np.asarray(want[i])), i
        assert np.array_equal(got[i].numpy(), np.asarray(want[i])), i


def test_k16_plan_fills_the_card_at_the_node_tier():
    """The node group at N = 8192 (the encoder's default widths: 535 bytes a
    node over 20 arrays) takes several blocks per SM of the H100's 132, and
    each narrow array a run of rows a vector."""
    widths = [1, 4, 32, 32, 8, 64, 64, 64, 32, 32, 32, 32, 32, 32, 32, 32, 1, 1, 4, 4]
    assert sum(widths) == 535 and len(widths) == len(_NODE_ARRAYS)
    plans = [k16_plan(w, 8192) for w in widths]
    assert sum(b for _v, _t, b in plans) >= 3 * 132
    assert all(v == 16 for v, _t, _b in plans)
    assert k16_plan(1, 8192) == (16, 1024, 8)  # 16 rows a vector, the slot map's rows
    assert k16_plan(12, 8192) == (4, 170, 49)  # 3 words a row
    assert k16_plan(12, 8192, False, False) == (1, 42, 196)
    assert k16_plan(2, 8192, False, True) == (1, 256, 32)  # narrow rows off 16: bytes
    assert k16_plan(1024, 8192) == (16, 8, 1024)  # the affinity counts' wide rows
    assert k16_plan(1 << 16, 3) == (16, 1, 3)  # a row longer than a tile
    assert k16_plan(0, 8192)[2] == 0


def test_k16_work_counts_outputs_clean_rows_and_distinct_payload():
    """K16's bound: every output written once, the old arrays read on clean
    rows only, the row list once and the payload once a distinct row."""
    n = 10
    arrays = [torch.zeros(n, dtype=torch.bool), torch.zeros((n, 3), dtype=torch.int32)]
    rows = torch.tensor([2, 7, 7, 2], dtype=torch.int64)  # two dirty rows, two pads
    vals = [torch.ones(4, dtype=torch.bool), torch.ones((4, 3), dtype=torch.int32)]
    per_row = 1 + 12
    assert k16_work(arrays, rows, vals) == (n * per_row + (n - 2) * per_row + 8 * 4
                                            + 2 * per_row, 0)
    assert k16_work(arrays, rows[:0], [v[:0] for v in vals]) == (2 * n * per_row, 0)
