"""K32's Hopper decomposition, mirrored in numpy, against the JAX package
(exact).

The CUDA kernel runs only on the card; this mirror walks a row as K32
``selector_spread_score`` (csrc/selectorspread.cu) does at most 16 rows,
so that the decomposition — not only the function — is held against the
reference's ``SelectorSpreadPlugin.score_row`` / ``score``
(``kubernetes_tpu/plugins/selectorspread.py:109-146``), weighted and added
as ``run_scores`` adds it, on the CPU:

* the row cut into the slices of ``kernel_work.k32_plan`` (up to 8, a
  cluster's blocks), each slice into 16-byte vectors of 4 entries (one
  entry at a time where a row does not start on a 16-byte boundary) and a
  scalar tail;
* each slice's (max_c, max_z) partial over its masked entries (0 where it
  has none), the partials merged in every order of the slices;
* the score computed per masked entry — multiply first, one correctly
  rounded division, the blend one fused multiply-add with the reference's
  float32 weights — and added into the total; a vector holding a masked
  entry stored whole (its unmasked entries with the bits they were loaded
  with), a tail entry only where masked, each entry written at most once.

The cases: the scenario of ``tests/test_torch_selectorspread.py`` (two
Service pods on n0, n1 alone in its zone: 0, 100, 33) and the profiles
cluster it builds; every row maximum 1–399 spread over an 8190-entry row;
has_zone holes; max_z = 0; a row with every entry masked and one with
none; N = 8190, 1000, 1025 and 4097 (not a multiple of a slice or of 4);
weights 1 and 2.  Each also runs through the port's plain version at
``device="cpu"``, and ``kernel_work.k32_work`` / ``k32_plan`` are held to
hand counts.

Tolerance: exact (float32 bits).
"""

from __future__ import annotations

import itertools
from types import SimpleNamespace as NS

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.plugins as JP
from kubernetes_tpu.framework.podbatch import PodBatchCompiler as JCompiler
from kubernetes_tpu.sim.store import ObjectStore as JStore
from kubernetes_tpu.state.cache import Cache as JCache, Snapshot as JSnapshot
from kubernetes_tpu.state.encoding import ClusterEncoder as JEncoder
from kubernetes_tpu_torch.kernels.selectorspread import W_NODE, W_ZONE, selector_spread_score
from kubernetes_tpu_torch.perf.kernel_work import k32_plan, k32_work

from test_torch_profiles import profile_cluster

FULL = 7


# --- the mirror ----------------------------------------------------------------------------


def fma_np(a, b, c):
    """float32 a·b + c rounded once (``__fmaf_rn``): the product is exact in
    float64, the sum's float64 rounding error recovered (TwoSum) decides a
    float32 halfway case."""
    a, b, c = (np.asarray(x, np.float32) for x in (a, b, c))
    p = a.astype(np.float64) * b.astype(np.float64)
    cd = c.astype(np.float64)
    s = cd + p
    bb = s - cd
    e = (cd - (s - bb)) + (p - bb)
    r = s.astype(np.float32)
    rd = r.astype(np.float64)
    nb = np.where(s > rd, np.nextafter(r, np.float32(np.inf)), np.nextafter(r, np.float32(-np.inf)))
    tie = (s != rd) & (2.0 * s == rd + nb.astype(np.float64))
    return np.where(tie & (e != 0) & ((e > 0) == (nb > r)), nb, r).astype(np.float32)


def entry_terms(cnt, zc, hz, max_c, max_z, weight):
    """weight · floor(blended) for masked entries, in the kernel's float32
    steps."""
    f32 = np.float32
    hundred = f32(100.0)
    div_c, div_z = f32(max(max_c, f32(1.0))), f32(max(max_z, f32(1.0)))
    node = np.where(max_c > 0, ((f32(max_c) - cnt) * hundred) / div_c, hundred).astype(f32)
    zone = (((f32(max_z) - zc) * hundred) / div_z).astype(f32)
    blended = np.where(hz & (max_z > 0), fma_np(f32(W_NODE), node, f32(W_ZONE) * zone), node)
    return (f32(weight) * np.floor(blended)).astype(f32)


def merge_orders(cl: int, orders=None) -> np.ndarray:
    """[orders, cl] slice indices: the given orders, else every permutation."""
    return np.array([list(o) for o in orders] if orders is not None
                    else list(itertools.permutations(range(cl))), np.int64)


def k32_mirror(bits, total, counts, zone, has_zone, weight, *, orders=None):
    """K32's split form over every row of ``[C, N]`` (C ≤ 16 in the
    kernel; the mirror walks each row alike) → (new total, the merged
    maxima per row, the slice count).  ``orders``: merge orders to try
    (default: every permutation of the slices up to 8)."""
    c, n = bits.shape
    vec = 4 if (c == 1 or n % 4 == 0) else 1
    cl, s, _threads = k32_plan(n, vec)
    out = total.copy()
    writes = np.zeros(total.shape, np.int32)
    maxima = []
    zero = np.float32(0.0)
    for row in range(c):
        mask = bits[row] == FULL
        parts, pieces = [], []
        for q in range(cl):
            lo, hi = min(q * s, n), min(q * s + s, n)
            full = (hi - lo) // vec
            body, tail = slice(lo, lo + full * vec), slice(lo + full * vec, hi)
            # the vectors (items of `vec` entries), then the scalar tail
            mb = mask[body].reshape(full, vec)
            mc = max(np.where(mb, counts[row, body].reshape(full, vec), zero).max(initial=zero),
                     np.where(mask[tail], counts[row, tail], zero).max(initial=zero))
            mz = max(np.where(mb, zone[row, body].reshape(full, vec), zero).max(initial=zero),
                     np.where(mask[tail], zone[row, tail], zero).max(initial=zero))
            parts.append((np.float32(mc), np.float32(mz)))
            pieces.append((body, tail, mb))
        # the partials folded in each order (np.maximum.reduce folds in turn)
        folded = np.maximum.reduce(np.array(parts, np.float32)[merge_orders(cl, orders)], axis=1)
        assert (folded == folded[0]).all()  # a maximum merges alike in any order
        mc, mz = folded[0]
        maxima.append((mc, mz))
        terms = entry_terms(counts[row], zone[row], has_zone, mc, mz, weight)
        new = np.where(mask, total[row] + terms, total[row]).astype(np.float32)
        for body, tail, mb in pieces:
            # a vector holding a masked entry is stored whole (vec = 4), a
            # single entry or a tail entry only where masked
            stored = np.repeat(mb.any(axis=1), vec) if vec == 4 else mb.reshape(-1)
            writes[row, body] += stored
            writes[row, tail] += mask[tail]
        out[row] = np.where(writes[row] > 0, new, total[row])
    assert writes.max(initial=0) <= 1
    assert np.array_equal(out[writes == 0].view(np.int32), total[writes == 0].view(np.int32))
    # a stored unmasked entry keeps the bits it was loaded with
    assert np.array_equal(out[bits != FULL].view(np.int32), total[bits != FULL].view(np.int32))
    return out.astype(np.float32), maxima, cl


# --- the reference -------------------------------------------------------------------------


REF_ROWS = 16  # the reference's plane at least this tall: see test_reference_blend_...


def reference_score(counts, zone, has_zone, mask):
    """The reference's ``score`` planes under ``jax.jit``, the rows given
    evaluated inside a plane of at least ``REF_ROWS`` rows (zero rows with
    an empty mask below them): there XLA:CPU rounds the blend once, as
    fma(0.33333334, node, 0.6666667 · zone); on a smaller plane it may
    round the same tie otherwise (``test_reference_blend_depends_on_its_plane``)."""
    plugin = JP.SelectorSpreadPlugin()
    c, n = counts.shape
    pad = max(REF_ROWS - c, 0)

    def tall(x, fill):
        return np.concatenate([x, np.full((pad, n), fill, x.dtype)]) if pad else x

    fn = jax.jit(lambda v, m, a: plugin.score(NS(valid=v), NS(num_nodes=n), None, aux=a,
                                              mask=m))
    out = fn(jnp.ones(c + pad, bool), tall(mask, False),
             {"counts": tall(counts, 0.0), "zone_counts": tall(zone, 0.0), "has_zone": has_zone})
    return np.asarray(out)[:c]


def reference_total(bits, total, counts, zone, has_zone, weight):
    """The reference's ``score`` over the mask, then ``run_scores``' add:
    total + weight · score on the masked entries."""
    mask = bits == FULL
    score = reference_score(counts, zone, has_zone, mask)
    return np.where(mask, total + np.float32(weight) * score, total).astype(np.float32)


def port_plain(bits, total, counts, zone, has_zone, weight):
    t = torch.from_numpy(total.copy())
    selector_spread_score(torch.from_numpy(bits), FULL, t, torch.from_numpy(counts),
                          torch.from_numpy(zone), torch.from_numpy(has_zone), weight)
    return t.numpy()


def check(bits, total, counts, zone, has_zone, weight, what, orders=None):
    want = reference_total(bits, total, counts, zone, has_zone, weight)
    got, maxima, cl = k32_mirror(bits, total, counts, zone, has_zone, weight, orders=orders)
    assert np.array_equal(got.view(np.int32), want.view(np.int32)), what
    assert np.array_equal(port_plain(bits, total, counts, zone, has_zone, weight).view(np.int32),
                          want.view(np.int32)), what
    return got, maxima, cl


# --- the cases -----------------------------------------------------------------------------


def random_rows(seed, c, n, *, live=None, p_mask=0.7, p_zone=0.8):
    rng = np.random.default_rng(seed)
    live = n if live is None else live
    mask = (rng.random((c, n)) < p_mask) & (np.arange(n) < live)
    bits = np.where(mask, FULL, FULL & ~(1 << rng.integers(0, 3, (c, n)))).astype(np.int32)
    mx = rng.integers(1, 400, (c, 1))
    counts = np.floor(rng.random((c, n)) * (mx + 1)).astype(np.float32)
    zone = np.floor(rng.random((c, n)) * (3 * mx + 1)).astype(np.float32)
    has_zone = rng.random(n) < p_zone
    total = np.where(mask, rng.integers(0, 600, (c, n)), -np.inf).astype(np.float32)
    return bits, total, counts, zone, has_zone


def test_k32_mirror_scenario_of_the_selectorspread_test():
    """n0 holds two Service pods in zone z0, n1 is alone in z1, n2 shares
    z0: the scores 0, 100, 33 (the exact scan then picks n1)."""
    bits = np.full((1, 3), FULL, np.int32)
    counts = np.array([[2.0, 0.0, 0.0]], np.float32)
    zone = np.array([[2.0, 0.0, 2.0]], np.float32)
    got, maxima, _ = check(bits, np.zeros((1, 3), np.float32), counts, zone,
                           np.ones(3, bool), 1.0, "scenario")
    assert got.tolist() == [[0.0, 100.0, 33.0]] and maxima == [(2.0, 2.0)]


@pytest.mark.parametrize("seed", [0, 1])
def test_k32_mirror_on_the_profiles_cluster(seed):
    """The JAX host_prepare's counts, zone counts and zone flags on the
    profiles cluster of ``tests/test_torch_selectorspread.py`` (Services and
    ReplicaSets, two zone label keys, nodes without a zone), each pending
    pod's row through the split walk (the scan's C = 1) and 16 rows at once."""
    store, cache = JStore(), JCache()
    objs, _pending = profile_cluster("jax", seed, n_nodes=40, n_bound=120)
    pending = []
    for kind, obj in objs:
        if kind == "Node":
            cache.add_node(obj)
        elif kind == "Pod" and obj.spec.node_name:
            cache.add_pod(obj)
        elif kind == "Pod":
            pending.append(obj)
        else:
            store.create(kind, obj)
    snap = JSnapshot()
    cache.update_snapshot(snap)
    enc = JEncoder()
    batch = JCompiler(enc).compile(pending, pad_to=128)
    enc.full_sync(snap)
    aux = JP.SelectorSpreadPlugin(store).host_prepare(batch, snap, enc)
    counts = np.asarray(aux["counts"], np.float32)
    zone = np.asarray(aux["zone_counts"], np.float32)
    has_zone = np.asarray(aux["has_zone"], bool)
    c, n = counts.shape
    assert counts.max() > 1 and has_zone.any() and not has_zone.all()
    rng = np.random.default_rng(seed)
    mask = (rng.random((c, n)) < 0.8) & (np.arange(n) < 40)
    bits = np.where(mask, FULL, 3).astype(np.int32)
    total = np.where(mask, rng.integers(0, 300, (c, n)), -np.inf).astype(np.float32)
    want = reference_total(bits, total, counts, zone, has_zone, 1.0)
    plain = port_plain(bits, total, counts, zone, has_zone, 1.0)
    assert np.array_equal(plain.view(np.int32), want.view(np.int32))
    for row in range(c):
        got, _maxima, _cl = k32_mirror(bits[row:row + 1], total[row:row + 1],
                                       counts[row:row + 1], zone[row:row + 1], has_zone, 1.0)
        assert np.array_equal(got[0].view(np.int32), want[row].view(np.int32)), f"row {row}"
    check(bits[:16], total[:16], counts[:16], zone[:16], has_zone, 2.0, "16 rows")


def test_k32_mirror_at_every_row_maximum():
    """Rows whose maxima run 1–399, the counts 0..max spread over an
    8190-entry row (all eight slices hold some, and the tail), each row
    through the split walk: every floor lands where the reference's do."""
    n, rows = 8190, 399
    counts = np.zeros((rows, n), np.float32)
    zone = np.zeros((rows, n), np.float32)
    mask = np.zeros((rows, n), bool)
    for i, m in enumerate(range(1, rows + 1)):
        at = np.linspace(0, n - 1, m + 1).round().astype(int)
        counts[i, at] = np.arange(m + 1)
        zone[i, at] = np.round(np.linspace(0, 3 * m, m + 1))
        mask[i, at] = True
    bits = np.where(mask, FULL, 3).astype(np.int32)
    has_zone = np.random.default_rng(3).random(n) < 0.8
    total = np.zeros((rows, n), np.float32)
    want = reference_total(bits, total, counts, zone, has_zone, 1.0)
    for i in range(rows):
        got, maxima, cl = k32_mirror(bits[i:i + 1], total[i:i + 1], counts[i:i + 1],
                                     zone[i:i + 1], has_zone, 1.0, orders=[range(8),
                                                                            range(7, -1, -1)])
        assert cl == 8 and maxima == [(np.float32(i + 1), np.float32(3 * (i + 1)))]
        assert np.array_equal(got[0].view(np.int32), want[i].view(np.int32)), f"max {i + 1}"


CASES = {
    "C = 1, N = 8192, 5000 live": dict(seed=10, c=1, n=8192, live=5000),
    "C = 1, N = 8190 (tail)": dict(seed=11, c=1, n=8190),
    "C = 4, N = 8190 (single entries)": dict(seed=12, c=4, n=8190),
    "C = 16, N = 4097": dict(seed=13, c=16, n=4097),
    "C = 2, N = 1025": dict(seed=14, c=2, n=1025),
    "C = 1, N = 1000 (one block)": dict(seed=15, c=1, n=1000),
    "has_zone holes": dict(seed=16, c=1, n=8192, p_zone=0.3),
}


@pytest.mark.parametrize("weight", [1.0, 2.0])
@pytest.mark.parametrize("label", list(CASES))
def test_k32_split_mirror_equals_reference(label, weight):
    kw = dict(CASES[label])
    bits, total, counts, zone, has_zone = random_rows(kw.pop("seed"), kw.pop("c"), kw.pop("n"),
                                                      **kw)
    _got, _maxima, cl = check(bits, total, counts, zone, has_zone, weight, label)
    assert cl == k32_plan(bits.shape[1], 4)[0]


@pytest.mark.parametrize("kind", ["max_z = 0", "every entry masked", "none masked",
                                  "counts 0 (max 0: every score 100)"])
def test_k32_split_mirror_on_degenerate_rows(kind):
    bits, total, counts, zone, has_zone = random_rows(20, 1, 8192, live=5000)
    if kind == "max_z = 0":
        zone[:] = 0.0
    elif kind == "every entry masked":
        bits[:] = FULL
        total = np.where(bits == FULL, np.float32(7.0), total).astype(np.float32)
    elif kind == "none masked":
        bits[:] = 3
    else:
        counts[:] = 0.0
    got, maxima, _cl = check(bits, total, counts, zone, has_zone, 1.0, kind)
    mask = bits[0] == FULL
    if kind == "none masked":
        assert np.array_equal(got.view(np.int32), total.view(np.int32))
        assert maxima == [(0.0, 0.0)]
    if kind == "max_z = 0":
        assert maxima[0][1] == 0.0
    if kind.startswith("counts 0"):
        # every score is 100 from the node term; the zone blend moves some
        assert maxima[0][0] == 0.0 and (got[0][mask] - total[0][mask]).max() == 100.0


def test_reference_blend_depends_on_its_plane():
    """A fault of the reference that the port does not keep: at a float tie
    of the blend (max_c 170 and a count of 127, max_z 510 and a zone count
    of 345: node 25.294117, zone 32.35294, the exact blend 29.9999996),
    XLA:CPU rounds the reference's a · node + b · zone as one fused
    multiply-add — 29.999998, floor 29 — in a [16, 8192] plane, but to 30
    in a [1, 8192] plane or one row's ``score_row`` with its mask an
    argument (XLA:CPU contracts one product or the other, or none, by the
    program's shape).  The port rounds it once everywhere: 29, the mirror's
    split walk too."""
    plugin = JP.SelectorSpreadPlugin()
    n = 8192

    def plane(c):
        counts = np.full((c, n), 127.0, np.float32)
        zone = np.full((c, n), 345.0, np.float32)
        counts[:, 0], zone[:, 0] = 170.0, 510.0
        return counts, zone

    has_zone = np.ones(n, bool)
    one = jax.jit(lambda v, m, a: plugin.score(NS(valid=v), NS(num_nodes=n), None, aux=a,
                                               mask=m))
    counts, zone = plane(1)
    small = np.asarray(one(jnp.ones(1, bool), np.ones((1, n), bool),
                           {"counts": counts, "zone_counts": zone, "has_zone": has_zone}))
    row = np.asarray(jax.jit(lambda a, m: plugin.score_row(None, None, None, a, 0, m))(
        {"counts": counts, "zone_counts": zone, "has_zone": has_zone}, jnp.ones(n, bool)))
    assert small[0, 1] == 30.0 and row[1] == 30.0
    counts16, zone16 = plane(16)
    tall = np.asarray(jax.jit(lambda v, m, a: plugin.score(
        NS(valid=v), NS(num_nodes=n), None, aux=a, mask=m))(
            jnp.ones(16, bool), np.ones((16, n), bool),
            {"counts": counts16, "zone_counts": zone16, "has_zone": has_zone}))
    assert tall[0, 1] == 29.0
    bits = np.full((1, n), FULL, np.int32)
    zero = np.zeros((1, n), np.float32)
    assert port_plain(bits, zero, counts, zone, has_zone, 1.0)[0, 1] == 29.0
    got, _maxima, _cl = k32_mirror(bits, zero, counts, zone, has_zone, 1.0, orders=[range(8)])
    assert got[0, 1] == 29.0
    assert reference_total(bits, zero, counts, zone, has_zone, 1.0)[0, 1] == 29.0


def test_k32_plan_splits_as_the_kernel_does():
    """The copy of csrc/selectorspread.cu's split_plan (the chip check holds
    it to the kernel's export)."""
    assert k32_plan(8192) == (8, 1024, 256)
    assert k32_plan(8190) == (8, 1024, 256)
    assert k32_plan(8190, 1) == (8, 1024, 1024)
    assert k32_plan(1000) == (1, 1000, 256)
    assert k32_plan(1025) == (2, 516, 160)
    assert k32_plan(100000) == (8, 12500, 1024)
    assert k32_plan(1) == (1, 4, 32)


def test_k32_work_counts_bits_has_zone_and_masked_entries():
    bits = torch.tensor([[7, 3, 7, 7, 0], [3, 3, 3, 7, 3]], dtype=torch.int32)
    has_zone = torch.ones(5, dtype=torch.bool)
    # bits 40 bytes, has_zone 5; 4 masked entries × (2 counts + total read + write)
    assert k32_work(bits, 7, has_zone) == (40 + 5 + 16 * 4, 10 + 12 * 4)
