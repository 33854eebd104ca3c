"""K6's and K18's Hopper decompositions, mirrored in numpy, against the JAX
package (exact).

The CUDA kernels run only on the card; these mirrors walk the inputs in the
kernels' own order and with their own splits, so that the decomposition —
not only the function — is held against the reference on the CPU:

* K6 ``spread_filter_bits`` (the reference's ``filter``,
  plugins/podtopologyspread.py:166-182): a row's nodes in vectors of 4 (or
  one at a time, the scalar form) a thread, blocks of ``kernel_work.k6_plan``;
  the test matchNum + selfMatch − min ≤ maxSkew built once per (constraint,
  domain) as a verdict bitmap — up to 32 domains one word a constraint from
  one lane a domain; above, the table split by whole words over the
  cluster's blocks, each slice's partial minimum and present count merged
  across the slices in every order — and a node's test its key and one
  verdict bit; the bit cleared only where the filter fails, every other bit
  untouched.  On the 3- and 5-zone problems of ``tests/test_torch_spread.py``
  (keyless nodes, two constraints one of them soft, minDomains), a
  zone problem whose skews sit exactly at maxSkew and one above, and a
  40-rack problem (a 64-domain bucket: three verdict words a constraint),
  each with a constraint whose nodeSelector matches no node (no present
  domain: the reference's BIG minimum), minDomains on and off, and a bit
  plane with other bits already cleared.
* K18 ``spread_update_row`` (the reference's ``update``, :287-304): one
  thread a (pending pod, constraint) row; pod i's node first, then (a placed
  pod) the row's match byte with the node's domain and counted flags, and
  (a matching row) one add at the domain that reads nothing first.  A chain of placements on live nodes, keyless nodes, a node past
  the last row (clipped, as the reference's gather) and steps whose node
  is −1 (nothing changes), on the zone tables and the 65-domain rack
  tables: every table equals the reference's after each step.

Each mirror also runs against the port's plain version at ``device="cpu"``.

Tolerance: exact (integer tables and bit planes).
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.plugins.podtopologyspread import PodTopologySpreadPlugin as JSpread
from kubernetes_tpu_torch.kernels.spread import (
    BIG,
    spread_filter_bits,
    spread_update_row,
)
from kubernetes_tpu_torch.perf.kernel_work import k6_plan, k6_work, k18_work

from tests.test_torch_spread import (
    BLUE,
    HARD,
    SOFT,
    ZONE,
    _build,
    _spread_index,
    _spread_problem,
    _zone_nodes,
)

RACK = "example.com/rack"
REQ = {"cpu": "100m", "memory": "500Mi"}
NVME = {"disk": "nvme"}  # no node carries it: a constraint with no counted node


# --- the problems -------------------------------------------------------------------------


def _boundary_problem():
    """Three zones of three nodes (and one keyless node) holding 3, 2 and 1
    matching pods: under maxSkew 1 a self-matching pod sits exactly at the
    limit in the third zone and one above in the second; under maxSkew 2
    exactly at it in the second and one above in the first."""
    nodes = _zone_nodes(10, 3, keyless=(9,))
    zone_of = {x["name"]: x["labels"].get(ZONE) for x in nodes}
    by_zone = {z: [nm for nm, zz in zone_of.items() if zz == z] for z in
               ("moon-0", "moon-1", "moon-2")}
    sched = []
    for z, cnt in (("moon-0", 3), ("moon-1", 2), ("moon-2", 1)):
        sched += [{"name": f"s{z}{k}", "ts": -100.0 + len(sched), "req": {"cpu": "100m"},
                   "labels": BLUE, "node": by_zone[z][k]} for k in range(cnt)]
    temps = [
        {"req": REQ, "labels": BLUE, "spread": [(1, ZONE, HARD, BLUE, None)]},
        {"req": REQ, "labels": BLUE, "spread": [(2, ZONE, HARD, BLUE, None)]},
        {"req": REQ, "labels": BLUE, "node_selector": NVME,
         "spread": [(1, ZONE, HARD, BLUE, None)]},
        {"req": REQ, "labels": BLUE, "spread": [(1, ZONE, HARD, BLUE, 5)]},
    ]
    pods = [dict(temps[i % len(temps)], name=f"p{i:02d}", ts=float(i)) for i in range(8)]
    return _build(nodes, sched, pods, pad_to=8)


def _rack_problem():
    """48 nodes on 40 racks (two without the rack label, one without the
    zone), 1–3 blue pods a rack and red ones at random: a rack bucket of 64
    domains (D + 1 = 65), so the verdict spans three words and the
    large-table form runs; every rack holds a blue pod, so minDomains (45
    asked, 40 present) lowers the minimum from 1 to 0."""
    rng = np.random.default_rng(18)
    nodes = _zone_nodes(48, 3, keyless=(11,))
    rack_node = {}
    for i, x in enumerate(nodes):
        if i not in (7, 41):
            x["labels"][RACK] = f"r{i % 40:02d}"
            rack_node.setdefault(i % 40, x["name"])
    names = [x["name"] for x in nodes]
    sched = [{"name": f"b{r:02d}{k}", "ts": -500.0 + 3 * r + k, "req": {"cpu": "100m"},
              "labels": BLUE, "node": rack_node[r]} for r in range(40) for k in range(1 + r % 3)]
    sched += [{"name": f"s{i:03d}", "ts": -100.0 + i, "req": {"cpu": "100m"},
               "labels": {"color": "red"}, "node": names[int(rng.integers(len(names)))]}
              for i in range(20)]
    temps = [
        {"req": REQ, "labels": BLUE, "spread": [(1, RACK, HARD, BLUE, None)]},
        {"req": REQ, "labels": BLUE, "spread": [(2, RACK, HARD, BLUE, 45)]},
        {"req": REQ, "labels": BLUE,
         "spread": [(1, RACK, HARD, BLUE, None), (1, ZONE, SOFT, BLUE, None)]},
        {"req": REQ, "labels": BLUE, "node_selector": NVME,
         "spread": [(1, RACK, HARD, BLUE, None)]},
        {"req": REQ, "labels": {"color": "red"}},
    ]
    pods = [dict(temps[i % len(temps)], name=f"p{i:02d}", ts=float(i)) for i in range(20)]
    return _build(nodes, sched, pods, pad_to=32)


PROBLEMS = {"3zones": lambda: _spread_problem(3, 0), "5zones": lambda: _spread_problem(5, 1),
            "boundary": _boundary_problem, "racks": _rack_problem}


def _np(taux) -> dict:
    return {f: getattr(taux, f).numpy().copy() for f in taux._fields}


@pytest.fixture(scope="module", params=list(PROBLEMS))
def problem(request):
    """(kind, p, JAX aux, port aux, the reference's filter with minDomains
    on and off)."""
    p = PROBLEMS[request.param]()
    idx = _spread_index(p["fw"])
    jaux = p["fw"].prepare(p["batch"], p["dsnap"], p["dyn"], p["host_auxes"])[idx]
    taux = p["tfw"].prepare(p["tbatch"], p["tsnap"], p["tdyn"])[idx]
    ref = {on: np.asarray(JSpread(enable_min_domains=on).filter(p["batch"], p["dsnap"],
                                                                  p["dyn"], jaux))
           for on in (True, False)}
    return request.param, p, jaux, taux, ref


# --- K6: the one pass and its per-domain verdict --------------------------------------------


def k6_verdict(a: dict, c: int, k: int, enable_min_domains: bool, cl: int, ws: int,
               order) -> list:
    """Constraint k of row c's verdict words, as K6 builds them: one word
    from one lane a domain up to 32 domains; above, ``cl`` slices of ``ws``
    whole words each reduced to a partial (minimum over present domains,
    present count), the partials merged in ``order``, then each slice's
    words built."""
    counts, present = a["hard_counts"][c, k], a["hard_present"][c, k]
    d1 = counts.shape[0]
    self_match = int(a["self_match"][c, k])
    max_skew, md = int(a["max_skew"][c, k]), int(a["min_domains"][c, k])

    def floor_min(m, n_present):
        return 0 if enable_min_domains and md > 0 and n_present < md else m

    def word(w, mn):
        return sum(1 << (d - 32 * w) for d in range(32 * w, min(32 * w + 32, d1))
                   if int(counts[d]) + self_match - mn <= max_skew)

    if d1 <= 32:
        m = min((int(x) for x, p in zip(counts, present) if p), default=BIG)
        return [word(0, floor_min(m, int(present.sum())))]
    n_words = (d1 + 31) // 32
    parts = []
    for q in range(cl):
        w_lo = min(q * ws, n_words)
        w_hi = min(w_lo + ws, n_words)
        sl = slice(w_lo * 32, min(w_hi * 32, d1))
        mine = counts[sl][present[sl]]
        parts.append((w_lo, w_hi, int(mine.min()) if mine.size else BIG, int(mine.size)))
    m, n_present = BIG, 0
    for q in order:
        m, n_present = min(m, parts[q][2]), n_present + parts[q][3]
    mn = floor_min(m, n_present)
    words = [None] * n_words
    for w_lo, w_hi, _m, _n in parts:
        for w in range(w_lo, w_hi):
            words[w] = word(w, mn)
    assert None not in words
    return words


def k6_mirror(a: dict, bits: np.ndarray, bit: int, enable_min_domains: bool, vec: int,
              cl: int = None, order: str = "forward") -> np.ndarray:
    """K6's decomposition of one call → the new bit plane: the rows in
    blocks of ``k6_plan`` (``cl`` slices of the table in place of the
    plan's), a vector of ``vec`` nodes a thread, a node failing where a
    hard constraint lacks its key or its domain's verdict bit."""
    c_rows, cc, d1 = a["hard_counts"].shape
    n = bits.shape[1]
    threads, nb, plan_cl, ws = k6_plan(n, d1, vec)
    if cl is not None:
        n_words = (d1 + 31) // 32
        plan_cl, ws = cl, (n_words + cl - 1) // cl
    rng = np.random.default_rng(cl or 0)
    perm = {"forward": list(range(plan_cl)), "reverse": list(range(plan_cl))[::-1],
            "shuffled": list(rng.permutation(plan_cl))}[order]
    out = bits.copy()
    for c in range(c_rows):
        hard = [k for k in range(cc) if a["hard_valid"][c, k]]
        if not hard:
            continue  # the kernel's early exit: the filter passes everywhere
        verdict = {k: k6_verdict(a, c, k, enable_min_domains, plan_cl, ws, perm) for k in hard}
        for blk, t in itertools.product(range(nb), range(threads)):
            n0 = (blk * threads + t) * vec
            if n0 >= n:
                continue
            vals = out[c, n0:n0 + vec].copy()
            changed = False
            for e in range(vec):
                node = n0 + e
                ok = True
                for k in hard:
                    d = int(a["dom_val"][c, k, node])
                    ok &= bool(a["has_key"][c, k, node]) and 0 <= d < d1 \
                        and bool((verdict[k][d >> 5] >> (d & 31)) & 1)
                if not ok and vals[e] & (1 << bit):
                    vals[e] &= ~(1 << bit)
                    changed = True
            if changed:  # the vector written back only where a word changes
                out[c, n0:n0 + vec] = vals
    return out


def _bits_plane(shape, bit: int, others_cleared: bool) -> np.ndarray:
    """K1's pass-bit plane: every bit of a 3-bit plane seeded, or other bits
    (and some of ``bit``) already cleared."""
    full = 0b111
    bits = np.full(shape, full, np.int32)
    if others_cleared:
        rng = np.random.default_rng(6)
        drop = rng.integers(0, 3, shape)
        bits = np.where(rng.random(shape) < 0.4, full & ~(1 << drop), full).astype(np.int32)
    return bits


@pytest.mark.parametrize("others_cleared", [False, True], ids=["seeded", "others-cleared"])
@pytest.mark.parametrize("min_domains", [True, False], ids=["minDomains", "no-minDomains"])
@pytest.mark.parametrize("form", ["vec4", "scalar"])
def test_k6_one_pass_equals_reference(problem, form, min_domains, others_cleared):
    kind, p, _jaux, taux, ref = problem
    a = _np(taux)
    n = a["dom_val"].shape[-1]
    vec = 4 if form == "vec4" and n % 4 == 0 else 1
    bit = 1
    bits = _bits_plane((a["dom_val"].shape[0], n), bit, others_cleared)
    got = k6_mirror(a, bits, bit, min_domains, vec)
    want = np.where(ref[min_domains], bits, bits & ~(1 << bit)).astype(np.int32)
    assert np.array_equal(got, want), np.argwhere(got != want)[:5]
    # only ``bit`` moved
    assert np.array_equal(got | (1 << bit), bits | (1 << bit))
    # the port's plain version agrees at device="cpu"
    tb = torch.from_numpy(bits.copy())
    spread_filter_bits(taux, tb, bit, min_domains)
    assert np.array_equal(tb.numpy(), want)


@pytest.mark.parametrize("order", ["forward", "reverse", "shuffled"])
@pytest.mark.parametrize("cl", [None, 2, 3, 8], ids=["plan", "cl2", "cl3", "cl8"])
def test_k6_table_slices_merge_in_every_order(problem, cl, order):
    """The large-table form's slices (whole verdict words) merged in any
    order give the reference's filter; the zone problems (one word) take
    the small form whatever ``cl`` says."""
    kind, p, _jaux, taux, ref = problem
    a = _np(taux)
    bits = _bits_plane(a["dom_val"].shape[::2], 2, True)
    got = k6_mirror(a, bits, 2, True, 1, cl=cl, order=order)
    want = np.where(ref[True], bits, bits & ~(1 << 2)).astype(np.int32)
    assert np.array_equal(got, want), np.argwhere(got != want)[:5]
    assert (a["hard_counts"].shape[-1] > 32) == (kind == "racks")


def test_k6_problems_hold_what_they_are_named_for(problem):
    kind, p, _jaux, taux, ref = problem
    a = _np(taux)
    valid = np.asarray(p["hbatch"].valid)
    hard = a["hard_valid"] & valid[:, None]
    # keyless nodes, a soft constraint beside a hard one, minDomains at work
    assert (~a["has_key"][hard]).any()
    if kind in ("3zones", "5zones", "racks"):
        assert (a["hard_valid"] != a["soft_valid"]).any() and a["soft_valid"].any()
    assert (ref[True] != ref[False]).any()
    # the filter fails somewhere and passes somewhere on valid rows
    assert not ref[True][valid].all() and ref[True][valid].any()
    if kind == "boundary":
        # no present domain on the NVME rows: min is BIG, every keyed node passes
        none = hard.any(axis=1) & ~a["hard_present"].any(axis=(1, 2))
        assert none.any()
        keyed = a["has_key"][none][:, 0]
        assert ref[True][none][keyed].all()
        # skews exactly at maxSkew and one above on the self-matching rows
        rows = np.flatnonzero(hard[:, 0] & a["hard_present"][:, 0].any(axis=1)
                              & (a["min_domains"][:, 0] == 0))
        at, above = False, False
        for c in rows:
            cnt, pres = a["hard_counts"][c, 0], a["hard_present"][c, 0]
            skew = cnt[:3] + int(a["self_match"][c, 0]) - cnt[pres].min()
            at |= bool((skew == a["max_skew"][c, 0]).any())
            above |= bool((skew == a["max_skew"][c, 0] + 1).any())
        assert at and above
    if kind == "racks":
        assert a["hard_counts"].shape[-1] == 65
        assert (hard.any(axis=1) & ~a["hard_present"].any(axis=(1, 2))).any()


def test_k6_plan_splits_as_the_kernel_does():
    assert k6_plan(8192, 9) == (256, 8, 1, 1)
    assert k6_plan(8192, 8193) == (256, 8, 8, 33)
    assert k6_plan(8192, 33) == (256, 8, 8, 1)
    assert k6_plan(5000, 8193) == (256, 8, 8, 33)
    assert k6_plan(8192, 9, 1) == (256, 32, 1, 1)
    assert k6_plan(1001, 9, 1) == (256, 4, 1, 1)
    assert k6_plan(1, 8193) == (32, 1, 1, 257)
    assert k6_plan(1025, 33) == (256, 2, 2, 1)
    assert k6_plan(131072, 8193) == (256, 128, 8, 33)


def test_k6_work_counts_hard_rows_and_failing_nodes():
    """K6's bound: the tables and scalars once, dom_val / has_key on hard
    rows only, the bit plane read where the filter fails and written where
    it fails on a set bit."""
    c, cc, n, d = 2, 2, 8, 3
    f = {"hard_counts": torch.tensor([[[0, 1, 0, 0], [0, 0, 0, 0]],
                                      [[2, 0, 0, 0], [0, 0, 0, 0]]], dtype=torch.int32),
         "hard_present": torch.zeros((c, cc, d + 1), dtype=torch.bool),
         "hard_valid": torch.tensor([[True, False], [True, False]]),
         "max_skew": torch.ones((c, cc), dtype=torch.int32),
         "min_domains": torch.zeros((c, cc), dtype=torch.int32),
         "self_match": torch.ones((c, cc), dtype=torch.bool),
         "dom_val": torch.zeros((c, cc, n), dtype=torch.int32),
         "has_key": torch.ones((c, cc, n), dtype=torch.bool)}
    f["hard_present"][:, 0, :2] = True
    # row 0: min 0; domain 0 has skew 0 + 1 − 0 = 1 ≤ 1 (passes), domain 1
    # has 1 + 1 = 2 (fails) — nodes 4..7 sit in domain 1
    f["dom_val"][0, 0, 4:] = 1
    # row 1: min 0 (domain 1); domain 0 has 2 + 1 = 3 (fails) for every node
    # but the two keyless ones (which fail too)
    f["has_key"][1, 0, :2] = False
    aux = type("Aux", (), f)
    bits = torch.full((c, n), 0b111, dtype=torch.int32)
    bits[1, :3] = 0b101  # bit 1 already clear on three failing nodes
    got = k6_work(aux, bits, 1)
    n_fail = 4 + 8
    n_clear = 4 + 5
    tables = 4 * c * cc * (d + 1) * 1 + c * cc * (d + 1) + c * cc + 4 * c * cc * 2 + c * cc
    assert got == (tables + 5 * 2 * n + 4 * n_fail + 4 * n_clear, 4 * 2 * n + c * cc * (d + 1))


# --- K18: the node and the match byte together ----------------------------------------------------------


def k18_mirror(a: dict, i: int, node: int) -> None:
    """K18's decomposition of one step, in place on ``a``: each (pending
    pod, constraint) row loads pod i's node (below 0: nothing more); then
    its match byte with the node's domain and j's counted flags, and a
    matching row adds 1 at the domain (an add that reads nothing first: the
    kernel's atomic add)."""
    b, cc, _bp = a["match_pending"].shape
    n = a["dom_val"].shape[-1]
    for row in range(b * cc):
        if node < 0:
            continue
        j, k = divmod(row, cc)
        at = min(node, n - 1)
        dv = int(a["dom_val"][j, k, at])
        ch, cs = bool(a["counted_hard"][j, at]), bool(a["counted_soft"][j, at])
        if not a["match_pending"][j, k, i]:
            continue
        if ch:
            a["hard_counts"][j, k, dv] += 1
        if cs:
            a["soft_counts"][j, k, dv] += 1


def _k18_steps(p, taux) -> list:
    """(i, node): live nodes, keyless nodes, a node past the last row and
    steps whose node is −1, over the batch's valid pods."""
    n = taux.dom_val.shape[-1]
    valid = np.flatnonzero(np.asarray(p["hbatch"].valid))
    keyless = np.flatnonzero(~taux.has_key.numpy().all(axis=(0, 1)))
    live = np.flatnonzero(taux.has_key.numpy().any(axis=(0, 1)))
    rng = np.random.default_rng(18)
    steps = []
    for s, i in enumerate(valid[:12]):
        kind = s % 6
        node = (-1 if kind == 2 else n + 3 if kind == 4
                else int(keyless[s % len(keyless)]) if kind == 5 and keyless.size
                else int(rng.choice(live)))
        steps.append((int(i), node))
    return steps


def test_k18_node_then_domain_equals_reference_over_a_chain(problem):
    kind, p, jaux, taux, _ref = problem
    a = _np(taux)
    port = taux._replace(hard_counts=taux.hard_counts.clone(),
                         soft_counts=taux.soft_counts.clone())
    jplug = JSpread()
    steps = _k18_steps(p, taux)
    assert any(nd < 0 for _i, nd in steps) and any(nd >= a["dom_val"].shape[-1]
                                                   for _i, nd in steps)
    moved = False
    for i, node in steps:
        before = a["hard_counts"].copy(), a["soft_counts"].copy()
        k18_mirror(a, i, node)
        spread_update_row(port, i, torch.tensor([node], dtype=torch.int32))
        if node >= 0:
            jaux = jplug.update(jaux, i, jnp.asarray(node, jnp.int32), p["batch"], p["dsnap"])
        else:  # not placed: nothing changes
            assert np.array_equal(a["hard_counts"], before[0])
            assert np.array_equal(a["soft_counts"], before[1])
        for f in ("hard_counts", "soft_counts"):
            want = np.asarray(getattr(jaux, f))
            assert np.array_equal(a[f], want), (f, i, node)
            assert np.array_equal(getattr(port, f).numpy(), want), (f, i, node)
        moved |= not np.array_equal(a["hard_counts"], before[0])
    assert moved


def test_k18_work_counts_the_match_column_and_matching_rows():
    """K18's bound: pod i's node; when placed, its match column, each
    matching row's domain, each matching pod's two counted flags and a read
    and a write per table add."""
    b, cc, n, d = 4, 2, 6, 3
    match = torch.zeros((b, cc, b), dtype=torch.bool)
    match[0, 0, 2] = match[0, 1, 2] = match[3, 1, 2] = True
    counted_hard = torch.ones((b, n), dtype=torch.bool)
    counted_soft = torch.zeros((b, n), dtype=torch.bool)
    counted_soft[3, 5] = True
    aux = type("Aux", (), {"match_pending": match, "counted_hard": counted_hard,
                           "counted_soft": counted_soft,
                           "dom_val": torch.zeros((b, cc, n), dtype=torch.int32),
                           "hard_counts": torch.zeros((b, cc, d + 1), dtype=torch.int32)})
    adds = 3 + 1  # three hard adds, one soft (pod 3 at node 5)
    assert k18_work(aux, 2, torch.tensor([5])) == (4 + b * cc + 4 * 3 + 2 * 2 + 8 * adds,
                                                   b * cc + adds)
    assert k18_work(aux, 2, torch.tensor([-1])) == (4, 0)
    assert k18_work(aux, 2, torch.tensor([n + 7])) == k18_work(aux, 2, torch.tensor([n - 1]))
