"""K19's and K7's Hopper decompositions, mirrored in numpy, against the JAX
package (exact).

The CUDA kernels run only on the card; these mirrors walk the inputs in the
kernels' own order and with their own skips, so that the decomposition —
not only the function — is held against the reference on the CPU:

* K19 ``ipa_update_row`` (the reference's ``update``,
  plugins/interpodaffinity.py:447-530): blocks of node tiles over runs of
  pending rows; per row the flags first (which of j's terms gain pod i and
  at which domain, which of pod i's terms match j), pod i's same-domain
  bits staged once a block, then a walk that touches only the flagged rows
  — the planes form's compare-add on the rows that gain pod i, the tables
  form's point add once per (row, term), required anti-affinity blocks and
  the score only on nodes of pod i's term domains.  A chain of placements
  (live and keyless nodes) on a zone-tables and a hostname-planes problem
  built from ``tests/test_torch_affinity.py``'s templates (all four term
  groups present: required anti-affinity blocking, every scoring group),
  at tile and run sizes that cut domains across blocks; every aux field
  equals the reference's after each step, the cells written lie in the
  rows and domains the flags name, and a step whose ``node_row`` is −1
  changes nothing.
* K7 ``spread_score_combine`` (``score`` + ``normalize``,
  plugins/podtopologyspread.py:186-232): a row split over CL blocks, each
  with its slice's present-domain bits, raw scores and partial max / min;
  the bits and the partials merged across the slices in every order; rows
  with no soft constraint in one pass over the bits and the total.  On the
  3- and 5-zone problems of ``tests/test_torch_spread.py`` (keyless nodes,
  two constraints, constraint-free rows), a row with no feasible node (max
  and min not finite, so 0) and the count-379-under-five-domains case;
  total + weight · floor(normalize) equals the reference's.

Tolerance: exact (every value is an integer-valued float32 below 2^24, and
the normalization is computed in the reference's order in float32).
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.kernels.spread import topo_log_table

from tests.test_torch_scan import (
    HOST,
    _aff_nodes,
    _aff_scheduled,
    _aff_templates,
    _plugin,
    build,
)
from tests.test_torch_spread import (
    BLUE,
    SOFT,
    ZONE,
    _build,
    _jax_all,
    _spread_index,
    _spread_problem,
    _zone_nodes,
)

F32 = np.float32
MUTABLE = ("aff_cnt", "anti_cnt", "paff_cnt", "panti_cnt", "aff_total", "block_dyn",
           "score_dyn")


# --- K19: the node-tile walk -------------------------------------------------------------


def _np_aux(taux):
    """The port's aux as numpy arrays (mutable copies of the count state)."""
    out = {f: (v.numpy().copy() if isinstance(v, torch.Tensor) else v)
           for f, v in taux._asdict().items()}
    present = set(taux.present)
    out["groups"] = []
    for name, g, cross, weight in (
            ("req_affinity", "aff", "aff_term_cross", None),
            ("req_anti_affinity", "anti", "anti_cross", None),
            ("pref_affinity", "paff", "paff_cross", "paff_weight"),
            ("pref_anti_affinity", "panti", "panti_cross", "panti_weight")):
        t = out[f"dom_{g}"].shape[1] if name in present else 0
        w = (np.full((out["dom_aff"].shape[0], t), F32(taux.hard_weight)) if g == "aff"
             else np.ones((out["dom_anti"].shape[0], t), F32) if g == "anti"
             else out[weight])
        out["groups"].append(dict(T=t, dom=out[f"dom_{g}"], cnt=out[f"{g}_cnt"],
                                  cross=out[cross], w=w))
    return out


def k19_mirror(a, i: int, node: int, tile: int, run: int) -> dict:
    """K19's decomposition of one scan step, in place on ``a`` (``_np_aux``):
    → the cells it wrote, by plane."""
    written = {"cnt": set(), "block": set(), "score": set(), "groups": set()}
    if node < 0:
        return written  # the kernel's first read: nothing changes
    b, n = a["score_dyn"].shape
    d = a["depth"]
    gs = a["groups"]
    terms = [(gi, t) for gi, g in enumerate(gs) for t in range(g["T"])]
    for n0, j0 in itertools.product(range(0, n, tile), range(0, b, run)):
        nodes = np.arange(n0, min(n0 + tile, n))
        rows = range(j0, min(j0 + run, b))
        # (a) the run's per-row flags, before any plane is touched
        dat, own, mass = {}, {}, {}
        for j, (k, (gi, t)) in itertools.product(rows, enumerate(terms)):
            g = gs[gi]
            match = (a["aff_cross_all"][j, i] and a["req_aff_valid"][j, t]) if gi == 0 \
                else g["cross"][j, t, i]
            dv = int(g["dom"][j, t, node])
            inc = bool(match) and dv < d
            planes = g["cnt"].shape[-1] == n
            if inc and not planes and n0 == 0:
                g["cnt"][j, t, dv] += 1  # the tables form's point add, once
                written["cnt"].add((gi, j, t, dv))
            if inc and gi == 0:
                mass[j] = mass.get(j, 0) + 1
            dat[j, k] = dv if inc and planes else -1
            own[j, k] = bool(g["cross"][i, t, j])
        # (b) pod i's same-domain bits for the tile, once a block
        same = {}
        for k, (gi, t) in enumerate(terms):
            dom_i = gs[gi]["dom"][i, t]
            di = int(dom_i[node])
            same[k] = (dom_i[nodes] == di) & (di < d)
        if n0 == 0:
            for j, m in mass.items():
                a["aff_total"][j] += m
        # (c) the walk: flagged rows only
        for j in rows:
            for k, (gi, t) in enumerate(terms):
                if dat[j, k] < 0:
                    continue
                g = gs[gi]
                hit = nodes[g["dom"][j, t, nodes] == dat[j, k]]
                g["cnt"][j, t, hit] += 1
                written["cnt"].update((gi, j, t, int(x)) for x in hit)
            block = np.zeros(len(nodes), bool)
            for k, (gi, t) in enumerate(terms):
                if gi == 1 and own[j, k]:
                    block |= same[k]
            a["block_dyn"][j, nodes[block]] = True
            written["block"].update((j, int(x)) for x in nodes[block])
            touch = np.zeros(len(nodes), bool)
            for k, (gi, t) in enumerate(terms):
                if gi != 1 and own[j, k]:
                    touch |= same[k]
            for x in np.flatnonzero(touch):
                s = a["score_dyn"][j, nodes[x]]
                for gi in (0, 2, 3):
                    if gs[gi]["T"] == 0:
                        continue
                    pl = F32(0.0)
                    for k, (gk, t) in enumerate(terms):
                        if gk == gi and own[j, k] and same[k][x]:
                            pl = F32(pl + gs[gi]["w"][i, t])
                    s = F32(s - pl) if gi == 3 else F32(s + pl)
                    if pl:
                        written["groups"].add(gi)
                a["score_dyn"][j, nodes[x]] = s
                written["score"].add((j, int(nodes[x])))
    return written


def _allowed(a, i: int, node: int) -> dict:
    """Where a step may write: count rows (j, t) that gain pod i, on nodes of
    its domain; block and score cells (j, n) where a term of pod i that
    matches j has n in the domain of pod i's node."""
    d = a["depth"]
    ok = {"block": set(), "score": set(), "cnt_rows": set()}
    for gi, g in enumerate(a["groups"]):
        for t in range(g["T"]):
            dom_i = g["dom"][i, t]
            same = (dom_i == dom_i[node]) & (dom_i[node] < d)
            for j in np.flatnonzero(g["cross"][i, t]):
                ok["block" if gi == 1 else "score"].update(
                    (int(j), int(x)) for x in np.flatnonzero(same))
            match = (a["aff_cross_all"][:, i] & a["req_aff_valid"][:, t]) if gi == 0 \
                else g["cross"][:, t, i]
            for j in np.flatnonzero(match & (g["dom"][:, t, node] < d)):
                ok["cnt_rows"].add((gi, int(j), t))
    return ok


def _k19_problem(form: str):
    """30 nodes (two keyless), 40 scheduled pods with their own terms, and
    24 pending pods taking the six templates in turn — every term group
    present, the first-pod escape among them — on zone keys (tables) or
    hostname keys (planes)."""
    rng = np.random.default_rng(14)
    key = ZONE if form == "tables" else HOST
    nodes = _aff_nodes(30, keyless=(4, 17))
    names = [x["name"] for x in nodes]
    temps = _aff_templates(key)
    pods = [dict(temps[i % len(temps)], name=f"p{i:03d}", ts=float(i)) for i in range(24)]
    return build(nodes, _aff_scheduled(rng, names, 40, key=key), pods)


@pytest.fixture(scope="module", params=["tables", "planes"],
                ids=["zone_tables", "hostname_planes"])
def k19_problem(request):
    return "affinity_" + request.param, _k19_problem(request.param)


@pytest.mark.parametrize("tile,run", [(8, 3), (16, 8), (64, 1)],
                         ids=["tile8_run3", "tile16_run8", "tile64_run1"])
def test_k19_tile_walk_equals_reference(k19_problem, tile, run):
    """A chain of placements: after each, the mirror's aux equals the
    reference's, and every cell it wrote lies where the step may change."""
    kind, p = k19_problem
    jplug, jaux, tplug, taux = _plugin(p, kind)
    a = _np_aux(taux)
    rng = np.random.default_rng(14)
    live = np.asarray(p["tsnap"].node_valid).nonzero()[0]
    keyless = [p["enc"].node_rows[f"n{k:04d}"] for k in (4, 17)]
    valid = np.asarray(p["hbatch"].valid).nonzero()[0]
    seen = {"cnt": 0, "block": 0, "score": 0}
    scored_by = set()
    for step, i in enumerate(valid.tolist()):
        node = int(keyless[step % 2]) if step % 4 == 3 else int(live[rng.integers(len(live))])
        ok = _allowed(a, i, node)
        wrote = k19_mirror(a, i, node, tile, run)
        jaux = jplug.update(jaux, i, jnp.int32(node), p["batch"], p["dsnap"])
        for f in MUTABLE:
            want = np.asarray(getattr(jaux, f))
            assert np.array_equal(a[f], want), (f, step, i, node, np.argwhere(a[f] != want)[:5])
        assert wrote["block"] <= ok["block"] and wrote["score"] <= ok["score"]
        assert {(gi, j, t) for gi, j, t, _ in wrote["cnt"]} <= ok["cnt_rows"]
        for key in seen:
            seen[key] += len(wrote[key])
        scored_by |= wrote["groups"]
    # the chain reached every part of the walk, and every scoring group
    assert all(seen.values()), seen
    assert scored_by == {0, 2, 3}, scored_by
    assert len(taux.present) == 4
    assert (a["aff_cnt"].shape[-1] == a["score_dyn"].shape[1]) == (kind == "affinity_planes")


def test_k19_unplaced_step_changes_nothing(k19_problem):
    kind, p = k19_problem
    _, _, _, taux = _plugin(p, kind)
    a = _np_aux(taux)
    before = {f: a[f].copy() for f in MUTABLE}
    i = int(np.asarray(p["hbatch"].valid).nonzero()[0][0])
    assert not any(k19_mirror(a, i, -1, 8, 3).values())
    for f in MUTABLE:
        assert np.array_equal(a[f], before[f]), f


# --- K7: a row split over a cluster ------------------------------------------------------


def k7_mirror(aux, bits, full: int, total, weight: float, cl: int, order) -> np.ndarray:
    """K7's decomposition: each row split into ``cl`` slices; rows with no
    soft constraint in one pass; otherwise each slice's present bits, raw
    scores (once) and partial max / min, merged across the slices in
    ``order`` → the new total."""
    soft_valid = aux.soft_valid.numpy()
    dom_val, has_key = aux.dom_val.numpy(), aux.has_key.numpy()
    counts, max_skew = aux.soft_counts.numpy(), aux.max_skew.numpy()
    table = topo_log_table(torch.device("cpu")).numpy()
    c_rows, cc, n = dom_val.shape
    d = counts.shape[-1] - 1
    out = total.copy()
    w = F32(weight)
    bounds = np.linspace(0, n, cl + 1).astype(int)
    for c in range(c_rows):
        feas = bits[c] == full
        soft = soft_valid[c]
        if not soft.any():  # the one-pass form
            out[c, feas] = (out[c, feas] + F32(w * F32(100.0))).astype(F32)
            continue
        parts = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            sl = slice(lo, hi)
            scored = feas[sl].copy()
            for k in np.flatnonzero(soft):
                scored &= has_key[c, k, sl]
            present = [set(dom_val[c, k, sl][scored & (dom_val[c, k, sl] < d)].tolist())
                       if soft[k] else set() for k in range(cc)]
            parts.append(dict(sl=sl, scored=scored, present=present))
        # the present bits merged in the given order, then topo_size's weight
        topo = [len(set().union(*(parts[q]["present"][k] for q in order))) for k in range(cc)]
        wk = [F32(table[min(t, len(table) - 1)]) for t in topo]
        for part in parts:
            raw = np.zeros(part["scored"].shape, F32)
            for x in np.flatnonzero(part["scored"]):
                node = part["sl"].start + x
                s = F32(0.0)
                for k in range(cc):
                    dv = dom_val[c, k, node]
                    term = F32(0.0)
                    if soft[k] and dv < d:
                        term = F32(F32(F32(counts[c, k, dv]) * wk[k])
                                   + F32(F32(max_skew[c, k]) - F32(1.0)))
                    s = F32(s + term)
                raw[x] = np.rint(s)
            part["raw"] = raw
            vals = raw[part["scored"]]
            part["max"] = vals.max() if vals.size else F32(-np.inf)
            part["min"] = vals.min() if vals.size else F32(np.inf)
        mx = F32(max(parts[q]["max"] for q in order))
        mn = F32(min(parts[q]["min"] for q in order))
        mx = mx if np.isfinite(mx) else F32(0.0)
        mn = mn if np.isfinite(mn) else F32(0.0)
        for part in parts:
            for x in np.flatnonzero(feas[part["sl"]]):
                node = part["sl"].start + x
                o = F32(0.0)
                if part["scored"][x]:
                    o = F32(100.0) if mx == 0 else \
                        F32(F32(F32(100.0) * F32(F32(mx + mn) - part["raw"][x])) / mx)
                out[c, node] = F32(out[c, node] + F32(w * F32(np.floor(o))))
    return out


def _k7_cases():
    return {"3zones": lambda: _spread_problem(3, 0), "5zones": lambda: _spread_problem(5, 1),
            "count379": _count379_problem}


def _count379_problem():
    nodes = _zone_nodes(20, 5)
    zone0 = [x["name"] for x in nodes if x["labels"][ZONE] == "moon-0"]
    sched = [{"name": f"s{i:03d}", "ts": -1000.0 + i, "req": {"cpu": "1m"},
              "labels": BLUE, "node": zone0[i % len(zone0)]} for i in range(379)]
    pods = [{"name": f"p{i}", "ts": float(i), "req": {"cpu": "100m"},
             "labels": {"color": "red"}, "spread": [(1, ZONE, SOFT, BLUE, None)]}
            for i in range(4)]
    return _build(nodes, sched, pods, pad_to=8)


@pytest.fixture(scope="module", params=list(_k7_cases()))
def k7_problem(request):
    """The problem, the port's aux, the reference's mask and normalized
    score (with one soft row's mask cleared: no feasible node)."""
    p = _k7_cases()[request.param]()
    idx = _spread_index(p["fw"])
    jaux = p["fw"].prepare(p["batch"], p["dsnap"], p["dyn"], p["host_auxes"])
    taux = p["tfw"].prepare(p["tbatch"], p["tsnap"], p["tdyn"])[idx]
    j = _jax_all(p, p["batch"], jaux)
    mask = j["mask"].copy()
    soft_rows = np.flatnonzero(taux.soft_valid.numpy().any(axis=1)
                               & np.asarray(p["hbatch"].valid))
    empty = int(soft_rows[-1])
    mask[empty] = False
    jplug = p["fw"].plugins[idx].plugin
    raw = jplug.score(p["batch"], p["dsnap"], p["dyn"], jaux[idx], mask=jnp.asarray(mask))
    norm = np.asarray(jplug.normalize(raw, jnp.asarray(mask)))
    return request.param, taux, mask, norm, empty


@pytest.mark.parametrize("cl", [1, 2, 3, 8])
@pytest.mark.parametrize("order", ["forward", "reverse", "shuffled"])
def test_k7_split_row_equals_reference(k7_problem, cl, order):
    kind, taux, mask, norm, empty = k7_problem
    full, weight = 0b111, 2.0
    rng = np.random.default_rng(7)
    c, n = mask.shape
    bits = np.where(mask, full, full & ~2).astype(np.int32)
    total = np.where(mask, rng.integers(0, 400, (c, n)), -np.inf).astype(F32)
    perm = {"forward": list(range(cl)), "reverse": list(range(cl))[::-1],
            "shuffled": list(rng.permutation(cl))}[order]
    got = k7_mirror(taux, bits, full, total, weight, cl, perm)
    want = np.where(mask, (total + F32(weight) * np.floor(norm).astype(F32)).astype(F32),
                    total)
    assert np.array_equal(got.view(np.int32), want.view(np.int32)), \
        np.argwhere(got.view(np.int32) != want.view(np.int32))[:5]
    # the problem holds what the test is named for
    soft = taux.soft_valid.numpy().any(axis=1)
    assert not mask[empty].any() and soft[empty]
    assert (~soft & mask.any(axis=1)).any() or kind == "count379"
    if kind == "count379":
        fin = np.isfinite(total)
        assert (got[fin] - total[fin] == F32(weight) * 100).any()


def test_k7_one_pass_rows_equal_the_general_form(k7_problem):
    """A row with no soft constraint: the one pass (total + weight · 100 on
    feasible nodes) is what the reference's normalize gives a row of
    zeros."""
    kind, taux, mask, norm, _ = k7_problem
    soft = taux.soft_valid.numpy().any(axis=1)
    rows = np.flatnonzero(~soft & mask.any(axis=1))
    if kind == "count379":
        assert rows.size == 0
        return
    assert rows.size
    assert (norm[rows][mask[rows]] == 100.0).all()
    assert (norm[rows][~mask[rows]] == 0.0).all()
