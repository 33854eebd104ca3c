"""K11's and K12's Hopper decompositions, mirrored in numpy, against the JAX
package (exact).

The CUDA kernels run only on the card; these mirrors walk the inputs in the
kernels' own order and with their own skips, so that the decomposition —
not only the function — is held against the reference on the CPU:

* K11 ``ipa_score_combine`` (``score`` + ``normalize`` + the weighted
  floor, plugins/interpodaffinity.py:368-398): a row split into slices
  (a cluster's blocks, or one block), each slice's raw scores computed once
  — the preferred groups' terms summed in term order, then the static and
  dynamic scores — and kept for the write, its partial max and min (±inf
  where no node of the slice is feasible) merged across the slices in every
  order; total + weight · floor(100 (raw − min) / (max − min)) on feasible
  nodes, the others untouched.  On zone tables and hostname planes with
  each preferred group alone and both together; slicings that cut N
  unevenly, leave a slice empty or follow the kernel's own rule; a row with
  no feasible node, one whose feasible scores are all equal, and raw scores
  spanning the floor-boundary diffs 97 and 100.
* K12 ``ipa_update_classes`` (``update_batch_classes``,
  plugins/interpodaffinity.py:676-764): every present group's count rows
  and committer rows in one grid of (row, node tile) blocks.  Each block
  compacts the round's commits (class, clamped node), keys its row's
  committed domains in the kernel's open-addressed table (its hash, its
  sizing: at most half full), and exits where the round does not reach the
  row; a count row adds aff_total's mass once, a table's counts at the
  committed domains once, a plane's on its tile's nodes of those domains; a
  committer row compacts the classes its term matches and blocks or scores
  them on its tile's nodes of its committed domains.  Rounds of no, one and
  many commits, several in one domain, commits on a node without the key
  and with ``choice`` out of range (clamped), all four groups present, in
  both forms, at tiles that cut domains across blocks, with the commits
  compacted in one pass or several (the table then sized for the batch);
  and a tables-form
  bucket of 65536 domains (beyond one block's shared memory for a
  domain-sized array) against the port's plain version.

Tolerance: exact (every score term is an integer-valued float32 below
2^24, and the normalization is computed in the reference's order in
float32).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.framework.podbatch import identity_classes
from kubernetes_tpu_torch.kernels import interpodaffinity as K
from kubernetes_tpu_torch.perf.kernel_work import k12_inputs

from tests.test_torch_affinity import (
    HOST,
    ZONE,
    _build,
    _class_view,
    _eq,
    _ipa_index,
    _nodes,
    _problem,
    _scheduled,
    _term,
)

F32 = np.float32
MUTABLE = ("aff_cnt", "anti_cnt", "paff_cnt", "panti_cnt", "aff_total", "block_dyn",
           "score_dyn")
GROUPS = (("req_affinity", "aff"), ("req_anti_affinity", "anti"), ("pref_affinity", "paff"),
          ("pref_anti_affinity", "panti"))


def _np(taux) -> dict:
    """The port's aux as numpy arrays (mutable copies)."""
    return {f: (v.numpy().copy() if isinstance(v, torch.Tensor) else v)
            for f, v in taux._asdict().items()}


# --- K11: one pass over a row split across slices ------------------------------------------


def _group_sum(a, g: str, c: int, nodes) -> np.ndarray:
    """Σ_t weight · count over group g's terms whose domain is live, in term
    order, for row c at ``nodes``."""
    d = a["depth"]
    dom, cnt, w = a[f"dom_{g}"], a[f"{g}_cnt"], a[f"{g}_weight"]
    planes = cnt.shape[-1] == dom.shape[-1]
    s = np.zeros(len(nodes), F32)
    for t in range(dom.shape[1]):
        dv = dom[c, t, nodes]
        ct = cnt[c, t, nodes] if planes else cnt[c, t, np.minimum(dv, d)]
        term = np.where(dv < d, (ct.astype(F32) * F32(w[c, t])).astype(F32), F32(0.0))
        s = (s + term).astype(F32)
    return s


def k11_mirror(a, bits, full: int, total, weight: float, bounds, order) -> np.ndarray:
    """K11's decomposition: each row cut at ``bounds`` into slices; each
    slice's raw scores once, its partial max / min, merged in ``order`` →
    the new total."""
    present = set(a["present"])
    out = total.copy()
    w = F32(weight)
    for c in range(bits.shape[0]):
        parts = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            nodes = np.arange(lo, hi)
            own = np.zeros(len(nodes), F32)
            if "pref_affinity" in present:
                own = (own + _group_sum(a, "paff", c, nodes)).astype(F32)
            if "pref_anti_affinity" in present:
                own = (own - _group_sum(a, "panti", c, nodes)).astype(F32)
            raw = ((own + a["score_static"][c, nodes]).astype(F32)
                   + a["score_dyn"][c, nodes]).astype(F32)
            feas = bits[c, nodes] == full
            vals = raw[feas]
            parts.append(dict(nodes=nodes, raw=raw, feas=feas,
                              max=vals.max() if vals.size else F32(-np.inf),
                              min=vals.min() if vals.size else F32(np.inf)))
        mx = F32(max(parts[q]["max"] for q in order))
        mn = F32(min(parts[q]["min"] for q in order))
        diff = F32(mx - mn)
        ok = bool(np.isfinite(diff) and diff > 0)
        for part in parts:
            for x in np.flatnonzero(part["feas"]):
                o = F32(F32(F32(100.0) * F32(part["raw"][x] - mn)) / diff) if ok else F32(0.0)
                node = part["nodes"][x]
                out[c, node] = F32(out[c, node] + F32(w * F32(np.floor(o))))
    return out


def _pref_problem(form: str, groups: str):
    """30 nodes (two keyless), 40 scheduled pods, 24 pending pods with
    preferred terms only: affinity to blue (weight 5), anti-affinity to
    green (weight 3), or both; every third pod without a term."""
    rng = np.random.default_rng(16)
    key = ZONE if form == "tables" else HOST
    nodes = _nodes(30, keyless=(4, 17))
    names = [x["name"] for x in nodes]
    terms = {"paff": [_term(key, {"color": "blue"}, weight=5)],
             "panti": [_term(key, {"color": "green"}, anti=True, weight=3)]}
    terms["both"] = terms["paff"] + terms["panti"] + [_term(ZONE, {"color": "red"}, weight=2)]
    req = {"cpu": "100m", "memory": "500Mi"}
    pods = []
    for i in range(24):
        d = {"name": f"p{i:03d}", "ts": float(i), "req": req, "labels": {"color": "blue"}}
        if i % 3:
            d["pod_affinity"] = terms[groups]
        pods.append(d)
    return _build(nodes, _scheduled(rng, names, 40, key=key), pods)


def _k11_views(p):
    """The JAX and the port's prepared auxes of problem ``p``."""
    idx = _ipa_index(p["fw"])
    jaux = p["fw"].prepare(p["batch"], p["dsnap"], p["dyn"], p["host_auxes"])[idx]
    taux = p["tfw"].prepare(p["tbatch"], p["tsnap"], p["tdyn"], p["ipa_host"])[idx]
    return p["fw"].plugins[idx].plugin, jaux, taux


def _k11_reference(p, jplug, jaux, mask, total, weight):
    raw = jplug.score(p["batch"], p["dsnap"], p["dyn"], jaux)
    norm = np.asarray(jplug.normalize(raw, jnp.asarray(mask)))
    return np.where(mask, (total + F32(weight) * np.floor(norm).astype(F32)).astype(F32), total)


def _slicing(kind: str, n: int):
    if kind == "one_block":
        return [0, n]
    if kind == "uneven3":
        return [0, 11, 22, n]
    if kind == "empty_slice":
        return [0, 0, n // 2 + 1, n, n]
    # the kernel's rule: up to 8 blocks of at least 1024 nodes, S a multiple
    # of the vector width — at these sizes, 8 slices of n / 8 (as N = 8192
    # gives 8 of 1024)
    s = -(-n // 8)
    s = -(-s // 4) * 4
    return [min(r * s, n) for r in range(9)]


@pytest.fixture(scope="module", params=[(f, g) for f in ("tables", "planes")
                                        for g in ("paff", "panti", "both")],
                ids=lambda x: f"{x[0]}_{x[1]}")
def k11_problem(request):
    form, groups = request.param
    p = _pref_problem(form, groups)
    jplug, jaux, taux = _k11_views(p)
    return form, groups, p, jplug, jaux, taux


def _k11_mask(p, taux):
    """Every valid pod's row feasible on live nodes but a few, one row with
    no feasible node, one with a single feasible node (all scores equal)."""
    rng = np.random.default_rng(11)
    c, n = taux.score_dyn.shape
    valid = np.asarray(p["hbatch"].valid)
    live = np.asarray(p["tsnap"].node_valid)
    mask = valid[:, None] & live[None, :] & (rng.random((c, n)) < 0.8)
    rows = np.flatnonzero(valid)
    mask[rows[0]] = False  # no feasible node
    mask[rows[1]] = False
    mask[rows[1], np.flatnonzero(live)[3]] = True  # one node: max = min
    return mask, rows[0], rows[1]


@pytest.mark.parametrize("slicing", ["one_block", "uneven3", "empty_slice", "cluster8"])
@pytest.mark.parametrize("order", ["forward", "reverse"])
def test_k11_split_row_equals_reference(k11_problem, slicing, order):
    form, groups, p, jplug, jaux, taux = k11_problem
    full, weight = 0b1011, 2.0
    mask, empty, single = _k11_mask(p, taux)
    c, n = mask.shape
    bits = np.where(mask, full, full & ~2).astype(np.int32)
    rng = np.random.default_rng(3)
    total = np.where(mask, rng.integers(0, 400, (c, n)), -np.inf).astype(F32)
    bounds = _slicing(slicing, n)
    perm = list(range(len(bounds) - 1))
    got = k11_mirror(_np(taux), bits, full, total, weight, bounds,
                     perm if order == "forward" else perm[::-1])
    want = _k11_reference(p, jplug, jaux, mask, total, weight)
    assert np.array_equal(got.view(np.int32), want.view(np.int32)), \
        np.argwhere(got.view(np.int32) != want.view(np.int32))[:5]
    # and the port's plain version, on the same inputs
    tt = torch.from_numpy(total.copy())
    K.ipa_score_combine_plain(taux, torch.from_numpy(bits), full, tt, weight)
    assert np.array_equal(tt.numpy(), want)
    # the problem holds what the test is named for
    present = set(taux.present)
    assert ("pref_affinity" in present) == (groups in ("paff", "both"))
    assert ("pref_anti_affinity" in present) == (groups in ("panti", "both"))
    assert (taux.paff_cnt.shape[-1] == n) == (form == "planes")
    assert not mask[empty].any() and mask[single].sum() == 1
    if slicing == "empty_slice":
        assert any(lo == hi for lo, hi in zip(bounds[:-1], bounds[1:]))
    raw = np.asarray(jplug.score(p["batch"], p["dsnap"], p["dyn"], jaux))
    scored = np.flatnonzero(mask.any(axis=1) & (np.ptp(np.where(mask, raw, 0), axis=1) > 0))
    assert scored.size >= 3


@pytest.mark.parametrize("form", ["tables", "planes"])
@pytest.mark.parametrize("diff", [97, 100])
def test_k11_floor_boundary_diffs_equal_reference(form, diff):
    """Raw scores spanning [0, diff] with both ends present on every row
    (the static score set to target − own): the mirror split over 8 slices
    equals the reference, and the top node gains exactly weight · 100."""
    p = _pref_problem(form, "both")
    jplug, jaux, taux = _k11_views(p)
    c, n = taux.score_dyn.shape
    zero = jaux._replace(score_static=jnp.zeros((c, n), jnp.float32),
                         score_dyn=jnp.zeros((c, n), jnp.float32))
    own = np.asarray(jplug.score(p["batch"], p["dsnap"], p["dyn"], zero))
    rng = np.random.default_rng(diff)
    target = rng.integers(0, diff + 1, (c, n)).astype(F32)
    target[:, 0], target[:, 1] = 0.0, float(diff)
    static = (target - own).astype(F32)
    jaux = zero._replace(score_static=jnp.asarray(static))
    taux = taux._replace(score_static=torch.from_numpy(static),
                         score_dyn=torch.zeros((c, n), dtype=torch.float32))
    mask = np.ones((c, n), bool)
    full = 1
    total = np.zeros((c, n), F32)
    got = k11_mirror(_np(taux), np.ones((c, n), np.int32), full, total, 1.0,
                     _slicing("cluster8", n), list(range(8))[::-1])
    want = _k11_reference(p, jplug, jaux, mask, total, 1.0)
    assert np.array_equal(got, want)
    assert (got[:, 1] == 100.0).all() and (got[:, 0] == 0.0).all()


# --- K12: compact the commits once, key the domains, walk node tiles ----------------------


class DomainTable:
    """K12's open-addressed table of a row's committed domains: 2^lg slots,
    the key's slot (d · 0x9E3779B1 mod 2^32) >> (32 − lg), linear probing."""

    def __init__(self, lg: int):
        self.lg = lg
        self.key = [-1] * (1 << lg)
        self.val = [0] * (1 << lg)

    def _probe(self, d: int):
        h = ((d * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - self.lg)
        while self.key[h] not in (-1, d):
            h = (h + 1) & ((1 << self.lg) - 1)
        return h

    def add(self, d: int) -> None:
        h = self._probe(d)
        self.key[h] = d
        self.val[h] += 1

    def get(self, d: int) -> int:
        return self.val[self._probe(d)]

    def items(self):
        return [(k, v) for k, v in zip(self.key, self.val) if k != -1]


def _lg_for(x: int) -> int:
    lg = 1
    while (1 << lg) < 2 * x:
        lg += 1
    return lg


def k12_mirror(a, commit, choice, class_of, tile: int, chunk: int = 4096) -> dict:
    """K12's decomposition of one round, in place on ``a`` (``_np``): → the
    row slots that went past their flags, by kind."""
    c_rows, n = a["score_dyn"].shape
    d = a["depth"]
    b = len(commit)
    present = set(a["present"])
    # the commits compacted once (class, clamped node), in row order
    entries = [(int(class_of[i]), min(max(int(choice[i]), 0), n - 1))
               for i in range(b) if commit[i]]
    lg_most = _lg_for(min(b, d))
    lg = min(_lg_for(len(entries)), lg_most) if b <= chunk else lg_most
    reached = {"count": set(), "committer": set()}
    for gi, (name, g) in enumerate(GROUPS):
        if name not in present:
            continue
        dom, cnt = a[f"dom_{g}"], a[f"{g}_cnt"]
        own = {"aff": a["aff_term_cross"], "anti": a["anti_cross"], "paff": a["paff_cross"],
               "panti": a["panti_cross"]}[g]
        t_n = dom.shape[1]
        planes = cnt.shape[-1] == n
        for owner in (False, True):
            for rt in range(c_rows * t_n):
                c, t = divmod(rt, t_n)
                for n0 in range(0, n, tile):
                    if not owner and not planes and n0:
                        break  # a table row is one block's
                    if not owner and gi == 0 and not a["req_aff_valid"][c, t]:
                        break
                    flags = own[c, t] if owner else (
                        a["aff_cross_all"][c] if gi == 0 else own[c, t])
                    if not entries:
                        break
                    table = DomainTable(lg)
                    mine = 0
                    for k, node in entries:
                        if not 0 <= k < c_rows or not (k == c if owner else flags[k]):
                            continue
                        dv = int(dom[c, t, node])
                        if dv < d:
                            table.add(dv)
                            mine += 1
                    assert len(table.items()) <= (1 << lg) // 2
                    if not mine:
                        break  # the round does not reach this row
                    nodes = np.arange(n0, min(n0 + tile, n))
                    if not owner:
                        reached["count"].add((gi, rt))
                        if gi == 0 and n0 == 0:
                            a["aff_total"][c] += mine
                        if not planes:
                            for k, v in table.items():
                                cnt[c, t, k] += v
                            break
                        for node in nodes:
                            dv = int(dom[c, t, node])
                            cnt[c, t, node] += table.get(dv) if dv < d else 0
                        continue
                    js = np.flatnonzero(flags)
                    if not js.size:
                        break
                    reached["committer"].add((gi, rt))
                    w = F32(0.0) if gi == 1 else F32(
                        a["hard_weight"] if gi == 0 else a[f"{g}_weight"][c, t])
                    sign = F32(-1.0) if gi == 3 else F32(1.0)
                    for node in nodes:
                        dv = int(dom[c, t, node])
                        m = table.get(dv) if dv < d else 0
                        if not m:
                            continue
                        for j in js:
                            if gi == 1:
                                a["block_dyn"][j, node] = True
                            else:
                                a["score_dyn"][j, node] = F32(
                                    a["score_dyn"][j, node] + F32(sign * F32(w * F32(m))))
    return reached


def _rounds(kind: str, rng, b: int, valid, live, keyless, n: int):
    """(commit, choice) of the rounds of scenario ``kind``."""
    def pick(k):
        return live[rng.integers(0, len(live), size=k)].astype(np.int32)

    if kind == "none":
        return [(np.zeros(b, bool), pick(b))]
    if kind == "one":
        commit = np.zeros(b, bool)
        commit[np.flatnonzero(valid)[2]] = True
        return [(commit, pick(b))]
    if kind == "many":
        return [((rng.random(b) < 0.5) & valid, pick(b)) for _ in range(3)]
    if kind == "same_domain":  # every commit on two nodes
        choice = np.where(rng.random(b) < 0.5, live[0], live[5]).astype(np.int32)
        return [(valid.copy(), choice)]
    if kind == "keyless":  # half the commits on nodes without the key
        choice = pick(b)
        choice[::2] = keyless[0]
        choice[1::4] = keyless[1]
        return [((rng.random(b) < 0.7) & valid, choice)]
    # choice out of range: clamped to [0, N − 1]
    choice = pick(b)
    choice[::3] = n + 5
    choice[1::3] = -3
    return [(valid.copy(), choice)]


@pytest.fixture(scope="module", params=[("tables", 0), ("planes", 1)],
                ids=["tables", "planes"])
def k12_problem(request):
    """The affinity problem of ``tests/test_torch_affinity.py`` (all four
    groups, the first-pod escape) at identity classes."""
    form, seed = request.param
    return form, _problem(form, seed)


@pytest.mark.parametrize("tile,chunk", [(8, 4096), (64, 4096), (8, 16)],
                         ids=["tile8", "tile64", "tile8_two_passes"])
@pytest.mark.parametrize("kind", ["none", "one", "many", "same_domain", "keyless",
                                  "out_of_range"])
def test_k12_round_walk_equals_reference(k12_problem, kind, tile, chunk):
    form, p = k12_problem
    class_of, reps = identity_classes(p["hbatch"])
    cpad = max(4, 1 << (len(reps) - 1).bit_length())
    rep_rows = np.full(cpad, reps[0], dtype=np.int32)
    rep_rows[: len(reps)] = reps
    jplug, jrep, jaux, tplug, trep, taux = _class_view(p, rep_rows)
    a = _np(taux)
    rng = np.random.default_rng(12)
    b, n = p["hbatch"].size, p["tsnap"].num_nodes
    valid = np.asarray(p["hbatch"].valid)
    live = np.asarray(p["tsnap"].node_valid).nonzero()[0]
    keyless = [p["enc"].node_rows[f"n{k:04d}"] for k in (4, 17)]
    seen = {"count": set(), "committer": set()}
    for commit, choice in _rounds(kind, rng, b, valid, live, keyless, n):
        clamped = np.clip(choice, 0, n - 1)
        u_c = jnp.zeros((cpad, n), jnp.float32).at[
            jnp.asarray(class_of), jnp.asarray(clamped)].add(jnp.asarray(commit, jnp.float32))
        jaux = jplug.update_batch_classes(jaux, u_c, p["batch"], jrep, p["dsnap"],
                                          jnp.asarray(class_of))
        got = k12_mirror(a, commit, choice, class_of, tile, chunk)
        for key in seen:
            seen[key] |= got[key]
        for f in MUTABLE:
            want = np.asarray(getattr(jaux, f))
            assert np.array_equal(a[f], want), (f, np.argwhere(a[f] != want)[:5])
        # the port's plain version takes the same round to the same state
        tplug.update_batch_classes(taux, torch.from_numpy(commit), torch.from_numpy(choice),
                                   torch.from_numpy(class_of.astype(np.int64)))
        for f in MUTABLE:
            _eq(getattr(taux, f), a[f], f)
    # the scenario reaches what it is named for
    assert len(taux.present) == 4
    assert (a["aff_cnt"].shape[-1] == n) == (form == "planes")
    if kind == "none":
        assert not seen["count"] and not seen["committer"]
    else:
        assert seen["count"] and seen["committer"]
        assert {gi for gi, _ in seen["committer"]} >= ({1, 2} if kind == "many" else set())


def test_k12_many_commits_share_a_domain_on_zone_tables():
    """Zone tables: a round's commits fold into at most three keys a row."""
    p = _problem("tables", 0)
    class_of, reps = identity_classes(p["hbatch"])
    cpad = max(4, 1 << (len(reps) - 1).bit_length())
    rep_rows = np.full(cpad, reps[0], dtype=np.int32)
    rep_rows[: len(reps)] = reps
    _, _, _, _, _, taux = _class_view(p, rep_rows)
    a = _np(taux)
    valid = np.asarray(p["hbatch"].valid)
    live = np.asarray(p["tsnap"].node_valid).nonzero()[0]
    before = a["anti_cnt"].copy()
    k12_mirror(a, valid, live[np.arange(len(valid)) % len(live)].astype(np.int32),
               class_of, 8)
    gained = (a["anti_cnt"] - before)[..., :-1]
    assert (gained > 1).any() and ((gained > 0).sum(axis=-1) <= 3).all()


@pytest.mark.parametrize("commits", ["one", "many"])
def test_k12_wide_tables_equal_plain(commits):
    """A tables-form bucket of 65536 domains (more than one block could keep
    as a domain-sized array in shared memory): the mirror equals the port's
    plain version, which equals the reference at small sizes."""
    aux, commit, choice, class_of = k12_inputs("C = 4, tables", "cpu", d=65536)
    if commits == "many":
        rng = np.random.default_rng(65536)
        commit = torch.from_numpy(rng.random(512) < 0.3)
        choice = torch.from_numpy(rng.integers(0, 5000, 512).astype(np.int32))
        class_of = torch.from_numpy(rng.integers(0, 4, 512))
    a = _np(aux)
    before = {f: a[f].copy() for f in ("aff_cnt", "score_dyn")}
    k12_mirror(a, commit.numpy(), choice.numpy(), class_of.numpy(), 4096)
    K.ipa_update_classes(aux, commit, choice, class_of)
    assert aux.depth == 65536 and aux.aff_cnt.shape[-1] == 65537
    assert aux.depth > K.MAX_SHARED_DOMAINS
    for f in MUTABLE:
        _eq(getattr(aux, f), a[f], f)
    assert all((a[f] != before[f]).any() for f in before)
