"""K10's Hopper decomposition, mirrored in numpy, against the JAX package
(exact).

The CUDA kernel runs only on the card; this mirror walks a bit plane in the
kernel's own split and order, so that the decomposition — not only the
function — is held against the reference on the CPU.  K10
``ipa_filter_bits`` (the reference's ``InterPodAffinityPlugin.filter``,
plugins/interpodaffinity.py:337-364, written into K1's pass-bit plane): a
thread owns a run of ``FILTER_RUN`` nodes of one row; a run whose row is on
a 16-byte boundary (N a multiple of 4, the run's first element a multiple
of the run) and inside N is loaded as vectors, any other — the tail of N,
every run of an odd-N plane — one element at a time.  With a required term
every load is issued at entry:
the bits, the exist / block_dyn bytes, the row's flags and the first terms'
domains (and a plane's counts); a table's count at a node's domain is the
one dependent load, issued only where the node's bit is set and no block
fails it already, for every term and node together; terms past the first
pass take further passes.  Without a required term (the path's batch) only a
block fails a node: the block words first, the bits only where one is set.
The verdict: every valid required-affinity term
keyed and matched (or the first pod of its series), no keyed anti-affinity
term matched, no block.  The bits go back only where a node's bit clears,
a 4-node word at a time.

Problems: ``kernel_work.ipa_view`` class views — hostname planes and zone
tables, required affinity and required anti-affinity alone and together,
one to three terms a group with invalid terms among them, rows whose
aff_total is 0 with a self-match (the first pod of a series), keyless nodes
(the trash slot D: the 3192 nodes past the live 5000), blocks in the
existing-pod and dynamic planes, N = 8190 (scalar rows) and N = 8200 (rows
off a 16-node run) — against the JAX package's filter on the same arrays,
and through the port's plain version.

Tolerance: exact (booleans and integer counts).
"""

from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.plugins.interpodaffinity import IPAAux as JIPAAux
from kubernetes_tpu.plugins.interpodaffinity import InterPodAffinityPlugin as JIPA
from kubernetes_tpu_torch.kernels.interpodaffinity import (
    FILTER_RUN,
    ipa_filter_bits,
    ipa_filter_bits_plain,
)
from kubernetes_tpu_torch.perf.kernel_work import K10_CASES, ipa_view, k10_inputs, k10_work

# --- the mirror ---------------------------------------------------------------------------


def _np(taux) -> dict:
    return {f: (v.numpy().copy() if isinstance(v, torch.Tensor) else v)
            for f, v in taux._asdict().items()}


def _run(a: dict, bits, c: int, nodes, bit: int, tb: int, st: dict):
    """One run: the entry loads, at most one dependent round trip a pass,
    the verdict; without a required term the block words first and the
    bits only where a block fails; → (the new bits where a bit clears,
    else None; the nodes cleared)."""
    d = a["depth"]
    aff = "req_affinity" in a["present"]
    anti = "req_anti_affinity" in a["present"]
    ex, bd = a["exist_anti_block"][c, nodes], a["block_dyn"][c, nodes]
    if not aff and not anti:
        if not (ex | bd).any():
            return None, np.zeros(len(nodes), bool)
        st["bits_loaded"] += 1
        bw = bits[c, nodes]
        clear = (ex | bd) & (((bw >> bit) & 1) == 1)
        if not clear.any():
            return None, clear
        return np.where(clear, bw & ~np.int32(1 << bit), bw).astype(np.int32), clear
    st["bits_loaded"] += 1
    bw = bits[c, nodes]
    set_ = ((bw >> bit) & 1) == 1
    need = set_ & ~(ex | bd)
    unkeyed = np.zeros(len(nodes), bool)
    empty = np.zeros(len(nodes), bool)
    blocked = np.zeros(len(nodes), bool)
    t1 = a["dom_aff"].shape[1] if aff else 0
    t2 = a["dom_anti"].shape[1] if anti else 0
    if need.any() and (aff or anti):
        for t0 in range(0, max(t1, t2), tb):
            st["passes"] += 1
            dependent = 0
            for t in range(t0, t0 + tb):
                for g, on, tn in (("aff", aff, t1), ("anti", anti, t2)):
                    if not on or t >= tn:
                        continue
                    dom = a[f"dom_{g}"][c, t, nodes]
                    cnt = a[f"{g}_cnt"]
                    valid = bool(a["req_aff_valid"][c, t]) if g == "aff" else True
                    if cnt.shape[-1] == bits.shape[1]:
                        ct = cnt[c, t, nodes]  # loaded at entry with the domains
                    else:
                        ask = need & valid & (dom < d)
                        ct = np.where(ask, cnt[c, t, np.minimum(dom, d)], 0)
                        dependent += int(ask.sum())
                    if g == "aff" and valid:
                        unkeyed |= dom >= d
                        empty |= ct <= 0
                    if g == "anti":
                        blocked |= (dom < d) & (ct > 0)
            st["dependent_trips"] += dependent > 0
    fail = blocked
    if aff:
        first = a["aff_total"][c] == 0 and bool(a["self_match_all"][c])
        fail = fail | unkeyed | (np.zeros_like(empty) if first else empty)
    clear = (set_ & (ex | bd)) | (need & fail)
    if not clear.any():
        return None, clear
    return np.where(clear, bw & ~np.int32(1 << bit), bw).astype(np.int32), clear


def k10_mirror(a: dict, bits, bit: int, v: int = FILTER_RUN, vec: bool = True):
    """K10's walk: each row's runs of ``v`` nodes, vector or scalar form (the
    same loads one element each, all at entry) → (bits after the filter,
    stats: runs by form, passes, dependent round trips, the words stored —
    a 4-node word where vector, a node where scalar)."""
    c, n = bits.shape
    tb = 2 if max(a["dom_aff"].shape[1] if "req_affinity" in a["present"] else 0,
                  a["dom_anti"].shape[1] if "req_anti_affinity" in a["present"] else 0) > 1 \
        else 1
    out = bits.copy()
    st = {"vector_runs": 0, "scalar_nodes": 0, "passes": 0, "dependent_trips": 0,
          "words": 0, "bits_loaded": 0}
    for ci in range(c):
        for n0 in range(0, n, v):
            nodes = np.arange(n0, min(n0 + v, n))
            vector = vec and n % 4 == 0 and nodes.size == v and (ci * n + n0) % v == 0
            if vector:
                st["vector_runs"] += 1
            else:
                st["scalar_nodes"] += nodes.size
            new, clear = _run(a, bits, ci, nodes, bit, tb, st)
            if new is None:
                continue
            if not vector:
                st["words"] += int(clear.sum())
                out[ci, nodes] = new
                continue
            for q in range(v // 4):  # an int4 only where a bit clears
                if clear[4 * q:4 * q + 4].any():
                    st["words"] += 1
                    out[ci, nodes[4 * q:4 * q + 4]] = new[4 * q:4 * q + 4]
    return out, st


# --- the reference -------------------------------------------------------------------------


def _jax_filter(taux, n: int) -> np.ndarray:
    """JAX's InterPodAffinityPlugin.filter on the class view's arrays."""
    a = _np(taux)
    c, t2 = a["dom_anti"].shape[:2]
    batch = SimpleNamespace(
        valid=np.ones(c, bool), ipa_domain_bucket=a["depth"], group_present=a["present"],
        req_affinity=SimpleNamespace(valid=a["req_aff_valid"]),
        req_anti_affinity=SimpleNamespace(valid=np.ones((c, t2), bool)))
    jaux = JIPAAux(**{f: jnp.asarray(a[f]) for f in JIPAAux._fields})
    return np.asarray(JIPA().filter(batch, SimpleNamespace(num_nodes=n), None, jaux))


def _view(c: int, form: str, present, *, t: int = 1, n: int = 8192, seed: int = 10,
          invalid_terms: bool = False):
    """``ipa_view`` with blocks on 1% of the nodes in each block plane, the
    first rows' aff_total 0 (the first pod of a series, self-matching), and
    with ``invalid_terms`` a required-affinity term invalid in some rows
    (its domains at the trash slot, as the plugin's group arrays hold it)."""
    aux = ipa_view(c, form, present, "cpu", t=t, seed=seed, n=n)
    rng = np.random.default_rng(seed)
    total = aux.aff_total.clone()
    total[: max(1, c // 3)] = 0
    kw = dict(aff_total=total,
              exist_anti_block=torch.from_numpy(rng.random((c, n)) < 0.01),
              block_dyn=torch.from_numpy(rng.random((c, n)) < 0.01))
    if invalid_terms and t > 1:
        valid = aux.req_aff_valid.clone()
        valid[1::2, 1] = False
        dom = aux.dom_aff.clone()
        dom[1::2, 1] = aux.depth
        kw.update(req_aff_valid=valid, dom_aff=dom)
    return aux._replace(**kw)


def _seeded(c: int, n: int, seed: int = 3):
    """K1's bit plane: 14 filter bits, ~70% of the nodes with every one."""
    rng = np.random.default_rng(seed)
    full = (1 << 14) - 1
    return np.where(rng.random((c, n)) < 0.7, full,
                    full & ~(1 << rng.integers(0, 14, (c, n)))).astype(np.int32)


VIEWS = {
    "planes, required anti-affinity": dict(c=4, form="planes", present=("req_anti_affinity",)),
    "tables, required affinity": dict(c=4, form="tables", present=("req_affinity",)),
    "tables, both groups, 3 terms, invalid terms": dict(
        c=3, form="tables", present=("req_affinity", "req_anti_affinity"), t=3,
        invalid_terms=True),
    "planes, both groups, 2 terms": dict(c=2, form="planes",
                                         present=("req_affinity", "req_anti_affinity"), t=2),
    "planes, no required term": dict(c=4, form="planes", present=("pref_affinity",)),
    "tables, required affinity, N = 8190": dict(c=3, form="tables",
                                                present=("req_affinity",), n=8190),
    "planes, required anti-affinity, N = 8200": dict(c=3, form="planes",
                                                     present=("req_anti_affinity",), n=8200),
    "tables, required affinity, one row": dict(c=1, form="tables", present=("req_affinity",)),
}


@pytest.mark.parametrize("bit", [3, 13])
@pytest.mark.parametrize("case", list(VIEWS))
def test_k10_runs_equal_reference(case, bit):
    """The mirror's runs, the port's plain version and the JAX filter give
    the same bits; a bit clears only where JAX's filter fails on a set bit,
    and only words holding such a node are stored."""
    kw = dict(VIEWS[case])
    aux = _view(**kw)
    c, n = aux.exist_anti_block.shape
    bits = _seeded(c, n)
    ok = _jax_filter(aux, n)
    want = np.where(ok, bits, bits & ~np.int32(1 << bit)).astype(np.int32)
    got, st = k10_mirror(_np(aux), bits, bit)
    assert np.array_equal(got, want)
    plain = ipa_filter_bits_plain(aux, torch.from_numpy(bits.copy()), bit).numpy()
    assert np.array_equal(plain, want)
    wrapped = ipa_filter_bits(aux, torch.from_numpy(bits.copy()), bit).numpy()  # CPU: plain
    assert np.array_equal(wrapped, want)
    changed = got != bits
    quads = changed[:, : n // 4 * 4].reshape(c, -1, 4).any(axis=2).sum() if n % 4 == 0 else 0
    assert quads <= st["words"] <= changed.sum()
    # the runs' forms: all scalar where N is not a multiple of 4; else a row
    # off a run's boundary scalar, and the tail of N
    scalar = sum(n if n % 4 or (ci * n) % FILTER_RUN else n % FILTER_RUN for ci in range(c))
    assert st["scalar_nodes"] == scalar
    if scalar == 0:
        assert st["words"] == quads
    # one dependent round trip a pass at most
    assert st["dependent_trips"] <= st["passes"]
    # not vacuous
    assert changed.any() and not changed.all()


def test_k10_first_pod_of_a_series_passes_unmatched_nodes():
    """A row whose aff_total is 0 and whose pod matches its own terms passes
    every keyed node, matched or not; a row with aff_total > 0 fails the
    unmatched ones; both fail the keyless nodes."""
    aux = _view(2, "tables", ("req_affinity",))
    total = aux.aff_total.clone()
    total[0], total[1] = 0, 5
    aux = aux._replace(aff_total=total, exist_anti_block=torch.zeros((2, 8192), dtype=torch.bool),
                       block_dyn=torch.zeros((2, 8192), dtype=torch.bool))
    bits = np.full((2, 8192), 0b1111, np.int32)
    got, _st = k10_mirror(_np(aux), bits, 3)
    ok = _jax_filter(aux, 8192)
    assert np.array_equal(got, np.where(ok, bits, bits & ~np.int32(8)))
    keyed = (aux.dom_aff[:, 0] < aux.depth).numpy()
    assert ok[0][keyed[0]].all() and not ok[0][~keyed[0]].any()
    assert not ok[1][keyed[1]].all() and ok[1][keyed[1]].any()
    assert not ok[1][~keyed[1]].any()


@pytest.mark.parametrize("label", [k for k, v in K10_CASES.items() if v[0] <= 4])
def test_k10_timing_cases_equal_reference(label):
    """kernel_ab.py's and chip_smoke.py's K10 cases (C = 1 and 4; the C =
    512 ones are the same views with more rows) through the mirror equal the
    JAX filter."""
    aux, bits, bit = k10_inputs(label, "cpu")
    n = bits.shape[1]
    ok = _jax_filter(aux, n)
    b = bits.numpy()
    want = np.where(ok, b, b & ~np.int32(1 << bit)).astype(np.int32)
    got, _st = k10_mirror(_np(aux), b, bit)
    assert np.array_equal(got, want)
    # the path's batch (no required term, no block) clears nothing and reads
    # no bit; the rest clear some
    path = K10_CASES[label][2] == ("pref_affinity",)
    assert np.array_equal(got, b) == path
    assert (_st["bits_loaded"] == 0) == path


def test_k10_work_counts_terms_and_failing_bits():
    """K10's bound: both block planes; with required affinity its row flags,
    each valid term row's domains and its counts once per keyed domain
    (tables) or keyed node (planes); with required anti-affinity each term
    row with a keyed node the same; the bits read where the filter fails and
    written where it fails on a set bit."""
    c, n, d = 2, 6, 3
    aff_dom = torch.tensor([[[0, 1, 3, 0, 1, 1]], [[3, 3, 3, 3, 3, 3]]], dtype=torch.int32)
    aff_cnt = torch.tensor([[[1, 0, 2, 5]], [[0, 0, 0, 0]]], dtype=torch.int32)  # tables
    anti_dom = torch.full((c, 1, n), d, dtype=torch.int32)
    anti_dom[1, 0, :2] = 2
    anti_cnt = torch.tensor([[[0, 0, 0, 0]], [[0, 0, 1, 0]]], dtype=torch.int32)
    aux = SimpleNamespace(
        depth=d, present=("req_affinity", "req_anti_affinity"),
        dom_aff=aff_dom, aff_cnt=aff_cnt, dom_anti=anti_dom, anti_cnt=anti_cnt,
        req_aff_valid=torch.tensor([[True], [False]]),
        aff_total=torch.tensor([3, 0], dtype=torch.int32),
        self_match_all=torch.tensor([True, True]),
        exist_anti_block=torch.zeros((c, n), dtype=torch.bool),
        block_dyn=torch.zeros((c, n), dtype=torch.bool))
    bits = torch.full((c, n), 0b1000, dtype=torch.int32)
    # row 0: domains {0, 1} keyed (2 table reads); node 2 keyless fails, nodes
    # 1, 4, 5 (domain 1, count 0) fail; row 1: its affinity term invalid, its
    # anti-affinity term keyed at nodes 0-1 (domain 2, count 1) fails them
    fail = 4 + 2
    set_fail = fail  # every failing node has bit 3 set
    want = (2 * c * n                      # the block planes
            + 2 + 8 + 2                    # req_aff_valid, aff_total, self_match
            + 4 * n * 1 + 4 * 2            # row 0's domain row, its 2 keyed domains
            + 4 * n * 1 + 4 * 1            # row 1's anti row, its 1 keyed domain
            + 4 * fail + 4 * set_fail)
    assert k10_work(aux, bits, 3) == (want, 2 * c * n + 2 * 2 * n)
