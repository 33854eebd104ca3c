"""K25's Hopper decomposition, mirrored in numpy, against the port's plain
version and the JAX package (exact).

The CUDA kernel runs only on the card; this mirror walks the [C, N] plane
in the kernel's own split.  K25 ``dra_score_into`` (DynamicResources'
``_score_plane`` + ``normalize``, floored and weighted as ``run_scores``
adds it; dra/plugin.py:127-147): a thread takes 4 consecutive nodes of
``rows`` rows (``kernel_work.k25_plan``: the fewest of 1, 2, 4, 8 that keep
the grid to one wave; one node of one row on a grid too small to fill the
card); it loads the nodes' cap and free once and each row's demand and bit
words at entry, then a row's totals only where one of its bit words is
full.  Each
feasible entry gets total + w · raw with raw = floor((((cap − free) +
demand) · 100) / max(cap, 1)) clipped to [0, 100], one correctly rounded
float32 step each; a row's four totals go out as one 16-byte store where
any entry is feasible (the others as loaded), or, where N is not a
multiple of 4 or a pointer is off 16 bytes, one store per feasible entry.

Problems: random claims (zero-demand rows, nodes without inventory,
negative free), the DeviceClaimGang path's 4-chip claims, no feasible
entry, N not a multiple of 4, rows a thread of 1, 2, 4 and 8 with C not a
multiple of them, one node a thread, weights 1 and 2, and the floor grid (capacity 1–256 ×
used 0–capacity) with its pins (used = cap = 61 → 100; used 53, cap 100 →
53).  Each against ``dra_score_into_plain`` and the JAX plugin.

Tolerance: exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.dra.plugin import DraAux as JDraAux
from kubernetes_tpu.dra.plugin import DynamicResourcesPlugin as JDRA
from kubernetes_tpu_torch.kernels.dra import dra_score_into, dra_score_into_plain
from kubernetes_tpu_torch.perf import kernel_work as KW

from tests.test_torch_dra import _claim_case, _jaux, _jsnap, _reference_term

F32 = np.float32
VEC = 4
FULL = (1 << 16) - 1


# --- the mirror ---------------------------------------------------------------------------


def k25_mirror(bits, full: int, total, cap, free, demand, weight: float, *,
               rows: int = None, nodes: int = None, vec: bool = True, stats: dict = None):
    """K25's walk over its grid → the new totals f32[C, N]; every store
    counted (a feasible entry written once, an infeasible one only inside
    a 16-byte store that writes back what it loaded).  ``rows`` / ``nodes``
    a thread default to the kernel's plan."""
    c_all, n_all = bits.shape
    plan = KW.k25_plan(c_all, n_all)
    rows = plan[0] if rows is None else rows
    nodes = plan[1] if nodes is None else nodes
    v4_ok = vec and n_all % VEC == 0 and nodes == VEC
    out = total.copy()
    writes = np.zeros((c_all, n_all), np.int64)
    st = stats if stats is not None else {}
    st.update(vec_stores=0, scalar_stores=0, totals_loaded=0, threads=0)
    for n in range(0, n_all, nodes):
        left = n_all - n
        v4 = v4_ok and left >= VEC
        js = [j for j in range(nodes) if j < left]
        # the nodes' loads, once for every row of the thread
        capf = [F32(cap[n + j]) for j in js]
        held = [F32(capf[j] - F32(free[n + j])) for j in js]
        for c0 in range(0, c_all, rows):
            st["threads"] += 1
            for c in range(c0, min(c0 + rows, c_all)):
                feas = [bits[c, n + j] == full for j in js]
                if any(feas):  # the totals only where a bit word is full
                    st["totals_loaded"] += len(js) if v4 else sum(feas)
                tt = [out[c, n + j] for j in js]
                for j in js:
                    if not feas[j]:
                        continue
                    d = int(demand[c])
                    raw = F32(0)
                    if d > 0 and cap[n + j] > 0:
                        used = F32(held[j] + F32(d))
                        q = F32(F32(used * F32(100)) / F32(max(capf[j], F32(1))))
                        raw = F32(min(max(np.floor(q), F32(0)), F32(100)))
                    tt[j] = F32(tt[j] + F32(F32(weight) * raw))
                if not any(feas):
                    continue
                if v4:
                    st["vec_stores"] += 1
                    for j in js:
                        out[c, n + j] = tt[j]
                        writes[c, n + j] += 1
                else:
                    for j in js:
                        if feas[j]:
                            st["scalar_stores"] += 1
                            out[c, n + j] = tt[j]
                            writes[c, n + j] += 1
    feasible = bits == full
    assert (writes[feasible] == 1).all()
    assert (writes[~feasible] <= 1).all()
    if not v4_ok:
        assert (writes[~feasible] == 0).all()
    return out


# --- the problems ---------------------------------------------------------------------------


def _case(seed: int, c: int, n: int, *, feasible: float = 0.7, path: bool = False):
    """A claim batch as the JAX plugin and the port's wrapper take it: the
    reference's ``_claim_case`` rows and nodes (``path``: a 4-chip claim a
    row, one 4-chip slice a node, half of them taken), a bit plane with a
    ``feasible`` share of full words, K2's totals (integers 0–400) on
    feasible entries and −inf elsewhere."""
    host, cap, alloc = _claim_case(seed, c, n)
    rng = np.random.default_rng(seed + 1)
    if path:
        host["demand"][:] = 4
        host["pinned"][:] = -1
        host["blocked"][:] = False
        cap = np.full(n, 4, np.int32)
        alloc = np.where(rng.random(n) < 0.5, 4, 0).astype(np.int32)
    bits = np.where(rng.random((c, n)) < feasible, FULL,
                    FULL & ~(1 << rng.integers(0, 16, (c, n)))).astype(np.int32)
    total = np.where(bits == FULL, rng.integers(0, 401, (c, n)).astype(F32),
                     F32(-np.inf)).astype(F32)
    return host, cap, alloc, bits, total


def _reference(host, cap, alloc, bits, total, weight):
    mask = bits == FULL
    term = _reference_term(_jaux(host, cap, alloc), _jsnap(cap), mask, weight)
    return np.where(mask, total + term, total).astype(F32)


CASES = {
    # name: (seed, C, N, case kwargs, weight, mirror kwargs)
    "random claims, C = 64": (1, 64, 200, {}, 1.0, {}),
    "random claims, weight 2": (2, 13, 120, {}, 2.0, {}),
    "the path's 4-chip claims": (3, 64, 256, dict(path=True), 1.0, {}),
    "no feasible entry": (4, 9, 64, dict(feasible=0.0), 1.0, {}),
    "all feasible": (5, 6, 64, dict(feasible=1.0), 1.0, {}),
    "N = 203": (6, 11, 203, {}, 1.0, {}),
    "bits off 16 bytes": (7, 8, 96, {}, 1.0, dict(vec=False)),
    "2 rows a thread, C = 13": (8, 13, 100, {}, 1.0, dict(rows=2)),
    "4 rows a thread, C = 30": (9, 30, 80, {}, 2.0, dict(rows=4)),
    "8 rows a thread, C = 21, N = 62": (10, 21, 62, {}, 1.0, dict(rows=8)),
    "4 nodes a thread, C = 1": (11, 1, 300, {}, 1.0, dict(nodes=4)),
    "C = 1 (one node a thread)": (12, 1, 300, {}, 1.0, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_k25_thread_walk_equals_plain_and_jax(case):
    """The mirror equals ``dra_score_into_plain`` and the reference's
    weighted, floored, normalized score bit for bit (−inf kept on
    infeasible entries), loads totals and stores only where an entry is
    feasible."""
    seed, c, n, ckw, weight, mkw = CASES[case]
    host, cap, alloc, bits, total = _case(seed, c, n, **ckw)
    free = (cap - alloc).astype(np.int32)
    st = {}
    got = k25_mirror(bits, FULL, total, cap, free, host["demand"], weight, stats=st, **mkw)
    want = dra_score_into_plain(torch.from_numpy(bits), FULL, torch.from_numpy(total.copy()),
                                torch.from_numpy(cap), torch.from_numpy(free),
                                torch.from_numpy(host["demand"]), weight).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, _reference(host, cap, alloc, bits, total, weight))
    # the wrapper on CPU tensors is the plain version
    w = dra_score_into(torch.from_numpy(bits), FULL, torch.from_numpy(total.copy()),
                       torch.from_numpy(cap), torch.from_numpy(free),
                       torch.from_numpy(host["demand"]), weight).numpy()
    assert np.array_equal(w, want)
    feasible = bits == FULL
    if feasible.any():
        assert (got[feasible] != total[feasible]).any() or not (host["demand"] > 0).any()
    else:
        assert st["vec_stores"] == st["scalar_stores"] == 0
    if case == "no feasible entry":
        assert st["totals_loaded"] == 0
    if n % VEC or mkw.get("vec") is False:
        assert st["vec_stores"] == 0
    rows, nodes = KW.k25_plan(c, n)
    rows, nodes = mkw.get("rows", rows), mkw.get("nodes", nodes)
    assert st["threads"] == -(-n // nodes) * -(-c // rows)
    if nodes == 1:
        assert st["vec_stores"] == 0


def test_k25_floor_grid_and_pins():
    """Every (used, capacity) pair with capacity 1–256 and used 0–capacity,
    one node a pair, one row of demand 1 (free = capacity − used + 1): the
    mirror's score equals the reference's, the integer floor(100 · used /
    capacity), and the pins (61, 61) → 100 and (53, 100) → 53."""
    pairs = [(u, cp) for cp in range(1, 257) for u in range(cp + 1)]
    used = np.array([u for u, _ in pairs], np.int32)
    cap = np.array([cp for _, cp in pairs], np.int32)
    free = (cap - used + 1).astype(np.int32)
    demand = np.ones(1, np.int32)
    bits = np.full((1, len(pairs)), FULL, np.int32)
    got = k25_mirror(bits, FULL, np.zeros((1, len(pairs)), F32), cap, free, demand, 1.0)[0]
    jaux = JDraAux(demand=jnp.asarray(demand), pinned=jnp.asarray(np.full(1, -1, np.int32)),
                   blocked=jnp.asarray(np.zeros(1, bool)), free=jnp.asarray(free))
    want = np.asarray(JDRA().score(None, _jsnap(cap), None, jaux))[0]
    assert np.array_equal(got, want)
    assert np.array_equal(got, (used.astype(np.int64) * 100 // cap).astype(F32))
    at = {p: k for k, p in enumerate(pairs)}
    assert got[at[(61, 61)]] == 100.0 and got[at[(53, 100)]] == 53.0


def test_k25_plan():
    """kernel_work.k25_plan (the copy of score_plan): 4 nodes of one row a
    thread while C · ceil(N / 4) threads fit one wave of 132 SMs × 2048,
    then 2, 4, 8 rows; one node of one row where C · ceil(N / 4) is under
    132 × 256.  The path's C = 64 at N = 8192 takes (1, 4), the harness's
    C = 512 (4, 4), the scan's C = 1 and the floor grid (1, 1)."""
    assert KW.k25_plan(64, 8192) == (1, 4)
    assert KW.k25_plan(512, 8192) == (4, 4)
    assert KW.k25_plan(1, 8192) == (1, 1) and KW.k25_plan(1, 33152) == (1, 1)
    assert KW.k25_plan(4096, 8192) == (8, 4) and KW.k25_plan(10 ** 6, 8192) == (8, 4)
    for c in (17, 63, 64, 129, 130, 300, 1000):
        r, v = KW.k25_plan(c, 8192)
        assert v == 4
        assert -(-c // r) * 2048 <= 132 * 2048 or r == 8
        assert r == 1 or -(-c // (r // 2)) * 2048 > 132 * 2048


def test_k25_work_counts_feasible_totals():
    """K25's bound: the bit plane read, each feasible entry's total read and
    written, cap / free and demand once; six float32 operations a scored
    entry (feasible, with demand, on a node with inventory)."""
    bits = torch.tensor([[FULL, 0, FULL], [FULL, FULL, 1]], dtype=torch.int32)
    cap = torch.tensor([4, 0, 2], dtype=torch.int32)
    demand = torch.tensor([1, 0], dtype=torch.int32)
    c, n = bits.shape
    # feasible: (0,0), (0,2), (1,0), (1,1); scored: (0,0), (0,2) (row 1 has
    # no demand)
    args = (bits, FULL, torch.zeros((c, n)), cap, torch.zeros(n, dtype=torch.int32), demand,
            1.0)
    assert KW.k25_work(*args) == (4 * c * n + 8 * 4 + 8 * n + 4 * c, 6 * 2)
