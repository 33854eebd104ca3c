"""K17's Hopper decomposition, mirrored in numpy, against the JAX package
(exact).

The CUDA kernel runs only on the card; this mirror walks its inputs in the
kernel's own order, so that the decomposition — not only the function — is
held against the reference on the CPU:

* K17 ``scan_select_assume`` (``select_host``,
  framework/runtime.py:299-308, and greedy_assign's step, :358-393, with
  the resource half of ``_apply_dynamic``, :434-438): the row split into
  CL slices (the kernel's plan, ``kernel_work.k17_plan`` — the fewest
  blocks, a power of two up to 8, of at most 1024 nodes, S a multiple of 4
  — and CL = 1, 2, 4, 8 besides);
  in a slice thread t takes the 4-wide vectors t, t + T, … and threads
  below N mod 4 the last slice's scalar tail (or every node scalar: an
  unaligned row); each thread folds (count, value, noise, row) in the
  order value descending, noise descending, row ascending; a warp merges
  by a butterfly, the block's warps by one more, the slices' partials in
  the leader — and here also in every order.  Keyless against
  ``select_host(…, key=None)`` and keyed against ``select_host`` with
  ``jax.random`` keys (the same uniform row in the mirror), at N = 1, 31,
  5000 and 8191: ties straddling slice boundaries and vector tails, equal
  noise on tied rows in different slices (found under real keys), a +0.0 /
  −0.0 tie, an all-infeasible (all −inf) row, all-tied and random rows.
  Then the whole step through the JAX package's ``greedy_assign`` (a static
  plugin whose filter and score are the rows given): a feasible and an
  infeasible nominated row, one past the bucket, a padding pod, an
  all-infeasible pod; node rows, feasible counts and the assumed
  requested / non_zero equal the reference's, keyless and keyed, and so
  does the port's plain version on the same rows (keyed, under the step
  keys of the same key).  Last, K17's bound (``kernel_work.k17_work``)
  counts only the cells a step needs, keyed a threefry a node.

Tolerance: exact (only compares and integer adds).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.framework.interface import DynamicState as JDyn
from kubernetes_tpu.framework.interface import PluginWithWeight
from kubernetes_tpu.framework.runtime import BatchedFramework as JFramework
from kubernetes_tpu_torch.kernels.scan import scan_select_assume
from kubernetes_tpu_torch.kernels.tie_noise import tie_split
from kubernetes_tpu_torch.perf.kernel_work import THREEFRY_OPS, k17_plan, k17_tie_rows, k17_work

FULL = 0b1111111
INF = float("inf")
SIZES = (1, 31, 5000, 8191)


# --- the mirror ----------------------------------------------------------------------------


def none(n: int) -> tuple:
    return (0, -INF, -1.0, n)


def beats(b, a, keyed: bool) -> bool:
    if b[1] != a[1]:
        return b[1] > a[1]
    if keyed and b[2] != a[2]:
        return b[2] > a[2]
    return b[3] < a[3]


def merge(a, b, keyed: bool) -> tuple:
    w = b if beats(b, a, keyed) else a
    return (a[0] + b[0], w[1], w[2], w[3])


def butterfly(parts: list, keyed: bool) -> list:
    """A warp's xor-shuffle merge: every lane ends with the warp's partial."""
    for off in (16, 8, 4, 2, 1):
        parts = [merge(parts[l], parts[l ^ off], keyed) for l in range(32)]
    return parts


def slice_partial(bits, total, noise, lo: int, hi: int, n: int, vec: int, nt: int,
                  keyed: bool) -> tuple:
    """One block of the cluster over the nodes [lo, hi): thread t folds the
    vectors t, t + nt, … and threads below the tail its scalars; the warps
    merge by butterflies, then warp 0 over the warps' partials."""
    lanes = [none(n)] * nt

    def fold(p, node):
        m = int(bits[node]) == FULL
        q = (0, float(total[node]) if m else -INF,
             float(noise[node]) if keyed else -1.0, node)
        w = q if beats(q, p, keyed) else p
        return (p[0] + m, w[1], w[2], w[3])

    nvec = (hi - lo) // vec
    for v in range(nvec):
        for e in range(vec):
            lanes[v % nt] = fold(lanes[v % nt], lo + v * vec + e)
    for t, node in enumerate(range(lo + nvec * vec, hi)):
        lanes[t] = fold(lanes[t], node)
    warps = [butterfly(lanes[w:w + 32], keyed)[0] for w in range(0, nt, 32)]
    return butterfly(warps + [none(n)] * (32 - len(warps)), keyed)[0]


def partials(bits, total, noise, keyed: bool, cl: int = None, vec: int = 4) -> list:
    n = len(bits)
    cl, s, nt = k17_plan(n, vec, cl)
    out = []
    for r in range(cl):
        lo = min(r * s, n)
        out.append(slice_partial(bits, total, noise, lo, min(lo + s, n), n, vec, nt, keyed))
    return out


def leader_merge(parts: list, n: int, keyed: bool) -> tuple:
    """The leader's warp 0 over the CL pushed partials (lanes past CL: none)."""
    return butterfly(parts + [none(n)] * (32 - len(parts)), keyed)[0]


def k17_mirror(bits, total, i: int, nominated, valid, request, pod_nz, requested, node_nz,
               node_row, feasible_count, noise=None, cl: int = None, vec: int = 4) -> None:
    """One K17 step in place on numpy arrays: the row's partial from the
    decomposition, then the nominated path, the infeasible and padding
    rules and the assume."""
    n = len(bits)
    keyed = noise is not None
    c, _v, _z, best = leader_merge(partials(bits, total, noise, keyed, cl, vec), n, keyed)
    nom = int(nominated[i])
    nomc = min(max(nom, 0), n - 1)
    node = nomc if nom >= 0 and int(bits[nomc]) == FULL else best
    if c == 0:
        node = 0
    placed = c > 0 and bool(valid[i])
    node_row[i] = node if placed else -1
    feasible_count[i] = c
    if placed:
        requested[node] += request[i]
        node_nz[node] += pod_nz[i]


# --- select_host --------------------------------------------------------------------------


def _jkey(seed: int):
    return jax.random.PRNGKey(seed)


def equal_noise_pair(n: int) -> tuple:
    """(seed, a, b): the first PRNGKey(seed) whose uniform row of n draws
    holds an equal pair a < b in different slices of the kernel's plan."""
    _cl, s, _t = k17_plan(n)
    for seed in range(64):
        z = np.asarray(jax.random.uniform(_jkey(seed), (n,)))
        order = np.argsort(z, kind="stable")
        same = np.nonzero(z[order][1:] == z[order][:-1])[0]
        for k in same:
            a, b = sorted((int(order[k]), int(order[k + 1])))
            if a // s != b // s:
                return seed, a, b
    raise AssertionError(f"no equal noise pair across slices at N = {n}")


def select_case(kind: str, n: int, seed: int = 3):
    """(bits, total, key seed or None, the rows the case is about) for
    ``kind``; totals integer floats, -inf off the mask."""
    rng = np.random.default_rng(seed + n)
    feas = rng.random(n) < 0.7
    total = rng.integers(0, 400, n).astype(np.float32)
    rows, key = [], None
    if kind == "ties across slices":
        rows = k17_tie_rows(n)
        feas[rows], total[rows] = True, 999.0
    elif kind == "plus and minus zero":
        feas[0] = True
        total = np.where(np.arange(n) % 2 == 0, np.float32(-0.0), np.float32(0.0))
    elif kind == "all infeasible":
        feas[:] = False
    elif kind == "all tied":
        total[:] = 250.0
    elif kind == "equal noise across slices":
        key, a, b = equal_noise_pair(n)
        rows = [a, b]
        feas[rows], total[rows] = True, 999.0
    bits = np.where(feas, FULL, FULL & ~(1 << rng.integers(0, 7, n))).astype(np.int32)
    total = np.where(feas, total, -np.inf).astype(np.float32)
    return bits, total, key, rows


SELECT_KINDS = ("ties across slices", "plus and minus zero", "all infeasible", "all tied",
                "random")
# (kind, N, keyed)
SELECT_CASES = [(k, n, keyed) for k in SELECT_KINDS for n in SIZES for keyed in (False, True)]
SELECT_CASES += [("equal noise across slices", n, True) for n in (5000, 8191)]
# slicings: the kernel's plan with vectors, its scalar form (an unaligned
# row), and other cluster sizes
SLICINGS = {"plan": (None, 4), "plan, scalar": (None, 1), "CL = 1": (1, 4),
            "CL = 2": (2, 4), "CL = 4": (4, 4), "CL = 8": (8, 1)}


@pytest.fixture(scope="module")
def select_refs():
    """(bits, total, noise or None, the reference's node, the case's rows) by
    case, the node from the JAX package's select_host."""
    out = {}
    for kind, n, keyed in SELECT_CASES:
        bits, total, key, rows = select_case(kind, n)
        mask = bits == FULL
        noise, jkey = None, None
        if keyed:
            jkey = _jkey(key if key is not None else 7 + n)
            noise = np.asarray(jax.random.uniform(jkey, (n,)))
        want = int(JFramework.select_host(jnp.asarray(total), jnp.asarray(mask), jkey))
        out[kind, n, keyed] = (bits, total, noise, want, rows)
    return out


@pytest.mark.parametrize("slicing", list(SLICINGS))
@pytest.mark.parametrize("case", SELECT_CASES, ids=lambda c: f"{c[0]}-N{c[1]}-"
                         + ("keyed" if c[2] else "keyless"))
def test_k17_split_row_equals_select_host(select_refs, case, slicing):
    bits, total, noise, want, rows = select_refs[case]
    kind, n, keyed = case
    cl, vec = SLICINGS[slicing]
    c, _v, _z, got = leader_merge(partials(bits, total, noise, keyed, cl, vec), n, keyed)
    assert c == int((bits == FULL).sum())
    assert got == want, (kind, n, keyed, slicing, got, want)
    if kind in ("ties across slices", "equal noise across slices") and not keyed or \
            kind == "equal noise across slices":
        assert want == rows[0]  # the lowest of the tied rows
    if kind == "plus and minus zero" and not keyed:
        assert want == 0  # -0.0 at row 0 ties +0.0: the first maximum


@pytest.mark.parametrize("case", [c for c in SELECT_CASES if c[1] >= 5000],
                         ids=lambda c: f"{c[0]}-N{c[1]}-" + ("keyed" if c[2] else "keyless"))
def test_k17_slice_partials_merge_in_every_order(select_refs, case):
    """The slices' partials merged in every order of the kernel's plan (8
    slices at these N: all 40320 orders) give the reference's node."""
    bits, total, noise, want, _rows = select_refs[case]
    _kind, n, keyed = case
    parts = partials(bits, total, noise, keyed)
    results = set()
    for perm in itertools.permutations(parts):
        acc = none(n)
        for p in perm:
            acc = merge(acc, p, keyed)
        results.add((acc[0], acc[3]))
    assert results == {(int((bits == FULL).sum()), want)}


def test_k17_plan_splits_as_the_kernel_does():
    plan = {n: k17_plan(n)[:2] for n in (1, 31, 1024, 1025, 5000, 8191, 8192, 100000)}
    assert plan[1] == (1, 4) and plan[31] == (1, 32) and plan[1024] == (1, 1024)
    assert plan[1025] == (2, 516) and plan[5000] == (8, 628) and plan[8191] == (8, 1024)
    assert plan[8192] == (8, 1024) and plan[100000] == (8, 12500)
    assert k17_plan(8192)[2] == 256 and k17_plan(5000)[2] == 160
    assert k17_plan(8192, 1)[2] == 1024 and k17_plan(1)[2] == 32
    assert k17_tie_rows(8191) == [1023, 1024, 2047, 2048, 3071, 3072, 4095, 4096, 5119, 5120,
                              6143, 6144, 7167, 7168, 8187, 8188, 8190]


@pytest.mark.parametrize("keyed", [False, True], ids=["keyless", "keyed"])
@pytest.mark.parametrize("kind", ["three tied maxima", "all infeasible", "nominated padding"])
def test_k17_work_counts_only_what_the_step_needs(kind, keyed):
    """K17's bound reads the bit row whole, the total only on feasible nodes
    and, keyed, the step's 8-byte key, with a threefry at each tied maximum
    where the placed pod's node is the draw's;
    the assume's rows only when the pod is placed."""
    n, b, r, i = 64, 4, 3, 2
    bits = torch.full((1, n), FULL & ~2, dtype=torch.int32)
    total = torch.full((1, n), -INF)
    feas = list(range(0, 40, 4))  # 10 feasible nodes, 3 of them at the maximum
    if kind != "all infeasible":
        bits[0, feas] = FULL
        total[0, feas] = torch.tensor([5.0, 9.0, 1.0, 9.0, 2.0, 9.0, 0.0, 3.0, 4.0, -0.0])
    nominated = torch.full((b,), -1, dtype=torch.int32)
    valid = torch.ones(b, dtype=torch.bool)
    if kind == "nominated padding":
        nominated[i], valid[i] = 8, False
    keys = tie_split((0, 7), b, "cpu") if keyed else None
    got, ops = k17_work(bits, FULL, total, i, nominated, valid,
                        torch.zeros((b, r), dtype=torch.int32), keys)
    n_feas = 0 if kind == "all infeasible" else 10
    want = 4 * n + 4 * n_feas + 4 + 1 + 8
    want += 8 if keyed else 0
    want += 4 if kind == "nominated padding" else 0
    want += 4 * (r + 2) * 3 if kind == "three tied maxima" else 0
    # keyed, a threefry and the noise compare at each of the three tied 9s
    # where the pod is placed; the other two pods' nodes are not the draws'
    ties = 3 if kind == "three tied maxima" else 0
    want_ops = 3 * n + (ties * (THREEFRY_OPS + 1) if keyed else 0)
    assert (got, ops) == (want, want_ops)


# --- the whole step through the reference's greedy_assign ----------------------------------


class _Batch(NamedTuple):
    valid: object
    request: object
    non_zero: object
    nominated_row: object


class _Snap(NamedTuple):
    node_valid: object


class _RowsPlugin:
    """A static plugin whose filter and score planes are the given rows
    (identity normalize): greedy_assign's row is then exactly them."""

    name = "Rows"
    dynamic = False

    def __init__(self, mask, raw):
        self.mask, self.raw = mask, raw

    def filter(self, batch, snap, dyn, aux):
        return self.mask

    def score(self, batch, snap, dyn, aux):
        return self.raw

    def normalize(self, plane, mask):
        return plane


STEP_KINDS = ("ties across slices", "padding pod", "all infeasible", "nominated feasible",
              "nominated infeasible", "nominated past the bucket", "all tied", "random")
R = 4


def step_problem(n: int, seed: int = 5):
    """A batch of one pod per STEP_KINDS over n nodes (all live)."""
    rng = np.random.default_rng(seed + n)
    b = len(STEP_KINDS)
    mask = rng.random((b, n)) < 0.7
    raw = rng.integers(0, 400, (b, n)).astype(np.float32)
    valid = np.ones(b, bool)
    nominated = np.full(b, -1, np.int32)
    for i, kind in enumerate(STEP_KINDS):
        if kind == "ties across slices":
            rows = k17_tie_rows(n)
            mask[i, rows], raw[i, rows] = True, 999.0
        elif kind == "padding pod":
            valid[i] = False
        elif kind == "all infeasible":
            mask[i] = False
        elif kind == "nominated feasible":
            nominated[i] = n // 2
            mask[i, n // 2] = True
        elif kind == "nominated infeasible":
            nominated[i] = n // 2
            mask[i, n // 2] = False
        elif kind == "nominated past the bucket":
            nominated[i] = n + 3
            mask[i, n - 1] = True
        elif kind == "all tied":
            raw[i] = 250.0
    return dict(mask=mask, raw=raw, valid=valid, nominated=nominated,
                request=rng.integers(0, 3000, (b, R)).astype(np.int32),
                pod_nz=rng.integers(0, 3000, (b, 2)).astype(np.int32),
                requested=rng.integers(0, 4000, (n, R)).astype(np.int32),
                node_nz=rng.integers(0, 4000, (n, 2)).astype(np.int32))


@pytest.fixture(scope="module", params=[(n, keyed) for n in (1, 31, 5000)
                                        for keyed in (False, True)],
                ids=lambda p: f"N{p[0]}-" + ("keyed" if p[1] else "keyless"))
def step_ref(request):
    """The problem, the reference's greedy_assign result and, keyed, each
    scan position's noise row (uniform(split(key, B)[k], [N]))."""
    n, keyed = request.param
    p = step_problem(n)
    b = len(STEP_KINDS)
    fw = JFramework([PluginWithWeight(_RowsPlugin(jnp.asarray(p["mask"]),
                                                  jnp.asarray(p["raw"])), 1)])
    batch = _Batch(jnp.asarray(p["valid"]), jnp.asarray(p["request"]),
                   jnp.asarray(p["pod_nz"]), jnp.asarray(p["nominated"]))
    dyn = JDyn(jnp.asarray(p["requested"]), jnp.asarray(p["node_nz"]))
    key = _jkey(11) if keyed else None
    res = fw.greedy_assign(batch, _Snap(jnp.ones(n, bool)), dyn, (None,), jnp.arange(b),
                           key=key)
    noise = [np.asarray(jax.random.uniform(k, (n,))) for k in jax.random.split(key, b)] \
        if keyed else None
    want = {"node_row": np.asarray(res.node_row), "feasible_count": np.asarray(res.feasible_count),
            "requested": np.asarray(res.dyn.requested), "node_nz": np.asarray(res.dyn.non_zero)}
    return n, p, noise, want, (0, 11) if keyed else None


def _step_rows(p, i: int):
    """Pod i's row as the port's step gives it to K17: the pass bits (the
    batch's valid flag folded in, as the reference's static mask) and the
    total, -inf off the mask."""
    m = p["mask"][i] & p["valid"][i]
    bits = np.where(m, FULL, FULL & ~2).astype(np.int32)
    return bits, np.where(m, p["raw"][i], -np.inf).astype(np.float32)


@pytest.mark.parametrize("slicing", ["plan", "plan, scalar", "CL = 2", "CL = 8"])
def test_k17_step_equals_greedy_assign(step_ref, slicing):
    n, p, noise, want, _key = step_ref
    cl, vec = SLICINGS[slicing]
    b = len(STEP_KINDS)
    requested, node_nz = p["requested"].copy(), p["node_nz"].copy()
    node_row, feas = np.full(b, -1, np.int32), np.zeros(b, np.int32)
    for k in range(b):
        bits, total = _step_rows(p, k)
        k17_mirror(bits, total, k, p["nominated"], p["valid"], p["request"], p["pod_nz"],
                   requested, node_nz, node_row, feas, None if noise is None else noise[k],
                   cl, vec)
    np.testing.assert_array_equal(node_row, want["node_row"])
    np.testing.assert_array_equal(feas, want["feasible_count"])
    np.testing.assert_array_equal(requested, want["requested"])
    np.testing.assert_array_equal(node_nz, want["node_nz"])
    kinds = dict(zip(STEP_KINDS, node_row))
    assert kinds["padding pod"] == -1 and kinds["all infeasible"] == -1
    if n > 1:
        assert kinds["nominated feasible"] == n // 2
        assert kinds["nominated past the bucket"] == n - 1
        assert kinds["ties across slices"] == k17_tie_rows(n)[0] or noise is not None


def test_k17_plain_step_equals_greedy_assign(step_ref):
    """The port's K17 on CPU tensors (its plain version), step by step on
    the same rows, equals the reference too — keyed under the step keys
    K33's split makes from the same key, step k its key row k."""
    n, p, _noise, want, key = step_ref
    b = len(STEP_KINDS)
    keys = None if key is None else tie_split(key, b, "cpu")
    t = {k: torch.from_numpy(p[k].copy()) for k in ("nominated", "valid", "request", "pod_nz",
                                                    "requested", "node_nz")}
    node_row = torch.full((b,), -1, dtype=torch.int32)
    feas = torch.zeros(b, dtype=torch.int32)
    for k in range(b):
        bits, total = _step_rows(p, k)
        scan_select_assume(torch.from_numpy(bits)[None], FULL, torch.from_numpy(total)[None],
                           k, t["nominated"], t["valid"], t["request"], t["pod_nz"],
                           t["requested"], t["node_nz"], node_row, feas,
                           *(() if keys is None else (keys, k)))
    np.testing.assert_array_equal(node_row.numpy(), want["node_row"])
    np.testing.assert_array_equal(feas.numpy(), want["feasible_count"])
    np.testing.assert_array_equal(t["requested"].numpy(), want["requested"])
    np.testing.assert_array_equal(t["node_nz"].numpy(), want["node_nz"])
