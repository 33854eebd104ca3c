"""K17's keyed step with its draws made in the kernel, mirrored in numpy,
against the JAX package (exact).

The keyed scan step no longer reads a noise row: K17 takes the batch's step
keys and the scan position k, and draws ``uniform(keys[k], [N])`` itself.
This mirror walks a row as the kernel does (csrc/scan.cu,
``kernel_work.k17_plan``'s slices — and CL = 1 and 8 besides —, thread t of
a slice taking the 4-wide vectors t, t + T, … and threads below N mod 4
the last slice's scalar tail):

* every node drawn: u(n) = threefry2x32(key, (0, n)) → float32, written
  here in numpy from the algorithm, not from either package, folded with
  the values;
* the fold of (count, value, noise, row) in the order value descending,
  noise descending, row ascending; the warps merge by butterflies, the
  block's warps by one more, the slices' partials in the leader.

Held against ``select_host`` with a ``jax.random`` key (equal draws across
slices under a real key, all tied, an all −inf row, random rows, at N = 512
and 8191) and against ``greedy_assign`` with a key over every scan position
of a batch whose order is not the pod order (the step key is the
position's).  ``k17_work``'s keyed form is held to a hand count.

Tolerance: exact (integer threefry, compares, integer adds).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.framework.interface import DynamicState as JDyn
from kubernetes_tpu.framework.interface import PluginWithWeight
from kubernetes_tpu.framework.runtime import BatchedFramework as JFramework
from kubernetes_tpu_torch.kernels.scan import scan_select_assume, scan_select_assume_plain
from kubernetes_tpu_torch.kernels.tie_noise import tie_split
from kubernetes_tpu_torch.perf.kernel_work import THREEFRY_OPS, k17_plan, k17_work

FULL = 0b1111111
INF = float("inf")
M32 = np.uint64(0xFFFFFFFF)


# --- threefry and the uniform, from the algorithm ------------------------------------------


def threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 (20 rounds; rotations 13, 15, 26, 6 / 17, 29, 16, 24; the
    key schedule injected after every 4 rounds with its index added)."""
    ks = [np.uint64(k0), np.uint64(k1), np.uint64(k0 ^ k1 ^ 0x1BD11BDA)]
    x0 = (x0.astype(np.uint64) + ks[0]) & M32
    x1 = (x1.astype(np.uint64) + ks[1]) & M32
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    for g in range(5):
        for r in rot[g % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << np.uint64(r)) | (x1 >> np.uint64(32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & M32
        x1 = (x1 + ks[(g + 2) % 3] + np.uint64(g + 1)) & M32
    return x0, x1


def uniform_at(key, nodes) -> np.ndarray:
    """u(n) for each node: the float32 of ((x0 ^ x1) >> 9) | 0x3F800000, minus 1."""
    nodes = np.asarray(nodes, dtype=np.uint64)
    x0, x1 = threefry2x32(int(key[0]), int(key[1]), np.zeros_like(nodes), nodes)
    w = (((x0 ^ x1) >> np.uint64(9)) | np.uint64(0x3F800000)).astype(np.uint32)
    return w.view(np.float32) - np.float32(1.0)


# --- the mirror ----------------------------------------------------------------------------


def none(n: int) -> tuple:
    return (0, -INF, -1.0, n)


def beats(b, a) -> bool:
    if b[1] != a[1]:
        return b[1] > a[1]
    if b[2] != a[2]:
        return b[2] > a[2]
    return b[3] < a[3]


def merge(a, b) -> tuple:
    w = b if beats(b, a) else a
    return (a[0] + b[0], w[1], w[2], w[3])


def butterfly(parts: list) -> list:
    """A warp's xor-shuffle merge: every lane ends with the warp's partial."""
    for off in (16, 8, 4, 2, 1):
        parts = [merge(parts[l], parts[l ^ off]) for l in range(32)]
    return parts


def thread_nodes(lo: int, hi: int, vec: int, nt: int) -> list:
    """Each thread's nodes in the kernel's order: its vectors t, t + nt, …,
    then its node of the slice's scalar tail."""
    nvec = (hi - lo) // vec
    tail = lo + nvec * vec
    out = []
    for t in range(nt):
        nodes = [lo + v * vec + e for v in range(t, nvec, nt) for e in range(vec)]
        if tail + t < hi:
            nodes.append(tail + t)
        out.append(nodes)
    return out


def drawn_row(bits, total, key, cl: int = None, vec: int = 4):
    """K17's keyed row → (count, value, noise, node): per thread the count
    and the fold of its nodes, each drawn; the warps', the block's and the
    leader's merges."""
    n = len(bits)
    cl, s, nt = k17_plan(n, vec, cl)
    masked = np.where(bits == FULL, total, -np.inf).astype(np.float32)
    parts = []
    for r in range(cl):
        lo = min(r * s, n)
        hi = min(lo + s, n)
        lanes = []
        for nodes in thread_nodes(lo, hi, vec, nt):
            p = none(n)
            for m, z in zip(nodes, uniform_at(key, nodes)):
                q = (0, float(masked[m]), float(z), m)
                if beats(q, p):
                    p = q
            lanes.append((int((bits[nodes] == FULL).sum()) if nodes else 0, p[1], p[2], p[3]))
        warps = [butterfly(lanes[w:w + 32])[0] for w in range(0, nt, 32)]
        parts.append(butterfly(warps + [none(n)] * (32 - len(warps)))[0])
    return butterfly(parts + [none(n)] * (32 - len(parts)))[0]


SLICINGS = {"plan": (None, 4), "plan, scalar": (None, 1), "CL = 1": (1, 4), "CL = 8": (8, 4)}


# --- select_host with a key ----------------------------------------------------------------


def equal_noise_seed(n: int, cl: int) -> tuple:
    """(seed, a, b): the first PRNGKey(seed) whose uniform row of n draws
    holds an equal pair a < b in different slices of a CL-block plan."""
    _cl, s, _t = k17_plan(n, 4, cl)
    for seed in range(4096):
        z = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n,)))
        order = np.argsort(z, kind="stable")
        for j in np.nonzero(z[order][1:] == z[order][:-1])[0]:
            a, b = sorted((int(order[j]), int(order[j + 1])))
            if a // s != b // s:
                return seed, a, b
    raise AssertionError(f"no equal noise pair across slices at N = {n}")


def row_case(kind: str, n: int, seed: int = 7):
    """(bits, total, key seed, the rows that must win among) for ``kind``."""
    rng = np.random.default_rng(seed + n)
    feas = rng.random(n) < 0.7
    total = rng.integers(0, 400, n).astype(np.float32)
    key, rows = 100 + n, []
    if kind == "equal noise across slices":
        key, a, b = equal_noise_seed(n, 8)
        rows = [a, b]
        feas[rows], total[rows] = True, 999.0
    elif kind == "all tied":
        feas[:], total[:] = True, 250.0
    elif kind == "all -inf":
        feas[:] = False
    bits = np.where(feas, FULL, FULL & ~(1 << rng.integers(0, 7, n))).astype(np.int32)
    total = np.where(feas, total, -np.inf).astype(np.float32)
    return bits, total, key, rows


ROW_CASES = [(k, n) for k in ("equal noise across slices", "all tied", "all -inf", "random")
             for n in (512, 8191)]


@pytest.fixture(scope="module")
def row_refs():
    """Each case's row and the JAX package's select_host node under the key."""
    out = {}
    for kind, n in ROW_CASES:
        bits, total, seed, rows = row_case(kind, n)
        jkey = jax.random.PRNGKey(seed)
        want = int(JFramework.select_host(jnp.asarray(total), jnp.asarray(bits == FULL), jkey))
        out[kind, n] = (bits, total, np.asarray(jkey), want, rows)
    return out


@pytest.mark.parametrize("slicing", list(SLICINGS))
@pytest.mark.parametrize("case", ROW_CASES, ids=lambda c: f"{c[0]}-N{c[1]}")
def test_k17_drawn_row_equals_select_host(row_refs, case, slicing):
    bits, total, key, want, rows = row_refs[case]
    kind, n = case
    cl, vec = SLICINGS[slicing]
    c, _v, _z, got = drawn_row(bits, total, key, cl, vec)
    assert c == int((bits == FULL).sum())
    assert got == want, (kind, n, slicing, got, want)
    if kind == "equal noise across slices":
        assert want == rows[0]  # equal draws: the lower row
    if kind == "all tied":
        assert want == int(np.argmax(uniform_at(key, np.arange(n))))


@pytest.mark.parametrize("row", ["one candidate a thread", "ties within a thread", "all -inf"])
def test_k17_work_keyed_hand_count(row):
    """k17_work keyed on a 16-node row: the 8-byte key, the feasible
    totals, the placed pod's rows, and a threefry and a noise compare only
    where the answer depends on the draws — none on the first row (its one
    9 wins whatever its draw), three on the second (its three tied 7s),
    none on a row with no feasible node (the pod is not placed)."""
    n, r = 16, 3
    tot = {"one candidate a thread": [3, 7, 1, 2, 7, 1, 2, 0, 4, 5, 6, 9, 5, 1, 2, 3],
           "ties within a thread": [3, 7, 7, None, 7, 1, 2, 0, None, None, None, None,
                                    5, 5, 5, 5],
           "all -inf": [None] * n}[row]
    bits = torch.tensor([[FULL if x is not None else 0 for x in tot]], dtype=torch.int32)
    total = torch.tensor([[float(x) if x is not None else -INF for x in tot]])
    keys = tie_split((0, 7), 4, "cpu")
    nominated = torch.full((4,), -1, dtype=torch.int32)
    valid = torch.ones(4, dtype=torch.bool)
    request = torch.zeros((4, r), dtype=torch.int32)
    draws, n_feas = {"one candidate a thread": (0, 16), "ties within a thread": (3, 11),
                     "all -inf": (0, 0)}[row]
    got = k17_work(bits, FULL, total, 1, nominated, valid, request, keys)
    want_bytes = 4 * n + 4 * n_feas + 4 + 1 + 8 + 8 + (4 * (r + 2) * 3 if n_feas else 0)
    assert got == (want_bytes, 3 * n + draws * (THREEFRY_OPS + 1))
    assert k17_work(bits, FULL, total, 1, nominated, valid, request) == \
        (want_bytes - 8, 3 * n)


# --- the whole batch through the reference's greedy_assign ---------------------------------


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


STEP_KINDS = ("all tied", "all -inf", "random", "equal noise across slices", "nominated",
              "padding pod")
R = 4
GREEDY_SEED = 29


def batch_problem(n: int, order) -> dict:
    """A batch of one pod per STEP_KINDS over n nodes; the "equal noise"
    pod's maximum on an equal pair of draws of its scan position's key
    where that row holds one (the lowest tied row otherwise)."""
    rng = np.random.default_rng(n)
    b = len(STEP_KINDS)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(GREEDY_SEED), b))
    mask = rng.random((b, n)) < 0.7
    raw = rng.integers(0, 400, (b, n)).astype(np.float32)
    valid = np.ones(b, bool)
    nominated = np.full(b, -1, np.int32)
    for i, kind in enumerate(STEP_KINDS):
        k = int(np.nonzero(order == i)[0][0])  # pod i's scan position
        if kind == "all tied":
            mask[i], raw[i] = True, 250.0
        elif kind == "all -inf":
            mask[i] = False
        elif kind == "equal noise across slices":
            z = uniform_at(keys[k], np.arange(n))
            srt = np.argsort(z, kind="stable")
            same = np.nonzero(z[srt][1:] == z[srt][:-1])[0]
            rows = sorted(srt[same[0]:same[0] + 2]) if same.size else [0, n - 1]
            mask[i, rows], raw[i, rows] = True, 999.0
        elif kind == "nominated":
            nominated[i] = n // 3
            mask[i, n // 3] = True
        elif kind == "padding pod":
            valid[i] = False
    return dict(mask=mask, raw=raw, valid=valid, nominated=nominated, keys=keys,
                request=rng.integers(0, 3000, (b, R)).astype(np.int32),
                pod_nz=rng.integers(0, 3000, (b, 2)).astype(np.int32),
                requested=rng.integers(0, 4000, (n, R)).astype(np.int32),
                node_nz=rng.integers(0, 4000, (n, 2)).astype(np.int32))


@pytest.fixture(scope="module", params=[512, 8191], ids=lambda n: f"N{n}")
def batch_ref(request):
    """The problem, its scan order (not the pod order) and the reference's
    greedy_assign result under PRNGKey(GREEDY_SEED)."""
    n = request.param
    b = len(STEP_KINDS)
    order = np.array([3, 0, 5, 1, 4, 2])
    p = batch_problem(n, order)
    fw = JFramework([PluginWithWeight(_RowsPlugin(jnp.asarray(p["mask"]),
                                                  jnp.asarray(p["raw"])), 1)])
    batch = _Batch(jnp.asarray(p["valid"]), jnp.asarray(p["request"]),
                   jnp.asarray(p["pod_nz"]), jnp.asarray(p["nominated"]))
    dyn = JDyn(jnp.asarray(p["requested"]), jnp.asarray(p["node_nz"]))
    res = fw.greedy_assign(batch, _Snap(jnp.ones(n, bool)), dyn, (None,), jnp.asarray(order),
                           key=jax.random.PRNGKey(GREEDY_SEED))
    want = {"node_row": np.asarray(res.node_row), "feasible_count": np.asarray(res.feasible_count),
            "requested": np.asarray(res.dyn.requested), "node_nz": np.asarray(res.dyn.non_zero)}
    assert b == len(order)
    return n, order, p, want


@pytest.mark.parametrize("slicing", ["plan", "CL = 1", "CL = 8"])
def test_k17_drawn_steps_equal_greedy_assign(batch_ref, slicing):
    """Every scan position k: pod order[k]'s row (the batch's valid flag
    folded into its mask), drawn under keys[k]; then the nominated path,
    the infeasible and padding rules and the assume."""
    n, order, p, want = batch_ref
    cl, vec = SLICINGS[slicing]
    b = len(order)
    requested, node_nz = p["requested"].copy(), p["node_nz"].copy()
    node_row, feas = np.full(b, -1, np.int32), np.zeros(b, np.int32)
    for k, i in enumerate(order):
        m = p["mask"][i] & p["valid"][i]
        bits = np.where(m, FULL, FULL & ~2).astype(np.int32)
        total = np.where(m, p["raw"][i], -np.inf).astype(np.float32)
        c, _v, _z, best = drawn_row(bits, total, p["keys"][k], cl, vec)
        nom = int(p["nominated"][i])
        nomc = min(max(nom, 0), n - 1)
        node = nomc if nom >= 0 and bits[nomc] == FULL else best
        node = node if c else 0
        placed = c > 0 and bool(p["valid"][i])
        node_row[i], feas[i] = (node if placed else -1), c
        if placed:
            requested[node] += p["request"][i]
            node_nz[node] += p["pod_nz"][i]
    np.testing.assert_array_equal(node_row, want["node_row"])
    np.testing.assert_array_equal(feas, want["feasible_count"])
    np.testing.assert_array_equal(requested, want["requested"])
    np.testing.assert_array_equal(node_nz, want["node_nz"])
    kinds = dict(zip(STEP_KINDS, node_row))
    assert kinds["all -inf"] == -1 and kinds["padding pod"] == -1
    assert kinds["nominated"] == n // 3


def test_k17_step_keys_are_the_references(batch_ref):
    """The port's K33 split (its plain version here) gives the step keys
    the mirror draws under: jax.random.split's words."""
    _n, order, p, _want = batch_ref
    got = tie_split((0, GREEDY_SEED), len(order), "cpu").to(torch.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(got.numpy(), p["keys"].astype(np.int64))


@pytest.mark.parametrize("fn", [scan_select_assume, scan_select_assume_plain],
                         ids=["wrapper", "plain"])
def test_k17_keyed_step_requires_its_scan_position(fn):
    """Keys without the scan position would draw every step under row 0:
    both forms refuse them."""
    i32 = torch.int32
    args = (torch.ones((1, 3), dtype=i32), 1, torch.zeros((1, 3)), 0,
            torch.tensor([-1], dtype=i32), torch.tensor([True]), torch.ones((1, 2), dtype=i32),
            torch.ones((1, 2), dtype=i32), torch.zeros((3, 2), dtype=i32),
            torch.zeros((3, 2), dtype=i32), torch.full((1,), -1, dtype=i32),
            torch.zeros(1, dtype=i32))
    with pytest.raises(ValueError, match="scan position"):
        fn(*args, tie_split((0, 7), 2, "cpu"))
