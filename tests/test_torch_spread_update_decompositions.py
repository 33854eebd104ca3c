"""K8's Hopper decomposition, mirrored in numpy, against the JAX package
(exact).

The CUDA kernel runs only on the card; this mirror walks a round's inputs
in the kernel's own order and with its own split, so that the
decomposition — not only the function — is held against the reference on
the CPU.  K8 ``spread_update_classes`` (the reference's
``update_batch_classes``, plugins/podtopologyspread.py:341-364, and at
identity classes ``update_batch``, :366-388): a thread owns a (pod, class
constraint row), a warp 32 consecutive pods of one row; its first round
trip reads the pod's commit flag, class (int64; the wrapper widens an
int32 ``class_of`` first) and node together
(a warp with no committed pod stops there); a committed pod's second round
trip reads the row's match byte at its class, the row's domain at its
(clipped) node and the class row's counted flags there; then a lone adding
lane adds 1, and where more lanes add, the warp's adds to one (table,
domain) are summed by their lowest lane into one add.
The adds are integer adds, so they are exact in any order and in any
grouping: one add a lane, the warp's sums (the kernel's), or a block's
sums (a shared-memory form).

Problems: the 3-zone cluster of ``tests/test_torch_spread.py`` at
class granularity (their identity classes, the reference's u_c built as its
runtime builds it, ``jnp.clip`` on the node), and synthetic class views
with keyless nodes (the trash slot D), ``counted_hard`` ≠
``counted_soft``, choices beyond N − 1 and uncommitted pods, every commit
in one domain, Cc of 1 and of ``MAX_CONSTRAINTS``, ``class_of`` in int64
and in int32 — against ``update_batch_classes``, and at identity classes
(Cp = B) against ``update_batch`` on the commit one-hot (whose nodes the
reference does not clip: there every committed choice is a node row).
Each round also runs through the port's plain version at ``device="cpu"``.

Tolerance: exact (integer tables).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.framework.podbatch import identity_classes
from kubernetes_tpu.plugins.podtopologyspread import PodTopologySpreadPlugin as JSpread
from kubernetes_tpu.plugins.podtopologyspread import TSAux as JTSAux
from kubernetes_tpu_torch.kernels.spread import MAX_CONSTRAINTS, spread_update_classes
from kubernetes_tpu_torch.perf.kernel_work import k8_work
from kubernetes_tpu_torch.plugins.podtopologyspread import TSAux as TTSAux

from tests.test_torch_spread import _spread_index, _spread_problem

UPDATE_THREADS = 256  # csrc/spread.cu: a block's pods
WARP = 32


# --- the mirror ---------------------------------------------------------------------------


def k8_adds(a: dict, commit, choice, class_of) -> list:
    """K8's walk of one round over its grid: (block, warp, table, row,
    domain) per lane's add, in launch order.  Block (x, row): 256
    consecutive pods of one row; each warp first loads its 32 pods' three
    inputs and stops where none committed; a committed pod then loads the
    row's match byte, domain and counted flags together, and adds where the
    row matches and the node counts."""
    c, cc, cp = a["match_pending"].shape
    n = a["dom_val"].shape[-1]
    b = commit.shape[0]
    match = a["match_pending"].reshape(c * cc, cp)
    dom = a["dom_val"].reshape(c * cc, n)
    out = []
    for r in range(c * cc):
        for w0 in range(0, b, WARP):
            lanes = range(w0, min(w0 + WARP, b))
            first = [(i, bool(commit[i]), int(class_of[i]), int(choice[i]))
                     for i in lanes]  # round trip 1
            if not any(com for _i, com, _k, _ch in first):
                continue
            for i, com, k, ch in first:
                if not com:
                    continue
                node = min(max(ch, 0), n - 1)  # the reference clips the node row
                m, dv = bool(match[r, k]), int(dom[r, node])  # round trip 2
                h = bool(a["counted_hard"][r // cc, node])
                s_ = bool(a["counted_soft"][r // cc, node])
                for f, on in (("hard_counts", m and h), ("soft_counts", m and s_)):
                    if on:
                        out.append((i // UPDATE_THREADS, i // WARP, f, r, dv))
    return out


def k8_apply(a: dict, adds: list, order: str, grouping: str, seed: int = 8) -> None:
    """The adds into the tables in place, in ``order`` (forward, reverse,
    shuffled) and ``grouping``: "lane" (one add a lane), "warp" (the
    kernel's: each warp's adds summed per (table, row, domain), one add a
    sum) or "block" (each block's, as a shared-memory form would)."""
    if order == "reverse":
        adds = adds[::-1]
    elif order == "shuffled":
        adds = [adds[j] for j in np.random.default_rng(seed).permutation(len(adds))]
    c, cc, d1 = a["hard_counts"].shape
    flat = {f: a[f].reshape(c * cc, d1) for f in ("hard_counts", "soft_counts")}
    part = {}
    for blk, warp, f, r, dv in adds:
        key = {"lane": (len(part),), "warp": (warp,), "block": (blk,)}[grouping] + (f, r, dv)
        part[key] = part.get(key, 0) + 1
    for key, cnt in part.items():
        f, r, dv = key[-3:]
        flat[f][r, dv] += cnt


# --- the problems --------------------------------------------------------------------------


def _aux_np(c: int, cc: int, cp: int, n: int, d: int, seed: int, *, keyless: float = 0.2,
            counted: float = 0.8) -> dict:
    """A synthetic class view: ``c`` class rows of ``cc`` constraints on
    ``n`` nodes and ``d`` domains (a keyless node at the trash slot D),
    counted_hard and counted_soft drawn independently, match bytes at
    random, tables of small counts."""
    rng = np.random.default_rng(seed)
    dom = rng.integers(0, d, (c, cc, n)).astype(np.int32)
    dom[rng.random((c, cc, n)) < keyless] = d
    return {
        "hard_valid": np.ones((c, cc), bool), "soft_valid": np.ones((c, cc), bool),
        "max_skew": np.ones((c, cc), np.int32), "min_domains": np.zeros((c, cc), np.int32),
        "self_match": np.ones((c, cc), bool), "dom_val": dom, "has_key": dom < d,
        "counted_hard": rng.random((c, n)) < counted,
        "counted_soft": rng.random((c, n)) < counted,
        "hard_counts": rng.integers(0, 4, (c, cc, d + 1)).astype(np.int32),
        "soft_counts": rng.integers(0, 4, (c, cc, d + 1)).astype(np.int32),
        "hard_present": np.ones((c, cc, d + 1), bool),
        "match_pending": rng.random((c, cc, cp)) < 0.6,
    }


def _round(b: int, cp: int, n: int, seed: int, *, frac: float = 0.6, beyond: bool = True,
           one_domain=None, identity: bool = False):
    """(commit, choice, class_of): ``frac`` of the pods committed; choices
    past N − 1 (and below 0) on uncommitted pods and, where ``beyond``, on
    committed ones too (clipped); ``one_domain`` (a node list) holds every
    commit."""
    rng = np.random.default_rng(seed)
    commit = rng.random(b) < frac
    choice = rng.integers(0, n, b).astype(np.int32)
    choice[~commit] = rng.choice([-3, n, n + 7], size=int((~commit).sum()))
    if beyond:
        hit = np.flatnonzero(commit)[:3]
        choice[hit] = n + 5  # clipped to the last row
    if one_domain is not None:
        choice[commit] = rng.choice(one_domain, size=int(commit.sum()))
    class_of = np.arange(b) if identity else rng.integers(0, cp, b)
    return commit, choice, class_of.astype(np.int64)


SYNTHETIC = {
    "Cc 1, keyless, counted differ": dict(c=4, cc=1, cp=4, n=40, d=5),
    f"Cc {MAX_CONSTRAINTS}": dict(c=3, cc=MAX_CONSTRAINTS, cp=5, n=24, d=4),
    "C 12, Cc 2": dict(c=12, cc=2, cp=12, n=30, d=7),
    "every commit in one domain": dict(c=4, cc=2, cp=4, n=30, d=3, one_domain=True),
    "nothing committed": dict(c=4, cc=1, cp=4, n=16, d=3, frac=0.0),
}


def _u_c(commit, choice, class_of, cp: int, n: int):
    """The reference runtime's class one-hot (runtime.py:839-841)."""
    return jnp.zeros((cp, n), jnp.float32).at[
        jnp.asarray(class_of), jnp.clip(jnp.asarray(choice), 0, n - 1)
    ].add(jnp.asarray(commit, jnp.float32))


def _port(a: dict) -> TTSAux:
    return TTSAux(**{f: torch.from_numpy(a[f].copy()) for f in TTSAux._fields})


def _jax(a: dict) -> JTSAux:
    return JTSAux(**{f: jnp.asarray(a[f]) for f in JTSAux._fields})


def _check_round(a: dict, jaux, port, commit, choice, class_of, order, grouping,
                 dtype=np.int64):
    """One round through the mirror, the port's plain version (class_of in
    ``dtype``) and the reference's tables ``jaux`` (already updated)."""
    adds = k8_adds(a, commit, choice, class_of.astype(dtype))
    k8_apply(a, adds, order, grouping)
    spread_update_classes(port, torch.from_numpy(commit), torch.from_numpy(choice),
                          torch.from_numpy(class_of.astype(dtype)))
    for f in ("hard_counts", "soft_counts"):
        want = np.asarray(getattr(jaux, f))
        assert np.array_equal(a[f], want), f
        assert np.array_equal(getattr(port, f).numpy(), want), f
    return adds


# (order, grouping): every grouping, and the kernel's in every order
ORDERS = [("forward", "lane"), ("forward", "warp"), ("reverse", "warp"), ("shuffled", "warp"),
          ("shuffled", "block")]


@pytest.mark.parametrize("dtype", [np.int64, np.int32], ids=["int64", "int32"])
@pytest.mark.parametrize("order,grouping", ORDERS)
@pytest.mark.parametrize("case", list(SYNTHETIC))
def test_k8_pod_row_threads_equal_update_batch_classes(case, order, grouping, dtype):
    kw = dict(SYNTHETIC[case])
    one = kw.pop("one_domain", False)
    frac = kw.pop("frac", 0.6)
    a = _aux_np(**kw, seed=len(case))
    cp, n, d = kw["cp"], kw["n"], kw["d"]
    nodes = None
    if one:  # the first half of the nodes in domain 1 under every row's key
        a["dom_val"][:, :, : n // 2] = 1
        a["has_key"][:, :, : n // 2] = True
        nodes = np.arange(n // 2)
    before = {f: a[f].copy() for f in ("hard_counts", "soft_counts")}
    jaux, port = _jax(a), _port(a)
    jplug = JSpread()
    moved = 0
    for s in range(3):
        commit, choice, class_of = _round(160, cp, n, 100 * s + len(case), frac=frac,
                                          beyond=not one, one_domain=nodes)
        jaux = jplug.update_batch_classes(jaux, _u_c(commit, choice, class_of, cp, n),
                                          None, None, None, jnp.asarray(class_of))
        moved += len(_check_round(a, jaux, port, commit, choice, class_of, order, grouping,
                                  dtype))
    assert (moved == 0) == (frac == 0.0)
    if one:  # every add on domain 1, many on each row
        for f, was in before.items():
            grew = a[f] - was
            assert grew[:, :, 1].max() > 1 and not np.delete(grew, 1, axis=-1).any()


@pytest.mark.parametrize("order,grouping", ORDERS)
def test_k8_identity_classes_equal_update_batch(order, grouping):
    """The full auction's form: one class row per pod (Cp = B), against the
    reference's update_batch on the commit one-hot."""
    b, n, d = 40, 30, 5
    a = _aux_np(b, 2, b, n, d, seed=41)
    jaux, port = _jax(a), _port(a)
    jplug = JSpread()
    for s in range(3):
        commit, choice, class_of = _round(b, b, n, 7 + s, beyond=False, identity=True)
        u = (jnp.asarray(choice)[:, None] == jnp.arange(n)[None, :]) & \
            jnp.asarray(commit)[:, None]
        jaux = jplug.update_batch(jaux, jnp.asarray(commit), jnp.asarray(choice),
                                  u.astype(jnp.float32), None, None)
        assert _check_round(a, jaux, port, commit, choice, class_of, order, grouping)


@pytest.fixture(scope="module")
def cluster():
    """The 3-zone cluster of tests/test_torch_spread.py at class
    granularity: its identity classes' rep view, prepared by both
    packages."""
    p = _spread_problem(3, 0)
    class_of, reps = identity_classes(p["hbatch"])
    cpad = max(4, 1 << (len(reps) - 1).bit_length())
    rep_rows = np.full(cpad, reps[0], dtype=np.int32)
    rep_rows[: len(reps)] = reps
    idx = _spread_index(p["fw"])
    jaux = p["fw"].plugins[idx].plugin.prepare(p["batch"].take(jnp.asarray(rep_rows)),
                                               p["dsnap"], p["dyn"])
    tplug = p["tfw"].plugins[idx].plugin
    taux = tplug.engine_copy(tplug.prepare(
        p["tbatch"].take(torch.from_numpy(rep_rows.astype(np.int64))), p["tsnap"], p["tdyn"]))
    return p, np.asarray(class_of), cpad, jaux, taux


@pytest.mark.parametrize("dtype", [np.int64, np.int32], ids=["int64", "int32"])
@pytest.mark.parametrize("grouping", ["lane", "warp", "block"])
def test_k8_cluster_rounds_equal_update_batch_classes(cluster, grouping, dtype):
    p, class_of, cpad, jaux, taux = cluster
    a = {f: getattr(taux, f).numpy().copy() for f in taux._fields}
    port = taux._replace(hard_counts=taux.hard_counts.clone(),
                         soft_counts=taux.soft_counts.clone())
    jplug = JSpread()
    b, n = p["hbatch"].size, p["tsnap"].num_nodes
    valid = np.asarray(p["hbatch"].valid)
    keyless = np.flatnonzero(~a["has_key"].any(axis=(0, 1)))
    assert keyless.size  # the trash slot is reached
    for s in range(3):
        commit, choice, _ = _round(b, cpad, n, 50 + s)
        commit &= valid
        choice[np.flatnonzero(commit)[-2:]] = keyless[0]
        jaux = jplug.update_batch_classes(jaux, _u_c(commit, choice, class_of, cpad, n),
                                          None, None, None, jnp.asarray(class_of))
        adds = k8_adds(a, commit, choice, class_of.astype(dtype))
        assert adds
        k8_apply(a, adds, "shuffled", grouping, seed=s)
        spread_update_classes(port, torch.from_numpy(commit), torch.from_numpy(choice),
                              torch.from_numpy(class_of.astype(dtype)))
        for f in ("hard_counts", "soft_counts"):
            want = np.asarray(getattr(jaux, f))
            assert np.array_equal(a[f], want), f
            assert np.array_equal(getattr(port, f).numpy(), want), f


def test_k8_work_counts_per_pod_inputs_match_bytes_and_adds():
    """K8's bound: every pod's commit flag; per committed pod its node and
    class at their widths, its rows' match bytes, the domain of each
    matching row, the counted flags of each class row with a matching row;
    a read and a write per add."""
    c, cc, cp, n, d = 2, 2, 3, 5, 3
    match = torch.zeros((c, cc, cp), dtype=torch.bool)
    match[0, 0, 1] = match[0, 1, 1] = match[1, 1, 1] = match[1, 0, 2] = True
    counted_hard = torch.ones((c, n), dtype=torch.bool)
    counted_soft = torch.zeros((c, n), dtype=torch.bool)
    counted_soft[1, 4] = True
    aux = type("Aux", (), {"match_pending": match, "counted_hard": counted_hard,
                           "counted_soft": counted_soft,
                           "dom_val": torch.zeros((c, cc, n), dtype=torch.int32),
                           "hard_counts": torch.zeros((c, cc, d + 1), dtype=torch.int32)})
    commit = torch.tensor([False, True, False, True])
    choice = torch.tensor([0, 4, 1, 9], dtype=torch.int32)  # pod 3's node clips to 4
    class_of = torch.tensor([2, 1, 1, 1])
    # pods 1 and 3, class 1 at node 4: rows (0,0), (0,1), (1,1) match; three
    # hard adds and one soft (class row 1 counts node 4 soft) each
    adds = 2 * (3 + 1)
    want = 4 * 1 + 2 * (4 + 8) + 2 * c * cc + 4 * 2 * 3 + 2 * 2 * 2 + 8 * adds
    assert k8_work(aux, commit, choice, class_of) == (want, 2 * c * cc + adds)
    small = k8_work(aux, commit, choice, class_of.to(torch.int32))
    assert small[0] == want - 2 * 4
    none = torch.zeros(4, dtype=torch.bool)
    assert k8_work(aux, none, choice, class_of) == (4 * 1, 0)
