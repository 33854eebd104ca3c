"""Preemption on the port against the JAX package (exact unless stated).

* The candidate mask: ``candidate_mask_device`` on CPU tensors (the plain
  versions of K27 + K28 with levels, K29 without) against the reference's
  ``whatif.dryrun.candidate_mask_device`` run under ``jax.jit`` on the same
  seeded arrays — the levels form and the dense form on randomized
  clusters (invalid, unbound and dead-node pods, padding rows, failing
  static bits), the dense form equal to the levels form at exact sums,
  and the float32 order pinned: 32Gi nodes (2^25 KiB) hold pods of odd KiB
  requests over 40 priority levels, so the level totals and their prefix
  round, and each batch pod asks for exactly the prefix's float32 value
  (and one ulp more) — one ulp of difference flips a mask bit.  The
  prefix's order is XLA:CPU's blocked cumulative sum, which differs from
  a left-to-right sum on these inputs (checked).
* ``sweep_and_rank``: the port's C++ pass (built with g++ here) == its
  numpy pass == the reference's numpy pass, on the rows the output
  contract defines (valid candidates).
* The Evaluator cases of the reference's tests/test_preemption.py on both
  packages: the minimal victim set, the PDB-first ranking, the PDB filter,
  the end-to-end pick, vectorized == serial, shared tables == full
  materialization.
* The three scenarios of the reference's tests/test_preemption_e2e.py
  through ``TorchScheduler(device="cpu")`` and ``TPUScheduler``: bindings,
  victims, ``_nominated`` and ``_fastbound_noms`` after every step; a
  store fault inside the PostFilter degrades to nominate-nothing on both.
* B2: the fused cycle's dynamic state (``requested`` / ``non_zero``) with
  live nominations and two in-flight carries equals the reference's, dispatch
  for dispatch, pipelined at depth 3.
* PreemptionBasic at a small scale: the port's harness binds as the
  reference's harness (bindings and victims), every node ends with one high
  and one low pod and three victims; synchronous with
  ``nominated_fast_bind=False`` the nominations live across cycles and the
  bindings still equal the reference's.
* The gang guard: members of a gang that cannot fully place evict nothing.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.api.objects as jv1
import kubernetes_tpu.testutil as jtu
import kubernetes_tpu_torch.api.objects as tv1
import kubernetes_tpu_torch.testutil as ttu
from kubernetes_tpu.perf import harness as jh
from kubernetes_tpu.perf import workloads as jw
from kubernetes_tpu.preemption import Candidate as JCandidate
from kubernetes_tpu.preemption import Evaluator as JEvaluator
from kubernetes_tpu.preemption import pods_with_pdb_violation as j_pdb_violation
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.sim.store import ObjectStore as JStore
from kubernetes_tpu.state.cache import Cache as JCache
from kubernetes_tpu.state.cache import Snapshot as JSnapshot
from kubernetes_tpu.whatif import dryrun as jdry
from kubernetes_tpu_torch.kernels import LAUNCHES, reset_launches
from kubernetes_tpu_torch.kernels.preempt import (
    DENSE_CAP,
    DENSE_CHUNK,
    DENSE_TILE,
    blocked_cumsum,
    candidate_dense,
    candidate_dense_plain,
    candidate_fit,
    node_segments,
    priority_prefix,
    priority_prefix_plain,
)
from kubernetes_tpu_torch.perf import workloads as tw
from kubernetes_tpu_torch.perf.harness import run_workload
from kubernetes_tpu_torch.preemption import Candidate as TCandidate
from kubernetes_tpu_torch.preemption import Evaluator as TEvaluator
from kubernetes_tpu_torch.preemption import pods_with_pdb_violation as t_pdb_violation
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.sim.store import ObjectStore as TStore
from kubernetes_tpu_torch.state.cache import Cache as TCache
from kubernetes_tpu_torch.state.cache import Snapshot as TSnapshot
from kubernetes_tpu_torch.whatif import dryrun as tdry

PKG = {
    "jax": SimpleNamespace(tu=jtu, v1=jv1, Store=JStore, Cache=JCache, Snapshot=JSnapshot,
                           Evaluator=JEvaluator, Candidate=JCandidate,
                           pdb_violation=j_pdb_violation, node_default=jw.node_default),
    "torch": SimpleNamespace(tu=ttu, v1=tv1, Store=TStore, Cache=TCache, Snapshot=TSnapshot,
                             Evaluator=TEvaluator, Candidate=TCandidate,
                             pdb_violation=t_pdb_violation, node_default=tw.node_default),
}
I32_MAX = np.iinfo(np.int32).max


# --- the candidate mask: the plain versions against the reference ----------------------


def _jax_candidate_mask(a: dict, levels):
    """The reference's candidate_mask_device under jax.jit, over arrays."""

    def run(alloc, requested, pv, pn, pp, pr, breq, bprio, ok, lv):
        snap = SimpleNamespace(num_nodes=alloc.shape[0], allocatable=alloc, pod_valid=pv,
                               pod_node=pn, pod_priority=pp, pod_request=pr)
        batch = SimpleNamespace(request=breq, priority=bprio)
        return jdry.candidate_mask_device(batch, snap, SimpleNamespace(requested=requested),
                                          ok, lv)

    args = [jnp.asarray(a[k]) for k in ("alloc", "requested", "pod_valid", "pod_node",
                                        "pod_priority", "pod_request", "request",
                                        "priority", "static_ok")]
    return np.asarray(jax.jit(run)(*args, None if levels is None else jnp.asarray(levels)))


def _torch_candidate_mask(a: dict, levels):
    """The port's candidate_mask_device on CPU tensors (the plain versions);
    the static filters as a bit plane (bit 3) with a mask of that bit."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}
    snap = SimpleNamespace(num_nodes=a["alloc"].shape[0], allocatable=t["alloc"],
                           pod_valid=t["pod_valid"], pod_node=t["pod_node"],
                           pod_priority=t["pod_priority"], pod_request=t["pod_request"])
    batch = SimpleNamespace(request=t["request"], priority=t["priority"])
    bits = (t["static_ok"].to(torch.int32) << 3) | 0b10001
    lv = None if levels is None else torch.from_numpy(levels)
    return tdry.candidate_mask_device(batch, snap, SimpleNamespace(requested=t["requested"]),
                                      bits, 1 << 3, lv).numpy()


def _levels_of(a: dict):
    u = np.unique(a["pod_priority"][a["pod_valid"]])
    if u.size > tdry.PRIORITY_LEVEL_CAP:
        return None
    lv = np.full(tdry.PRIORITY_LEVEL_CAP, I32_MAX, np.int32)
    lv[: u.size] = u
    return lv


def _random_arrays(seed: int, n=37, p=400, b=24, r=4, prios=(0, 1, 5, 20, 33),
                   batch_prios=(0, 2, 5, 10, 30, 40)) -> dict:
    """A randomized cluster as the candidate mask's arrays: requests small
    integers (exact float32 sums), a tenth of the pods invalid, a tenth
    unbound, nodes with free room from negative to most of the node, batch
    rows with zero requests, padding rows and failing static bits."""
    rng = np.random.default_rng(seed)
    alloc = rng.integers(2000, 9000, size=(n, r)).astype(np.int32)
    alloc[:, r - 1] = 110
    requested = (alloc * rng.uniform(0.3, 1.05, size=(n, r))).astype(np.int32)
    pod_node = rng.integers(0, n, size=p).astype(np.int32)
    pod_node[rng.random(p) < 0.1] = -1
    pod_request = rng.integers(0, 900, size=(p, r)).astype(np.int32)
    pod_request[:, r - 1] = 1
    req = rng.integers(0, 4000, size=(b, r)).astype(np.int32)
    req[rng.random((b, r)) < 0.2] = 0
    valid_rows = rng.random(b) < 0.85
    static_ok = (rng.random((b, n)) < 0.85) & valid_rows[:, None]
    return {
        "alloc": alloc, "requested": requested,
        "pod_valid": rng.random(p) < 0.9, "pod_node": pod_node,
        "pod_priority": rng.choice(prios, size=p).astype(np.int32),
        "pod_request": pod_request, "request": req,
        "priority": rng.choice(batch_prios, size=b).astype(np.int32),
        "static_ok": static_ok,
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_candidate_mask_levels_equals_reference(seed):
    a = _random_arrays(seed)
    lv = _levels_of(a)
    want = _jax_candidate_mask(a, lv)
    got = _torch_candidate_mask(a, lv)
    assert np.array_equal(got, want)
    # not vacuous: some pairs pass, some fail on resources or victims
    assert 0 < got.sum() < a["static_ok"].sum()


@pytest.mark.parametrize("seed", [3, 4])
def test_candidate_mask_dense_equals_reference_and_levels(seed):
    """Above 128 distinct priorities the dense form (K29's plain version)
    runs; at exact sums it equals the reference's dense einsum, and on the
    same cluster cut to few priorities the levels form equals the dense."""
    a = _random_arrays(seed, prios=tuple(range(0, 300, 2)),
                       batch_prios=(1, 57, 151, 299, 400))
    assert _levels_of(a) is None
    want = _jax_candidate_mask(a, None)
    got = _torch_candidate_mask(a, None)
    assert np.array_equal(got, want)
    assert 0 < got.sum()
    b = _random_arrays(seed)
    assert np.array_equal(_torch_candidate_mask(b, None), _torch_candidate_mask(b, _levels_of(b)))


def _odd_kib_cluster(seed: int, n=8, per_node=120, n_levels=40):
    """32Gi nodes (2^25 KiB) whose pods ask for odd KiB amounts near 1.6M
    over ``n_levels`` priorities, the low ones crowded (weights 1/(1+k)):
    the per-level totals and their prefix pass 2^24, where float32
    rounds."""
    rng = np.random.default_rng(seed)
    r = 4
    p = n * per_node
    alloc = np.zeros((n, r), np.int32)
    alloc[:, 1] = 1 << 25
    alloc[:, 3] = 110
    requested = np.zeros((n, r), np.int32)
    requested[:, 1] = rng.integers(1 << 23, 1 << 24, size=n) * 2
    pod_request = np.zeros((p, r), np.int32)
    pod_request[:, 1] = rng.integers(700_000, 900_000, size=p) * 2 + 1
    pod_request[:, 3] = 1
    weights = 1.0 / (1.0 + np.arange(n_levels))
    weights /= weights.sum()
    return {
        "alloc": alloc, "requested": requested,
        "pod_valid": np.ones(p, bool),
        "pod_node": np.repeat(np.arange(n, dtype=np.int32), per_node)[rng.permutation(p)],
        "pod_priority": rng.choice(n_levels, size=p, p=weights).astype(np.int32),
        "pod_request": pod_request,
    }


def test_levels_float32_order_pins_reference():
    """Each batch pod asks for the float32 value free_base + prefix[t] the
    port computes for one (node, threshold), and a twin asks one ulp more:
    the reference agrees on both bits only if its float32 sums are the
    port's, bit for bit.  A left-to-right prefix differs on these inputs,
    so the pin is not vacuous."""
    c = _odd_kib_cluster(7)
    n = c["alloc"].shape[0]
    lv = _levels_of(dict(c, static_ok=None))
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    prefix, prefix_cnt = priority_prefix_plain(t["pod_valid"], t["pod_node"],
                                               t["pod_priority"], t["pod_request"],
                                               torch.from_numpy(lv), n)
    base = (t["alloc"].float() - t["requested"].float())[:, 1]
    rows, prios, targets = [], [], []
    n_lv = int((lv != I32_MAX).sum())
    for node in range(n):
        for th in (2, 5, 17, 18, 33, n_lv):
            if prefix_cnt[th, node] == 0:  # no victim below th on this node
                continue
            targets.append(node)
            v = (base[node] + prefix[th, node, 1]).item()
            # the next request above v that float32 holds: one ulp, at
            # least 1 KiB
            ulp = max(1, int(np.spacing(np.float32(v))))
            rows += [int(v), int(v) + ulp]
            prios += [int(lv[th]) if th < n_lv else 1000] * 2
    b = len(rows)
    req = np.zeros((b, 4), np.int32)
    req[:, 1] = rows
    a = dict(c, request=req, priority=np.asarray(prios, np.int32),
             static_ok=np.ones((b, n), bool))
    want = _jax_candidate_mask(a, lv)
    got = _torch_candidate_mask(a, lv)
    assert np.array_equal(got, want)
    # each pod fits its own node with equality and its twin does not
    assert len(targets) >= 4 * n
    for k, node in enumerate(targets):
        assert got[2 * k, node] and not got[2 * k + 1, node]
    # the order matters here: a left-to-right prefix of the same level
    # totals, and level totals summed in another pod order, both differ
    table = np.zeros((lv.size + 1, n), np.float32)
    for p_ in range(c["pod_node"].size):
        bk = int(np.searchsorted(lv, c["pod_priority"][p_]))
        table[bk, c["pod_node"][p_]] = np.float32(table[bk, c["pod_node"][p_]]
                                                  + np.float32(c["pod_request"][p_, 1]))
    seq = np.zeros((lv.size + 1, n), np.float32)
    for k in range(lv.size):
        seq[k + 1] = seq[k] + table[k]
    assert np.array_equal(table[:lv.size].cumsum(axis=0, dtype=np.float32)[-1], seq[-1])
    assert not np.array_equal(seq, prefix[:, :, 1].numpy())
    assert np.array_equal(blocked_cumsum(torch.from_numpy(table[:lv.size])).numpy(),
                          prefix[1:, :, 1].numpy())
    rev = np.zeros_like(table)
    for p_ in reversed(range(c["pod_node"].size)):
        bk = int(np.searchsorted(lv, c["pod_priority"][p_]))
        rev[bk, c["pod_node"][p_]] = np.float32(rev[bk, c["pod_node"][p_]]
                                                + np.float32(c["pod_request"][p_, 1]))
    assert not np.array_equal(rev, table)


def _row_order_freed(c: dict, thr: int, reverse: bool = False):
    """(f32[N, R], i64[N]): per node, the requests of its valid pods below
    ``thr`` added in float32 one pod at a time from 0 in ascending pod-row
    order (descending with ``reverse``), and their count."""
    n, r = c["alloc"].shape
    freed = np.zeros((n, r), np.float32)
    cnt = np.zeros(n, np.int64)
    rows = np.flatnonzero(c["pod_valid"] & (c["pod_node"] >= 0) & (c["pod_priority"] < thr))
    for p_ in (rows[::-1] if reverse else rows):
        nd = c["pod_node"][p_]
        freed[nd] = freed[nd] + c["pod_request"][p_].astype(np.float32)
        cnt[nd] += 1
    return freed, cnt


def _dense_mask_by_loop(a: dict, reverse: bool = False) -> np.ndarray:
    """bool[B, N]: the dense candidate mask with each (pod, node) sum taken
    by ``_row_order_freed``, the fit in float32 as the reference writes it."""
    base = a["alloc"].astype(np.float32) - a["requested"].astype(np.float32)
    sums = {}
    out = np.zeros(a["static_ok"].shape, bool)
    for i, thr in enumerate(a["priority"]):
        if thr not in sums:
            sums[thr] = _row_order_freed(a, int(thr), reverse)
        freed, cnt = sums[thr]
        req = a["request"][i].astype(np.float32)[None, :]
        fits = ((req == 0) | (req <= base + freed)).all(axis=1)
        out[i] = fits & (cnt > 0) & a["static_ok"][i]
    return out


def test_dense_float32_order_pins_row_order():
    """Above 128 priorities the dense form (K29's plain version) sums each
    node's lower-priority pods in ascending pod-row order: on odd-KiB
    requests whose sums pass 2^24, each batch pod asks for exactly that
    sum's float32 fit value on one node and a twin one ulp more, and the
    plain version equals a numpy float32 loop in row order on every pair.
    The same loop in descending row order flips at least one pair, so the
    order is what the pin holds."""
    c = _odd_kib_cluster(11, n=8, per_node=160, n_levels=400)
    assert _levels_of(c) is None
    n = c["alloc"].shape[0]
    base = c["alloc"].astype(np.float32) - c["requested"].astype(np.float32)
    rows, prios, targets = [], [], []
    for thr in (3, 20, 90, 250, 1000):
        freed, cnt = _row_order_freed(c, thr)
        for node in range(n):
            if cnt[node] == 0:
                continue
            v = np.float32(base[node, 1] + freed[node, 1])
            ulp = max(1, int(np.spacing(v)))
            targets.append(node)
            rows += [int(v), int(v) + ulp]
            prios += [thr, thr]
    b = len(rows)
    req = np.zeros((b, 4), np.int32)
    req[:, 1] = rows
    a = dict(c, request=req, priority=np.asarray(prios, np.int32),
             static_ok=np.ones((b, n), bool))
    got = _torch_candidate_mask(a, None)
    want = _dense_mask_by_loop(a)
    assert np.array_equal(got, want)
    assert len(targets) >= 4 * n
    for k, node in enumerate(targets):
        assert got[2 * k, node] and not got[2 * k + 1, node]
    assert not np.array_equal(_dense_mask_by_loop(a, reverse=True), want)


def _dense_visit_order(pod_valid, pod_node, n: int) -> list:
    """Per node, the pod rows K29's lane for that node adds, in the order it
    adds them — a numpy mirror of csrc/preempt.cu's index arithmetic: per
    tile of DENSE_TILE nodes the tier in chunks of DENSE_CHUNK rows, 256
    threads of DENSE_CHUNK / 256 consecutive rows each; a thread's pods of
    the tile placed at its warp's inclusive scan of the counts less its own,
    plus the scan of the warps' totals; the list in rounds of DENSE_CAP
    entries and groups of 32, each lane taking its node's entries of a
    group lowest first."""
    threads, p = 256, pod_node.size
    ppt = DENSE_CHUNK // threads
    order = [[] for _ in range(-(-n // DENSE_TILE) * DENSE_TILE)]
    for n0 in range(0, n, DENSE_TILE):
        for c0 in range(0, p, DENSE_CHUNK):
            rows = c0 + np.arange(threads)[:, None] * ppt + np.arange(ppt)[None, :]
            inb = rows < p
            rr = np.where(inb, rows, 0)
            flag = inb & pod_valid[rr] & (pod_node[rr] >= n0) & (pod_node[rr] < n0 + DENSE_TILE)
            mine = flag.sum(axis=1)
            incl = np.concatenate([np.cumsum(w) for w in mine.reshape(-1, 32)])
            wsum = incl.reshape(-1, 32)[:, -1]
            first = incl - mine + np.concatenate([[0], np.cumsum(wsum)[:-1]])[
                np.arange(threads) // 32]
            lst = np.full(int(wsum.sum()), -1)
            for t in range(threads):
                lst[first[t]:first[t] + mine[t]] = rows[t][flag[t]]
            assert (lst >= 0).all()
            for rb in range(0, lst.size, DENSE_CAP):
                rnd = lst[rb:rb + DENSE_CAP]
                for g in range(0, rnd.size, 32):
                    grp = rnd[g:g + 32]
                    local = pod_node[grp] - n0
                    for lane in range(DENSE_TILE):
                        order[n0 + lane] += [int(x) for x in grp[local == lane]]
    return order[:n]


@pytest.mark.parametrize("case", ["skewed", "spread"])
def test_dense_gather_order_equals_node_segments(case):
    """K29's chunked tile gather visits each node's pods in node_segments'
    stable order (ascending row within a node): on a tier whose node 5
    holds ~5000 pods across every chunk (more than a round a chunk) and
    node 40 1200 pods inside one chunk, with empty nodes, invalid and
    unbound pods, P not a multiple of a thread's rows and N not a multiple
    of the tile; and on a uniform tier."""
    rng = np.random.default_rng(5 if case == "skewed" else 6)
    if case == "skewed":
        n, p = 70, 3 * DENSE_CHUNK + 777
        node = rng.integers(0, 60, p).astype(np.int32)
        node[rng.random(p) < 0.4] = 5
        node[DENSE_CHUNK:DENSE_CHUNK + 1200] = 40
    else:
        n, p = 33, 5000
        node = rng.integers(0, n, p).astype(np.int32)
    node[rng.random(p) < 0.05] = -1
    valid = rng.random(p) >= 0.1
    order = _dense_visit_order(valid, node, n)
    perm, offsets = node_segments(torch.from_numpy(valid), torch.from_numpy(node), n)
    perm, offsets = perm.tolist(), offsets.tolist()
    for k in range(n):
        assert order[k] == perm[offsets[k]:offsets[k + 1]], k
    if case == "skewed":
        assert len(order[5]) > DENSE_CHUNK and len(order[40]) > DENSE_CAP
        assert not any(order[60:])


@pytest.mark.parametrize("k", [16, 40, 128, 256])
def test_blocked_cumsum_equals_xla_cumsum(k):
    """blocked_cumsum is XLA:CPU's float32 cumulative sum, bit for bit."""
    rng = np.random.default_rng(k)
    x = (rng.integers(1, 1 << 22, size=(k, 33, 3)) * 7 + (1 << 25)).astype(np.float32)
    x[rng.random(x.shape) < 0.4] = 0
    want = np.asarray(jax.jit(lambda t: jnp.cumsum(t, axis=0))(jnp.asarray(x)))
    assert np.array_equal(blocked_cumsum(torch.from_numpy(x)).numpy(), want)


def test_preempt_kernels_take_their_plain_versions_on_cpu():
    """On CPU tensors K27–K29's wrappers run their plain versions and
    launch nothing."""
    a = _random_arrays(9)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    lv = torch.from_numpy(_levels_of(a))
    n = a["alloc"].shape[0]
    bits = t["static_ok"].to(torch.int32)
    reset_launches()
    prefix, cnt = priority_prefix(t["pod_valid"], t["pod_node"], t["pod_priority"],
                                  t["pod_request"], lv, n)
    fit = candidate_fit(prefix, cnt, lv, t["priority"], t["request"], t["alloc"],
                        t["requested"], bits, 1)
    dense = candidate_dense(t["pod_valid"], t["pod_node"], t["pod_priority"],
                            t["pod_request"], t["priority"], t["request"], t["alloc"],
                            t["requested"], bits, 1)
    assert torch.equal(fit, dense)
    assert all(v == 0 for v in LAUNCHES.values())


# --- the reprieve sweep -------------------------------------------------------------


def test_sweep_native_equals_numpy_equals_reference(monkeypatch):
    """csrc/preempt_sweep.cpp (g++) == the port's numpy pass == the
    reference's numpy pass, on valid rows (the output contract)."""
    import kubernetes_tpu.native as jnative

    monkeypatch.setattr(jnative, "load_preempt_sweep", lambda: None)
    rng = np.random.default_rng(11)
    calls0 = tdry.NATIVE_CALLS[0]
    for trial in range(40):
        c = int(rng.integers(1, 24))
        vmax = int(rng.integers(1, 7))
        r = 4
        alloc = rng.integers(4, 4000, size=(c, r)).astype(np.int64)
        vr = rng.integers(0, 900, size=(c, vmax, r)).astype(np.int64)
        v_valid = rng.random((c, vmax)) < 0.8
        vr[~v_valid] = 0
        used_now = (vr * v_valid[:, :, None]).sum(axis=1) + rng.integers(0, 500, size=(c, r))
        base = used_now - (vr * v_valid[:, :, None]).sum(axis=1)
        v_viol = rng.random((c, vmax)) < 0.3
        v_prio = rng.integers(0, 5, size=(c, vmax)).astype(np.int64)
        v_ts = rng.integers(0, 100, size=(c, vmax)).astype(np.float64)
        req_v = rng.integers(0, 1200, size=r).astype(np.int64)
        args = (base, alloc, vr, v_valid, v_viol, v_prio, v_ts, req_v)
        ref = jdry.sweep_and_rank(*args)
        plain = tdry.sweep_and_rank(*args)
        nat = tdry.sweep_and_rank(*args, native=True)
        r_mask, r_nviol, r_order, r_valid = ref
        for got in (plain, nat):
            g_mask, g_nviol, g_order, g_valid = got
            if r_valid is None or not r_valid.any():
                assert g_valid is None or not g_valid.any(), f"trial {trial}"
                continue
            assert np.array_equal(g_valid, r_valid), f"trial {trial}"
            g_pref = [i for i in g_order if g_valid[i]]
            r_pref = [i for i in r_order if r_valid[i]]
            assert g_pref == r_pref, f"trial {trial}"
            for i in g_pref:
                assert np.array_equal(g_mask[i], r_mask[i]), f"trial {trial} c{i}"
                assert g_nviol[i] == r_nviol[i], f"trial {trial} c{i}"
    assert tdry.NATIVE_CALLS[0] - calls0 == 40


# --- the Evaluator ------------------------------------------------------------------


def _snapshot_of(k, cache):
    s = k.Snapshot()
    cache.update_snapshot(s)
    return s


def _names(pods):
    return [p.metadata.name for p in pods]


def _minimal_set(pkg):
    k = PKG[pkg]
    cache = k.Cache()
    cache.add_node(k.tu.make_node().name("n0")
                   .capacity({"cpu": "4", "memory": "8Gi", "pods": "10"}).obj())
    for i in range(3):
        cache.add_pod(k.tu.make_pod().name(f"v{i}").uid(f"v{i}").namespace("default")
                      .priority(i).req({"cpu": "1"}).node("n0").obj())
    snap = _snapshot_of(k, cache)
    hi = (k.tu.make_pod().name("hi").uid("hi").namespace("default").priority(100)
          .req({"cpu": "2"}).obj())
    c = k.Evaluator().select_victims_on_node(hi, snap.node_info_list[0], snap.node_info_list)
    return _names(c.victims), c.num_pdb_violations


def _pick_pdb_first(pkg):
    k = PKG[pkg]
    mk = k.tu.make_pod
    cands = [k.Candidate("a", [mk().name("x").priority(5).obj()], num_pdb_violations=1),
             k.Candidate("b", [mk().name("y").priority(9).obj()], num_pdb_violations=0),
             k.Candidate("c", [mk().name("z").priority(3).obj()], num_pdb_violations=0)]
    return k.Evaluator().pick_one_node(cands).node_name


def _pdb_filter(pkg):
    k = PKG[pkg]
    pdb = k.v1.PodDisruptionBudget(
        selector=k.v1.LabelSelector(match_labels={"app": "web"}), disruptions_allowed=0)
    pdb.metadata.namespace = "default"
    protected = k.tu.make_pod().name("a").namespace("default").label("app", "web").obj()
    free = k.tu.make_pod().name("b").namespace("default").label("app", "db").obj()
    violating, ok = k.pdb_violation([protected, free], [pdb])
    return _names(violating), _names(ok)


def _end_to_end_pick(pkg):
    k = PKG[pkg]
    cache = k.Cache()
    for name in ("n0", "n1"):
        cache.add_node(k.tu.make_node().name(name)
                       .capacity({"cpu": "2", "memory": "4Gi", "pods": "10"}).obj())
    cache.add_pod(k.tu.make_pod().name("imp").uid("imp").namespace("default")
                  .priority(50).req({"cpu": "2"}).node("n0").obj())
    cache.add_pod(k.tu.make_pod().name("cheap").uid("cheap").namespace("default")
                  .priority(1).req({"cpu": "2"}).node("n1").obj())
    snap = _snapshot_of(k, cache)
    hi = (k.tu.make_pod().name("hi").uid("hi").namespace("default").priority(100)
          .req({"cpu": "2"}).obj())
    c = k.Evaluator().preempt(hi, snap, ["n0", "n1"])
    return c.node_name, _names(c.victims)


def _guard_pdb(k, allowed=0):
    guard = k.v1.PodDisruptionBudget()
    guard.metadata.name = "g"
    guard.metadata.namespace = "default"
    guard.selector = k.v1.LabelSelector(match_labels={"app": "guarded"})
    guard.disruptions_allowed = allowed
    return guard


def _vectorized_vs_serial(pkg):
    k = PKG[pkg]
    rng = np.random.default_rng(7)
    cache = k.Cache()
    for i in range(24):
        cache.add_node(k.node_default(i))
    for i in range(140):
        p = (k.tu.make_pod().name(f"low{i}").uid(f"low{i}").namespace("default")
             .label("app", "guarded" if i % 3 == 0 else "plain")
             .req({"cpu": f"{int(rng.choice([2, 4, 9]))}", "memory": "1Gi"})
             .priority(int(rng.choice([0, 1, 2]))).obj())
        p.spec.node_name = f"node-{int(rng.integers(24)):06d}"
        p.metadata.creation_timestamp = float(i)
        cache.add_pod(p)
    snap = _snapshot_of(k, cache)
    pdbs = [_guard_pdb(k)]
    ev = k.Evaluator()
    hi = (k.tu.make_pod().name("hi").uid("hi").namespace("default")
          .req({"cpu": "3", "memory": "2Gi"}).priority(50).obj())
    infos = snap.node_info_list
    vec = ev.select_victims_vectorized(hi, infos, pdbs)
    out = []
    for info, got in zip(infos, vec):
        want = ev.select_victims_on_node(hi, info, infos, pdbs,
                                         cluster_has_req_anti_affinity=False)
        assert (got is None) == (want is None), info.node_name
        if got is not None:
            assert _names(got.victims) == _names(want.victims)
            assert got.num_pdb_violations == want.num_pdb_violations
            out.append((info.node_name, _names(got.victims), got.num_pdb_violations))
    assert any(v for _n, v, _x in out)
    return out


def _tables_vs_full(pkg):
    k = PKG[pkg]
    rng = np.random.default_rng(11)
    out = []
    for trial in range(6):
        cache = k.Cache()
        n = int(rng.integers(8, 30))
        for i in range(n):
            cache.add_node(k.node_default(i))
        for i in range(int(rng.integers(40, 160))):
            p = (k.tu.make_pod().name(f"low{trial}-{i}").uid(f"low{trial}-{i}")
                 .namespace("default")
                 .label("app", "guarded" if i % 4 == 0 else "plain")
                 .req({"cpu": f"{int(rng.choice([1, 2, 4]))}", "memory": "1Gi"})
                 .priority(int(rng.choice([0, 1, 2, 5]))).obj())
            p.spec.node_name = f"node-{int(rng.integers(n)):06d}"
            p.metadata.creation_timestamp = float(rng.integers(1000))
            cache.add_pod(p)
        snap = _snapshot_of(k, cache)
        allowed = int(rng.integers(0, 2))
        pdbs = [_guard_pdb(k, allowed)] if trial % 2 == 0 else []
        hi = (k.tu.make_pod().name("hi").uid("hi").namespace("default")
              .req({"cpu": "3", "memory": "2Gi"}).priority(50).obj())
        nom = (k.tu.make_pod().name("nom").uid("nom").namespace("default")
               .req({"cpu": "2", "memory": "1Gi"}).priority(60).obj())
        nominated = {f"node-{int(rng.integers(n)):06d}": [nom]}
        names = [ni.node_name for ni in snap.node_info_list]
        got = k.Evaluator().preempt(hi, snap, names, pdbs, nominated=nominated)
        ref = k.Evaluator()
        res = ref.select_victims_vectorized(
            hi, [snap.node_info_map[nm] for nm in names], pdbs, nominated=nominated)
        want = ref.pick_one_node([c for c in res if c is not None])
        assert (got is None) == (want is None), f"trial {trial}"
        if got is not None:
            assert (got.node_name, _names(got.victims), got.num_pdb_violations) == \
                (want.node_name, _names(want.victims), want.num_pdb_violations)
            out.append((got.node_name, _names(got.victims), got.num_pdb_violations))
        else:
            out.append(None)
    assert any(out)
    return out


@pytest.mark.parametrize("case", [_minimal_set, _pick_pdb_first, _pdb_filter,
                                  _end_to_end_pick, _vectorized_vs_serial, _tables_vs_full],
                         ids=lambda f: f.__name__.strip("_"))
def test_evaluator_equals_reference(case):
    assert case("torch") == case("jax")


def test_evaluator_native_sweep_equals_numpy():
    """The shared-tables path gives the same candidate through the C++
    sweep as through its numpy pass."""
    k = PKG["torch"]
    rng = np.random.default_rng(5)
    cache = k.Cache()
    for i in range(30):
        cache.add_node(k.node_default(i))
    for i in range(120):
        p = (k.tu.make_pod().name(f"low{i}").uid(f"low{i}").namespace("default")
             .req({"cpu": f"{int(rng.choice([1, 2]))}", "memory": "1Gi"})
             .priority(int(rng.choice([0, 1, 2]))).obj())
        p.spec.node_name = f"node-{int(rng.integers(30)):06d}"
        p.metadata.creation_timestamp = float(rng.integers(1000))
        cache.add_pod(p)
    snap = _snapshot_of(k, cache)
    names = [ni.node_name for ni in snap.node_info_list]
    for prio in (1, 2, 50):
        hi = (k.tu.make_pod().name("hi").uid("hi").namespace("default")
              .req({"cpu": "3", "memory": "2Gi"}).priority(prio).obj())
        a = k.Evaluator(native=False).preempt(hi, snap, names)
        b = k.Evaluator(native=True).preempt(hi, snap, names)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.node_name, _names(a.victims)) == (b.node_name, _names(b.victims))


# --- the scheduler: the e2e scenarios ---------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _sched(pkg, store, clock, **kw):
    if pkg == "jax":
        return TPUScheduler(store, rng_key=None, clock=clock, **kw)
    return TorchScheduler(store, device="cpu", clock=clock, **kw)


def _state(store, sched):
    pods = {p.metadata.name: (p.spec.node_name, p.status.nominated_node_name or "")
            for p in store.list("Pod")[0]}
    noms = {uid: v[0] for uid, v in sched._nominated.items()}
    return pods, noms, dict(sched._fastbound_noms)


class _FaultyDelete:
    """Store mixin: the first ``fail`` pod deletes raise."""

    fail = 0

    def delete(self, kind, namespace, name):
        if kind == "Pod" and self.fail > 0:
            self.fail -= 1
            raise ConnectionError("injected store fault")
        return super().delete(kind, namespace, name)


def _e2e(pkg, scenario):
    """One scenario on one package; the fake clock stands still while a
    cycle runs, so no backoff spin is needed (backoff_wait=0)."""
    k = PKG[pkg]
    store = type("S", (_FaultyDelete, k.Store), {})()
    clock = FakeClock()
    sched = _sched(pkg, store, clock, batch_size=4,
                   nominated_fast_bind=scenario != "requeue")
    store.create("Node", k.tu.make_node().name("only")
                 .capacity({"cpu": "2", "memory": "4Gi", "pods": "10"}).obj())
    store.create("Pod", k.tu.make_pod().name("low").uid("low").namespace("default")
                 .priority(1).req({"cpu": "2"}).creation_timestamp(1.0).obj())
    sched.run_until_idle(backoff_wait=0)
    steps = [_state(store, sched)]
    high = (k.tu.make_pod().name("high").uid("high").namespace("default").priority(100)
            .req({"cpu": "2"}).creation_timestamp(2.0).obj())
    if scenario == "never":
        high.spec.preemption_policy = "Never"
    if scenario == "fault":
        store.fail = 1
    store.create("Pod", high)
    clock.advance(3.0)
    sched.run_until_idle(backoff_wait=0)
    steps.append(_state(store, sched))
    store.create("Pod", k.tu.make_pod().name("tick").uid("tick").namespace("default")
                 .req({"cpu": "100m"}).creation_timestamp(3.0).obj())
    clock.advance(3.0)
    sched.run_until_idle(backoff_wait=0)
    steps.append(_state(store, sched))
    # past the unschedulable queue's 60 s flush: every parked pod retries
    clock.advance(61.0)
    sched.run_until_idle(backoff_wait=0)
    steps.append(_state(store, sched))
    return steps


@pytest.mark.parametrize("scenario", ["fast_bind", "requeue", "never", "fault"])
def test_e2e_scenarios_equal_reference(scenario):
    got, want = _e2e("torch", scenario), _e2e("jax", scenario)
    assert got == want
    pods, noms, fast = got[1]
    if scenario == "fast_bind":
        # bound in the failing attempt; the nomination outlives the phase
        assert "low" not in pods and pods["high"][0] == "only"
        assert noms == {"high": "only"} and set(fast) == {"high"}
        assert not got[2][1]  # purged once the snapshot carries the bind
    elif scenario == "requeue":
        assert "low" not in pods and pods["high"] == ("", "only")
        assert got[2][0]["high"][0] == "only" and not got[3][1]
    elif scenario == "never":
        assert pods["low"][0] == "only" and pods["high"] == ("", "")
        assert got[3][0]["low"][0] == "only"
    else:
        # the victim's delete failed: nominate nothing, retry clean later
        assert pods["low"][0] == "only" and not noms
        assert "low" not in got[3][0] and got[3][0]["high"][0] == "only"


# --- B2: the nominated reservations in the fused cycle -----------------------------------


def _dispatch_states(pkg, monkeypatch):
    """Drive a pipelined (depth 3) scheduler through nominate-and-requeue
    preemptions, then plain pods that chain while the nominations are live
    → per dispatch: (requested, non_zero, carries, live nominations)."""
    k = PKG[pkg]
    store, clock = k.Store(), FakeClock()
    sched = _sched(pkg, store, clock, batch_size=4, batch_wait=0, pipeline=True,
                   pipeline_depth=3, nominated_fast_bind=False)
    log = []
    if pkg == "jax":
        orig = TPUScheduler._dispatch_batch

        def dispatch(self, *a, **kw):
            fl = orig(self, *a, **kw)
            if fl is not None and fl.node_row_dev is not None:
                jax.block_until_ready(fl.node_row_dev)
            log.append((np.asarray(fl.dyn.requested), np.asarray(fl.dyn.non_zero),
                        len(kw.get("prevs") or ()), len(self._nominated)))
            return fl

        monkeypatch.setattr(TPUScheduler, "_dispatch_batch", dispatch)
    else:
        orig = TorchScheduler._dispatch

        def dispatch(self, *a, **kw):
            fl = orig(self, *a, **kw)
            log.append((fl.dyn.requested.numpy().copy(), fl.dyn.non_zero.numpy().copy(),
                        len(kw.get("prevs") or ()), len(self._nominated)))
            return fl

        monkeypatch.setattr(TorchScheduler, "_dispatch", dispatch)
    for i in range(6):
        store.create("Node", k.tu.make_node().name(f"n{i}")
                     .capacity({"cpu": "4", "memory": "8Gi", "pods": "20"}).obj())
    for i in range(12):
        store.create("Pod", k.tu.make_pod().name(f"low{i}").uid(f"low{i}")
                     .namespace("default").req({"cpu": "1", "memory": "1Gi"})
                     .creation_timestamp(float(i)).obj())
    sched.run_until_idle(backoff_wait=0)
    for i in range(3):
        store.create("Pod", k.tu.make_pod().name(f"pre{i}").uid(f"pre{i}")
                     .namespace("default").priority(100)
                     .req({"cpu": "3", "memory": "2Gi"}).creation_timestamp(20.0 + i).obj())
    sched.run_until_idle(backoff_wait=0)
    for i in range(12):
        store.create("Pod", k.tu.make_pod().name(f"plain{i}").uid(f"plain{i}")
                     .namespace("default").req({"cpu": "300m", "memory": "256Mi"})
                     .creation_timestamp(40.0 + i).obj())
    sched.run_until_idle(backoff_wait=0)
    clock.advance(30.0)
    sched.run_until_idle(backoff_wait=0)
    monkeypatch.undo()
    pods = {p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]}
    return log, pods


def test_nominated_bundle_in_the_fused_cycle_equals_reference(monkeypatch):
    tlog, tpods = _dispatch_states("torch", monkeypatch)
    jlog, jpods = _dispatch_states("jax", monkeypatch)
    assert tpods == jpods
    assert len(tlog) == len(jlog)
    for (tr, tn, tc, tk), (jr, jn, jc, jk) in zip(tlog, jlog):
        assert (tc, tk) == (jc, jk)
        assert np.array_equal(tr, jr) and np.array_equal(tn, jn)
    # the nominations were live while a batch chained on two in-flight ones
    assert any(c == 2 and k_ for _r, _n, c, k_ in tlog)
    assert all(v for name, v in tpods.items() if name.startswith(("pre", "plain")))


# --- PreemptionBasic -------------------------------------------------------------------


def _victims_and_layout(pods: dict, created_low: int):
    victims = {f"low-{i:06d}" for i in range(created_low)} - set(pods)
    per_node = {}
    for name, node in pods.items():
        per_node.setdefault(node, []).append(name.split("-")[0])
    return victims, per_node


def test_preemption_basic_harness_equals_reference(monkeypatch):
    """PreemptionBasic/500Nodes at scale 0.04 (20 nodes, 80 low pods, 20
    high) through both harnesses: the same bindings and victims; every node
    ends with one high and one low pod."""
    w_t = tw.build_workload("PreemptionBasic", "500Nodes", scale=0.04)
    w_j = jw.build_workload("PreemptionBasic", "500Nodes", scale=0.04)
    seen = {}

    def inspect(store, sched, _ctrl):
        seen["pods"] = {p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]}
        seen["victims"] = list(sched.preemption_victims)
        seen["fast"] = sched.fast_binds

    items = run_workload(w_t, device="cpu", inspect=inspect)
    stores = []

    class Store(JStore):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            stores.append(self)

    monkeypatch.setattr(jh, "ObjectStore", Store)
    jh.run_workload(w_j)
    monkeypatch.undo()
    want = {p.metadata.name: p.spec.node_name for p in stores[0].list("Pod")[0]}
    assert seen["pods"] == want
    n_nodes, n_low, n_high = (op.count for op in w_t.ops)
    victims, per_node = _victims_and_layout(seen["pods"], n_low)
    assert len(victims) == 3 * n_nodes and seen["victims"] == [3] * n_high
    assert seen["fast"] == n_high
    assert all(sorted(v) == ["high", "low"] for v in per_node.values())
    assert len(per_node) == n_nodes
    by = {it.labels["Metric"]: it.data for it in items}
    assert by["SchedulingThroughput"]["Average"] > 0
    assert set(by["KernelLaunchesInWindow"].values()) == {0.0}


@pytest.mark.parametrize("fast_bind", [True, False])
def test_preemption_basic_bindings_equal_reference(fast_bind):
    """PreemptionBasic/500Nodes at scale 0.06 through the synchronous
    schedulers; with nominated_fast_bind=False every preemptor is
    nominated, requeued and bound on a later cycle while the nominations
    reserve their nodes (B2 with live rows)."""
    out = {}
    for pkg in ("jax", "torch"):
        k = PKG[pkg]
        w = (jw if pkg == "jax" else tw).build_workload("PreemptionBasic", "500Nodes",
                                                        scale=0.06)
        store, clock = k.Store(), FakeClock()
        sched = _sched(pkg, store, clock, batch_size=w.batch_size, batch_wait=0,
                       nominated_fast_bind=fast_bind)
        (_, n, nt), (_, p, pt), (_, mp, mt) = ((op.opcode, op.count,
                                               op.node_template or op.pod_template)
                                              for op in w.ops)
        for i in range(n):
            store.create("Node", nt(i))
        for i in range(p):
            pod = pt(i)
            pod.metadata.creation_timestamp = float(i)
            store.create("Pod", pod)
        sched.run_until_idle(backoff_wait=0)
        noms = []
        for i in range(p, p + mp):
            pod = mt(i)
            pod.metadata.creation_timestamp = float(i)
            store.create("Pod", pod)
        for _ in range(6):
            sched.run_until_idle(backoff_wait=0)
            noms.append(sorted((u, v[0]) for u, v in sched._nominated.items()))
            clock.advance(11.0)
        pods = {x.metadata.name: x.spec.node_name for x in store.list("Pod")[0]}
        out[pkg] = (pods, noms)
    assert out["torch"] == out["jax"]
    pods, noms = out["torch"]
    victims, per_node = _victims_and_layout(pods, 120)
    assert len(victims) == 90 and all(pods.values())
    assert all(sorted(v) == ["high", "low"] for v in per_node.values())
    if not fast_bind:
        assert len(noms[0]) == 30  # nominated, then bound on the retry


# --- the gang guard -------------------------------------------------------------------


def _gang_guard(pkg):
    k = PKG[pkg]
    store, clock = k.Store(), FakeClock()
    sched = _sched(pkg, store, clock, batch_size=8, batch_wait=0)
    for i in range(2):
        store.create("Node", k.tu.make_node().name(f"n{i}")
                     .capacity({"cpu": "2", "pods": "10"}).obj())
        store.create("Pod", k.tu.make_pod().name(f"low{i}").uid(f"low{i}")
                     .namespace("default").req({"cpu": "2"}).creation_timestamp(float(i))
                     .obj())
    sched.run_until_idle(backoff_wait=0)
    pg = k.v1.PodGroup(metadata=k.v1.ObjectMeta(name="g", namespace="default"),
                       min_member=3, schedule_timeout_seconds=30)
    pg.metadata.creation_timestamp = 100.0
    store.create("PodGroup", pg)
    for i in range(3):
        p = (k.tu.make_pod().name(f"g-{i}").uid(f"g-{i}").namespace("default")
             .label("pod-group.scheduling/name", "g").priority(100).req({"cpu": "2"}).obj())
        p.metadata.creation_timestamp = 200.0 + i
        store.create("Pod", p)
    clock.advance(2.0)
    sched.run_until_idle(backoff_wait=0)
    attempts = sched.preemption_attempts if pkg == "torch" else None
    return _state(store, sched), attempts


def test_gang_member_that_cannot_place_does_not_preempt():
    (got, attempts), (want, _) = _gang_guard("torch"), _gang_guard("jax")
    assert got == want
    pods, noms, _fast = got
    assert pods["low0"][0] and pods["low1"][0]  # nothing evicted
    assert not any(pods[f"g-{i}"][0] for i in range(3)) and not noms
    assert attempts == 0
