"""The keyed tie noise on the port against the JAX package (exact).

* ``select_host`` with a key: the argmax of where(masked == max, noise, −1)
  — rows of all ties, a few ties, distinct maxima and an all-−inf row —
  equals the reference's for several keys; the uniform tie-break spreads
  picks over two zones of identical nodes in proportion to their sizes
  (tests/test_zone_spreading.py), pick for pick the reference's.
* ``greedy_assign`` and ``batch_assign`` (the full path) with
  ``key=PRNGKey(7)`` against the JAX package's jitted engines on the JAX
  encoder's arrays: node rows, feasible counts, the final dynamic state and
  the round count, on a heterogeneous batch with nominated rows, spread
  and affinity batches and a contended batch; the noise changes the
  keyless bindings there, so the check has teeth.  The port's node
  capacity (``num_nodes``) equals the reference's padded
  ``node_valid.shape[0]``, which the noise's shape depends on.
* End to end: ``TorchScheduler(rng_key=(0, 7), device="cpu")`` binds as
  ``TPUScheduler(rng_key=PRNGKey(7))`` through the full auction (identical
  pods the dedup gate sends there under the "rng_key" fallback, and
  heterogeneous ones), through the scan (``assign_mode="scan"``, and
  coupled priority-10 batches the router scans) and pipelined at depth 2.
* The what-if engine's fork solves take the scheduler's key: victim,
  node-add and remove forks over tied nodes predict the reference's
  placements, stacked and one by one.

Tolerance: exact everywhere.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.framework.runtime import BatchedFramework as JFramework
from kubernetes_tpu.framework.runtime import coupling_flags
from kubernetes_tpu.metrics import scheduler_metrics as jmetrics
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.sim.store import ObjectStore as JStore
from kubernetes_tpu_torch.framework.runtime import BatchedFramework as TFramework
from kubernetes_tpu_torch.ops import prng
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.sim.store import ObjectStore as TStore

from tests.test_torch_common import (
    engine_cluster,
    fake_clock,
    make_node_obj,
    make_pod_obj,
    route_log,
)
from tests.test_torch_fullpath import FULL_PROBLEMS
from tests.test_torch_scan import _eq

KEY = (0, 7)


def _jkey(key):
    return jax.random.wrap_key_data(np.asarray(key, dtype=np.uint32), impl="threefry2x32")


@pytest.mark.parametrize("key", [(0, 0), (0, 7), (2**32 - 1, 2**32 - 1)])
def test_select_host_with_a_key_equals_reference(key):
    n = 37
    rows = [np.zeros(n, np.float32),
            np.where(np.arange(n) % 5 == 0, 9.0, 3.0).astype(np.float32),
            np.arange(n, dtype=np.float32)]
    masks = [np.ones(n, bool), np.arange(n) % 3 != 1, np.zeros(n, bool)]
    for scores in rows:
        for mask in masks:
            want = int(JFramework.select_host(jnp.asarray(scores), jnp.asarray(mask),
                                              _jkey(key)))
            got = int(TFramework.select_host(torch.from_numpy(scores),
                                             torch.from_numpy(mask), key))
            assert got == want, (scores[:4], mask[:4])
    assert int(TFramework.select_host(torch.zeros(8), torch.ones(8, dtype=torch.bool))) == 0


def test_uniform_tiebreak_spreads_across_zones_like_the_reference():
    """tests/test_zone_spreading.py on the port: 64 tied nodes in two
    contiguous zones, 400 picks from successive split keys."""
    n = 64
    zone_of = np.array([0] * 32 + [1] * 32)
    scores = torch.zeros(n)
    mask = torch.ones(n, dtype=torch.bool)
    jkey, key = jax.random.PRNGKey(7), prng.prng_key(7)
    picks, want = [], []
    for _ in range(400):
        jkey, jsub = jax.random.split(jkey)
        want.append(int(JFramework.select_host(jnp.zeros(n), jnp.ones(n, bool), jsub)))
        pair = prng.split(key, 2)
        key, sub = pair[0], pair[1]
        picks.append(int(TFramework.select_host(scores, mask, sub)))
    assert picks == want
    zones = np.bincount(zone_of[picks], minlength=2)
    assert abs(zones[0] - zones[1]) < 80, zones


@pytest.fixture(scope="module", params=["plain", "contended", "spread_3zones",
                                        "affinity_planes"])
def problem(request):
    return request.param, FULL_PROBLEMS[request.param]()


def test_node_capacity_is_the_reference_padded_shape(problem):
    _kind, p = problem
    assert p["tsnap"].num_nodes == int(p["dsnap"].node_valid.shape[0])


def _check(jres, tres, rounds=True):
    _eq(jres.node_row, tres.node_row, "node_row")
    _eq(jres.feasible_count, tres.feasible_count, "feasible_count")
    _eq(jres.dyn.requested, tres.dyn.requested, "requested")
    _eq(jres.dyn.non_zero, tres.dyn.non_zero, "non_zero")
    if rounds:
        assert int(jres.rounds) == tres.rounds >= 1


def test_keyed_scan_equals_reference(problem):
    kind, p = problem
    b = p["hbatch"].size
    fw = p["fw"]
    jauxes = fw.prepare(p["batch"], p["dsnap"], p["dyn"], p["host_auxes"])
    jres = jax.jit(fw.greedy_assign)(p["batch"], p["dsnap"], p["dyn"], jauxes,
                                     jnp.arange(b), jax.random.PRNGKey(7))
    tauxes = p["tfw"].prepare(p["tbatch"], p["tsnap"], p["tdyn"], p["thost"])
    tres = p["tfw"].greedy_assign(p["tbatch"], p["tsnap"], p["tdyn"], tauxes,
                                  np.arange(b), key=KEY)
    _check(jres, tres)
    keyless = jax.jit(fw.greedy_assign)(p["batch"], p["dsnap"], p["dyn"], jauxes,
                                        jnp.arange(b), None)
    assert not np.array_equal(np.asarray(keyless.node_row), tres.node_row.numpy()), kind


def test_keyed_full_auction_equals_reference(problem):
    kind, p = problem
    b = p["hbatch"].size
    fw = p["fw"]
    coupling = coupling_flags(p["hbatch"])
    jauxes = fw.prepare(p["batch"], p["dsnap"], p["dyn"], p["host_auxes"])
    jres = jax.jit(lambda *a: fw.batch_assign(*a, classes=None))(
        p["batch"], p["dsnap"], p["dyn"], jauxes, jnp.arange(b), coupling,
        jax.random.PRNGKey(7))
    tauxes = p["tfw"].prepare(p["tbatch"], p["tsnap"], p["tdyn"], p["thost"])
    req0 = p["tdyn"].requested.clone()
    tres = p["tfw"].batch_assign(p["tbatch"], p["tsnap"], p["tdyn"], tauxes,
                                 torch.arange(b), coupling, key=KEY)
    _check(jres, tres)
    _eq(req0, p["tdyn"].requested, "input requested")
    # a key never dedups: classes are ignored when a key is given
    tres2 = p["tfw"].batch_assign(p["tbatch"], p["tsnap"], p["tdyn"], tauxes,
                                  torch.arange(b), coupling, key=KEY,
                                  classes=(torch.zeros(b, dtype=torch.long), None, None))
    _eq(tres.node_row, tres2.node_row, "node_row with classes")


def _run(pkg, cluster, monkeypatch, **kw):
    """``cluster`` (engine_cluster's form) through one package's scheduler
    with the key → (bindings, route log)."""
    nodes, pre, pods, batch = cluster
    if pkg == "jax":
        store = JStore()
        sched = TPUScheduler(store, batch_size=batch, rng_key=jax.random.PRNGKey(7),
                             clock=fake_clock(), batch_wait=0, **kw)
    else:
        store = TStore()
        sched = TorchScheduler(store, batch_size=batch, device="cpu", rng_key=KEY,
                               clock=fake_clock(), batch_wait=0, **kw)
    for d in nodes:
        store.create("Node", make_node_obj(pkg, d))
    for d in pre + pods:
        store.create("Pod", make_pod_obj(pkg, d))
    log = route_log(pkg, monkeypatch)
    sched.run_until_idle(backoff_wait=0)
    monkeypatch.undo()
    if pkg == "torch":
        sched.close()
    return {p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]}, log


def _plain_cluster():
    """24 identical nodes and 40 identical pods: every batch would dedup."""
    nodes = [{"name": f"n{i:03d}", "cpu": "4", "memory": "16Gi", "pods": "110",
              "labels": {}, "taints": [], "images": [], "unschedulable": False,
              "not_ready": False} for i in range(24)]
    pods = [{"name": f"p{i:03d}", "ts": float(i), "req": {"cpu": "100m", "memory": "500Mi"}}
            for i in range(40)]
    return nodes, [], pods, 16


@pytest.mark.parametrize("kind,kw,engines", [
    ("plain", {}, {"full"}),
    ("hetero", {}, {"full"}),
    ("spread10", {}, {"scan"}),
    ("hetero", {"assign_mode": "scan"}, {"scan"}),
    ("mixed", {"pipeline": True, "pipeline_depth": 2}, {"full", "scan"}),
])
def test_keyed_scheduler_binds_as_reference(kind, kw, engines, monkeypatch):
    cluster = _plain_cluster() if kind == "plain" else engine_cluster(kind)
    f0 = jmetrics.dedup_fallback.value(("rng_key",))
    jb, jlog = _run("jax", cluster, monkeypatch, **kw)
    f1 = jmetrics.dedup_fallback.value(("rng_key",))
    tb, tlog = _run("torch", cluster, monkeypatch, **kw)
    assert tb == jb, {k: (jb[k], tb[k]) for k in jb if jb[k] != tb.get(k)}
    assert tlog == jlog
    took = {"scan" if m == "scan" else ("dedup" if d else "full") for m, d, _r in tlog}
    assert took == engines, tlog
    n_full = sum(1 for m, _d, _r in tlog if m == "batch")
    assert all(r == "rng_key" for m, _d, r in tlog if m == "batch")
    assert f1 - f0 == n_full
    if kind == "plain":
        # the noise spreads ties: not the keyless lowest-row packing
        rows = sorted(int(v[1:]) for v in tb.values() if v and v.startswith("n"))
        assert rows != sorted(list(range(24)) + list(range(16)))


def test_keyed_whatif_forks_equal_reference():
    """Each fork's solve takes the scheduler's key (the reference passes
    ``sched.rng_key``, whatif/engine.py:161, :170): victim, node-add and
    remove forks over tied nodes predict the reference's placements,
    stacked and one by one."""
    from tests.test_torch_whatif import PKG, SLICE, FakeClock, _group, _pod

    def predictions(pkg):
        k = PKG[pkg]
        store = k.Store()
        key = jax.random.PRNGKey(7) if pkg == "jax" else KEY
        sched = k.sched(store, batch_size=8, clock=FakeClock(), batch_wait=0, rng_key=key)
        for i in range(10):
            store.create("Node", k.tu.make_node().name(f"n{i}")
                         .capacity({"cpu": "4", "pods": "10"}).obj())
        for i in range(4):
            store.create("Pod", _pod(k, f"b{i}", cpu="2", node=f"n{i}"))
        sched.schedule_cycle()
        engine = k.Engine(sched)
        bound = sorted((p for p in store.list("Pod")[0] if p.spec.node_name),
                       key=lambda p: p.metadata.name)
        pend = [_pod(k, f"pend-{i}", cpu="1") for i in range(6)]
        forks = [k.ForkSpec(victims=bound[:2], note="victims"),
                 k.ForkSpec(add_nodes=k.materialize(_group(k), 2, 0, 0, SLICE), note="adds"),
                 k.ForkSpec(remove_nodes=["n5", "n6"], note="removes")]
        out = [[p.placements for p in engine.evaluate(pend, forks, vmapped=v)]
               for v in (True, False)]
        if pkg == "torch":
            sched.close()
        return out

    port, ref = predictions("torch"), predictions("jax")
    assert port[0] == port[1] == ref[0] == ref[1]
    # the noise spreads the tied pods: not all of them on the lowest rows
    rows = {v for fork in port[0] for v in fork.values()}
    assert len(rows) > 3
