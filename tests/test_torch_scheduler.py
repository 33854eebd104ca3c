"""End-to-end scheduler parity: TorchScheduler (cpu) against the JAX
package's TPUScheduler (pipeline=False, rng_key=None).

Both run on separate stores fed the same objects in the same order, with
the same deterministic clock; every pod must land on the same node and the
same pods must stay unschedulable.  Clusters: a SchedulingBasic-shaped one
(node_default nodes, pod_default pods) and a heterogeneous one (a few node
shapes, zones, taints, images, ports, NotReady / unschedulable nodes, eight
pod classes, some of which fit nowhere).  The scope guard must raise for
every feature outside the port (topology-spread clusters are held against
the reference in tests/test_torch_spread.py); the batches the reference
sends to its full auction or its exact scan run on the port with the
reference's bindings.
"""

from __future__ import annotations

import numpy as np
import pytest

from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.sim.store import ObjectStore as JStore
from kubernetes_tpu_torch.framework.runtime import BatchedFramework
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.sim.store import ObjectStore as TStore

from tests.test_torch_common import (
    PKGS,
    fake_clock,
    make_node_obj,
    make_pod_obj,
    node_descs,
    pod_descs,
    scheduled_descs,
)


def _basic_cluster():
    nodes = [{"name": f"node-{i:06d}", "cpu": "4", "memory": "32Gi", "pods": "110",
              "labels": {}, "taints": [], "images": [], "unschedulable": False,
              "not_ready": False} for i in range(48)]
    pre = [{"name": f"pre-{i:06d}", "ts": -100.0 + i,
            "req": {"cpu": "100m", "memory": "500Mi"},
            "node": f"node-{i % 48:06d}"} for i in range(20)]
    pods = [{"name": f"pod-{i:06d}", "ts": float(i),
             "req": {"cpu": "100m", "memory": "500Mi"}} for i in range(150)]
    return nodes, pre, pods


def _hetero_cluster():
    rng = np.random.default_rng(42)
    nodes = node_descs(rng, 60)
    pre = scheduled_descs(rng, 30, [d["name"] for d in nodes])
    pods = pod_descs(rng, 180)
    return nodes, pre, pods


def _feed(pkg, store, cluster):
    nodes, pre, pods = cluster
    for d in nodes:
        store.create("Node", make_node_obj(pkg, d))
    for d in pre:
        store.create("Pod", make_pod_obj(pkg, d))
    for d in pods:
        store.create("Pod", make_pod_obj(pkg, d))


def _drive(sched, store, max_cycles=50):
    for _ in range(max_cycles):
        if sched.schedule_cycle().attempted == 0:
            break
    pods, _ = store.list("Pod")
    return {p.metadata.name: p.spec.node_name for p in pods}


def _run_jax(cluster):
    store = JStore()
    sched = TPUScheduler(store, batch_size=64, pipeline=False, rng_key=None,
                         clock=fake_clock(), batch_wait=0)
    _feed("jax", store, cluster)
    return _drive(sched, store)


def _run_torch(cluster):
    store = TStore()
    sched = TorchScheduler(store, batch_size=64, device="cpu", clock=fake_clock(),
                           batch_wait=0)
    _feed("torch", store, cluster)
    return _drive(sched, store), sched


@pytest.fixture(scope="module", params=["basic", "hetero"])
def runs(request):
    cluster = _basic_cluster() if request.param == "basic" else _hetero_cluster()
    jax_bind = _run_jax(cluster)
    torch_bind, sched = _run_torch(cluster)
    return request.param, jax_bind, torch_bind, sched


def test_same_node_for_every_pod(runs):
    kind, jb, tb, _ = runs
    assert jb.keys() == tb.keys()
    diff = {k: (jb[k], tb[k]) for k in jb if jb[k] != tb[k]}
    assert not diff, f"{len(diff)} pods differ, e.g. {list(diff.items())[:3]}"


def test_same_pods_unschedulable(runs):
    kind, jb, tb, sched = runs
    ju = {k for k, v in jb.items() if not v}
    tu = {k for k, v in tb.items() if not v}
    assert ju == tu
    if kind == "basic":
        assert not tu
    else:
        # the 64-cpu template fits nowhere; everything else finds a node
        assert tu
        assert len(tu) < len(tb) // 2
    assert sched.cycles > 1


def _guard_pods(kind, pkg="torch"):
    make_pod = PKGS[pkg][0].make_pod
    w = make_pod().name(kind).uid(kind).namespace("default").req({"cpu": "1"})
    if kind == "affinity_preemptor":
        # an affinity pod that outranks the running pod: a coupled batch that
        # could preempt, which the reference takes off the dedup engine (B8)
        return [w.label("app", "x").pod_affinity("zone", {"app": "x"}).priority(10).obj()]
    if kind == "affinity_scan":
        # one coupled preferred-affinity component of ten distinct classes:
        # more classes than half the batch, so the reference scans it (B9)
        return [make_pod().name(f"s{i}").uid(f"s{i}").namespace("default")
                .req({"cpu": f"{100 + i}m"}).label("app", "x").label("i", str(i))
                .pod_affinity("kubernetes.io/hostname", {"app": "x"}, weight=1).obj()
                for i in range(10)]
    if kind == "spread":
        # a spread pod that outranks the running pod: a coupled batch that
        # could preempt, which the reference takes off the dedup engine
        return [w.topology_spread(1, "zone", labels={"app": "x"}).priority(10).obj()]
    if kind == "gang":
        return [w.label("pod-group.scheduling/name", "g1").obj()]
    if kind == "volume":
        return [w.pvc("claim-a").obj()]
    if kind == "claim":
        return [w.claim("dev-claim").obj()]
    assert kind == "preemptor"
    # fits nowhere, and outranks the running pod: it could preempt
    return [w.req({"cpu": "64"}).priority(10).obj()]


_GUARD_NODE = {"name": "n0", "cpu": "4", "memory": "8Gi", "pods": "110",
               "labels": {"zone": "z0"}, "taints": [], "images": [],
               "unschedulable": False, "not_ready": False}
_GUARD_RUNNING = {"name": "running", "ts": -1.0, "req": {"cpu": "100m"}, "node": "n0"}
# the batches the reference takes off its dedup engine, with the engine it
# takes: now in the port
_ENGINE_OF = {"affinity_preemptor": "batch_assign", "spread": "batch_assign",
              "affinity_scan": "greedy_assign"}


def _engine_log(monkeypatch):
    """Record the port's full-auction (classes=None) and scan calls."""
    log = []
    orig_batch, orig_scan = BatchedFramework.batch_assign, BatchedFramework.greedy_assign

    def batch_assign(self, *a, classes=None, **kw):
        if classes is None:
            log.append("batch_assign")
        return orig_batch(self, *a, classes=classes, **kw)

    def greedy_assign(self, *a, **kw):
        log.append("greedy_assign")
        return orig_scan(self, *a, **kw)

    monkeypatch.setattr(BatchedFramework, "batch_assign", batch_assign)
    monkeypatch.setattr(BatchedFramework, "greedy_assign", greedy_assign)
    return log


def _guard_bindings(pkg, nodes, pre, pods, batch_size):
    if pkg == "jax":
        store = JStore()
        sched = TPUScheduler(store, batch_size=batch_size, pipeline=False, rng_key=None,
                             clock=fake_clock(), batch_wait=0)
    else:
        store = TStore()
        sched = TorchScheduler(store, batch_size=batch_size, device="cpu",
                               clock=fake_clock(), batch_wait=0)
    for d in nodes:
        store.create("Node", make_node_obj(pkg, d))
    for d in pre:
        store.create("Pod", make_pod_obj(pkg, d))
    for pod in pods(pkg):
        store.create("Pod", pod)
    return _drive(sched, store)


@pytest.mark.parametrize("kind", ["affinity_preemptor", "spread", "gang", "volume", "claim",
                                  "preemptor", "affinity_scan"])
def test_scope_guard_raises(kind, monkeypatch):
    """Anything outside the slice raises NotImplementedError naming its
    ROADMAP item — never a silently different answer.  The coupled batches
    with a pod that could preempt (the reference's full auction) and the
    coupled batch of many classes (its exact scan) are in the slice now:
    they bind as the reference binds them, through that engine.  So are
    gang members: one whose PodGroup does not exist stays pending, as in
    the reference.  So are pods with resource claims: one whose claim does
    not exist stays pending, as in the reference.  So is a failing pod that
    could preempt: its PostFilter runs, and a pod that fits no node even
    with every lower-priority pod evicted stays pending, the running pod
    untouched, as in the reference."""
    if kind == "preemptor":
        jb = _guard_bindings("jax", [_GUARD_NODE], [_GUARD_RUNNING],
                             lambda pkg: _guard_pods(kind, pkg), 16)
        tb = _guard_bindings("torch", [_GUARD_NODE], [_GUARD_RUNNING],
                             lambda pkg: _guard_pods(kind, pkg), 16)
        assert tb == jb
        assert tb["running"] == "n0" and not tb["preemptor"]
        return
    if kind in ("gang", "claim"):
        # gang members are in the slice now (the gang runtime): a member of
        # a PodGroup that does not exist is rejected at the Coscheduling
        # PreFilter, as the reference rejects it, before any engine runs.
        # Claim pods are in the slice too (DRA): a claim that does not exist
        # is unresolvable, so DynamicResources' filter fails every node; as
        # in the reference (which has no claim PreFilter) the batch takes
        # the full auction for its pod-indexed claim aux, and the pod stays
        # pending
        jb = _guard_bindings("jax", [_GUARD_NODE], [_GUARD_RUNNING],
                             lambda pkg: _guard_pods(kind, pkg), 16)
        log = _engine_log(monkeypatch)
        tb = _guard_bindings("torch", [_GUARD_NODE], [_GUARD_RUNNING],
                             lambda pkg: _guard_pods(kind, pkg), 16)
        assert tb == jb
        assert sum(1 for v in tb.values() if not v) == 1
        assert log == ([] if kind == "gang" else ["batch_assign"])
        return
    if kind in _ENGINE_OF:
        jb = _guard_bindings("jax", [_GUARD_NODE], [_GUARD_RUNNING],
                             lambda pkg: _guard_pods(kind, pkg), 16)
        log = _engine_log(monkeypatch)
        tb = _guard_bindings("torch", [_GUARD_NODE], [_GUARD_RUNNING],
                             lambda pkg: _guard_pods(kind, pkg), 16)
        assert tb == jb
        assert all(tb.values())
        assert log and set(log) == {_ENGINE_OF[kind]}
        return
    store = TStore()
    sched = TorchScheduler(store, batch_size=16, device="cpu", clock=fake_clock(),
                           batch_wait=0)
    store.create("Node", make_node_obj("torch", _GUARD_NODE))
    store.create("Pod", make_pod_obj("torch", _GUARD_RUNNING))
    for pod in _guard_pods(kind):
        store.create("Pod", pod)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sched.schedule_cycle()


def test_scope_guard_raises_for_a_batch_too_heterogeneous_to_dedup(monkeypatch):
    """More identity classes than half the batch: the reference takes its
    full [B, N] engine, and so does the port now — with the reference's
    bindings."""
    node = dict(_GUARD_NODE, labels={})
    pods = [{"name": f"p{i}", "ts": float(i), "req": {"cpu": cpu}}
            for i, cpu in enumerate(["100m", "200m", "300m"])]
    jb = _guard_bindings("jax", [node], pods, lambda pkg: [], 4)
    log = _engine_log(monkeypatch)
    tb = _guard_bindings("torch", [node], pods, lambda pkg: [], 4)
    assert tb == jb and all(tb.values())
    assert log == ["batch_assign"]


def test_scope_guard_raises_for_pipeline_and_extenders():
    """pipeline=True is in scope (tests/test_torch_pipeline.py); extenders,
    pipelined or not, and a depth the fused cycle cannot carry are not."""
    TorchScheduler(TStore(), device="cpu", pipeline=True)
    with pytest.raises(NotImplementedError, match="item 6"):
        TorchScheduler(TStore(), device="cpu", pipeline=True, extenders=[object()])
    with pytest.raises(NotImplementedError):
        TorchScheduler(TStore(), device="cpu", extenders=[object()])
    with pytest.raises(ValueError):
        TorchScheduler(TStore(), device="cpu", pipeline=True, pipeline_depth=0)


def test_scope_guard_raises_for_a_cuda_batch_beyond_one_block():
    """The auction kernel resolves at most 1024 pods in one block: a larger
    batch on cuda raises before any card is touched; the plain versions
    on the CPU have no such limit."""
    with pytest.raises(NotImplementedError, match="B5"):
        TorchScheduler(TStore(), batch_size=2048, device="cuda")
    TorchScheduler(TStore(), batch_size=2048, device="cpu")
