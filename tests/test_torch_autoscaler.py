"""The cluster autoscaler on the port against the JAX package (exact: scale
decisions, created nodes and bindings are compared for equality).

* The reference's tests/test_autoscaler.py scenarios (:111-509) on both
  schedulers: a starved gang scaled up and bound all-or-nothing onto the
  simulated nodes, max size and at-max, the cheapest group, dry run, the
  waste measure, both expanders, scale-down with its PDB, joint-budget,
  replacement, min-size and placed-gang guards, a name squatter.  The CLI
  and the scheme round trip stay with the reference.
* Exactly once under store faults: a node create that fails before its
  write and one that fails after it (a lost response) — the scale-up
  retries with the same names, finds the written node, and the group ends
  with exactly the simulated node set, each node created once, on both
  packages (the reference's version drives its chaos module; here a store
  that fails chosen creates).
* AutoscaleGang/64Nodes through both perf harnesses: the same scale-ups,
  forks, nodes and bindings.
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

import kubernetes_tpu.api.objects as jv1
import kubernetes_tpu.autoscaler as jauto
import kubernetes_tpu.testutil as jtu
import kubernetes_tpu_torch.api.objects as tv1
import kubernetes_tpu_torch.autoscaler as tauto
import kubernetes_tpu_torch.testutil as ttu
from kubernetes_tpu.controllers.disruption import sync_pdbs as j_sync_pdbs
from kubernetes_tpu.metrics import scheduler_metrics as jm
from kubernetes_tpu.perf import harness as jh
from kubernetes_tpu.perf import workloads as jw
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.sim.store import ObjectStore as JStore
from kubernetes_tpu_torch.perf import workloads as tw
from kubernetes_tpu_torch.perf.harness import run_workload
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.sim.store import ObjectStore as TStore
from tests.test_torch_common import port_sync_pdbs

SLICE = "tpu.kubernetes.io/slice"
GROUP = "pod-group.scheduling/name"

PKG = {
    "jax": SimpleNamespace(
        tu=jtu, v1=jv1, Store=JStore, a=jauto, sync_pdbs=j_sync_pdbs,
        sched=lambda store, **kw: TPUScheduler(store, **kw)),
    "torch": SimpleNamespace(
        tu=ttu, v1=tv1, Store=TStore, a=tauto, sync_pdbs=port_sync_pdbs,
        sched=lambda store, **kw: TorchScheduler(store, device="cpu", **kw)),
}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _env(k, store=None, batch_size=8):
    clock = FakeClock()
    store = store if store is not None else k.Store()
    return clock, store, k.sched(store, batch_size=batch_size, clock=clock, batch_wait=0)


def _group(k, name="tpu", min_size=0, max_size=8, cpu="4", slice_size=4, cost=1.0):
    return k.a.NodeGroup(metadata=k.v1.ObjectMeta(name=name, namespace="default"),
                         min_size=min_size, max_size=max_size,
                         capacity={"cpu": cpu, "pods": "10"}, slice_size=slice_size,
                         cost_per_node=cost)


def _gang(k, store, name="g", members=4, cpu="3", created=100.0):
    pg = k.v1.PodGroup(metadata=k.v1.ObjectMeta(name=name, namespace="default"),
                       min_member=members, schedule_timeout_seconds=30)
    pg.metadata.creation_timestamp = created
    store.create("PodGroup", pg)
    for i in range(members):
        p = (k.tu.make_pod().name(f"{name}-{i}").uid(f"{name}-{i}").namespace("default")
             .label(GROUP, name).req({"cpu": cpu}).obj())
        p.metadata.creation_timestamp = created
        store.create("Pod", p)


def _starve(store, sched, clock, cycles=4):
    for _ in range(cycles):
        sched.schedule_cycle()
        clock.advance(0.5)
    clock.advance(40.0)  # fail any Permit hold so nothing stays assumed
    sched.schedule_cycle()


def _node(k, store, name, cpu="4", labels=None):
    w = k.tu.make_node().name(name).capacity({"cpu": cpu, "pods": "10"})
    for key, val in (labels or {}).items():
        w = w.label(key, val)
    store.create("Node", w.obj())


def _member_node(k, store, group_name, idx, slice_name="s0"):
    _node(k, store, f"{group_name}-{idx}",
          labels={k.a.NODE_GROUP_LABEL: group_name, SLICE: slice_name})


def _decisions(ca):
    return [(d.direction, d.group, d.result, d.count) for d in ca.last_decisions]


def _bindings(store):
    return {p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]}


def _nodes(store):
    return sorted(n.metadata.name for n in store.list("Node")[0])


def _both(fn):
    return fn("torch"), fn("jax")


# --- scale-up ------------------------------------------------------------------------------


def _starved_gang(pkg):
    k = PKG[pkg]
    clock, store, sched = _env(k)
    for i in range(2):  # an existing slice too small for the gang
        _node(k, store, f"n{i}", labels={SLICE: "s0"})
    store.create("NodeGroup", _group(k, max_size=8, slice_size=4))
    _gang(k, store)
    _starve(store, sched, clock)
    assert len(sched.queue.unschedulable_pods()) == 4
    ca = k.a.ClusterAutoscaler(store, sched)
    assert ca.sync_once() is True
    first = _decisions(ca)
    assert first == [("up", "tpu", "applied", 4)]
    added = k.a.member_nodes(store.get("NodeGroup", "default", "tpu"), store.list("Node")[0])
    assert sorted(n.metadata.name for n in added) == ["tpu-0", "tpu-1", "tpu-2", "tpu-3"]
    assert {n.metadata.labels[SLICE] for n in added} == {"tpu-slice-0"}
    # before the scheduler retries: the zero-add baseline fits, no more nodes
    assert ca.sync_once() is False
    sched.run_until_idle(backoff_wait=2.0)
    bound = [store.get("Pod", "default", f"g-{i}").spec.node_name for i in range(4)]
    assert set(bound) == {n.metadata.name for n in added}
    assert store.get("PodGroup", "default", "g").phase == k.v1.POD_GROUP_SCHEDULED
    assert ca.sync_once() is False and ca.last_decisions == []
    if pkg == "torch":
        assert ca.decisions == {("up", "applied"): 1}
        assert ca.engine.forks >= 2
    return first, _bindings(store), _nodes(store)


def test_scale_up_starved_gang_binds_all_or_nothing():
    port, ref = _both(_starved_gang)
    assert port == ref


def _max_size(pkg):
    k = PKG[pkg]
    clock, store, sched = _env(k)
    _node(k, store, "n0")
    store.create("NodeGroup", _group(k, max_size=2, slice_size=1))
    _gang(k, store)
    _starve(store, sched, clock)
    ca = k.a.ClusterAutoscaler(store, sched)
    assert ca.sync_once() is False
    first = _decisions(ca)
    assert [d[2] for d in first] == ["no_fit"]
    assert all(k.a.NODE_GROUP_LABEL not in n.metadata.labels for n in store.list("Node")[0])
    store.delete("NodeGroup", "default", "tpu")
    store.create("NodeGroup", _group(k, name="full", max_size=1, slice_size=1))
    _member_node(k, store, "full", 0)
    sched.schedule_cycle()
    assert ca.sync_once() is False
    assert ca.last_decisions[-1].result == "at_max"
    return first, _decisions(ca)


def test_scale_up_bounded_by_max_size():
    port, ref = _both(_max_size)
    assert port == ref


def _cheapest(pkg):
    k = PKG[pkg]
    clock, store, sched = _env(k)
    _node(k, store, "n0", cpu="1")
    # big hosts: 2 nodes × cost 4 = 8; small hosts: 4 nodes × cost 1 = 4
    store.create("NodeGroup", _group(k, name="big", cpu="8", slice_size=1, cost=4.0))
    store.create("NodeGroup", _group(k, name="small", cpu="4", slice_size=1, cost=1.0))
    _gang(k, store)
    _starve(store, sched, clock)
    ca = k.a.ClusterAutoscaler(store, sched)
    assert ca.sync_once() is True
    assert [(d[1], d[2]) for d in _decisions(ca)] == [("small", "applied")]
    sched.run_until_idle(backoff_wait=2.0)
    assert all(store.get("Pod", "default", f"g-{i}").spec.node_name for i in range(4))
    return _decisions(ca), _bindings(store)


def test_scale_up_picks_cheapest_group():
    port, ref = _both(_cheapest)
    assert port == ref


def _dry_run(pkg):
    k = PKG[pkg]
    clock, store, sched = _env(k)
    _node(k, store, "n0")
    store.create("NodeGroup", _group(k, max_size=8, slice_size=1))
    _gang(k, store, members=2)
    _starve(store, sched, clock)
    before = _nodes(store)
    ca = k.a.ClusterAutoscaler(store, sched, dry_run=True)
    assert ca.sync_once() is False
    assert ca.last_decisions[0].result == "dry_run"
    assert _nodes(store) == before
    return _decisions(ca)


def test_scale_up_dry_run_creates_nothing():
    port, ref = _both(_dry_run)
    assert port == ref


# --- expanders ------------------------------------------------------------------------------


def test_waste_of_and_unknown_expander():
    """Waste = the mean unused fraction of the ADDED capacity over the
    template's resources, as the reference computes it; an unknown expander
    is refused."""
    need = {"cpu": 4000.0, "pods": 4.0}
    for count, nd in ((1, need), (2, need), (1, {"cpu": 99999.0, "pods": 99.0})):
        got = tauto.ClusterAutoscaler._waste_of(
            object.__new__(tauto.ClusterAutoscaler), _group(PKG["torch"], name="g"), count, nd)
        want = jauto.ClusterAutoscaler._waste_of(
            object.__new__(jauto.ClusterAutoscaler), _group(PKG["jax"], name="g"), count, nd)
        assert got == want
    assert tauto.ClusterAutoscaler._waste_of(
        object.__new__(tauto.ClusterAutoscaler), _group(PKG["torch"]), 1, need) == \
        pytest.approx(0.3)
    with pytest.raises(ValueError):
        tauto.ClusterAutoscaler(TStore(), TorchScheduler(TStore(), device="cpu"),
                                expander="cheapest")


def _expander(pkg, expander):
    """'small' is cheaper in total (8 × 1.0) but strands 90% of its pods
    capacity; 'big' costs more (1 × 10.0) and the demand fills its one
    template node."""
    k = PKG[pkg]
    clock, store, sched = _env(k)
    _node(k, store, "n0", cpu="1")
    store.create("NodeGroup", _group(k, name="small", cpu="2", slice_size=1, cost=1.0))
    store.create("NodeGroup", _group(k, name="big", cpu="16", slice_size=1, cost=10.0))
    _gang(k, store, members=8, cpu="2")
    _starve(store, sched, clock)
    ca = k.a.ClusterAutoscaler(store, sched, expander=expander)
    assert ca.sync_once() is True
    sched.run_until_idle(backoff_wait=2.0)
    return _decisions(ca), _bindings(store)


@pytest.mark.parametrize("expander,want", [("least-cost", ("small", "applied", 8)),
                                           ("least-waste", ("big", "applied", 1))])
def test_expanders(expander, want):
    port = _expander("torch", expander)
    assert [d[1:] for d in port[0]] == [want]
    if expander == "least-waste":
        assert {v for n, v in port[1].items() if n.startswith("g-")} == {"big-0"}
    assert port == _expander("jax", expander)


# --- scale-down -----------------------------------------------------------------------------


def _scaled_cluster(k, idle_cpu="1", min_size=1):
    """A 3-member group: two busy hosts (3 of 4 cpu) and one underutilized
    host carrying a single small pod."""
    clock, store, sched = _env(k)
    store.create("NodeGroup", _group(k, min_size=min_size, slice_size=0))
    for i in range(3):
        _member_node(k, store, "tpu", i)
    for i in range(2):
        store.create("Pod", k.tu.make_pod().name(f"busy-{i}").uid(f"busy-{i}")
                     .namespace("default").req({"cpu": "3"}).node(f"tpu-{i}").obj())
    store.create("Pod", k.tu.make_pod().name("idle").uid("idle").namespace("default")
                 .label("app", "idle").req({"cpu": idle_cpu}).node("tpu-2").obj())
    sched.schedule_cycle()
    return store, sched


def _pdb(k, store, name, match, min_available):
    store.create("PodDisruptionBudget", k.v1.PodDisruptionBudget(
        metadata=k.v1.ObjectMeta(name=name, namespace="default"),
        selector=k.v1.LabelSelector(match_labels=match), min_available=min_available))
    k.sync_pdbs(store)


def _scale_down(pkg, case):
    k = PKG[pkg]
    if case == "drain":
        store, sched = _scaled_cluster(k)
    elif case == "pdb":
        store, sched = _scaled_cluster(k)
        _pdb(k, store, "prot", {"app": "idle"}, 1)
    elif case == "no_replacement":
        # the idle pod needs 1.5 cpu (util 0.375); the survivors have 1 free
        store, sched = _scaled_cluster(k, idle_cpu="1500m")
    elif case == "joint":
        clock, store, sched = _env(k)
        store.create("NodeGroup", _group(k, slice_size=0))
        for i in range(3):
            _member_node(k, store, "tpu", i)
        for i in range(2):
            store.create("Pod", k.tu.make_pod().name(f"busy-{i}").uid(f"busy-{i}")
                         .namespace("default").req({"cpu": "3"}).node(f"tpu-{i}").obj())
        for i in range(2):
            store.create("Pod", k.tu.make_pod().name(f"pair-{i}").uid(f"pair-{i}")
                         .namespace("default").label("app", "pair").req({"cpu": "500m"})
                         .node("tpu-2").obj())
        _pdb(k, store, "pair", {"app": "pair"}, 1)  # budget 1 < the drain's 2
        sched.schedule_cycle()
    ca = k.a.ClusterAutoscaler(store, sched)
    changed = ca.sync_once()
    [d] = ca.last_decisions
    want = {"drain": "applied", "pdb": "blocked", "no_replacement": "no_replacement",
            "joint": "blocked"}[case]
    assert (d.direction, d.result) == ("down", want)
    assert changed is (want == "applied")
    if want == "applied":
        assert store.get("Node", "", "tpu-2") is None
        assert store.get("Pod", "default", "idle") is None  # drained via the gate
        if pkg == "torch":
            assert ca.evictions.results[("autoscaler", "evicted")] == 1
            assert ca.decisions == {("down", "applied"): 1}
    else:
        assert store.get("Node", "", "tpu-2") is not None
        assert store.get("Pod", "default", "idle" if case != "joint" else "pair-0")
        if case == "pdb":
            assert "pdb" in d.note
        if case == "joint":
            assert "afford" in d.note  # refused before any eviction
    return _decisions(ca), d.note, _bindings(store), _nodes(store)


@pytest.mark.parametrize("case", ["drain", "pdb", "joint", "no_replacement"])
def test_scale_down(case):
    port = _scale_down("torch", case)
    assert port == _scale_down("jax", case)


def _guards(pkg):
    """min size: two empty members at min 2 stay; a bound gang member (tiny
    request) is never a scale-down victim."""
    k = PKG[pkg]
    clock, store, sched = _env(k)
    store.create("NodeGroup", _group(k, min_size=2, slice_size=0))
    for i in range(2):
        _member_node(k, store, "tpu", i)
    sched.schedule_cycle()
    ca = k.a.ClusterAutoscaler(store, sched)
    assert ca.sync_once() is False
    assert len(store.list("Node")[0]) == 2
    clock, store2, sched2 = _env(k)
    store2.create("NodeGroup", _group(k, slice_size=0))
    for i in range(2):
        _member_node(k, store2, "tpu", i)
    pg = k.v1.PodGroup(metadata=k.v1.ObjectMeta(name="g", namespace="default"), min_member=1)
    store2.create("PodGroup", pg)
    store2.create("Pod", k.tu.make_pod().name("g-0").uid("g-0").namespace("default")
                  .label(GROUP, "g").req({"cpu": "100m"}).node("tpu-0").obj())
    sched2.schedule_cycle()
    ca2 = k.a.ClusterAutoscaler(store2, sched2, max_scale_downs_per_sync=4)
    ca2.sync_once()
    assert store2.get("Node", "", "tpu-0") is not None
    assert store2.get("Pod", "default", "g-0") is not None
    return _decisions(ca), _decisions(ca2), _nodes(store2)


def test_scale_down_respects_min_size_and_never_breaks_a_placed_gang():
    port, ref = _both(_guards)
    assert port == ref


def _squatter(pkg):
    """tpu-0 exists without the membership label (and is full): the next
    index skips past it instead of colliding with the simulation."""
    k = PKG[pkg]
    clock, store, sched = _env(k)
    _node(k, store, "tpu-0")
    store.create("Pod", k.tu.make_pod().name("squat").uid("squat").namespace("default")
                 .req({"cpu": "4"}).node("tpu-0").obj())
    store.create("NodeGroup", _group(k, max_size=8, slice_size=2))
    _gang(k, store, members=2)
    _starve(store, sched, clock)
    ca = k.a.ClusterAutoscaler(store, sched)
    assert ca.sync_once() is True
    assert ca.last_decisions[0].result == "applied"
    assert {"tpu-1", "tpu-2"} <= set(_nodes(store))
    sched.run_until_idle(backoff_wait=2.0)
    assert all(store.get("Pod", "default", f"g-{i}").spec.node_name for i in range(2))
    return _decisions(ca), _bindings(store), _nodes(store)


def test_scale_up_skips_unlabeled_name_squatter():
    port, ref = _both(_squatter)
    assert port == ref


# --- exactly once under store faults -------------------------------------------------------


def _faulty(base):
    """A store class whose Node creates fail at chosen attempts: before the
    write (``fail_before``: nothing created) or after it (``fail_after``:
    the node exists, the caller sees an error — a lost response).  It
    counts every Node that does get written."""

    class FaultyStore(base):
        def __init__(self, fail_before=(), fail_after=()):
            super().__init__()
            self.fail_before, self.fail_after = set(fail_before), set(fail_after)
            self.node_attempts = 0
            self.created = {}

        def create(self, kind, obj):
            if kind != "Node":
                return super().create(kind, obj)
            self.node_attempts += 1
            if self.node_attempts in self.fail_before:
                raise RuntimeError("injected store fault before the write")
            rv = super().create(kind, obj)
            self.created[obj.metadata.name] = self.created.get(obj.metadata.name, 0) + 1
            if self.node_attempts in self.fail_after:
                raise RuntimeError("injected store fault after the write")
            return rv

    return FaultyStore


def _exactly_once(pkg):
    """Node create 2 (the first scale-up's first node) fails before its
    write, node create 6 (the retried scale-up's last node, tpu-3) after
    it: the decision retries with the SAME names, the node already written
    is found on the next sync, and the group ends with exactly the
    simulated slice, each node created once."""
    k = PKG[pkg]
    store = _faulty(k.Store)(fail_before=(2,), fail_after=(6,))
    clock, store, sched = _env(k, store=store)
    _node(k, store, "n0")  # node create 1
    store.create("NodeGroup", _group(k, max_size=8, slice_size=4))
    _gang(k, store)
    _starve(store, sched, clock)
    ca = k.a.ClusterAutoscaler(store, sched)
    log = []
    for _ in range(8):
        ca.sync_once()
        log.append(_decisions(ca))
        for _ in range(3):
            sched.schedule_cycle()
            clock.advance(1.0)
        if all(store.get("Pod", "default", f"g-{i}").spec.node_name for i in range(4)):
            break
    assert all(store.get("Pod", "default", f"g-{i}").spec.node_name for i in range(4))
    group_nodes = sorted(n.metadata.name for n in store.list("Node")[0]
                         if n.metadata.labels.get(k.a.NODE_GROUP_LABEL) == "tpu")
    assert group_nodes == ["tpu-0", "tpu-1", "tpu-2", "tpu-3"]
    assert all(c == 1 for c in store.created.values())
    assert log[:2] == [[("up", "tpu", "error", 0)], [("up", "tpu", "error", 3)]]
    return log, _bindings(store), group_nodes


def test_scale_up_applies_exactly_once_under_store_faults():
    port, ref = _both(_exactly_once)
    assert port == ref


# --- AutoscaleGang through both harnesses ----------------------------------------------------


def test_autoscale_gang_harness_equals_reference(monkeypatch):
    """AutoscaleGang/64Nodes (16 initial nodes, 7 gangs of 8): the same
    scale-ups, forks, nodes and bindings through both harnesses; every gang
    bound whole, the added nodes those of the applied scale-ups."""
    seen = {}

    def inspect(store, sched, ctrl):
        seen["pods"] = _bindings(store)
        seen["nodes"] = _nodes(store)
        seen["added"] = sum(d.count for d in ctrl.last_decisions if d.result == "applied")
        seen["decisions"] = dict(ctrl.decisions)

    items = run_workload(tw.build_workload("AutoscaleGang", "64Nodes"), device="cpu",
                         inspect=inspect)
    by = {it.labels["Metric"]: it.data for it in items}
    stores = []

    class Store(JStore):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            stores.append(self)

    monkeypatch.setattr(jh, "ObjectStore", Store)
    jitems = jh.run_workload(jw.build_workload("AutoscaleGang", "64Nodes"))
    monkeypatch.undo()
    jby = {it.labels["Metric"]: it.data for it in jitems}
    assert seen["pods"] == _bindings(stores[0])
    assert seen["nodes"] == _nodes(stores[0])
    assert by["AutoscalerScaleUps"] == jby["AutoscalerScaleUps"]
    assert by["WhatIfForks"]["Count"] == jby["WhatIfForks"]["Count"] == jm.whatif_forks.value(())
    assert by["AutoscalerScaleUps"]["Count"] == seen["decisions"][("up", "applied")] >= 1
    added = [n for n in seen["nodes"] if n.startswith("asg-")]
    assert len(added) == len(seen["nodes"]) - 16
    gangs = {}
    for name, node in seen["pods"].items():
        assert node, name
        gangs.setdefault(int(name.split("-")[1]) // 8, []).append(node)
    assert len(gangs) == 7 and all(len(v) == 8 for v in gangs.values())
    assert by["GangThroughput"]["Gangs"] == 7.0
