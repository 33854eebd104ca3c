"""The descheduler on the port against the JAX package (exact: chosen
plans, victims, predictions and bindings are compared for equality).

* The reference's tests/test_descheduler.py scenarios of the planner, the
  policies and the controller loop (:370-611, :744-828) on both
  schedulers: the fragmented-cluster acceptance scenario (a minimal,
  PDB-respecting victim set; the prediction equals the real
  post-eviction bindings), dry run, affinity-carrying victims, the live
  state left alone, spread repair, drain with a deferred protected pod,
  the per-sync eviction cap, the minimum interval, a mid-plan refusal,
  drain chunking, a dry-run drain, never evicting another gang, an
  undersized free slice.  The eviction-gate unit tests came with
  preemption (tests/test_torch_preemption.py); the apiserver and CLI tests
  stay with the reference.  PodDisruptionBudget status: the reference's
  disruption controller (``sync_pdbs``) on its store, the same arithmetic
  here on the port's (which has no disruption controller).
* Defrag/64Nodes through both perf harnesses: the same evictions, what-if
  forks and bindings.
"""

from __future__ import annotations

from types import SimpleNamespace

import kubernetes_tpu.api.objects as jv1
import kubernetes_tpu.descheduler as jdesched
import kubernetes_tpu.testutil as jtu
import kubernetes_tpu_torch.api.objects as tv1
import kubernetes_tpu_torch.descheduler as tdesched
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
        tu=jtu, v1=jv1, Store=JStore, d=jdesched, sync_pdbs=j_sync_pdbs,
        sched=lambda store, **kw: TPUScheduler(store, **kw),
        plans=lambda ctrl, key: jm.descheduler_plans.value(key)),
    "torch": SimpleNamespace(
        tu=ttu, v1=tv1, Store=TStore, d=tdesched, sync_pdbs=port_sync_pdbs,
        sched=lambda store, **kw: TorchScheduler(store, device="cpu", **kw),
        plans=lambda ctrl, key: ctrl.plans.get(key, 0)),
}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _pod(k, name, labels=None, node="", cpu="2", created=None):
    w = k.tu.make_pod().name(name).uid(name).namespace("default").req({"cpu": cpu})
    for key, val in (labels or {}).items():
        w = w.label(key, val)
    if node:
        w = w.node(node)
    p = w.obj()
    if created is not None:
        p.metadata.creation_timestamp = created
    return p


def _sched(k, clock, batch_size=8):
    store = k.Store()
    return store, k.sched(store, batch_size=batch_size, clock=clock, batch_wait=0)


def _pdb(k, store, name, match, min_available):
    store.create("PodDisruptionBudget", k.v1.PodDisruptionBudget(
        metadata=k.v1.ObjectMeta(name=name, namespace="default"),
        selector=k.v1.LabelSelector(match_labels=match), min_available=min_available))
    k.sync_pdbs(store)


def _podgroup(k, store, name, created=1000.0, phase=None):
    pg = k.v1.PodGroup(metadata=k.v1.ObjectMeta(name=name, namespace="default"),
                       min_member=4, schedule_timeout_seconds=30)
    pg.metadata.creation_timestamp = created
    if phase is not None:
        pg.phase = phase
    store.create("PodGroup", pg)


def _fragmented_cluster(k, clock):
    """3 slices × 4 hosts; s0 fully occupied by PDB-protected stragglers, s1
    half-occupied (the cheapest viable defrag), s2 fully occupied by loose
    stragglers; a 4-member gang (3 cpu a host) waits unschedulable."""
    store, sched = _sched(k, clock)
    for i in range(12):
        store.create("Node", k.tu.make_node().name(f"n{i:02d}")
                     .capacity({"cpu": "4", "pods": "10"}).label(SLICE, f"s{i // 4}").obj())
    for i in range(4):
        store.create("Pod", _pod(k, f"prot-{i}", {"app": "prot"}, node=f"n{i:02d}"))
    store.create("Pod", _pod(k, "str-1a", node="n04"))
    store.create("Pod", _pod(k, "str-1b", node="n05"))
    for i in range(4):
        store.create("Pod", _pod(k, f"str-2{chr(97 + i)}", node=f"n{8 + i:02d}"))
    _pdb(k, store, "prot", {"app": "prot"}, 4)
    _podgroup(k, store, "g")
    for i in range(4):
        store.create("Pod", _pod(k, f"g-{i}", {GROUP: "g"}, cpu="3", created=1000.0))
    return store, sched


def _drive_to_unschedulable(store, sched, clock):
    for _ in range(6):
        sched.schedule_cycle()
        clock.advance(0.5)
    clock.advance(40.0)  # fail any Permit hold so nothing stays assumed
    sched.schedule_cycle()
    assert not any(store.get("Pod", "default", f"g-{i}").spec.node_name for i in range(4))


def _bindings(store):
    return {p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]}


def _both(fn):
    """Run a scenario on the port and on the reference → (port, reference)."""
    return fn("torch"), fn("jax")


# --- the acceptance scenario ------------------------------------------------------------


def _e2e_defrag(pkg):
    k = PKG[pkg]
    clock = FakeClock()
    store, sched = _fragmented_cluster(k, clock)
    _drive_to_unschedulable(store, sched, clock)
    ctrl = k.d.DeschedulerController(store, sched, policies=[k.d.SliceDefragmentation()])
    assert ctrl.sync_once() is True
    scored = ctrl.last_plans["defrag"]
    victims = sorted(p.metadata.name for p in scored.plan.victims)
    assert victims == ["str-1a", "str-1b"]
    assert scored.slices_freed == 1 and scored.replacements_found == 2
    assert store.get("Pod", "default", "str-1a") is None
    assert k.plans(ctrl, ("defrag", "applied")) >= 1
    sched.run_until_idle(backoff_wait=2.0)
    assert all(store.get("Pod", "default", f"prot-{i}") is not None for i in range(4))
    slices = {store.get("Node", "", store.get("Pod", "default", f"g-{i}").spec.node_name)
              .metadata.labels[SLICE] for i in range(4)}
    assert slices == {"s1"}
    pred = scored.prediction
    assert pred is not None and pred.unplaced == 0
    for pod in pred.pods:
        assert store.get("Pod", "default", pod.metadata.name).spec.node_name == \
            pred.placements[pod.uid]
    assert store.get("PodGroup", "default", "g").phase == k.v1.POD_GROUP_SCHEDULED
    return victims, pred.placements, _bindings(store)


def test_e2e_defrag_parity_and_minimal_victims():
    port, ref = _both(_e2e_defrag)
    assert port == ref


def _dry_run(pkg):
    k = PKG[pkg]
    clock = FakeClock()
    store, sched = _fragmented_cluster(k, clock)
    _drive_to_unschedulable(store, sched, clock)
    before = set(_bindings(store))
    ctrl = k.d.DeschedulerController(store, sched, dry_run=True,
                                     policies=[k.d.SliceDefragmentation()])
    assert ctrl.sync_once() is False
    scored = ctrl.last_plans["defrag"]
    assert scored.prediction is not None and scored.prediction.placed == 4
    assert set(_bindings(store)) == before
    assert k.plans(ctrl, ("defrag", "dry_run")) >= 1
    return scored.prediction.placements, sorted(v.metadata.name for v in scored.plan.victims)


def test_dry_run_mode_scores_but_evicts_nothing():
    port, ref = _both(_dry_run)
    assert port == ref


# --- the planner --------------------------------------------------------------------------


def _affinity_victim(pkg):
    """The victim on n0 carries required anti-affinity against color=g and
    n1 is nearly full: with the victim the pending color=g pod fits nowhere;
    with it evicted it lands on n0 — the fork masks the victim's affinity
    contributions."""
    k = PKG[pkg]
    clock = FakeClock()
    store, sched = _sched(k, clock, batch_size=4)
    for i in range(2):
        store.create("Node", k.tu.make_node().name(f"n{i}")
                     .capacity({"cpu": "4", "pods": "10"}).obj())
    vic = (k.tu.make_pod().name("vic").uid("vic").namespace("default")
           .req({"cpu": "1"}).label("color", "g")
           .pod_affinity("kubernetes.io/hostname", {"color": "g"}, anti=True)
           .node("n0").obj())
    store.create("Pod", vic)
    store.create("Pod", _pod(k, "filler", node="n1", cpu="3"))
    sched.schedule_cycle()
    pend = (k.tu.make_pod().name("pend").uid("pend").namespace("default")
            .req({"cpu": "2"}).label("color", "g").obj())
    pred = k.d.WhatIfPlanner(sched).predict([pend], [vic])
    assert pred is not None and pred.masked_victims == 1
    assert pred.placements["pend"] == "n0"
    assert k.d.EvictionAPI(store).evict(vic, policy="test").evicted
    store.create("Pod", pend)
    sched.run_until_idle(backoff_wait=1.0)
    assert store.get("Pod", "default", "pend").spec.node_name == pred.placements["pend"]
    return pred.placements


def test_planner_masks_affinity_victims():
    port, ref = _both(_affinity_victim)
    assert port == ref


def _live_state(pkg):
    """A predict() never changes what the real scheduler then does."""
    k = PKG[pkg]
    clock = FakeClock()
    store, sched = _sched(k, clock, batch_size=4)
    for i in range(2):
        store.create("Node", k.tu.make_node().name(f"n{i}")
                     .capacity({"cpu": "4", "pods": "10"}).obj())
    vic = _pod(k, "vic", node="n0", cpu="3")
    store.create("Pod", vic)
    sched.schedule_cycle()
    planner = k.d.WhatIfPlanner(sched)
    pend = _pod(k, "pend", cpu="3")
    pred = planner.predict([pend], [vic])
    assert pred is not None and pred.placements["pend"] in ("n0", "n1")
    store.create("Pod", pend)
    sched.run_until_idle(backoff_wait=1.0)
    assert store.get("Pod", "default", "vic") is not None
    assert store.get("Pod", "default", "pend").spec.node_name == "n1"
    return pred.placements, _bindings(store)


def test_planner_does_not_disturb_live_state():
    port, ref = _both(_live_state)
    assert port == ref


# --- policies and the controller ---------------------------------------------------------


def _spread_cluster(k, n, zones):
    clock = FakeClock()
    store, sched = _sched(k, clock, batch_size=4)
    for i in range(n):
        store.create("Node", k.tu.make_node().name(f"n{i}")
                     .capacity({"cpu": "8", "pods": "10"})
                     .label("topology.kubernetes.io/zone", zones(i)).obj())
    return clock, store, sched


def _spread_pod(k, name, node, created):
    p = (k.tu.make_pod().name(name).uid(name).namespace("default")
         .req({"cpu": "1"}).label("app", "s")
         .topology_spread(1, "topology.kubernetes.io/zone", labels={"app": "s"}).obj())
    p.spec.node_name = node
    p.metadata.creation_timestamp = created
    return p


def _spread_repair(pkg):
    k = PKG[pkg]
    clock, store, sched = _spread_cluster(k, 4, lambda i: "za" if i < 2 else "zb")
    for i in range(3):  # 3 matching pods in za, 0 in zb: skew 3 > maxSkew 1
        store.create("Pod", _spread_pod(k, f"s{i}", f"n{i % 2}", 100.0 + i))
    sched.schedule_cycle()
    ctrl = k.d.DeschedulerController(store, sched, policies=[k.d.SpreadViolationRepair()])
    assert ctrl.sync_once() is True
    scored = ctrl.last_plans["spread"]
    assert [p.metadata.name for p in scored.plan.victims] == ["s2"]
    assert store.get("Pod", "default", "s2") is None
    target = scored.prediction.placements[scored.plan.pending[0].uid]
    assert target in ("n2", "n3")
    # within skew: nothing to repair
    clock, store2, sched2 = _spread_cluster(k, 2, lambda i: f"z{i}")
    store2.create("Pod", _spread_pod(k, "s0", "n0", 100.0))
    ctrl2 = k.d.DeschedulerController(store2, sched2, policies=[k.d.SpreadViolationRepair()])
    assert ctrl2.sync_once() is False
    assert store2.get("Pod", "default", "s0") is not None
    return target, _bindings(store)


def test_spread_violation_repair_and_noop_within_skew():
    port, ref = _both(_spread_repair)
    assert port == ref


def _drain_node(k, store, name="n0", cpu="8", pods="10"):
    node = k.tu.make_node().name(name).capacity({"cpu": cpu, "pods": pods}).obj()
    node.metadata.annotations[k.d.DRAIN_ANNOTATION] = "true"
    store.create("Node", node)


def _drain_defers(pkg):
    k = PKG[pkg]
    clock = FakeClock()
    store, sched = _sched(k, clock, batch_size=4)
    _drain_node(k, store)
    store.create("Pod", _pod(k, "loose", node="n0"))
    store.create("Pod", _pod(k, "web-0", {"app": "web"}, node="n0"))
    store.create("Pod", _pod(k, "web-1", {"app": "web"}, node="n1"))
    _pdb(k, store, "pdb", {"app": "web"}, 2)
    ctrl = k.d.DeschedulerController(store, sched, policies=[k.d.NodeDrainPolicy()])
    assert ctrl.sync_once() is True
    assert store.get("Node", "", "n0").spec.unschedulable  # cordoned
    assert store.get("Pod", "default", "loose") is None
    assert store.get("Pod", "default", "web-0") is not None  # deferred, not violated
    store.create("Pod", _pod(k, "web-2", {"app": "web"}, node="n1"))
    k.sync_pdbs(store)
    ctrl.sync_once()
    assert store.get("Pod", "default", "web-0") is None
    return _bindings(store)


def test_drain_policy_cordons_and_defers_protected():
    port, ref = _both(_drain_defers)
    assert port == ref


def _rate_limit(pkg):
    k = PKG[pkg]
    clock = FakeClock()
    store, sched = _fragmented_cluster(k, clock)
    _drive_to_unschedulable(store, sched, clock)
    ctrl = k.d.DeschedulerController(store, sched, max_evictions_per_sync=1,
                                     policies=[k.d.SliceDefragmentation()])
    # the cheapest plan needs 2 evictions > cap 1: nothing may be applied
    assert ctrl.sync_once() is False
    assert store.get("Pod", "default", "str-1a") is not None
    assert store.get("Pod", "default", "str-1b") is not None
    return _bindings(store)


def test_controller_rate_limit_caps_evictions_per_sync():
    port, ref = _both(_rate_limit)
    assert port == ref


def _min_interval(pkg):
    k = PKG[pkg]
    clock = FakeClock()
    store, sched = _fragmented_cluster(k, clock)
    _drive_to_unschedulable(store, sched, clock)
    ctrl = k.d.DeschedulerController(store, sched, min_interval=100.0,
                                     policies=[k.d.SliceDefragmentation()])
    assert ctrl.sync_once() is True
    assert ctrl.sync_once() is False  # held until the interval elapses
    clock.advance(101.0)
    again = ctrl.sync_once()
    return again, _bindings(store)


def test_controller_min_interval_spaces_active_syncs():
    port, ref = _both(_min_interval)
    assert port == ref


def _mid_plan_refusal(pkg):
    """A victim refused mid-plan (a budget raced away between scoring and
    apply) stops the plan: the remaining victims stay, outcome abandoned."""
    k = PKG[pkg]
    clock = FakeClock()
    store, sched = _fragmented_cluster(k, clock)
    _drive_to_unschedulable(store, sched, clock)
    ctrl = k.d.DeschedulerController(store, sched, policies=[k.d.SliceDefragmentation()])
    before = k.plans(ctrl, ("defrag", "abandoned"))
    real_scored = ctrl._scored

    def scored_then_protect(plan, prediction):
        scored = real_scored(plan, prediction)
        if scored.viable and not store.get("PodDisruptionBudget", "default", "race"):
            for v_ in plan.victims:
                v_.metadata.labels["raced"] = "1"
                store.update("Pod", v_)
            _pdb(k, store, "race", {"raced": "1"}, len(plan.victims))
        return scored

    ctrl._scored = scored_then_protect
    ctrl.sync_once()
    assert k.plans(ctrl, ("defrag", "abandoned")) == before + 1
    assert store.get("Pod", "default", "str-1a") is not None
    assert store.get("Pod", "default", "str-1b") is not None
    return _bindings(store)


def test_mid_plan_refusal_abandons_plan():
    port, ref = _both(_mid_plan_refusal)
    assert port == ref


def _drain_chunks(pkg):
    k = PKG[pkg]
    clock = FakeClock()
    store, sched = _sched(k, clock, batch_size=4)
    _drain_node(k, store, cpu="32", pods="20")
    for i in range(5):
        store.create("Pod", _pod(k, f"p{i}", node="n0", cpu="1"))
    ctrl = k.d.DeschedulerController(store, sched, max_evictions_per_sync=2,
                                     policies=[k.d.NodeDrainPolicy()])
    assert ctrl.sync_once() is True
    remaining = [i for i in range(5) if store.get("Pod", "default", f"p{i}") is not None]
    assert len(remaining) == 3  # chunked to the budget, not skipped
    ctrl.sync_once()
    ctrl.sync_once()
    assert all(store.get("Pod", "default", f"p{i}") is None for i in range(5))
    # a dry-run drain neither cordons nor evicts
    store2, sched2 = _sched(k, clock, batch_size=4)
    _drain_node(k, store2)
    store2.create("Pod", _pod(k, "p0", node="n0"))
    ctrl2 = k.d.DeschedulerController(store2, sched2, dry_run=True,
                                      policies=[k.d.NodeDrainPolicy()])
    assert ctrl2.sync_once() is False
    assert not store2.get("Node", "", "n0").spec.unschedulable
    assert store2.get("Pod", "default", "p0") is not None
    return remaining


def test_drain_plan_chunks_to_eviction_budget_and_dry_run_does_not_cordon():
    port, ref = _both(_drain_chunks)
    assert port == ref


def _other_gang(pkg):
    """A slice hosting a PLACED gang is disqualified outright."""
    k = PKG[pkg]
    clock = FakeClock()
    store, sched = _sched(k, clock)
    for i in range(8):
        store.create("Node", k.tu.make_node().name(f"n{i:02d}")
                     .capacity({"cpu": "4", "pods": "10"}).label(SLICE, f"s{i // 4}").obj())
    _podgroup(k, store, "ga", phase=k.v1.POD_GROUP_SCHEDULED)
    for i in range(4):
        store.create("Pod", _pod(k, f"ga-{i}", {GROUP: "ga"}, node=f"n{i:02d}", cpu="3"))
    for i in range(4):
        store.create("Pod", _pod(k, f"str-{i}", node=f"n{4 + i:02d}"))
    _podgroup(k, store, "gb")
    for i in range(4):
        store.create("Pod", _pod(k, f"gb-{i}", {GROUP: "gb"}, cpu="3", created=1000.0))
    for _ in range(4):
        sched.schedule_cycle()
        clock.advance(0.5)
    clock.advance(40.0)
    sched.schedule_cycle()
    ctrl = k.d.DeschedulerController(store, sched, policies=[k.d.SliceDefragmentation()])
    ctrl.sync_once()
    assert all(store.get("Pod", "default", f"ga-{i}") is not None for i in range(4))
    assert all(store.get("Pod", "default", f"str-{i}") is None for i in range(4))
    sched.run_until_idle(backoff_wait=2.0)
    assert all(store.get("Pod", "default", f"gb-{i}").spec.node_name for i in range(4))
    return _bindings(store)


def test_defrag_never_evicts_another_gangs_members():
    port, ref = _both(_other_gang)
    assert port == ref


def _undersized(pkg):
    """A straggler-free slice too small to seat the gang does not satisfy
    the free-slice short-circuit."""
    k = PKG[pkg]
    clock = FakeClock()
    store, sched = _sched(k, clock)
    for i in range(2):
        store.create("Node", k.tu.make_node().name(f"small-{i}")
                     .capacity({"cpu": "4", "pods": "10"}).label(SLICE, "s0").obj())
    for i in range(4):
        store.create("Node", k.tu.make_node().name(f"n{i}")
                     .capacity({"cpu": "4", "pods": "10"}).label(SLICE, "s1").obj())
        store.create("Pod", _pod(k, f"str-{i}", node=f"n{i}"))
    _podgroup(k, store, "g")
    for i in range(4):
        store.create("Pod", _pod(k, f"g-{i}", {GROUP: "g"}, cpu="3", created=1000.0))
    for _ in range(4):
        sched.schedule_cycle()
        clock.advance(0.5)
    clock.advance(40.0)
    sched.schedule_cycle()
    ctrl = k.d.DeschedulerController(store, sched, policies=[k.d.SliceDefragmentation()])
    assert ctrl.sync_once() is True
    assert all(store.get("Pod", "default", f"str-{i}") is None for i in range(4))
    sched.run_until_idle(backoff_wait=2.0)
    assert all(store.get("Pod", "default", f"g-{i}").spec.node_name for i in range(4))
    return _bindings(store)


def test_defrag_ignores_undersized_free_slice():
    port, ref = _both(_undersized)
    assert port == ref


# --- Defrag through both harnesses ---------------------------------------------------------


def test_defrag_harness_equals_reference(monkeypatch):
    """Defrag/64Nodes (64 fragmented hosts in 8 slices, 4 gangs of 8): the
    same evictions, forks and bindings through both harnesses; every gang
    bound whole inside one slice, no gang member evicted, 8 evictions per
    freed slice."""
    seen = {}

    def inspect(store, sched, ctrl):
        seen["pods"] = _bindings(store)
        seen["slice_of"] = {n.metadata.name: n.metadata.labels[SLICE]
                            for n in store.list("Node")[0]}

    items = run_workload(tw.build_workload("Defrag", "64Nodes"), device="cpu", inspect=inspect)
    by = {it.labels["Metric"]: it.data for it in items}
    stores = []

    class Store(JStore):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            stores.append(self)

    monkeypatch.setattr(jh, "ObjectStore", Store)
    jitems = jh.run_workload(jw.build_workload("Defrag", "64Nodes"))
    monkeypatch.undo()
    jby = {it.labels["Metric"]: it.data for it in jitems}
    assert seen["pods"] == _bindings(stores[0])
    assert by["DeschedulerEvictions"]["Count"] == jby["DeschedulerEvictions"]["Count"]
    # the reference's harness resets its metrics registry at the start
    assert by["WhatIfForks"]["Count"] == jm.whatif_forks.value(()) > 0
    gangs = {}
    for name, node in seen["pods"].items():
        if name.startswith("gang-"):
            assert node, name
            gangs.setdefault(int(name.split("-")[1]) // 8, set()).add(seen["slice_of"][node])
    assert len(gangs) == 4 and all(len(s) == 1 for s in gangs.values())
    evicted = {f"strag-{i:06d}" for i in range(64)} - set(seen["pods"])
    freed = {seen["slice_of"][f"node-{int(n.split('-')[1]):06d}"] for n in evicted}
    assert len(evicted) == 8 * len(freed) == by["DeschedulerEvictions"]["Count"]
    assert by["GangThroughput"]["Gangs"] == 4.0
    assert set(by["KernelLaunchesInWindow"].values()) == {0.0}
