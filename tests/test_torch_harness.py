"""The port's perf workloads and harness against the JAX package's.

* ``build_workload`` of every suite the port carries gives the reference's
  ops (opcode, count, templates, collect / skip flags), batch size and
  micro-bucket latency target, at full size and scaled; the templates
  build the same pods and nodes.
* Every other suite of the reference raises NotImplementedError naming
  its ROADMAP item.
* ``run_workload`` of the port on ``device="cpu"`` at scale 0.02 runs
  NorthStar, TopologySpreading, SchedulingPodAntiAffinity,
  SchedulingWithMixedChurn and SchedulingExtender (its subprocess
  extender on the path) to the end:
  every measured pod bound, the reference's item names and labels (with
  KernelBuildsInWindow for its XLACompilesInWindow), no kernel built in the
  window; NorthStar runs on a stepped clock (every read 0.1 s after the
  last), so its micro-bucket policy takes a sub-bucket on any host and the
  window's batches chain; the default device raises without a card.
* SchedulingWithMixedChurn at the reference's test scale through both
  harnesses: the churn hook's warm calls and its call before every
  measured cycle give the reference's bindings, churn pods included.
"""

from __future__ import annotations

import time

import pytest
import torch

from kubernetes_tpu.perf import harness as jh
from kubernetes_tpu.perf import workloads as jw
from kubernetes_tpu.sim.store import ObjectStore as JStore
from kubernetes_tpu_torch.perf import workloads as tw
from kubernetes_tpu_torch.perf.harness import data_items_to_json, run_workload

PORTED = sorted(tw.SUITES)


def _same_object(a, b, what):
    assert a.metadata.name == b.metadata.name, what
    assert a.metadata.namespace == b.metadata.namespace, what
    assert a.metadata.labels == b.metadata.labels, what
    assert repr(a.spec) == repr(b.spec), what
    if hasattr(a, "status") and hasattr(a.status, "allocatable"):
        assert repr(a.status.allocatable) == repr(b.status.allocatable), what


@pytest.mark.parametrize("scale", [1.0, 0.02])
@pytest.mark.parametrize("suite", PORTED)
def test_build_workload_equals_reference(suite, scale):
    assert set(tw.SUITES[suite].sizes) == set(jw.SUITES[suite].sizes)
    for size in jw.SUITES[suite].sizes:
        j = jw.build_workload(suite, size, scale=scale)
        t = tw.build_workload(suite, size, scale=scale)
        assert (t.name, t.batch_size, t.latency_target_ms) == \
            (j.name, j.batch_size, j.latency_target_ms)
        assert len(t.ops) == len(j.ops)
        for jo, to in zip(j.ops, t.ops):
            assert (to.opcode, to.count, to.collect_metrics, to.skip_wait) == \
                (jo.opcode, jo.count, jo.collect_metrics, jo.skip_wait)
            for i in (0, 1, 7):
                if jo.node_template is not None:
                    _same_object(jo.node_template(i), to.node_template(i), f"{suite} node {i}")
                if jo.pod_template is not None:
                    _same_object(jo.pod_template(i), to.pod_template(i), f"{suite} pod {i}")


def test_the_other_suites_name_their_roadmap_item():
    others = sorted(set(jw.SUITES) - set(tw.SUITES))
    assert set(others) == set(tw.UNPORTED)
    for suite in others:
        size = next(iter(jw.SUITES[suite].sizes))
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A item"):
            tw.build_workload(suite, size)


def _stepped_clock(step: float):
    """A clock that advances ``step`` seconds at every read."""
    t = [0.0]

    def clock():
        t[0] += step
        return t[0]

    return clock


@pytest.mark.parametrize("suite,size", [("NorthStar", "5000Nodes/10000Pods"),
                                        ("TopologySpreading", "5000Nodes"),
                                        ("SchedulingPodAntiAffinity", "5000Nodes"),
                                        ("SchedulingWithMixedChurn", "5000Nodes"),
                                        ("SchedulingExtender", "500Nodes")])
def test_run_workload_on_cpu_binds_every_measured_pod(suite, size):
    w = tw.build_workload(suite, size, scale=0.02)
    seen = {}

    def inspect(store, sched, _ctrl):
        pods, _ = store.list("Pod")
        measured = w.ops[-1].pod_template
        # the measured pods' indices follow the earlier createPods ops'
        first = sum(op.count for op in w.ops[:-1] if op.opcode == "createPods")
        names = {measured(i).metadata.name for i in range(first, first + w.ops[-1].count)}
        seen["unbound"] = [p.metadata.name for p in pods
                           if p.metadata.name in names and not p.spec.node_name]
        seen["measured"] = sum(1 for p in pods if p.metadata.name in names)
        seen["tiers"] = dict(sched._tier_p99)

    # NorthStar: every attempt spans at least two clock reads, 0.2 s, over
    # 90% of the 200 ms target at every tier, so the policy takes its
    # smallest tier whatever the host's speed (the harness passes its clock
    # to the scheduler)
    clock = _stepped_clock(0.1) if suite == "NorthStar" else time.perf_counter
    items = run_workload(w, device="cpu", inspect=inspect, clock=clock)
    assert seen["measured"] == w.ops[-1].count and not seen["unbound"]
    by_metric = {it.labels["Metric"]: it for it in items}
    assert set(by_metric) == {"SchedulingThroughput",
                              "scheduler_scheduling_attempt_duration_seconds",
                              "PhaseWallBreakdown", "KernelBuildsInWindow",
                              "KernelLaunchesInWindow", "PipelineInWindow"}
    assert all(it.labels["Name"] == w.name for it in items)
    assert by_metric["SchedulingThroughput"].unit == "pods/s"
    assert by_metric["SchedulingThroughput"].data["Average"] > 0
    att = by_metric["scheduler_scheduling_attempt_duration_seconds"].data
    assert 0 < att["Perc50"] <= att["Perc90"] <= att["Perc99"] <= att["Max"]
    assert by_metric["KernelBuildsInWindow"].data == {"Count": 0.0}
    # on the CPU every wrapper takes its plain version: no launch
    assert set(by_metric["KernelLaunchesInWindow"].data.values()) == {0.0}
    pipe = by_metric["PipelineInWindow"].data
    assert pipe["Dispatches"] > 0
    assert pipe["SyncAheadReused"] + pipe["SyncAheadMerged"] > 0
    if suite == "NorthStar":  # a window of several sub-bucket batches chains
        assert 0 < pipe["ChainedDispatches"] < pipe["Dispatches"]
        assert pipe["CarriedPods"] > 0
    assert {"snapshot", "compile", "device", "bind", "sync_overlap"} <= \
        set(by_metric["PhaseWallBreakdown"].data)
    if w.latency_target_ms is not None:
        # the tier bursts profiled every sub-bucket tier before the window
        assert set(seen["tiers"]) >= set(
            t for t in (w.batch_size // 2, w.batch_size // 4) if t >= 16)
    assert '"dataItems"' in data_items_to_json(items)


def test_run_workload_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_workload(tw.build_workload("NorthStar", "5000Nodes/10000Pods", scale=0.001))


def test_mixed_churn_bindings_equal_reference(monkeypatch):
    """SchedulingWithMixedChurn/1000Nodes at the reference's test scale
    (tests/test_perf_workloads.py: scale 0.01, B = 8) through both
    harnesses: the same bindings, the churn nodes and pods included."""
    w_t = tw.build_workload("SchedulingWithMixedChurn", "1000Nodes", scale=0.01)
    w_j = jw.build_workload("SchedulingWithMixedChurn", "1000Nodes", scale=0.01)
    w_t.batch_size = w_j.batch_size = 8
    assert w_t.churn_between_cycles is not None
    seen = {}

    def inspect(store, _sched, _ctrl):
        seen["pods"] = {p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]}
        seen["nodes"] = sorted(n.metadata.name for n in store.list("Node")[0])

    items = run_workload(w_t, device="cpu", inspect=inspect)
    stores = []

    class Store(JStore):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            stores.append(self)

    monkeypatch.setattr(jh, "ObjectStore", Store)
    jh.run_workload(w_j)
    monkeypatch.undo()
    assert seen["pods"] == {p.metadata.name: p.spec.node_name
                            for p in stores[0].list("Pod")[0]}
    assert seen["nodes"] == sorted(n.metadata.name for n in stores[0].list("Node")[0])
    churn = [name for name, node in seen["pods"].items() if name.startswith("churn-pod")]
    assert churn and any(seen["pods"][n] for n in churn)
    assert any(node.startswith("churn-node") for node in seen["pods"].values())
    by = {it.labels["Metric"]: it.data for it in items}
    assert by["SchedulingThroughput"]["Average"] > 0
