"""Config-driven workloads and their metrics, on the port.

Reference: the JAX package's perf/harness.py (``Op`` / ``Workload`` /
``DataItem`` :32-112, ``run_workload`` :132-807), itself after
test/integration/scheduler_perf (opcodes createNodes / createPods,
scheduler_perf_test.go:60-71; the throughput collector, util.go:278-345;
the attempt-duration quantiles, util.go:238-276; perf-dashboard DataItems,
util.go:165).  A workload runs against the in-process store and
``TorchScheduler(pipeline=True)`` with the workload's micro-bucket latency
target — what the JAX package's ``bench.py`` measures.

Trimmed to what the port runs: the createNodes, createObjects (PodGroups,
the DRA objects) and createPods opcodes (with ``skip_wait``).  Before the
measured window: every kernel is built (``kernels/build.py`` build_all),
then the failure warm (the reference's :236-262: one 100000-cpu pod that
fits nowhere, at priority 1 — so a failing batch runs the diagnosis and,
where a scheduled pod ranks below it, the PostFilter with its candidate mask, K1 + K27 + K28, before the
window; it nominates nothing), the suite-template warms, the micro-bucket
tier bursts (5 × tier pods per tier through the real pipelined regime,
which fill the scheduler's per-tier latency profiles) and a settle
dispatch, and for a churn suite (``Workload.churn_between_cycles``) two
calls of its hook with the objects they created deleted again (the
reference's :372-410).  The reference's anti-affinity scan warm
pre-compiles an XLA program variant the port does not have, and is left
out.  A churn suite's hook runs before every measured cycle.  The window
freezes the warmed heap out of the collector (``gc.freeze``).

Items: SchedulingThroughput, scheduler_scheduling_attempt_duration_seconds
(as the reference measures it: the batch's algorithm time, from its
dispatch start to its result reaching the host, plus the pod's own bind
segment; exact nearest-rank quantiles — the port keeps raw samples, not
histogram buckets), PhaseWallBreakdown, KernelBuildsInWindow (the port's
counterpart of the reference's XLACompilesInWindow: nvcc builds started
inside the window), and two items of the port's own:
KernelLaunchesInWindow (each kernel's launches on the card inside the
window) and PipelineInWindow (dispatches, those that chained on in-flight
batches, the placed pods they carried, and what became of the background
sync's payloads: reused, rebuilt, voided by a node delete).  A gang suite
(``Workload.gang_size``) adds the reference's GangThroughput (gangs whose
last member bound in the window, per second) and TimeToFullSlice (window
start → a gang's last member bound; nearest-rank quantiles, Perc99 beside
the reference's Perc50 / Perc90 / Max) (the reference's harness.py:431-460,
:646-660); a DRA suite (``Workload.dra``) adds ClaimsAllocated (claims
allocated in the window and per second: the window's delta of
DynamicResources' "allocated" counter, so the warm pods' commits do not
count; the reference's :467-474, :636-644).

A workload with a driven controller (``Workload.make_descheduler``: the
Defrag suite's descheduler, AutoscaleGang's cluster autoscaler) gets one
``sync_once`` after every measured ``schedule_cycle``, behind the
overlapped sync's barrier (``join_sync_ahead``; the reference's :534-538),
and its items: DeschedulerEvictions (the controller's gate evictions, count
and per second) or AutoscalerScaleUps (scale-up decisions applied), and
WhatIfForks (the forks its what-if engine evaluated, count and per second;
the reference emits it for the autoscaler, the port for both).  The
window still ends at the last bind.
"""

from __future__ import annotations

import gc
import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .. import kernels
from ..api import objects as v1
from ..device import resolve_device
from ..gang import POD_GROUP_LABEL
from ..kernels import build as kernel_build
from ..scheduler import TorchScheduler
from ..sim.store import ObjectStore
from ..testutil import make_node, make_pod


@dataclass
class Op:
    """One opcode: createNodes | createObjects | createPods."""

    opcode: str
    count: int = 0
    node_template: Optional[Callable[[int], v1.Node]] = None
    pod_template: Optional[Callable[[int], v1.Pod]] = None
    # createObjects: i → (kind, object) for setup objects that are not
    # nodes or pods (PodGroups)
    object_template: Optional[Callable[[int], tuple]] = None
    collect_metrics: bool = False
    # createPods only: do not drive the scheduler to completion afterwards
    # (scheduler_perf's skipWaitToCompletion, for never-schedulable fillers)
    skip_wait: bool = False


@dataclass
class Workload:
    name: str
    ops: List[Op] = field(default_factory=list)
    batch_size: int = 64
    # the scheduler's micro-bucket latency target (TorchScheduler
    # latency_target_ms); the harness warms every bucket tier pre-window
    latency_target_ms: Optional[float] = None
    # gang suites: members per gang, for the GangThroughput and
    # TimeToFullSlice items
    gang_size: Optional[int] = None
    # DRA suites (DeviceClaimGang): the ClaimsAllocated item, from the
    # window's delta of DynamicResources' "allocated" counter
    dra: bool = False
    # (store, sched) → a controller with sync_once(), driven once per
    # measured cycle: the Defrag suite's descheduler (DeschedulerEvictions)
    # or, with ``autoscaler``, AutoscaleGang's cluster autoscaler
    # (AutoscalerScaleUps); both add WhatIfForks
    make_descheduler: Optional[Callable] = None
    autoscaler: bool = False
    # recreate-mode churn (SchedulingWithMixedChurn): called with (store,
    # cycle index) before every measured scheduling cycle — the
    # synchronous form of scheduler_perf's background churn goroutine
    churn_between_cycles: Optional[Callable] = None
    # () → (extenders, stop): the suites that measure the extender path
    # (SchedulingExtender: one subprocess extender); the harness passes
    # the extenders to the scheduler and calls stop at the end
    make_extenders: Optional[Callable] = None


@dataclass
class DataItem:
    labels: Dict[str, str]
    data: Dict[str, float]
    unit: str

    def to_dict(self):
        return {"labels": self.labels, "data": self.data, "unit": self.unit}


def default_node(i: int) -> v1.Node:
    return (
        make_node().name(f"node-{i:06d}")
        .capacity({"cpu": "32", "memory": "64Gi", "pods": "110"})
        .label("topology.kubernetes.io/zone", f"zone-{i % 16}")
        .obj()
    )


def default_pod(i: int) -> v1.Pod:
    return (
        make_pod().name(f"pod-{i:06d}").uid(f"pod-{i:06d}").namespace("default")
        .label("app", f"app-{i % 10}")
        .req({"cpu": "1", "memory": "2Gi"})
        .obj()
    )


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank quantile of a sorted list (the reference's exact form)."""
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1,
                           max(0, int(round(q * (len(sorted_vals) - 1)))))]


def _warm(sched: TorchScheduler, store: ObjectStore, tmpl, w: Workload) -> None:
    """The pre-window warms: the failure warm, the suite-template warms, the
    micro-bucket tier bursts, the settle dispatch (the reference's
    run_workload :196-370, without its anti-affinity scan warm)."""
    warm_keys = []
    # the failure warm: fits no node even with every victim evicted, so
    # its PostFilter (at priority 1, where a scheduled pod ranks below it)
    # finds no candidate and nominates nothing
    warm = (make_pod().name("warmup-pod3").uid("warmup-pod3").namespace("default")
            .req({"cpu": "100000"}).label("warmup", "1").priority(1).obj())
    store.create("Pod", warm)
    sched.schedule_cycle()
    sched.schedule_cycle()
    warm_keys.append((warm.metadata.namespace, warm.metadata.name))

    def create(i):
        pod = tmpl(i)
        # warm pods never disturb the window's initial state
        pod.spec.preemption_policy = "Never"
        store.create("Pod", pod)
        return pod.metadata.namespace, pod.metadata.name

    # four template warms: two 2-pod batches (a coupled template forms a
    # multi-pod component, as the window's batches do), then two 1-pod
    # batches, the third through the full upload
    for wi in range(4):
        for j in range(2 if wi < 2 else 1):
            warm_keys.append(create(9_990_000 + 2 * wi + j))
        if wi == 2:
            sched.encoder.force_full_next()
        sched.schedule_cycle()
        sched.schedule_cycle()
    if w.latency_target_ms is not None:
        # every sub-bucket tier through the pipelined regime, 5 batches each
        # (scatter and forced-full uploads), so its latency profile is
        # measured before the window
        for ti, tier in enumerate(sched.bucket_tiers()):
            burst = [create(9_000_000 + 100_000 * ti + j) for j in range(5 * tier)]
            sched._forced_bucket = tier
            sched.schedule_cycle()
            sched.encoder.force_full_next()
            for _ in range(32):
                s = sched.schedule_cycle()
                if s.attempted == 0 and s.in_flight == 0:
                    break
            for ns, name in burst:
                store.delete("Pod", ns, name)
        sched._forced_bucket = None
    for ns, name in warm_keys:
        store.delete("Pod", ns, name)
    if w.latency_target_ms is not None:
        # one disposable dispatch carries the bursts' deletions, so the
        # window's first dispatch does not
        ns, name = create(9_970_000)
        sched.schedule_cycle()
        sched.schedule_cycle()
        sched.run_until_idle(max_cycles=4)
        store.delete("Pod", ns, name)
    if w.churn_between_cycles is not None:
        _warm_churn(sched, store, w)


def _warm_churn(sched: TorchScheduler, store: ObjectStore, w: Workload) -> None:
    """The churn hook twice before the window (the reference's
    run_workload :372-410): its objects' first appearance and the recreate
    path (a second call with the same cycle index deletes and re-adds
    them, then a full upload) run outside the window; every object the
    calls created is deleted again.  The hook must only have created
    objects: one that removed pre-existing state would change the window's
    declared initial cluster."""
    def key(o):
        return (getattr(o.metadata, "namespace", "") or "", o.metadata.name)

    pre = {kind: {key(o) for o in store.list(kind)[0]} for kind in ("Node", "Pod", "Service")}
    w.churn_between_cycles(store, 0)
    sched.schedule_cycle()
    sched.schedule_cycle()
    w.churn_between_cycles(store, 0)
    sched.encoder.force_full_next()
    sched.schedule_cycle()
    sched.schedule_cycle()
    for kind, had in pre.items():
        for o in list(store.list(kind)[0]):
            ns, name = key(o)
            if (ns, name) not in had:
                store.delete(kind, ns, name)
        missing = had - {key(o) for o in store.list(kind)[0]}
        assert not missing, (f"churn hook removed pre-existing {kind} objects during "
                             f"warmup: {sorted(missing)[:4]}")


def _measure(sched: TorchScheduler, store: ObjectStore, created: List[v1.Pod],
             w: Workload, clock, ctrl=None) -> List[DataItem]:
    """Drive cycles until every pod of the measured op is bound (the
    reference's window loop) → the window's items."""
    pending = {(p.namespace, p.metadata.name) for p in created}
    target = len(created)
    done = 0
    # gang suites: per-group bind counts → time-to-full-slice (window start
    # → the gang's last member bound)
    gang_counts: Dict[str, int] = {}
    gang_done_t: List[float] = []
    t0 = clock()

    def on_bind(ev):
        nonlocal done
        if ev.kind != "Pod" or not ev.obj.spec.node_name:
            return
        key = (ev.obj.namespace, ev.obj.metadata.name)
        if key in pending:
            pending.discard(key)
            done += 1
            g = ev.obj.metadata.labels.get(POD_GROUP_LABEL) if w.gang_size else None
            if g:
                gang_counts[g] = gang_counts.get(g, 0) + 1
                if gang_counts[g] == w.gang_size:
                    gang_done_t.append(clock() - t0)

    unwatch = store.watch(on_bind)
    phase0 = dict(sched.phase_wall)
    att0 = len(sched.attempt_seconds)
    builds0 = kernel_build.BUILDS
    launches0 = dict(kernels.LAUNCHES)
    pipe0 = _pipeline_counts(sched)
    # the window's delta: the warm pods' claim commits do not count
    claims0 = sched.dra_plugin.claims_allocated["allocated"]
    gc.collect()
    gc.freeze()
    try:
        t0 = clock()
        t_last = t0
        cycle = stall = 0
        waited = 0.0
        # the reference's cycle cap, over the smallest pad the micro-bucket
        # policy may dispatch (on a slower host it settles on small tiers)
        pad = min(sched.bucket_tiers() or [w.batch_size]) \
            if w.latency_target_ms is not None else w.batch_size
        max_cycles = max(64, 4 * (target // max(pad, 1) + 1))
        while done < target and cycle < max_cycles:
            if w.churn_between_cycles is not None:
                w.churn_between_cycles(store, cycle)
            done_pre = done
            stats = sched.schedule_cycle()
            if ctrl is not None:
                # an external reader of the snapshot and the encoder: the
                # background sync's barrier first
                sched.join_sync_ahead()
                ctrl.sync_once()
            if done > done_pre:
                t_last = clock()
            if stats.attempted == 0 and stats.in_flight == 0 and done == done_pre:
                # pods may be waiting out their backoff or held at Permit
                # (or were just made schedulable by the controller): spin
                # rather than misread the empty active queue as done
                a, b, u = sched.queue.pending_count()
                if (a == 0 and b == 0 and u == 0 and stats.waiting == 0) \
                        or waited > 30.0:
                    break
                time.sleep(0.02)
                waited += 0.02
                continue
            cycle += 1
            if stats.scheduled == 0 and done == done_pre:
                stall += 1
                if stall >= 8 and waited > 12.0:
                    break
            else:
                stall = 0
                waited = 0.0
                t_last = clock()
        # the window ends at the last bind, not after a terminal spin
        total_s = (t_last if done else clock()) - t0
    finally:
        gc.unfreeze()
        unwatch()
    samples = sorted(sched.attempt_seconds[att0:])
    ctrl_items = _controller_items(ctrl, w, total_s) if ctrl is not None else []
    dra_items = []
    if w.dra:
        allocated = float(sched.dra_plugin.claims_allocated["allocated"] - claims0)
        dra_items = [DataItem(
            labels={"Name": w.name, "Metric": "ClaimsAllocated"},
            data={"Count": allocated,
                  "PerSecond": round(allocated / total_s, 2) if total_s > 0 else 0.0},
            unit="claims/s")]
    gang_items = []
    if w.gang_size:
        gd = sorted(gang_done_t)
        gang_items = [
            DataItem(labels={"Name": w.name, "Metric": "GangThroughput"},
                     data={"Average": round(len(gd) / total_s, 2) if total_s > 0 else 0.0,
                           "Gangs": float(len(gd))},
                     unit="gangs/s"),
            DataItem(labels={"Name": w.name, "Metric": "TimeToFullSlice"},
                     data={"Perc50": _quantile(gd, 0.50), "Perc90": _quantile(gd, 0.90),
                           "Perc99": _quantile(gd, 0.99), "Max": gd[-1] if gd else 0.0},
                     unit="s"),
        ]
    return [
        DataItem(labels={"Name": w.name, "Metric": "SchedulingThroughput"},
                 data={"Average": round(done / total_s, 1) if total_s > 0 else 0.0},
                 unit="pods/s"),
        DataItem(labels={"Name": w.name,
                         "Metric": "scheduler_scheduling_attempt_duration_seconds"},
                 data={"Perc50": _quantile(samples, 0.50), "Perc90": _quantile(samples, 0.90),
                       "Perc95": _quantile(samples, 0.95), "Perc99": _quantile(samples, 0.99),
                       "Average": sum(samples) / max(len(samples), 1),
                       "Max": samples[-1] if samples else 0.0},
                 unit="s"),
        DataItem(labels={"Name": w.name, "Metric": "PhaseWallBreakdown"},
                 data={k: round(sched.phase_wall[k] - phase0.get(k, 0.0), 4)
                       for k in sched.phase_wall},
                 unit="s"),
        DataItem(labels={"Name": w.name, "Metric": "KernelBuildsInWindow"},
                 data={"Count": float(kernel_build.BUILDS - builds0)},
                 unit="builds"),
        DataItem(labels={"Name": w.name, "Metric": "KernelLaunchesInWindow"},
                 data={k: float(v - launches0[k]) for k, v in kernels.LAUNCHES.items()},
                 unit="launches"),
        DataItem(labels={"Name": w.name, "Metric": "PipelineInWindow"},
                 data={k: float(v - pipe0[k]) for k, v in _pipeline_counts(sched).items()},
                 unit="count"),
    ] + ctrl_items + dra_items + gang_items


def _per_s(n: float, total_s: float) -> float:
    return round(n / total_s, 2) if total_s > 0 else 0.0


def _controller_items(ctrl, w: Workload, total_s: float) -> List[DataItem]:
    """The driven controller's items (the reference's :590-632):
    AutoscalerScaleUps or DeschedulerEvictions, then WhatIfForks."""
    if w.autoscaler:
        ups = float(ctrl.decisions.get(("up", "applied"), 0))
        items = [DataItem(labels={"Name": w.name, "Metric": "AutoscalerScaleUps"},
                          data={"Count": ups}, unit="decisions")]
        engine = ctrl.engine
    else:
        evicted = float(sum(v for (_policy, result), v in ctrl.evictions.results.items()
                            if result in ("evicted", "overridden")))
        items = [DataItem(labels={"Name": w.name, "Metric": "DeschedulerEvictions"},
                          data={"Count": evicted, "PerSecond": _per_s(evicted, total_s)},
                          unit="evictions/s")]
        engine = ctrl.planner.engine
    forks = float(engine.forks)
    items.append(DataItem(labels={"Name": w.name, "Metric": "WhatIfForks"},
                          data={"Count": forks, "PerSecond": _per_s(forks, total_s)},
                          unit="forks/s"))
    return items


def _pipeline_counts(sched: TorchScheduler) -> Dict[str, int]:
    """The scheduler's pipeline counters (PipelineInWindow's fields)."""
    sync = sched.sync_overlap_counts
    return {"Dispatches": sched.cycles, "ChainedDispatches": sched.chained_dispatches,
            "CarriedPods": sched.carried_pods, "SyncAheadReused": sync["reused"],
            "SyncAheadMerged": sync["merged"],
            "SyncAheadFallbackNodeDelete": sync["fallback_node_delete"]}


def run_workload(w: Workload, device="cuda", clock=time.perf_counter,
                 inspect: Optional[Callable[[ObjectStore, TorchScheduler, object], None]] = None,
                 overlap_sync: object = "auto") -> List[DataItem]:
    """Run ``w`` end to end on ``device`` (``"cuda"`` unless the caller asks
    for the CPU; raises without a card) → the measured op's items.
    ``clock`` times the window and is the scheduler's clock too (its
    attempt latencies and the micro-bucket policy's tier profiles read
    it).  ``inspect(store, sched, ctrl)``, when given, sees the cluster
    once every op has run (``ctrl`` is the driven controller, None when the
    workload has none); ``overlap_sync`` is passed to the scheduler.  A
    workload with ``make_extenders`` runs with its extenders, stopped at
    the end."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        kernel_build.build_all()
    extenders, stop_extenders = (w.make_extenders() if w.make_extenders is not None
                                 else ([], None))
    try:
        return _run(w, dev, clock, inspect, overlap_sync, extenders)
    finally:
        if stop_extenders is not None:
            stop_extenders()


def _run(w: Workload, dev, clock, inspect, overlap_sync, extenders) -> List[DataItem]:
    store = ObjectStore()
    sched = TorchScheduler(store, batch_size=w.batch_size, device=dev, pipeline=True,
                           latency_target_ms=w.latency_target_ms, overlap_sync=overlap_sync,
                           clock=clock, extenders=extenders)
    # the run's full extent up front, with headroom for the tier bursts:
    # no tier grows mid-run
    sched.presize(
        sum(op.count for op in w.ops if op.opcode == "createNodes"),
        sum(op.count for op in w.ops if op.opcode == "createPods")
        + (3 * w.batch_size if w.latency_target_ms is not None else 0))
    ctrl = w.make_descheduler(store, sched) if w.make_descheduler is not None else None
    items: List[DataItem] = []
    node_idx = pod_idx = 0
    for op in w.ops:
        if op.opcode == "createNodes":
            tmpl = op.node_template or default_node
            for _ in range(op.count):
                store.create("Node", tmpl(node_idx))
                node_idx += 1
        elif op.opcode == "createObjects":
            # per-op indices from 0, so templates that name each other line
            # up (gang pods naming their pg-{i})
            for j in range(op.count):
                kind, obj = op.object_template(j)
                store.create(kind, obj)
        elif op.opcode == "createPods":
            tmpl = op.pod_template or default_pod
            if op.collect_metrics:
                _warm(sched, store, tmpl, w)
            created = []
            for _ in range(op.count):
                p = tmpl(pod_idx)
                store.create("Pod", p)
                created.append(p)
                pod_idx += 1
            if op.collect_metrics:
                items += _measure(sched, store, created, w, clock, ctrl)
            elif not op.skip_wait:
                sched.run_until_idle()
        else:
            raise NotImplementedError(
                f"opcode {op.opcode}: the port's harness runs createNodes, createObjects "
                "and createPods (the others come with the suites that need them, ROADMAP "
                "Queue A items 9-10)")
    if inspect is not None:
        inspect(store, sched, ctrl)
    sched.close()  # the store watch and the extender-callout pool
    return items


def data_items_to_json(items: List[DataItem]) -> str:
    """Perf-dashboard JSON shape (util.go:165 dataItems2JSONFile)."""
    return json.dumps({"version": "v1", "dataItems": [i.to_dict() for i in items]})
