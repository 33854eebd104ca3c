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
then the suite-template warms, the micro-bucket tier bursts (5 × tier
pods per tier through the real pipelined regime, which fill the
scheduler's per-tier latency profiles) and a settle dispatch.  The reference's XLA-only warms — the
anti-affinity scan warm and the priority-1 failure warm — pre-compile
programs the port does not have, and are left out.  The window freezes
the warmed heap out of the collector (``gc.freeze``).

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
    """The pre-window warms: the suite-template warms, the micro-bucket tier
    bursts, the settle dispatch (the reference's run_workload :196-370,
    without its XLA-only warms)."""
    warm_keys = []

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


def _measure(sched: TorchScheduler, store: ObjectStore, created: List[v1.Pod],
             w: Workload, clock) -> List[DataItem]:
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
            done_pre = done
            stats = sched.schedule_cycle()
            if done > done_pre:
                t_last = clock()
            if stats.attempted == 0 and stats.in_flight == 0 and done == done_pre:
                # pods may be waiting out their backoff or held at Permit:
                # spin rather than misread the empty active queue as done
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
    ] + dra_items + gang_items


def _pipeline_counts(sched: TorchScheduler) -> Dict[str, int]:
    """The scheduler's pipeline counters (PipelineInWindow's fields)."""
    sync = sched.sync_overlap_counts
    return {"Dispatches": sched.cycles, "ChainedDispatches": sched.chained_dispatches,
            "CarriedPods": sched.carried_pods, "SyncAheadReused": sync["reused"],
            "SyncAheadMerged": sync["merged"],
            "SyncAheadFallbackNodeDelete": sync["fallback_node_delete"]}


def run_workload(w: Workload, device="cuda", clock=time.perf_counter,
                 inspect: Optional[Callable[[ObjectStore, TorchScheduler], None]] = None,
                 overlap_sync: object = "auto") -> List[DataItem]:
    """Run ``w`` end to end on ``device`` (``"cuda"`` unless the caller asks
    for the CPU; raises without a card) → the measured op's items.
    ``inspect(store, sched)``, when given, sees the cluster once every op
    has run; ``overlap_sync`` is passed to the scheduler."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        kernel_build.build_all()
    store = ObjectStore()
    sched = TorchScheduler(store, batch_size=w.batch_size, device=dev, pipeline=True,
                           latency_target_ms=w.latency_target_ms, overlap_sync=overlap_sync)
    # the run's full extent up front, with headroom for the tier bursts:
    # no tier grows mid-run
    sched.presize(
        sum(op.count for op in w.ops if op.opcode == "createNodes"),
        sum(op.count for op in w.ops if op.opcode == "createPods")
        + (3 * w.batch_size if w.latency_target_ms is not None else 0))
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
                items += _measure(sched, store, created, w, clock)
            elif not op.skip_wait:
                sched.run_until_idle()
        else:
            raise NotImplementedError(
                f"opcode {op.opcode}: the port's harness runs createNodes, createObjects "
                "and createPods (the others come with the suites that need them, ROADMAP "
                "Queue A items 9-10)")
    if inspect is not None:
        inspect(store, sched)
    sched.close()
    return items


def data_items_to_json(items: List[DataItem]) -> str:
    """Perf-dashboard JSON shape (util.go:165 dataItems2JSONFile)."""
    return json.dumps({"version": "v1", "dataItems": [i.to_dict() for i in items]})
