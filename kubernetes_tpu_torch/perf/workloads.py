"""Named benchmark workloads after the reference's scheduler_perf suite.

Reference: the JAX package's perf/workloads.py, itself after
test/integration/scheduler_perf/config/performance-config.yaml and the
pod / node templates it references (node-default.yaml: 4 cpu / 32Gi / 110
pods; pod-default.yaml: 100m / 500Mi; the color-selector affinity and
spread pods).  Each suite has the reference's shape, named sizes
(initNodes, initPods, measurePods), batch sizes and latency targets;
``scale`` runs the same shapes small.

The port carries the suites whose pods it schedules: SchedulingBasic,
NorthStar, Density, TopologySpreading, PreferredTopologySpreading,
SchedulingNodeAffinity, SchedulingPodAntiAffinity, SchedulingPodAffinity,
SchedulingPreferredPodAffinity, Unschedulable, PreemptionBasic,
SchedulingWithMixedChurn, SchedulingExtender, GangBasic, DeviceClaimGang,
Defrag and AutoscaleGang.  ``build_workload`` of any other
suite raises NotImplementedError naming the ROADMAP item that brings what it
needs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..api import objects as v1
from ..state.units import pow2_round_up
from ..testutil import make_node, make_pod
from .harness import Op, Workload

ZONES3 = ["moon-1", "moon-2", "moon-3"]


def node_default(i: int) -> v1.Node:
    return (
        make_node().name(f"node-{i:06d}")
        .capacity({"cpu": "4", "memory": "32Gi", "pods": "110"})
        .obj()
    )


def node_unique_hostname(i: int) -> v1.Node:
    return (
        make_node().name(f"node-{i:06d}")
        .capacity({"cpu": "4", "memory": "32Gi", "pods": "110"})
        .label("kubernetes.io/hostname", f"node-{i:06d}")
        .obj()
    )


def node_zoned(zones: List[str]) -> Callable[[int], v1.Node]:
    def tmpl(i: int) -> v1.Node:
        return (
            make_node().name(f"node-{i:06d}")
            .capacity({"cpu": "4", "memory": "32Gi", "pods": "110"})
            .label("topology.kubernetes.io/zone", zones[i % len(zones)])
            .obj()
        )

    return tmpl


def _base_pod(i: int, prefix: str, ns: str = "default"):
    return make_pod().name(f"{prefix}-{i:06d}").uid(f"{prefix}-{i:06d}").namespace(ns)


def pod_default(i: int, ns: str = "default") -> v1.Pod:
    return _base_pod(i, "pod", ns).req({"cpu": "100m", "memory": "500Mi"}).obj()


def pod_low_priority(i: int) -> v1.Pod:
    return _base_pod(i, "low", "default").req({"cpu": "900m", "memory": "500Mi"}).obj()


def pod_high_priority(i: int) -> v1.Pod:
    return (
        _base_pod(i, "high", "default")
        .req({"cpu": "3000m", "memory": "500Mi"})
        .priority(10)
        .obj()
    )


def pod_large_cpu(i: int) -> v1.Pod:
    return _base_pod(i, "large", "default").req({"cpu": "9", "memory": "500Mi"}).obj()


def pod_anti_affinity(ns: str) -> Callable[[int], v1.Pod]:
    """pod-with-pod-anti-affinity.yaml: color=green, required anti-affinity
    on kubernetes.io/hostname across sched-0/sched-1."""

    def tmpl(i: int) -> v1.Pod:
        return (
            _base_pod(i, f"anti-{ns}", ns)
            .req({"cpu": "100m", "memory": "500Mi"})
            .label("color", "green")
            .pod_affinity("kubernetes.io/hostname", {"color": "green"}, anti=True,
                          namespaces=["sched-0", "sched-1"])
            .obj()
        )

    return tmpl


def pod_affinity(ns: str) -> Callable[[int], v1.Pod]:
    """pod-with-pod-affinity.yaml: color=blue, required affinity on zone."""

    def tmpl(i: int) -> v1.Pod:
        return (
            _base_pod(i, f"aff-{ns}", ns)
            .req({"cpu": "100m", "memory": "500Mi"})
            .label("color", "blue")
            .pod_affinity("topology.kubernetes.io/zone", {"color": "blue"},
                          namespaces=["sched-0", "sched-1"])
            .obj()
        )

    return tmpl


def pod_topology_spread(i: int) -> v1.Pod:
    """pod-with-topology-spreading.yaml: maxSkew=5 DoNotSchedule on zone."""
    return (
        _base_pod(i, "spread", "default")
        .req({"cpu": "100m", "memory": "500Mi"})
        .label("color", "blue")
        .topology_spread(5, "topology.kubernetes.io/zone", labels={"color": "blue"})
        .obj()
    )


def pod_preferred_topology_spread(i: int) -> v1.Pod:
    """pod-with-preferred-topology-spreading.yaml: maxSkew=5 ScheduleAnyway."""
    return (
        _base_pod(i, "pspread", "default")
        .req({"cpu": "100m", "memory": "500Mi"})
        .label("color", "blue")
        .topology_spread(5, "topology.kubernetes.io/zone",
                         when_unsatisfiable=v1.SCHEDULE_ANYWAY, labels={"color": "blue"})
        .obj()
    )


def pod_node_affinity(i: int) -> v1.Pod:
    """pod-with-node-affinity.yaml: required node affinity zone In
    {zone1, zone2}."""
    return (
        _base_pod(i, "naff", "default")
        .req({"cpu": "100m", "memory": "500Mi"})
        .node_affinity_in("topology.kubernetes.io/zone", ["zone1", "zone2"])
        .obj()
    )


def pod_preferred_affinity(ns: str) -> Callable[[int], v1.Pod]:
    """pod-with-preferred-pod-affinity.yaml: color=red, PREFERRED (w=1)
    affinity on hostname across sched-0/sched-1."""

    def tmpl(i: int) -> v1.Pod:
        return (
            _base_pod(i, f"paff-{ns}", ns)
            .req({"cpu": "100m", "memory": "500Mi"})
            .label("color", "red")
            .pod_affinity("kubernetes.io/hostname", {"color": "red"}, weight=1,
                          namespaces=["sched-1", "sched-0"])
            .obj()
        )

    return tmpl


GANG_SIZE = 8  # members per slice job (one multi-host TPU slice)


def node_sliced(gang_size: int = GANG_SIZE) -> Callable[[int], v1.Node]:
    """One TPU host VM per node, ``gang_size`` hosts per slice — the slice
    label feeds the Coscheduling anchor-slice score plane."""
    from ..gang import SLICE_LABEL

    def tmpl(i: int) -> v1.Node:
        return (
            make_node().name(f"node-{i:06d}")
            .capacity({"cpu": "4", "memory": "32Gi", "pods": "110"})
            .label(SLICE_LABEL, f"slice-{i // gang_size:05d}")
            .obj()
        )

    return tmpl


def pod_gang(gang_size: int = GANG_SIZE) -> Callable[[int], v1.Pod]:
    """Gang member i belongs to PodGroup pg-{i // gang_size}; the 3-cpu
    request packs ONE member per 4-cpu host (a slice job owns its hosts).
    Harness warm indices (≥ 9M) yield plain pods: the warms exercise the
    normal bind path, not the quorum gate of a group that does not exist."""
    from ..gang import POD_GROUP_LABEL

    def tmpl(i: int) -> v1.Pod:
        if i >= 9_000_000:
            return pod_default(i)
        return (
            _base_pod(i, "gang", "default")
            .label(POD_GROUP_LABEL, f"pg-{i // gang_size:05d}")
            .req({"cpu": "3000m", "memory": "500Mi"})
            .obj()
        )

    return tmpl


def podgroup_template(gang_size: int = GANG_SIZE) -> Callable[[int], tuple]:
    """PodGroup pg-{i}: min_member ``gang_size``, a 60 s schedule timeout."""

    def tmpl(i: int):
        pg = v1.PodGroup(
            metadata=v1.ObjectMeta(name=f"pg-{i:05d}", namespace="default"),
            min_member=gang_size,
            schedule_timeout_seconds=60,
        )
        return ("PodGroup", pg)

    return tmpl


def straggler_per_host() -> Callable[[int], v1.Pod]:
    """Straggler i lands PRE-BOUND on host i (a 2-cpu pod on a 4-cpu host):
    with one on EVERY host no slice — and no set of hosts — can take a
    3-cpu gang member, so the gangs are blocked until the descheduler frees
    whole slices.  Warm indices (≥ 9M) yield tiny UNBOUND pods that fit
    beside any straggler (the warms exercise the normal bind path)."""

    def tmpl(i: int) -> v1.Pod:
        if i >= 9_000_000:
            return _base_pod(i, "stragwarm", "default").req({"cpu": "1m"}).obj()
        return (
            _base_pod(i, "strag", "default")
            .req({"cpu": "2000m", "memory": "500Mi"})
            .label("strag", "1")
            .node(f"node-{i:06d}")
            .obj()
        )

    return tmpl


def _defrag(n, p, mp) -> Workload:
    """Defrag (the reference's perf/workloads.py:480-525): every host starts
    fragmented by a pre-bound straggler; the gangs are unschedulable until
    the descheduler's slice-defrag policy evicts whole straggler sets (each
    group of candidate slices scored by one K-fork evaluate) — measures
    time to a free slice (TimeToFullSlice spans defrag + gang bind) and
    evictions/s (DeschedulerEvictions)."""
    from ..descheduler import DeschedulerController, SliceDefragmentation

    gs = GANG_SIZE if mp >= GANG_SIZE else max(2, mp)
    n_slices = max(1, n // gs)
    ngangs = max(1, min(mp // gs, n_slices))
    stragglers = min(p, n) if p else n
    strag_tmpl = straggler_per_host()
    gang_tmpl = pod_gang(gs)

    def make_descheduler(store, sched):
        # 16 gangs served per sync keeps the 5000-node size (312 waiting
        # gangs) inside the harness's cycle budget; each freed slice costs
        # gs straggler evictions
        return DeschedulerController(
            store, sched, policies=[SliceDefragmentation(max_gangs_per_sync=16)],
            max_evictions_per_sync=16 * gs)

    return Workload(
        name="Defrag",
        ops=[
            Op("createNodes", n, node_template=node_sliced(gs)),
            # pre-bound stragglers: the post-op run_until_idle is a no-op
            Op("createPods", stragglers, pod_template=strag_tmpl),
            Op("createObjects", ngangs, object_template=podgroup_template(gs)),
            # the harness's pod index continues past the stragglers: shift so
            # gang pod i still references pg-{i // gs}
            Op("createPods", ngangs * gs,
               pod_template=lambda i: gang_tmpl(i if i >= 9_000_000 else i - stragglers),
               collect_metrics=True),
        ],
        batch_size=64,
        gang_size=gs,
        make_descheduler=make_descheduler,
    )


def _autoscale_gang(n, p, mp) -> Workload:
    """AutoscaleGang (the reference's perf/workloads.py:528-568): gang demand
    outnumbers the initial capacity — only the first slices' worth of gangs
    seat; the rest starve until the cluster autoscaler simulates and
    applies scale-ups from a NodeGroup (whole fresh slices per decision,
    node-add forks).  Measures time to capacity (TimeToFullSlice spans
    starve → scale-up → bind), scale-ups applied and what-if forks/s.  The
    node tier grows inside the window by design."""
    from ..autoscaler import ClusterAutoscaler, NodeGroup

    gs = GANG_SIZE if mp >= GANG_SIZE else max(2, mp)
    ngangs = max(1, mp // gs)
    need = ngangs * gs

    def nodegroup_template(i: int):
        ng = NodeGroup(
            metadata=v1.ObjectMeta(name="asg", namespace="default"),
            min_size=0, max_size=need + gs,
            capacity={"cpu": "4", "memory": "32Gi", "pods": "110"},
            slice_size=gs,
        )
        return ("NodeGroup", ng)

    def make_autoscaler(store, sched):
        # one sync per measured cycle; the candidate sizes capped so a
        # sync's evaluate stays a handful of forks
        return ClusterAutoscaler(store, sched, max_simulated_sizes=4)

    return Workload(
        name="AutoscaleGang",
        ops=[
            Op("createNodes", n, node_template=node_sliced(gs)),
            Op("createObjects", 1, object_template=nodegroup_template),
            Op("createObjects", ngangs, object_template=podgroup_template(gs)),
            Op("createPods", ngangs * gs, pod_template=pod_gang(gs), collect_metrics=True),
        ],
        batch_size=64,
        gang_size=gs,
        make_descheduler=make_autoscaler,
        autoscaler=True,
    )


# --- Dynamic resource allocation (DRA) -------------------------------------------

CHIPS_PER_HOST = 4  # chips each host's ResourceSlice publishes

# warm-pod offsets the harness's template warms dispatch (9_990_000 + 2·wi +
# j, perf/harness.py _warm); the warm pool provisions one claim and one
# singleton PodGroup per offset, so the warm batches run the claim path
DRA_WARM_POOL = 8


def dra_class_template(i: int) -> tuple:
    from ..dra.api import DeviceClass

    return ("DeviceClass", DeviceClass(metadata=v1.ObjectMeta(name="tpu")))


def dra_slice_template(gang_size: int = GANG_SIZE) -> Callable[[int], tuple]:
    """ResourceSlice j publishes host node-j's chips into pool slice-{j//gs}
    — the TPU driver's per-node inventory, one slice label per pool."""
    from ..dra.api import ATTR_CHIP_INDEX, ATTR_HOST, ATTR_MEMORY, ATTR_SLICE, Device, \
        ResourceSlice

    def tmpl(j: int) -> tuple:
        host = f"node-{j:06d}"
        sl = f"slice-{j // gang_size:05d}"
        devs = [
            # device names carry the host: unique within the pool (several
            # hosts publish into one slice's pool), so "<pool>/<device>"
            # pins (slice, host, chip) exactly
            Device(name=f"{host}-chip{c}", attributes={
                ATTR_SLICE: sl, ATTR_HOST: host,
                ATTR_CHIP_INDEX: str(c), ATTR_MEMORY: "16",
            })
            for c in range(CHIPS_PER_HOST)
        ]
        return ("ResourceSlice", ResourceSlice(
            metadata=v1.ObjectMeta(name=f"rs-{host}"), node_name=host, pool=sl,
            devices=devs))

    return tmpl


def dra_claim_template(j: int) -> tuple:
    from ..dra.api import DeviceRequest, ResourceClaim

    return ("ResourceClaim", ResourceClaim(
        metadata=v1.ObjectMeta(name=f"gangclaim-{j:06d}", namespace="default"),
        request=DeviceRequest(device_class_name="tpu", count=CHIPS_PER_HOST)))


def dra_warm_node(n: int) -> Callable[[int], v1.Node]:
    """One dedicated warm host (index n, its own slice label): warm pods pin
    here through a node selector, so the chips their claims consume — left
    Reserved when the harness deletes the warm pods — never shrink a
    measured slice below a gang's demand."""
    from ..gang import SLICE_LABEL

    def tmpl(i: int) -> v1.Node:
        return (
            make_node().name(f"node-{i:06d}")
            .capacity({"cpu": "8", "memory": "32Gi", "pods": "110"})
            .label("dra-warm", "1")
            .label(SLICE_LABEL, "slice-warm")
            .obj()
        )

    return tmpl


def dra_warm_slice(n: int) -> Callable[[int], tuple]:
    from ..dra.api import ATTR_CHIP_INDEX, ATTR_HOST, ATTR_SLICE, Device, ResourceSlice

    def tmpl(j: int) -> tuple:
        host = f"node-{n:06d}"
        devs = [
            Device(name=f"chip{c}", attributes={
                ATTR_SLICE: "slice-warm", ATTR_HOST: host, ATTR_CHIP_INDEX: str(c),
            })
            for c in range(2 * DRA_WARM_POOL)
        ]
        return ("ResourceSlice", ResourceSlice(
            metadata=v1.ObjectMeta(name=f"rs-{host}"), node_name=host,
            pool="slice-warm", devices=devs))

    return tmpl


def dra_warm_claim_template(j: int) -> tuple:
    from ..dra.api import DeviceRequest, ResourceClaim

    return ("ResourceClaim", ResourceClaim(
        metadata=v1.ObjectMeta(name=f"warmclaim-{j}", namespace="default"),
        request=DeviceRequest(device_class_name="tpu", count=1)))


def dra_warm_group_template(j: int) -> tuple:
    # min_member=1: the warm singleton gang reaches quorum at once, so the
    # warm batch runs the whole gang + claim path (anchor score, claim
    # filter / score, Reserve, the PreBind commit) end to end
    pg = v1.PodGroup(metadata=v1.ObjectMeta(name=f"wg-{j}", namespace="default"),
                     min_member=1, schedule_timeout_seconds=60)
    return ("PodGroup", pg)


def pod_claim_gang(gang_size: int = GANG_SIZE) -> Callable[[int], v1.Pod]:
    """Gang member i claims its host's whole chip inventory (one named
    ResourceClaim per member, created beforehand); warm indices (≥ 9M)
    yield singleton-gang pods claiming ONE warm-pool chip, pinned to the
    warm host."""
    from ..gang import POD_GROUP_LABEL

    def tmpl(i: int) -> v1.Pod:
        if i >= 9_000_000:
            k = i - 9_990_000
            return (
                _base_pod(i, "dwarm", "default")
                .label(POD_GROUP_LABEL, f"wg-{k}")
                .req({"cpu": "100m", "memory": "100Mi"})
                .node_selector({"dra-warm": "1"})
                .claim(f"warmclaim-{k}")
                .obj()
            )
        return (
            _base_pod(i, "dgang", "default")
            .label(POD_GROUP_LABEL, f"pg-{i // gang_size:05d}")
            .req({"cpu": "3000m", "memory": "500Mi"})
            .claim(f"gangclaim-{i:06d}")
            .obj()
        )

    return tmpl


@dataclass
class Suite:
    name: str
    build: Callable[[int, int, int], Workload]  # (initNodes, initPods, measurePods)
    sizes: Dict[str, tuple]  # workload name → (initNodes, initPods, measurePods)
    # device batch (None = the build's default): an int, or a dict by size name
    batch_size: Optional[object] = None
    # the micro-bucket policy's target (ms), or a dict by size name; None = off
    latency_target_ms: Optional[object] = None


def _three_ops(name, node_tmpl, init_tmpl, measure_tmpl, n, p, mp, skip_init=False):
    return Workload(
        name=name,
        ops=[
            Op("createNodes", n, node_template=node_tmpl),
            Op("createPods", p, pod_template=init_tmpl, skip_wait=skip_init),
            Op("createPods", mp, pod_template=measure_tmpl, collect_metrics=True),
        ],
        batch_size=256,
    )


def _basic(n, p, mp) -> Workload:
    return _three_ops("SchedulingBasic", node_default, pod_default, pod_default, n, p, mp)


def _extender(n, p, mp) -> Workload:
    """SchedulingBasic's shape with one HTTP extender on the path (the
    reference's _extender, workloads.py:332-381): the round-based extender
    cadence.  The extender runs in a subprocess, as a real extender would,
    so the protocol cost measured is the scheduler's client and the wire,
    not the extender's handler sharing the scheduler's interpreter."""
    import multiprocessing as mp_

    from ..extender import ExtenderConfig, HTTPExtender

    def make_extenders():
        # the subprocess target lives in extender.py: a spawn child imports
        # only the standard library, not torch behind the perf package
        from functools import partial

        from ..extender import run_subprocess_score_server, uniform_score_fn

        ctx = mp_.get_context("spawn")
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=partial(run_subprocess_score_server, uniform_score_fn),
                           args=(child,), daemon=True)
        proc.start()
        if not parent.poll(60):
            proc.terminate()
            raise RuntimeError("extender subprocess failed to start")
        port = parent.recv()
        ext = HTTPExtender(ExtenderConfig(
            url_prefix=f"http://127.0.0.1:{port}", filter_verb="filter",
            prioritize_verb="prioritize", weight=1, node_cache_capable=True))

        def stop():
            ext.close()
            proc.terminate()
            proc.join(timeout=5)

        return [ext], stop

    return Workload(
        name="SchedulingExtender",
        ops=[
            Op("createNodes", n, node_template=node_default),
            Op("createPods", p, pod_template=pod_default),
            Op("createPods", mp, pod_template=pod_default, collect_metrics=True),
        ],
        batch_size=256,
        make_extenders=make_extenders,
    )


def _anti_affinity(n, p, mp) -> Workload:
    return _three_ops("SchedulingPodAntiAffinity", node_unique_hostname,
                      pod_anti_affinity("sched-0"), pod_anti_affinity("sched-1"), n, p, mp)


def _affinity(n, p, mp) -> Workload:
    return _three_ops("SchedulingPodAffinity", node_zoned(["zone1"]),
                      pod_affinity("sched-0"), pod_affinity("sched-1"), n, p, mp)


def _topology(n, p, mp) -> Workload:
    return _three_ops("TopologySpreading", node_zoned(ZONES3), pod_default,
                      pod_topology_spread, n, p, mp)


def _node_affinity(n, p, mp) -> Workload:
    return _three_ops("SchedulingNodeAffinity", node_zoned(["zone1"]), pod_node_affinity,
                      pod_node_affinity, n, p, mp)


def _preferred_affinity(n, p, mp) -> Workload:
    return _three_ops("SchedulingPreferredPodAffinity", node_unique_hostname,
                      pod_preferred_affinity("sched-0"), pod_preferred_affinity("sched-1"),
                      n, p, mp)


def _preferred_topology(n, p, mp) -> Workload:
    return _three_ops("PreferredTopologySpreading", node_zoned(ZONES3), pod_default,
                      pod_preferred_topology_spread, n, p, mp)


def _gang_basic(n, p, mp) -> Workload:
    # a scaled-down run may shrink mp below the slice size: the gang shrinks
    # with it so every group can still reach quorum
    gs = GANG_SIZE if mp >= GANG_SIZE else max(2, mp)
    ngangs = max(1, mp // gs)
    return Workload(
        name="GangBasic",
        ops=[
            Op("createNodes", n, node_template=node_sliced(gs)),
            Op("createObjects", ngangs, object_template=podgroup_template(gs)),
            Op("createPods", ngangs * gs, pod_template=pod_gang(gs),
               collect_metrics=True),
        ],
        batch_size=64,
        gang_size=gs,
    )


def _device_claim_gang(n, p, mp) -> Workload:
    """DeviceClaimGang: GangBasic's all-or-nothing slice jobs, each member
    carrying a named ResourceClaim for its host's chips — the anchor-slice
    pick counts claim demand, Filter / Score run on the claim planes,
    Reserve / PreBind allocate named devices with CAS exactly once.
    Measures claims/s beside gangs/s and time to full slice."""
    gs = GANG_SIZE if mp >= GANG_SIZE else max(2, mp)
    ngangs = max(1, mp // gs)
    return Workload(
        name="DeviceClaimGang",
        ops=[
            Op("createNodes", n, node_template=node_sliced(gs)),
            Op("createNodes", 1, node_template=dra_warm_node(n)),
            Op("createObjects", 1, object_template=dra_class_template),
            Op("createObjects", n, object_template=dra_slice_template(gs)),
            Op("createObjects", 1, object_template=dra_warm_slice(n)),
            Op("createObjects", DRA_WARM_POOL, object_template=dra_warm_claim_template),
            Op("createObjects", DRA_WARM_POOL, object_template=dra_warm_group_template),
            Op("createObjects", ngangs, object_template=podgroup_template(gs)),
            Op("createObjects", ngangs * gs, object_template=dra_claim_template),
            Op("createPods", ngangs * gs, pod_template=pod_claim_gang(gs),
               collect_metrics=True),
        ],
        batch_size=64,
        gang_size=gs,
        dra=True,
    )


def _preemption(n, p, mp) -> Workload:
    # four 900m low pods fill each 4-cpu node; every 3000m high pod fails,
    # preempts three of them and binds beside the fourth
    return _three_ops("PreemptionBasic", node_default, pod_low_priority,
                      pod_high_priority, n, p, mp)


def _unschedulable(n, p, mp) -> Workload:
    # 9-cpu pods never fit a 4-cpu node; they churn the unschedulable queue
    # while the measured pods schedule
    return _three_ops("Unschedulable", node_default, pod_large_cpu, pod_default, n, p, mp,
                      skip_init=True)


def _mixed_churn(n, p, mp) -> Workload:
    """SchedulingWithMixedChurn (the reference's _mixed_churn, :973-1011):
    recreate-mode churn between cycles — one node, one priority-10 pod and
    one Service recreated per interval — beside default pods.  The churn
    Services reach no plugin of the default set."""
    def churn(store, cycle: int):
        name = f"churn-node-{cycle % 8:03d}"
        if store.get("Node", "", name) is not None:
            store.delete("Node", "", name)
        store.create("Node", make_node().name(name)
                     .capacity({"cpu": "4", "memory": "32Gi", "pods": "110"}).obj())
        pname = f"churn-pod-{cycle % 8:03d}"
        if store.get("Pod", "default", pname) is not None:
            store.delete("Pod", "default", pname)
        store.create("Pod", make_pod().name(pname).uid(f"{pname}-{cycle}")
                     .namespace("default").priority(10)
                     .req({"cpu": "1", "memory": "500Mi"}).obj())
        svc = v1.Service(metadata=v1.ObjectMeta(name=f"churn-svc-{cycle % 8:03d}",
                                                namespace="default"),
                         selector={"app": "none"})
        if store.get("Service", "default", svc.metadata.name) is not None:
            store.delete("Service", "default", svc.metadata.name)
        store.create("Service", svc)

    return Workload(
        name="SchedulingWithMixedChurn",
        ops=[
            Op("createNodes", n, node_template=node_default),
            Op("createPods", mp, pod_template=pod_default, collect_metrics=True),
        ],
        batch_size=256,
        churn_between_cycles=churn,
    )


SUITES: Dict[str, Suite] = {
    s.name: s
    for s in [
        Suite("SchedulingBasic", _basic,
              {"500Nodes": (500, 500, 1000), "5000Nodes": (5000, 1000, 1000)},
              batch_size={"5000Nodes": 512}, latency_target_ms={"5000Nodes": 140.0}),
        Suite("SchedulingPodAntiAffinity", _anti_affinity,
              {"500Nodes": (500, 100, 400), "5000Nodes": (5000, 1000, 1000)},
              batch_size={"5000Nodes": 512}),
        Suite("SchedulingPodAffinity", _affinity,
              {"500Nodes": (500, 500, 1000), "5000Nodes": (5000, 5000, 1000)},
              batch_size={"5000Nodes": 512}),
        Suite("TopologySpreading", _topology,
              {"500Nodes": (500, 1000, 1000), "5000Nodes": (5000, 5000, 2000)},
              batch_size={"5000Nodes": 512}),
        Suite("PreferredTopologySpreading", _preferred_topology,
              {"500Nodes": (500, 1000, 1000), "5000Nodes": (5000, 5000, 2000)},
              batch_size={"5000Nodes": 512}),
        Suite("SchedulingNodeAffinity", _node_affinity,
              {"500Nodes": (500, 500, 1000), "5000Nodes": (5000, 5000, 1000)},
              batch_size={"5000Nodes": 512}),
        Suite("SchedulingPreferredPodAffinity", _preferred_affinity,
              {"500Nodes": (500, 500, 1000), "5000Nodes": (5000, 5000, 1000)},
              batch_size={"5000Nodes": 512}),
        Suite("PreemptionBasic", _preemption,
              {"500Nodes": (500, 2000, 500), "5000Nodes": (5000, 20000, 5000)},
              batch_size={"5000Nodes": 512}),
        Suite("Unschedulable", _unschedulable,
              {"500Nodes/200InitPods": (500, 200, 1000),
               "5000Nodes/200InitPods": (5000, 200, 5000)},
              batch_size={"5000Nodes/200InitPods": 512}),
        Suite("SchedulingWithMixedChurn", _mixed_churn,
              {"1000Nodes": (1000, 0, 1000), "5000Nodes": (5000, 0, 2000)},
              batch_size={"5000Nodes": 512}),
        # one subprocess extender on the path; the batch (384) stays under
        # the node count, so the one-commit-per-node rule lets every pod
        # commit in the first round
        Suite("SchedulingExtender", _extender,
              {"500Nodes": (500, 500, 1000)}, batch_size=384),
        # the north-star configuration: 5k nodes, 10k pending pods
        Suite("NorthStar", _basic,
              {"5000Nodes/10000Pods": (5000, 2000, 10000), "100kNodes": (100_352, 0, 2000)},
              batch_size={"5000Nodes/10000Pods": 512, "100kNodes": 256},
              latency_target_ms={"5000Nodes/10000Pods": 200.0}),
        # scheduler_perf's historic density target
        Suite("Density", _basic,
              {"1000Nodes/30000Pods": (1000, 0, 30000), "100Nodes/3000Pods": (100, 0, 3000)},
              batch_size={"1000Nodes/30000Pods": 512}),
        # gang scheduling: N/8 slice jobs of 8 members, one member per host,
        # capacity slightly over the job count (every gang lands); measures
        # gangs/s and time-to-full-slice beside pods/s
        Suite("GangBasic", _gang_basic,
              {"64Nodes": (64, 0, 56), "500Nodes": (500, 0, 480),
               "5000Nodes": (5000, 0, 4800)},
              batch_size={"5000Nodes": 512}),
        # gang scheduling with named-device claims: every member carries a
        # ResourceClaim for its host's chips; the anchor-slice pick counts
        # claim demand and PreBind commits the allocations with CAS
        Suite("DeviceClaimGang", _device_claim_gang,
              {"64Nodes": (64, 0, 56), "500Nodes": (500, 0, 480),
               "5000Nodes": (5000, 0, 4800)},
              batch_size={"5000Nodes": 512}),
        # the cluster autoscaler: the initial capacity seats a quarter of the
        # gangs, the rest starve until simulated-then-applied scale-ups add
        # whole slices; sizes are (initial nodes, 0, measured gang pods)
        Suite("AutoscaleGang", _autoscale_gang,
              {"64Nodes": (16, 0, 56), "500Nodes": (120, 0, 480),
               "5000Nodes": (1200, 0, 4800)},
              batch_size={"5000Nodes": 512}),
        # the descheduler: every host fragmented by a pre-bound straggler,
        # the gangs blocked until the defrag policy frees whole slices
        Suite("Defrag", _defrag,
              {"64Nodes": (64, 64, 32), "500Nodes": (512, 512, 256),
               "5000Nodes": (5000, 5000, 2496)},
              batch_size={"5000Nodes": 512}),
    ]
}

# the reference's other suites, and the ROADMAP items that bring what they need
UNPORTED: Dict[str, str] = {
    "TrainingJobFlow": "the TrainingJob controller (ROADMAP Queue A item 10; its gangs "
                       "came with item 8a, its device claims with item 8b)",
    "StatefulChurn": "volume binding (ROADMAP Queue A item 8c)",
    "VolumeZoneSpread": "volume binding (ROADMAP Queue A item 8c)",
}


def build_workload(suite: str, size: str, scale: float = 1.0,
                   batch_size: Optional[int] = None) -> Workload:
    """The named workload at ``size``, its counts times ``scale`` (the
    reference's build_workload: the same floors, batch and latency target)."""
    if suite in UNPORTED:
        raise NotImplementedError(f"suite {suite} needs {UNPORTED[suite]}, not ported yet")
    s = SUITES[suite]
    n, p, mp = s.sizes[size]
    if scale != 1.0:
        n = max(4, int(n * scale))
        p = max(0, int(p * scale))
        mp = max(2, int(mp * scale))
    w = s.build(n, p, mp)
    w.name = f"{suite}/{size}"
    suite_batch = s.batch_size
    if isinstance(suite_batch, dict):
        suite_batch = suite_batch.get(size)
    if batch_size is not None:
        w.batch_size = batch_size
    elif suite_batch is not None:
        # the suite's batch capped at the scaled backlog
        w.batch_size = min(suite_batch, max(16, pow2_round_up(mp)))
    lt = s.latency_target_ms
    if isinstance(lt, dict):
        lt = lt.get(size)
    if lt is not None:
        w.latency_target_ms = float(lt)
    return w
