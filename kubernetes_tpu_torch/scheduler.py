"""TorchScheduler: the synchronous end-to-end scheduling loop on the port.

Reference: the JAX package's TPUScheduler with ``pipeline=False`` and no
tie noise (scheduler.py: watch handlers :705-800, schedule_cycle, the
engine routing ``engine_choice`` :2679 with its parallel-safety test
``_class_parallel_safe`` :2819 and its dedup gate ``_dedup_classes`` :2596,
the host half ``host_prepare`` :1645 with ``_host_aux_take`` :138, the
fused dedup cycle ``fused_batch`` :969-1017, bind :3461, run_until_idle
:3777), itself after
pkg/scheduler/scheduler.go (scheduleOne :496, assume :424, bind :446) and
eventhandlers.go (addAllEventHandlers :251).

One cycle: pop ≤ B → cache snapshot → encoder sync (with the existing-pod
affinity index) → batch compile → host_prepare (InterPodAffinity's
existing-pod match matrix) → conflict partition + engine routing +
identity-class dedup gate → the fused cycle on the device (apply_scatter,
the dynamic plugins' class state — PodTopologySpread's count tables,
InterPodAffinity's count planes or tables and existing-pod planes —, the
dedup engine's rounds through the kernels, gang all-or-nothing, diagnosis
bits, pack) → one [3, B] fetch → assume → bind through the store → requeue
the unschedulable pods with backoff.  Bindings equal the JAX scheduler's,
pod for pod.  Topology-spread pods and pod (anti)affinity pods (required
and preferred, and scheduled pods carrying such terms) are in scope: a
self-matching class whose commits change its own planes unevenly is one
coupled component, so the dedup engine commits one of its pods per round.

Scope guard: a batch or cluster that needs anything outside the port —
gang members, volumes, resource claims, extenders, profiles,
``pipeline=True``, a batch the reference routes to its full auction (too
heterogeneous for the dedup engine, or coupled with a pod that could
preempt) or to its exact scan, a batch larger than the auction kernel's one
block on cuda, or a failing pod that could preempt — raises
NotImplementedError naming the ROADMAP item.  It never gives a silently
different answer.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from . import plugins as P
from .api import objects as v1
from .device import resolve_device
from .framework import events as fwk_events
from .api.labels import affinity_term_matches, match_label_selector
from .framework.conflict import conflict_components
from .framework.events import ActionType, ClusterEvent, EventResource
from .framework.interface import PluginWithWeight
from .framework.podbatch import PodBatchCompiler, batch_to_device, identity_classes
from .framework.runtime import (
    BatchedFramework,
    coupling_flags,
    diagnose_bits_from_plane,
    initial_dynamic_state,
    pack_diag,
)
from .gang import POD_GROUP_LABEL, gang_all_or_nothing
from .queueing import PriorityQueue
from .queueing.priority_queue import QueuedPodInfo
from .sim.store import ADDED, DELETED, MODIFIED, ObjectStore, WatchEvent
from .state.cache import Cache, Snapshot
from .state.dictionary import MISSING
from .state.encoding import ClusterEncoder, apply_scatter
from .state.units import pow2_round_up as _pow2

DEFAULT_SCHEDULER_NAME = "default-scheduler"  # apis/config v1.Pod default
# the reference's default router threshold (TPUScheduler coupled_fraction_threshold)
COUPLED_FRACTION_THRESHOLD = 0.25


def default_plugins(domain_cap: int) -> List[PluginWithWeight]:
    """Default plugin set + weights, in the reference's order
    (apis/config/v1beta3/default_plugins.go:32-51)."""
    PW = PluginWithWeight
    return [
        PW(P.CoschedulingPlugin(), 1),
        PW(P.NodeUnschedulablePlugin(), 0),
        PW(P.NodeNamePlugin(), 0),
        PW(P.TaintTolerationPlugin(), 3),
        PW(P.NodeAffinityPlugin(), 2),
        PW(P.NodePortsPlugin(), 0),
        PW(P.FitPlugin(), 1),
        PW(P.VolumeRestrictionsPlugin(), 0),
        PW(P.NodeVolumeLimitsPlugin(), 0),
        PW(P.VolumeBindingPlugin(), 0),
        PW(P.VolumeZonePlugin(), 0),
        PW(P.DynamicResourcesPlugin(), 1),
        PW(P.PodTopologySpreadPlugin(domain_cap=domain_cap), 2),
        PW(P.InterPodAffinityPlugin(domain_cap=domain_cap), 2),
        PW(P.BalancedAllocationPlugin(), 1),
        PW(P.ImageLocalityPlugin(), 1),
    ]


@dataclass
class CycleStats:
    attempted: int = 0
    scheduled: int = 0
    unschedulable: int = 0
    batch_seconds: float = 0.0


def _unpack_diag(bits: np.ndarray, n_filters: int) -> np.ndarray:
    """int32[B] bitmask → bool[B, K] diagnosis bits."""
    return (
        (bits[:, None].astype(np.int64) >> np.arange(n_filters)[None, :]) & 1
    ).astype(bool)


def _queue_less(a: QueuedPodInfo, b: QueuedPodInfo) -> bool:
    """The JAX scheduler's queue order for gang-free pods (the Coscheduling
    QueueSort, gang/directory.py less): priority desc, then the pod's
    creation timestamp, then its first-attempt timestamp."""
    pa, pb = a.pod.spec.priority, b.pod.spec.priority
    if pa != pb:
        return pa > pb
    ka = a.pod.metadata.creation_timestamp
    kb = b.pod.metadata.creation_timestamp
    if ka != kb:
        return ka < kb
    return a.initial_attempt_timestamp < b.initial_attempt_timestamp


def _pod_out_of_scope(p: v1.Pod) -> Optional[str]:
    """Why a pending pod needs something outside this slice, or None."""
    if POD_GROUP_LABEL in p.metadata.labels:
        return "gang membership (ROADMAP Queue A item 8, Queue B B14)"
    if getattr(p.spec, "volumes", None):
        return "volumes (ROADMAP Queue A item 8)"
    if getattr(p.spec, "resource_claims", None):
        return "resource claims (ROADMAP Queue A item 8, Queue B B14)"
    return None


def _host_aux_take(fw, host_auxes, rows):
    """The identity-class rep view of the host auxes (the reference's
    _host_aux_take, scheduler.py:138): a plugin with a pod-indexed host aux
    gathers the rep columns through its ``host_aux_take``; the dedup gate
    admits no other non-None host aux."""
    host_auxes = host_auxes or {}
    out = {}
    for pw in fw.plugins:
        name = pw.plugin.name
        if name not in host_auxes:
            continue
        aux = host_auxes[name]
        fn = getattr(pw.plugin, "host_aux_take", None)
        out[name] = aux if aux is None or fn is None else fn(aux, rows)
    return out


class TorchScheduler:
    """The synchronous scheduling loop over the port (see the module doc)."""

    _KIND_RESOURCE = {
        "PersistentVolumeClaim": EventResource.PVC,
        "PersistentVolume": EventResource.PV,
        "StorageClass": EventResource.STORAGE_CLASS,
        "CSINode": EventResource.CSI_NODE,
        "Service": EventResource.SERVICE,
    }
    # gang and DRA objects drive subsystems this slice does not carry
    _UNSUPPORTED_KINDS = {"PodGroup", "ResourceClaim", "ResourceSlice",
                          "DeviceClass"}
    # kinds that never unblock scheduling (avoid wildcard requeue storms)
    _IGNORED_KINDS = {"Lease", "Event", "ReplicaSet", "Deployment", "Job",
                      "StatefulSet", "DaemonSet", "HorizontalPodAutoscaler",
                      "ResourceClaimTemplate"}

    def __init__(
        self,
        store: ObjectStore,
        batch_size: int = 64,
        clock=time.monotonic,
        namespace_labels: Optional[Dict[str, Dict[str, str]]] = None,
        pod_initial_backoff: float = 1.0,
        pod_max_backoff: float = 10.0,
        batch_wait: float = 0.5,
        device="cuda",
        pipeline: bool = False,
        extenders: Optional[List] = None,
        profiles: Optional[Dict[str, object]] = None,
    ):
        if pipeline:
            raise NotImplementedError(
                "pipeline=True (deep-chained dispatch) is not ported yet "
                "(ROADMAP Queue A item 5)")
        if extenders:
            raise NotImplementedError(
                "scheduler extenders are not ported yet (ROADMAP Queue A item 6)")
        if profiles:
            raise NotImplementedError(
                "scheduler profiles are not ported yet (ROADMAP Queue A item 10)")
        if torch.device(device).type == "cuda" and batch_size > 1024:
            raise NotImplementedError(
                f"batch_size={batch_size} on cuda: the auction kernel runs one "
                "block of at most 1024 pods; larger batches wait for the "
                "multi-block auction (ROADMAP Queue B B5)")
        self.device = resolve_device(device)
        self.store = store
        self.clock = clock
        self.batch_size = batch_size
        self.batch_wait = batch_wait
        self.cache = Cache(clock=clock)
        self.snapshot = Snapshot()
        self.encoder = ClusterEncoder(device=self.device)
        self.namespace_labels = namespace_labels or {}
        self.compiler = PodBatchCompiler(self.encoder, self.namespace_labels)
        self._fw_domain_cap = -1
        self.fw = self._framework()
        self.n_filters = len(self.fw.filter_names)
        event_map: Dict[ClusterEvent, Set[str]] = {}
        for pw in default_plugins(8):
            for ev in pw.plugin.events_to_register():
                event_map.setdefault(ev, set()).add(pw.plugin.name)
        self.queue = PriorityQueue(
            less=_queue_less, clock=clock, cluster_event_map=event_map,
            pod_initial_backoff=pod_initial_backoff,
            pod_max_backoff=pod_max_backoff,
        )
        # host-vs-device wall per phase (seconds, summed over cycles):
        # "host_prepare" is the plugins' host halves (InterPodAffinity's
        # existing-pod match matrix); "partition" is the conflict partition,
        # the engine routing and the dedup gate; "device" brackets the fused
        # cycle from the first upload to the [3, B] fetch, which
        # synchronises with the card
        self.phase_wall: Dict[str, float] = {
            k: 0.0 for k in ("snapshot", "compile", "host_prepare", "partition", "device",
                             "bind")}
        self.cycles = 0
        self.rounds_total = 0
        # host wall spent in the dedup engine's per-round read of its loop
        # condition (seconds, summed over cycles; part of "device")
        self.round_read_s = 0.0
        # per-pod attempt latency (seconds, wall clock): from the cycle's
        # start (after the pop) to the pod's own bind or requeue
        self.attempt_seconds: List[float] = []
        store.watch(self._on_event)

    def _framework(self) -> BatchedFramework:
        """The framework for the encoder's current domain_cap, rebuilt when
        it grows (the reference's _framework, scheduler.py:859-878)."""
        d = self.encoder.domain_cap
        if d != self._fw_domain_cap:
            self.fw = BatchedFramework(default_plugins(d))
            self._fw_domain_cap = d
        return self.fw

    # --- event handlers (eventhandlers.go:251+) ------------------------------

    def _on_event(self, ev: WatchEvent):
        if ev.kind == "Node":
            self._on_node_event(ev)
        elif ev.kind == "Pod":
            self._on_pod_event(ev)
        elif ev.kind in self._UNSUPPORTED_KINDS:
            raise NotImplementedError(
                f"{ev.kind} objects drive the gang / DRA subsystems, which are "
                "not ported yet (ROADMAP Queue A item 8)")
        elif ev.kind in self._IGNORED_KINDS:
            return
        else:
            resource = self._KIND_RESOURCE.get(ev.kind, EventResource.WILDCARD)
            action = {ADDED: ActionType.ADD, MODIFIED: ActionType.UPDATE,
                      DELETED: ActionType.DELETE}.get(ev.type, ActionType.ALL)
            if resource == EventResource.WILDCARD:
                action = ActionType.ALL
            self.queue.move_all_to_active_or_backoff(ClusterEvent(resource, action))

    def _node_update_action(self, old: Optional[v1.Node], new: v1.Node) -> ActionType:
        if old is None:
            return ActionType.ADD
        action = ActionType(0)
        if old.status.allocatable != new.status.allocatable:
            action |= ActionType.UPDATE_NODE_ALLOCATABLE
        if old.metadata.labels != new.metadata.labels:
            action |= ActionType.UPDATE_NODE_LABEL
        if old.spec.taints != new.spec.taints or old.spec.unschedulable != new.spec.unschedulable:
            action |= ActionType.UPDATE_NODE_TAINT
        return action or ActionType.UPDATE_NODE_CONDITION

    def _on_node_event(self, ev: WatchEvent):
        node: v1.Node = ev.obj
        if ev.type == ADDED:
            self.cache.add_node(node)
            self.queue.move_all_to_active_or_backoff(fwk_events.NODE_ADD)
        elif ev.type == MODIFIED:
            old_info = self.cache._nodes.get(node.metadata.name)
            old = old_info.node if old_info else None
            action = self._node_update_action(old, node)
            self.cache.update_node(node)
            self.queue.move_all_to_active_or_backoff(
                ClusterEvent(EventResource.NODE, action))
        elif ev.type == DELETED:
            self.cache.remove_node(node.metadata.name)
            self.queue.move_all_to_active_or_backoff(fwk_events.NODE_DELETE)

    def _on_pod_event(self, ev: WatchEvent):
        pod: v1.Pod = ev.obj
        assigned = bool(pod.spec.node_name)
        # responsibleForPod: only pods naming this scheduler enter the queue;
        # assigned pods always feed the cache (they occupy resources)
        if not assigned and (pod.spec.scheduler_name or DEFAULT_SCHEDULER_NAME) \
                != DEFAULT_SCHEDULER_NAME:
            return
        if ev.type == ADDED:
            if assigned:
                self.cache.add_pod(pod)
            else:
                self.queue.add(pod)
        elif ev.type == MODIFIED:
            if assigned:
                if pod.uid in self.cache._pod_states and not self.cache.is_assumed(pod):
                    self.cache.update_pod(pod, pod)
                else:
                    self.cache.add_pod(pod)  # also confirms an assumed pod
                self.queue.move_all_to_active_or_backoff(fwk_events.POD_UPDATE)
            else:
                self.queue.update(pod, pod)
        elif ev.type == DELETED:
            if assigned or pod.uid in self.cache._pod_states:
                self.cache.remove_pod(pod)
                self.queue.move_all_to_active_or_backoff(fwk_events.POD_DELETE)
            else:
                self.queue.delete(pod)

    def presize(self, n_nodes: int, n_pods: int):
        """Pre-grow the encoder's node/pod tiers (the reference's presize)."""
        self.encoder.reserve(
            _pow2(n_nodes, 1), _pow2(n_pods, 1),
            n_ids=16 * n_nodes + 8 * n_pods,
        )
        self.encoder._scatter_bucket.setdefault(
            "node_valid",
            min(_pow2(n_nodes, 32), max(256, _pow2(self.batch_size, 32))))
        self.encoder._scatter_bucket.setdefault(
            "pod_valid",
            min(_pow2(max(n_pods, 1), 32),
                max(256, _pow2(2 * self.batch_size, 32))))

    # --- the scheduling cycle ----------------------------------------------------

    def schedule_cycle(self) -> CycleStats:
        """One synchronous cycle: dispatch, fetch, assume, bind."""
        stats = CycleStats()
        if self.batch_wait > 0:
            self._await_backoff_wave()
        infos = self.queue.pop_batch(
            self.batch_size,
            group_key=lambda qi: qi.pod.spec.scheduler_name or DEFAULT_SCHEDULER_NAME)
        if not infos:
            return stats
        for qi in infos:
            why = _pod_out_of_scope(qi.pod)
            if why is not None:
                raise NotImplementedError(
                    f"pod {qi.pod.key()} needs {why}: outside this slice")
        t0 = self.clock()
        self._cycle_start = time.perf_counter()
        cycle = self.queue.scheduling_cycle()
        node_row, diag = self._dispatch(infos)
        stats.batch_seconds = self.clock() - t0
        self._complete(infos, node_row)
        s = self._bind_phase(infos, node_row, diag, cycle)
        stats.attempted = s.attempted
        stats.scheduled = s.scheduled
        stats.unschedulable = s.unschedulable
        stats.batch_seconds = self.clock() - t0
        self.cycles += 1
        return stats

    def _dispatch(self, infos: List[QueuedPodInfo]):
        t0 = time.perf_counter()
        changed = self.cache.update_snapshot(self.snapshot)
        self.encoder.sync(self.snapshot, changed)
        t1 = time.perf_counter()
        pods = [qi.pod for qi in infos]
        batch = self.compiler.compile(pods, pad_to=self.batch_size)
        t_hp = time.perf_counter()
        fw = self._framework()
        host_auxes = fw.host_prepare(batch, self.snapshot, self.encoder,
                                     namespace_labels=self.namespace_labels)
        t2 = time.perf_counter()
        mode, coupling, _info = self.engine_choice(batch)
        if mode == "scan":
            raise NotImplementedError(
                "the reference routes this batch to its exact serial scan "
                "(greedy_assign), which is not ported yet (ROADMAP Queue A "
                "item 6, Queue B B9)")
        class_of, rep_rows, why = self._dedup_classes(batch, host_auxes)
        if class_of is None:
            raise NotImplementedError(
                f"{why}: the reference takes its full (non-dedup) assignment "
                "engine, which is not ported yet (ROADMAP Queue A item 6, "
                "Queue B B8)")
        t3 = time.perf_counter()
        packed = self._fused_cycle(batch, class_of, rep_rows, coupling, host_auxes)
        t4 = time.perf_counter()
        self.phase_wall["snapshot"] += t1 - t0
        self.phase_wall["compile"] += t_hp - t1
        self.phase_wall["host_prepare"] += t2 - t_hp
        self.phase_wall["partition"] += t3 - t2
        self.phase_wall["device"] += t4 - t3
        self.rounds_total += int(packed[2, 0])
        return packed[0].copy(), _unpack_diag(packed[1], self.n_filters)

    # --- engine routing (the reference's one shared predicate) -------------------

    def engine_choice(self, batch):
        """(mode, coupling, partition info): "batch" (the auction engines)
        or "scan" — the reference's engine_choice (scheduler.py:2679) under
        its default ``assign_mode="auto"``.  The conflict partition is first
        relaxed for parallel-safe single-class components; a batch whose
        largest coupled component exceeds the threshold still takes the
        auction when the dedup precheck admits it."""
        info = conflict_components(batch.pods, batch.size,
                                   namespace_labels=self.namespace_labels)
        info = self._relax_parallel_safe(info)
        coupling = coupling_flags(batch, info=info)
        n_valid = max(int(np.asarray(batch.valid).sum()), 1)
        if info.max_multi <= max(1, int(COUPLED_FRACTION_THRESHOLD * n_valid)):
            return "batch", coupling, info
        if self._dedup_precheck(batch):
            return "batch", coupling, info
        return "scan", coupling, info

    def _batch_can_preempt(self, batch) -> bool:
        """Any valid batch pod that could run the preemption dry-run (the
        reference's _batch_can_preempt, scheduler.py:2723)."""
        prios = np.asarray(batch.priority)[np.asarray(batch.valid)]
        return bool(prios.size) and int(prios.max()) > 0 and any(
            (p.spec.priority or 0) > 0 and p.spec.preemption_policy != "Never"
            for p in batch.pods)

    def _class_hooks_ok(self) -> bool:
        """Every dynamic plugin with per-pod update hooks also has the
        class-level hook the dedup engine needs."""
        for pw in self.fw.plugins:
            p = pw.plugin
            if p.dynamic and (getattr(p, "update", None) is not None
                              or getattr(p, "update_batch", None) is not None) \
                    and getattr(p, "update_batch_classes", None) is None:
                return False
        return True

    def _dedup_precheck(self, batch) -> bool:
        """The router's scan→auction upgrade check (the reference's
        _dedup_precheck, scheduler.py:2733): class hooks present, no gang
        members, volumes or resource claims, no pod that could preempt, at
        most B/2 identity classes."""
        if not self._class_hooks_ok():
            return False
        for p in batch.pods:
            if POD_GROUP_LABEL in p.metadata.labels or getattr(p.spec, "volumes", None) \
                    or getattr(p.spec, "resource_claims", None):
                return False
        if self._batch_can_preempt(batch):
            return False
        _class_of, reps = identity_classes(batch)
        return len(reps) * 2 <= batch.size

    def _dedup_classes(self, batch, host_auxes=None):
        """The identity-class dedup gate (the reference's _dedup_classes,
        scheduler.py:2596-2677, for a scheduler with no tie noise): →
        (class_of i32[B], rep_rows i64[Cp], None), or (None, None, why) when
        the reference takes its full auction.  A non-None host aux is
        admitted when its plugin has a rep view (``host_aux_take``:
        InterPodAffinity's match matrix).  Cp is the pow-2 bucket of the
        class count (floor 4), padded with the first rep."""
        if batch.has_affinity or batch.has_spread:
            if not self._class_hooks_ok():
                return None, None, "a dynamic plugin without a class-level update hook"
            if self._batch_can_preempt(batch):
                return None, None, "a coupled batch with a pod that could preempt"
        for name, aux in (host_auxes or {}).items():
            if aux is None:
                continue
            if not any(pw.plugin.name == name
                       and getattr(pw.plugin, "host_aux_take", None) is not None
                       for pw in self.fw.plugins):
                return None, None, f"a pod-indexed host aux of {name}"
        class_of, reps = identity_classes(batch)
        if len(reps) * 2 > batch.size:
            return None, None, (f"a batch of {len(reps)} identity classes in "
                                f"{batch.size} slots")
        cpad = _pow2(len(reps), 4)
        rep_rows = np.full(cpad, reps[0], dtype=np.int64)
        rep_rows[: len(reps)] = reps
        return class_of, rep_rows, None

    def _relax_parallel_safe(self, info):
        """Demote parallel-safe single-class components to singletons (the
        reference's _relax_parallel_safe, scheduler.py:2773)."""
        import dataclasses

        reps = info.single_class_reps or {}
        safe = [r for r, rep in reps.items() if self._class_parallel_safe(rep)]
        if not safe:
            return info
        comp = info.comp.copy()
        multi = info.multi.copy()
        for r in safe:
            idxs = np.nonzero((comp == r) & multi)[0]
            multi[idxs] = False
            comp[idxs] = idxs
        sizes = [int(((comp == r) & multi).sum())
                 for r in sorted(set(comp[multi].tolist()))]
        return dataclasses.replace(
            info, comp=comp, multi=multi, sizes=sizes,
            single_class_reps={k: v for k, v in reps.items() if k not in safe})

    def _class_parallel_safe(self, rep) -> bool:
        """May the pods of this single-class component commit in the same
        auction round (the reference's _class_parallel_safe,
        scheduler.py:2806-2855)?  True when every SELF-matching term's
        intra-class effect is used-node-equivalent or plane-uniform: a
        required anti-affinity term over a key whose every keyed node has
        its own value (hostname), a required affinity term over a key with
        at most one live value, a preferred term over a key that every valid
        node carries with one value (or none does).  A self-matching spread
        constraint's per-domain skew math refuses."""
        for c in rep.spec.topology_spread_constraints:
            if match_label_selector(c.label_selector, rep.metadata.labels):
                return False
        aff = rep.spec.affinity
        if aff is None:
            return True
        pa, paa = aff.pod_affinity, aff.pod_anti_affinity
        groups = (
            ("anti_req", list(paa.required) if paa else []),
            ("aff_req", list(pa.required) if pa else []),
            ("pref", ([wt.pod_affinity_term for wt in pa.preferred] if pa else [])
             + ([wt.pod_affinity_term for wt in paa.preferred] if paa else [])),
        )
        for kind, terms in groups:
            for term in terms:
                if not affinity_term_matches(term, rep, rep, self.namespace_labels):
                    continue
                n_keyed, n_vals, n_nodes = self._slot_domain_profile(term.topology_key)
                if kind == "anti_req":
                    if n_keyed != n_vals:
                        return False
                elif kind == "aff_req":
                    if n_vals > 1:
                        return False
                elif n_vals > 1 or (n_vals == 1 and n_keyed != n_nodes):
                    return False
        return True

    def _slot_domain_profile(self, topo_key: str):
        """(keyed-node count, distinct live values, valid-node count) of a
        topology key over the encoder's live node mirror (the reference's
        _slot_domain_profile, scheduler.py:2857).  An unregistered key has
        no keyed nodes."""
        enc = self.encoder
        valid = np.asarray(enc.node_valid)
        n_nodes = int(valid.sum())
        slot = enc._topo_slots.get(topo_key)
        if slot is None:
            return 0, 0, n_nodes
        vals = np.asarray(enc.node_topo)[valid, slot]
        present = vals != MISSING
        return int(present.sum()), int(np.unique(vals[present]).size), n_nodes

    def _fused_cycle(self, batch, class_of: np.ndarray, rep_rows: np.ndarray,
                     coupling, host_auxes=None) -> np.ndarray:
        """The device half of the cycle (the reference's fused_batch dedup
        branch, scheduler.py:969-1017) → the packed [3, B] result on the
        host (the cycle's one fetch)."""
        dev = self.device
        fw = self._framework()
        dsnap, upd = self.encoder.to_device_deferred()
        dsnap = apply_scatter(dsnap, upd)
        self.encoder.commit_device(dsnap)
        # the reference's reserve_nominated (scheduler.py:889) adds only the
        # requests of pods that preemption nominated; the port has no
        # preemption (ROADMAP Queue A item 9, Queue B B2), so there are none
        dyn = initial_dynamic_state(dsnap)
        dbatch = batch_to_device(batch, dev)
        rep_batch = dbatch.take(torch.from_numpy(rep_rows).to(dev))
        # the class representatives' plugin auxes, from the rep view of the
        # host auxes: PodTopologySpread's count tables (K5), InterPodAffinity's
        # count state and existing-pod planes (K9); None for a plugin with
        # nothing to carry for this batch
        rep_host = _host_aux_take(fw, host_auxes, rep_rows)
        rep_auxes = fw.prepare(rep_batch, dsnap, dyn, rep_host)
        b = batch.size
        order = torch.arange(b, dtype=torch.int32, device=dev)
        class_t = torch.from_numpy(class_of.astype(np.int64)).to(dev)
        res = fw._batch_assign_dedup(
            dbatch, dsnap, dyn, None, order, coupling, (class_t, rep_batch, rep_auxes))
        self.round_read_s += res.host_read_s
        gang_seg = torch.full((b,), -1, dtype=torch.int32, device=dev)
        node_row = gang_all_or_nothing(res.node_row, gang_seg)
        # a dispatched batch holds at least one valid pod, so round 0 ran; its
        # bit plane carries the dynamic plugins' bits (K6, K10), as the
        # reference diagnoses with the prepared rep auxes (scheduler.py:1015)
        bits = diagnose_bits_from_plane(res.diag_plane, self.n_filters)[class_t]
        return pack_diag(bits, node_row, res.rounds).cpu().numpy()

    def _complete(self, infos: List[QueuedPodInfo], node_row: np.ndarray) -> None:
        """Assume every placed pod in the cache (assume :571)."""
        name_of = self.encoder.row_to_name()
        self._node_names = [None] * len(infos)
        for i, qi in enumerate(infos):
            row = int(node_row[i])
            if row < 0:
                continue
            name = name_of.get(row)
            info = self.cache._nodes.get(name) if name is not None else None
            if info is None or info.node is None:
                node_row[i] = -1  # node gone since dispatch — retry the pod
                continue
            self._node_names[i] = name
            self.cache.assume_pod(qi.pod, name)

    def _bind_phase(self, infos, node_row, diag, cycle) -> CycleStats:
        """Bind every placed pod; diagnose and requeue every failed one."""
        t0 = time.perf_counter()
        stats = CycleStats(attempted=len(infos))
        failing = [i for i in range(len(infos)) if int(node_row[i]) < 0]
        if failing:
            valid = self.encoder.pod_valid
            prios = self.encoder.pod_priority[valid]
            min_sched_prio = int(prios.min()) if prios.size else 1 << 30
            for i in failing:
                pod = infos[i].pod
                if pod.spec.preemption_policy != "Never" \
                        and min_sched_prio < (pod.spec.priority or 0):
                    raise NotImplementedError(
                        f"pod {pod.key()} failed and could preempt: preemption "
                        "is not ported yet (ROADMAP Queue A item 9)")
        names = self.fw.filter_names
        for i, qi in enumerate(infos):
            row = int(node_row[i])
            if row >= 0:
                node_name = self._node_names[i]
                ok = self.store.bind_pod(qi.pod.namespace, qi.pod.metadata.name,
                                         node_name)
                if ok:
                    self.cache.finish_binding(qi.pod)
                    stats.scheduled += 1
                else:  # pod deleted mid-cycle: roll back
                    self.cache.forget_pod(qi.pod)
                    if self.store.get("Pod", qi.pod.namespace,
                                      qi.pod.metadata.name) is not None:
                        self.queue.add_unschedulable(qi, cycle)
            else:
                row_bits = diag[i]
                failing_plugins = {names[k] for k in range(len(names))
                                   if not bool(row_bits[k])}
                qi.unschedulable_plugins = failing_plugins or set(names)
                stats.unschedulable += 1
                self.queue.add_unschedulable(qi, cycle)
            self.attempt_seconds.append(time.perf_counter() - self._cycle_start)
        self.phase_wall["bind"] += time.perf_counter() - t0
        return stats

    def _await_backoff_wave(self) -> None:
        """Hold the cycle briefly while an imminent backoff wave drains into
        the active queue (the reference's batch-formation hysteresis)."""
        real_deadline = time.monotonic() + self.batch_wait
        while True:
            nxt = self.queue.next_backoff_expiry()
            a, b, _ = self.queue.pending_count()
            if b == 0 or nxt is None or a >= self.batch_size // 2 or a >= b:
                return
            now = self.clock()
            if time.monotonic() >= real_deadline or nxt - now > self.batch_wait:
                return
            time.sleep(min(0.02, max(nxt - now, 0.001)))

    def run_until_idle(self, max_cycles: int = 1000,
                       backoff_wait: Optional[float] = None) -> CycleStats:
        """Drive cycles until nothing is attempted or waiting out backoff."""
        if backoff_wait is None:
            backoff_wait = 1.2 * self.queue._max_backoff
        total = CycleStats()
        waited = 0.0
        cycles = 0
        while cycles < max_cycles:
            s = self.schedule_cycle()
            if s.attempted == 0:
                _a, b, _u = self.queue.pending_count()
                if b == 0 or waited >= backoff_wait:
                    break
                time.sleep(0.05)
                waited += 0.05
                continue
            cycles += 1
            if s.scheduled:
                waited = 0.0
            total.attempted += s.attempted
            total.scheduled += s.scheduled
            total.unschedulable += s.unschedulable
            total.batch_seconds += s.batch_seconds
        return total


__all__ = ["TorchScheduler", "default_plugins"]
