"""TorchScheduler: the end-to-end scheduling loop on the port, synchronous or
pipelined.

Reference: the JAX package's TPUScheduler (scheduler.py:
watch handlers :705-800, the pipelined ``schedule_cycle`` :1066-1221 with
``_InFlight`` :239, ``_SyncAhead`` :325, the overlapped sync :1319-1453,
the micro-bucket policy :1455-1520, ``_dispatch_batch`` and ``_bg_fetch``
:1522-1967, ``_complete`` :1969, the bind phase :2058 with the per-tier
latency profile :2355-2378, the engine routing ``engine_choice`` :2679
(``assign_mode`` / ``coupled_fraction_threshold`` :362-365) with its
parallel-safety test ``_class_parallel_safe`` :2819, its dedup gate
``_dedup_classes`` :2596 and precheck ``_dedup_precheck`` :2733, the host
half ``host_prepare`` :1645 with ``_host_aux_take`` :138, the fused cycles
``fused_greedy`` :954-967 and ``fused_batch`` :969-1017 with
``reserve_nominated`` :889 and ``apply_prev_delta`` :897,
``_infos_block_deep`` :3523, run_until_idle :3777; the profiles
(``profiles`` :367, :382-386, the profile map and the union event map
:565-580, ``_profile_of`` :843, ``_framework`` :859-878, the in-flight
record's ``profile`` / ``fw`` :273-279); preemption: the
nominator ``_nominated`` / ``_fastbound_noms`` :653-664 with their purges
:803, :1612-1620, :2330-2345, ``_nominated_arrays`` :3494,
``_priority_levels`` :3583, the candidate program ``cand_mask``
:1019-1028 and ``_candidate_mask`` :3598 with the speculative dispatch
:1859-1877, the bind phase's lazy PostFilter context :2209-2330,
``_run_post_filter`` :3605 and ``_try_nominated_fast_bind`` :3667; the DRA wiring :553-562, :589, :718-723, :751-753, :1605; the gang
runtime: the directory :582-595, ``_gang_prefilter`` :1223,
the binding cycle ``_run_reserve_and_bind`` :3364 / ``_finish_bind`` :3428
with its Permit hold ``_WaitingBind`` :103 and ``_flush_waiting_binds``
:2409); the extender path: the constructor's ``extenders`` /
``serialize_extender_callouts`` / ``async_extenders`` :598-627, the
dispatch branch :1672-1795 with ``prepare_packed`` :1030-1039, the walk
join :1969-1990, ``_num_feasible_nodes`` :155, ``_capture_walk_state``
:2921, ``_assign_with_extenders`` :2942, ``_ext_pool`` :3270; the tie
noise ``rng_key`` :362, :574, :2588-2593, :2628, :2743), itself after
pkg/scheduler/scheduler.go (scheduleOne :496, assume
:424, bind :446, the async binding goroutine :623) and eventhandlers.go
(addAllEventHandlers :251).

One dispatch: cache snapshot → encoder sync (with the existing-pod affinity
index) and the DRA index's claim planes → batch compile → host_prepare
(InterPodAffinity's existing-pod match matrix, DynamicResources' claim
resolution) → conflict partition + engine routing + identity-class dedup gate →
the fused cycle on the device (apply_scatter through K16, the in-flight
batches' resource delta through K13, the dynamic plugins' state —
PodTopologySpread's count tables, InterPodAffinity's count planes or tables
and existing-pod planes, at class rows for the dedup engine and at pod rows
for the full auction and the scan — with the in-flight batches chained in
through K14 / K15, the routed engine through the kernels, the gang
all-or-nothing mask (K20), diagnosis bits + pack (K22)) → one [3, B] fetch
→ assume → reserve → permit → bind through the store → requeue the
unschedulable pods with backoff.  The
router (``assign_mode="auto"``, as the reference) sends a batch to the
dedup engine when its identity classes fill at most half the batch and it
is not a coupled batch with a pod that could preempt; to the full auction
(``batch_assign``) otherwise, when its largest coupled component is at most
``coupled_fraction_threshold`` of the batch or the dedup precheck admits
it; else to the exact serial scan (``greedy_assign``).  ``"batch"`` and
``"scan"`` force the auctions or the scan.
Topology-spread pods and pod (anti)affinity pods (required and preferred,
and scheduled pods carrying such terms) are in scope: a self-matching class
whose commits change its own planes unevenly is one coupled component, so
the dedup engine commits one of its pods per round.  Gang members are in
scope: a GangDirectory (gang/directory.py) tracks PodGroups and members
from the watch; the queue sorts by the directory's gang-cohesive ``less``
and requeues gangs atomically; a member below quorum is rejected at
PreFilter before any device work; a batch that anchors a gang takes the
full auction with Coscheduling's anchor-slice score (K21); the in-batch
mask withdraws a partly placed gang; a placed member whose gang is not
complete holds at Permit (assumed, reserve kept) until its last sibling
releases it or the PodGroup's timeout rolls the whole gang back into the
queue together (``_flush_waiting_binds``, at the end of every cycle).
Pods with resource claims are in scope: a DraIndex (dra/index.py) tracks
device classes, ResourceSlice inventories and claim allocations from the
watch and projects each node's chips into the encoder's claim planes; a
batch with claim pods takes the full auction (or the scan) with
DynamicResources' filter, score and device assume (K24–K26); Reserve picks
named devices, PreBind commits each claim with CAS (all-or-nothing per
pod), Unreserve — a gang timeout among its callers — releases them; the
gang anchor-slice pick counts the gang's pending chip demand.
A pod that fails its attempt and may preempt (priority above some
scheduled pod's, preemptionPolicy not Never, not a gang member the gang
guard holds back, not in a chained batch) runs DefaultPreemption's
PostFilter: the batch's candidate mask on the device (K1's static bits,
then K27 + K28 over the priority levels, or K29), the Evaluator's victim
minimization and 6-criteria ranking on the host, the victims evicted
through the eviction gate, and the pod fast-bound to its nominated node in
the same attempt (``nominated_fast_bind``, plain preemptors) or nominated
and requeued; a nominated pod's request is reserved on its node in every
later cycle (K13's nominated bundle) until it binds.

``pipeline=False`` dispatches, completes and binds each batch within one
``schedule_cycle``.  ``pipeline=True`` keeps up to ``pipeline_depth``
batches in flight: a batch whose pods carry nothing the chain cannot carry
dispatches before the newest in-flight batches are fetched, their
device-resident decisions feeding its cycle as resource deltas and chained
plugin tables; older batches complete (fetch + assume) before the dispatch
and bind after it; the next dispatch's snapshot and encoder sync run on a
background thread meanwhile (``overlap_sync``); and with
``latency_target_ms`` a chainable batch dispatches at the largest pow-2
sub-bucket whose measured attempt latency fits the target.  The port's
dispatch is not asynchronous — the auctions read their loop condition on
the host every round (ROADMAP Queue B B5) — so the pipeline overlaps host
work only: the background sync, the fetch and the binds.  Bindings equal
the JAX scheduler's, pod for pod, in both modes and at every depth.

Profiles: ``profiles`` maps a schedulerName to a plugins factory
(``domain_cap → [PluginWithWeight]``, config/componentconfig.py builds
them from a KubeSchedulerConfiguration); each profile gets its own
BatchedFramework, all sharing the queue, the cache and the encoder; a batch
holds one profile's pods (the queue groups by schedulerName) and runs on
its framework, and a pending pod naming no profile of this scheduler is
ignored.  Without ``profiles`` the one profile is ``default_plugins``.

Extenders: with ``extenders`` (extender.py HTTPExtender clients) every
batch takes the round-based extender walk instead of the engines: the
first round's packed plane comes with the dispatch (``prepare_packed``:
K16, K13's nominated bundle, the plugins' prepare, ``compute_packed`` — K1
+ K2's packed mode); each round the host walks the unresolved pods in
order, calls each interested extender's filter and prioritize (concurrently
on a 16-worker pool, or serialized per ``serialize_extender_callouts``),
merges the weighted extender scores into the device totals, commits at most
one pod a node (a host ledger re-checks the fit; a coupled pod commits only
as its component's first accept of the round), and the round's commits go
to the device through ``apply_commits`` (K13 + the dynamic plugins' class
updates) before the next round's ``compute_packed``.  The candidate list an
extender sees is capped at ``_num_feasible_nodes`` and striped over the
batch, rotating per round.  With ``async_extenders`` (default: when
pipelined) the walk runs on a background thread that ``_complete`` joins;
its callout wall is the ``extender_wait`` phase.  The Evaluator consults
preemption-capable extenders.  Extender batches never chain, never
sub-bucket and never fast-bind a preemptor that such an extender may veto.

Tie noise: ``rng_key`` (two uint32 words, the reference's
``jax.random.PRNGKey(s)`` is ``(0, s)``) draws the reference's threefry
tie noise in the full auction and the scan (K33, K17's keyed mode); the
dedup engine takes no key, so every batch that would dedup takes the full
auction (the reference's ``dedup_fallback("rng_key")``).  Without it ties
break by the lowest node row.

Scope guard: a batch or cluster that needs anything outside the port —
volumes, or a batch larger than the auction kernel's one block on cuda —
raises NotImplementedError naming the ROADMAP item.  It never gives a
silently different answer.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from . import plugins as P
from .api import objects as v1
from .device import resolve_device
from .dra import DraIndex, DynamicResourcesPlugin
from .framework import events as fwk_events
from .api.labels import affinity_term_matches, match_label_selector
from .api.resource import compute_pod_resource_request
from .descheduler import EvictionAPI
from .extender import ExtenderError, _node_to_dict
from .framework.conflict import conflict_components
from .framework.events import ActionType, ClusterEvent, EventResource
from .framework.interface import Code, PluginWithWeight
from .framework.podbatch import (
    AFFINITY_GROUPS,
    PodBatchCompiler,
    batch_to_device,
    identity_classes,
)
from .framework.runtime import (
    BatchedFramework,
    PrevBatch,
    apply_prev_delta,
    coupling_flags,
    initial_dynamic_state,
)
from .framework.waiting_pods import WaitingPodsMap
from .gang import POD_GROUP_LABEL, CoschedulingPlugin, GangDirectory, gang_all_or_nothing
from .kernels import build as kernel_build
from .kernels.diag import diag_pack
from .kernels.filter_score import filter_score_planes
from .ops.prng import key_of
from .oracle import (
    fits_resources,
    node_affinity_fits,
    node_name_fits,
    node_schedulable,
    tolerates_all_hard_taints,
)
from .preemption import Evaluator, _is_plain_preemptor
from .queueing import PriorityQueue
from .queueing.priority_queue import QueuedPodInfo
from .sim.store import ADDED, DELETED, MODIFIED, ObjectStore, WatchEvent
from .state.cache import Cache, Snapshot
from .state.dictionary import MISSING
from .state.encoding import ClusterEncoder, apply_scatter
from .state.node_info import _pod_host_ports
from .state.units import pow2_round_up as _pow2
from .whatif.dryrun import PRIORITY_LEVEL_CAP, candidate_mask_device

DEFAULT_SCHEDULER_NAME = "default-scheduler"  # apis/config v1.Pod default
ASSIGN_MODES = ("auto", "batch", "scan")


def default_plugins(domain_cap: int, dra_index=None) -> List[PluginWithWeight]:
    """Default plugin set + weights, in the reference's order
    (apis/config/v1beta3/default_plugins.go:32-51); ``dra_index`` is the
    scheduler's DraIndex, which DynamicResources resolves claims in (the
    scheduler attaches it to every framework it builds)."""
    PW = PluginWithWeight
    return [
        PW(CoschedulingPlugin(), 1),
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
        PW(DynamicResourcesPlugin(dra_index), 1),
        PW(P.PodTopologySpreadPlugin(domain_cap=domain_cap), 2),
        PW(P.InterPodAffinityPlugin(domain_cap=domain_cap), 2),
        PW(P.BalancedAllocationPlugin(), 1),
        PW(P.ImageLocalityPlugin(), 1),
    ]


# _run_reserve_and_bind outcome: a holds_on_wait Permit plugin (gang
# Coscheduling) left the pod pending — assume + reserve kept, bind deferred
_PERMIT_WAIT = object()


class _PostFilterStoreFault(RuntimeError):
    """A store write inside the PostFilter failed (a victim's delete or the
    nomination's update): the bind phase degrades that pod to
    nominate-nothing and requeues it (the reference's guard,
    scheduler.py:2268-2280).  Only store faults take this path; anything
    else raised inside the PostFilter propagates."""


@dataclass
class _WaitingBind:
    """A binding cycle held open at Permit (the gang all-or-nothing hold; the
    reference's _WaitingBind, scheduler.py:103): the pod stays assumed in
    the cache on ``node_name`` with ``reserved`` plugins intact;
    _flush_waiting_binds finishes or rolls it back."""

    qi: QueuedPodInfo
    node_name: str
    fw: object
    reserved: List
    since: float  # clock() when the hold began


@dataclass
class CycleStats:
    attempted: int = 0
    scheduled: int = 0
    unschedulable: int = 0
    batch_seconds: float = 0.0
    in_flight: int = 0  # pods dispatched whose batch is not bound yet
    # gang members assumed and holding a Permit wait (bind deferred until
    # the gang completes or the wait deadline fires) at cycle end
    waiting: int = 0


def _unpack_diag(bits: np.ndarray, n_filters: int) -> np.ndarray:
    """int32[B] bitmask → bool[B, K] diagnosis bits."""
    return (
        (bits[:, None].astype(np.int64) >> np.arange(n_filters)[None, :]) & 1
    ).astype(bool)


def _num_feasible_nodes(n_all: int) -> int:
    """numFeasibleNodesToFind (scheduler.go:852-872, the reference's
    _num_feasible_nodes, scheduler.py:155, default percentageOfNodesToScore
    0): at most 100 nodes are never sampled; above that the adaptive
    percentage 50 − n/125 applies (floor 5%, floor 100 nodes).  The engines
    score every node; this bound caps the candidate list shipped to the
    extenders per callout — the subset the reference's extenders see."""
    if n_all <= 100:
        return n_all
    pct = min(max(50 - n_all // 125, 5), 100)
    return max(100, n_all * pct // 100)


def _pod_out_of_scope(p: v1.Pod) -> Optional[str]:
    """Why a pending pod needs something outside this slice, or None."""
    if getattr(p.spec, "volumes", None):
        return "volumes (ROADMAP Queue A item 8c)"
    return None


def _dra_plugin(fw: BatchedFramework) -> Optional[DynamicResourcesPlugin]:
    return next((pw.plugin for pw in fw.plugins if pw.plugin.name == "DynamicResources"),
                None)


def _pod_blocks_static(p: v1.Pod) -> bool:
    """Constraints the deep chain cannot carry (the reference's
    _pod_blocks_static, scheduler.py:202): host ports and volumes live in
    host-side structures updated at assume time, and gang members hold
    Permit state.  Topology spread and pod (anti)affinity chain through
    the plugins' ``chain_prev`` hooks."""
    return bool(_pod_host_ports(p) or getattr(p.spec, "volumes", None)
                or POD_GROUP_LABEL in p.metadata.labels)


def _pods_block_deep(pods: Sequence[v1.Pod]) -> bool:
    """Any pod the deep chain cannot carry, counting every pod that could
    preempt (the reference's _pods_block_deep, scheduler.py:171; the
    scheduler's own gate, ``_infos_block_deep``, refines the preemption
    rule)."""
    return any(_pod_blocks_static(p)
               or ((p.spec.priority or 0) > 0 and p.spec.preemption_policy != "Never")
               for p in pods)


def _pod_has_affinity(p: v1.Pod) -> bool:
    """Any pod (anti)affinity term — agrees with PodBatch.has_affinity (the
    reference's _pod_has_affinity, scheduler.py:220)."""
    aff = p.spec.affinity
    if aff is None:
        return False
    pa, paa = aff.pod_affinity, aff.pod_anti_affinity
    return bool(pa and (pa.required or pa.preferred)) or bool(
        paa and (paa.required or paa.preferred))


@dataclass
class _InFlight:
    """One dispatched batch awaiting fetch and bind (the reference's
    _InFlight, scheduler.py:239)."""

    infos: List[QueuedPodInfo]
    batch: object  # the compiled PodBatch (host)
    dbatch: object  # its device copy: the chain's carry reads it
    node_row_dev: torch.Tensor  # i32[B] decisions, on the device
    packed_dev: torch.Tensor  # i32[3, B] node_row / diagnosis bits / rounds
    t0: float  # clock() at the dispatch's start
    cycle: int
    # row → node name at dispatch: a later sync may reuse a deleted node's row
    name_of: Dict[int, str]
    # carries something the deep chain cannot: the next dispatch completes
    # this batch first
    interacts: bool = True
    node_del_gen: int = -1  # the scheduler's node-delete generation at dispatch
    chained: bool = False  # dispatched on in-flight carries
    carried: int = 0  # later dispatches that chained on this batch
    has_aff: bool = False  # carries pod (anti)affinity terms
    builds0: int = 0  # kernel builds before the dispatch (kernels/build.BUILDS)
    # the fetch: a non_blocking copy into pinned memory and the event that
    # marks it done, polled by the background thread (_bg_fetch)
    fetch_event: object = None
    fetch_thread: object = None
    pinned: object = None
    fetched: Optional[np.ndarray] = None  # the packed [3, B] on the host
    fetched_at: float = 0.0  # clock() when the result reached the host
    node_names: Optional[List[Optional[str]]] = None  # resolved at _complete
    diag: Optional[np.ndarray] = None  # bool[B, K], unpacked at _complete
    # the cycle's snapshot and its dynamic state before this batch's
    # commits (after the nominated reservations and the carries): what
    # the preemption candidate mask reads
    dsnap: object = None
    dyn: object = None
    # the candidate mask's priority levels (None: the dense form), set at
    # dispatch for a batch that may preempt; the speculative mask's trip to
    # the host (a pinned copy and its event) and the mask on the host
    cand_levels: Optional[np.ndarray] = None
    cand_pinned: object = None
    cand_event: object = None
    cand_np: Optional[np.ndarray] = None
    # the batch's profile and the framework it was dispatched with (a
    # domain growth may rebuild the profile's framework before the bind
    # phase, so the record owns it)
    profile: str = DEFAULT_SCHEDULER_NAME
    fw: object = None
    # the engine: "batch" / "scan" (the fused cycle) or "extender" (the
    # round walk); the extender walk's result: the plugins' auxes at
    # dispatch (its failing pods' diagnosis reads them), each pod's
    # algorithm latency (dispatch start → its own round's decision), the
    # rounds run, and an exception the async walk died with (raised again
    # at _complete, which requeues the batch)
    engine: str = "batch"
    auxes: object = None
    algo_lat: Optional[np.ndarray] = None
    rounds: int = 0
    walk_error: Optional[BaseException] = None


@dataclass
class _SyncAhead:
    """The overlapped snapshot/sync hand-off (the reference's _SyncAhead,
    scheduler.py:325): one background build of the next dispatch's encoder
    sync and deferred-scatter payload.  The record carries everything
    across the thread seam; _complete joins the thread before any assume
    and the next dispatch consumes or discards the payload."""

    thread: object = None
    dsnap: object = None
    upd: object = None
    consumed: object = None  # dirty rows the payload took (capture_dirty)
    node_del_gen: int = -1  # a node delete after the capture voids the payload
    dic_len: int = -1
    error: object = None
    wall: float = 0.0  # the thread's wall, folded into phase_wall at the join


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
    """The scheduling loop over the port (see the module doc)."""

    _KIND_RESOURCE = {
        "PersistentVolumeClaim": EventResource.PVC,
        "PersistentVolume": EventResource.PV,
        "StorageClass": EventResource.STORAGE_CLASS,
        "CSINode": EventResource.CSI_NODE,
        "Service": EventResource.SERVICE,
        "ResourceClaim": EventResource.RESOURCE_CLAIM,
        "ResourceSlice": EventResource.RESOURCE_SLICE,
        "DeviceClass": EventResource.DEVICE_CLASS,
    }
    # DRA kinds feed the index before the requeue fires (claim-plane dirt
    # must precede the pods the event unblocks)
    _DRA_KINDS = frozenset(("ResourceClaim", "ResourceSlice", "DeviceClass"))
    # kinds that never unblock scheduling (avoid wildcard requeue storms); a
    # ResourceClaimTemplate only matters once the claim controller stamps a
    # claim from it — THAT create requeues
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
        pipeline_depth: int = 3,
        chain_affinity: object = "auto",
        overlap_sync: object = "auto",
        latency_target_ms: Optional[float] = None,
        assign_mode: str = "auto",
        coupled_fraction_threshold: float = 0.25,
        extenders: Optional[List] = None,
        profiles: Optional[Dict[str, object]] = None,
        nominated_fast_bind: bool = True,
        rng_key=None,
        serialize_extender_callouts: str = "auto",
        async_extenders: object = "auto",
    ):
        if assign_mode not in ASSIGN_MODES:
            raise ValueError(f"unknown assign_mode {assign_mode!r}")
        if serialize_extender_callouts not in ("auto", "always", "never"):
            raise ValueError(
                f"unknown serialize_extender_callouts {serialize_extender_callouts!r}")
        if async_extenders not in ("auto", True, False):
            raise ValueError(f"unknown async_extenders {async_extenders!r}")
        if torch.device(device).type == "cuda" and batch_size > 1024:
            raise NotImplementedError(
                f"batch_size={batch_size} on cuda: the auction kernel runs one "
                "block of at most 1024 pods; larger batches wait for the "
                "multi-block auction (ROADMAP Queue B B5)")
        # the fused cycle carries at most two in-flight batches
        if not 1 <= pipeline_depth <= 3:
            raise ValueError(f"pipeline_depth must be 1..3, got {pipeline_depth}")
        self.device = resolve_device(device)
        # "auto": the reference's router; "batch" / "scan" force the
        # auctions or the exact serial scan (the reference's assign_mode)
        self.assign_mode = assign_mode
        self.coupled_fraction_threshold = coupled_fraction_threshold
        self.pipeline = pipeline
        self.pipeline_depth = pipeline_depth
        # the tie-noise key as two uint32 words (None: lowest-row ties)
        self.rng_key = None if rng_key is None else key_of(rng_key)
        # the extenders (extender.py clients) and their callout cadence:
        # "auto" serializes a round's callouts when an extender declares
        # managedResources (a stateful extender must see requests in commit
        # order), "always" / "never" force either cadence; the async walk
        # runs on a background thread, on exactly when pipelined under
        # "auto" (the reference's scheduler.py:598-627)
        self.extenders = list(extenders or [])
        self.serialize_extender_callouts = serialize_extender_callouts
        self.async_extenders = pipeline if async_extenders == "auto" else bool(async_extenders)
        self._ext_pool_lock = threading.Lock()
        self._ext_pool_obj = None
        self._ext_round_warmed = False
        # chain affinity batches on the card (the reference: on any backend
        # but its CPU one); on the CPU the chain still runs while the last
        # dispatch deduped (_chain_affinity_now)
        if chain_affinity == "auto":
            chain_affinity = self.device.type == "cuda"
        self.chain_affinity = bool(chain_affinity)
        self._last_dedup = False
        # the next dispatch's sync on a background thread: on exactly when
        # the pipeline is (a synchronous cycle would join it at once)
        if overlap_sync == "auto":
            overlap_sync = pipeline
        self.overlap_sync = bool(overlap_sync)
        self._sync_ahead: Optional[_SyncAhead] = None
        self._unconsumed_prep: Optional[_SyncAhead] = None
        # what became of each background payload at its dispatch (the
        # reference's sync_overlap counter labels): used as built, rebuilt
        # from the live mirrors after later changes, or voided by a node delete
        self.sync_overlap_counts: Dict[str, int] = {
            "reused": 0, "merged": 0, "fallback_node_delete": 0}
        # micro-bucket dispatch: None = every cycle pads to batch_size
        self.latency_target_ms = latency_target_ms
        self._forced_bucket: Optional[int] = None  # the harness's warm override
        # pad tier → EMA of the batch's largest attempt latency (seconds)
        self._tier_p99: Dict[int, float] = {}
        self._inflight_q: List[_InFlight] = []  # oldest first
        self._node_del_gen = 0  # bumped on node DELETE (deep-chain gate)
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
        # the DRA ledger: device inventory and claim allocations, projected
        # into the encoder's claim planes right after every foreground sync
        # (_dispatch) and read by DynamicResources' Reserve / PreBind and the
        # gang anchor-slice resolver (the reference's scheduler.py:553-589)
        self.dra = DraIndex(store)
        # the profile map: schedulerName → plugins factory (domain_cap →
        # [PluginWithWeight]); each profile gets its own framework, all
        # sharing this scheduler's queue, cache and encoder (profile.NewMap)
        self.profiles: Dict[str, object] = (
            dict(profiles) if profiles else {DEFAULT_SCHEDULER_NAME: default_plugins})
        self._fws: Dict[str, BatchedFramework] = {}
        # the event map is the union of every profile's registrations
        # (scheduler.go:347-362)
        event_map: Dict[ClusterEvent, Set[str]] = {}
        for factory in self.profiles.values():
            for pw in factory(8):
                for ev in pw.plugin.events_to_register():
                    event_map.setdefault(ev, set()).add(pw.plugin.name)
        # the gang runtime (the reference's scheduler.py:582-595): one
        # directory wired into the Coscheduling plugin; its less is the
        # Coscheduling QueueSort (gang cohesion over PrioritySort) and its
        # group key gives the queue gang-atomic activate / requeue
        self.gangs = GangDirectory(store, clock=clock)
        self.gangs.attach_claim_resolver(self.dra.pod_claim_demand)
        self.queue = PriorityQueue(
            less=self.gangs.less, clock=clock, cluster_event_map=event_map,
            pod_initial_backoff=pod_initial_backoff,
            pod_max_backoff=pod_max_backoff,
            group_key=self.gangs.queue_group_key,
        )
        self.waiting_pods = WaitingPodsMap(clock=clock)
        self.gangs.bind_runtime(self.waiting_pods)
        # uid → _WaitingBind: binding cycles held open at Permit (gang
        # members keep their assume + reserve until the gang completes or
        # the wait deadline fires — flushed at the end of every cycle)
        self._waiting_binds: Dict[str, _WaitingBind] = {}
        self._framework()
        # wall per phase (seconds, summed over cycles): "host_prepare" is the
        # plugins' host halves (InterPodAffinity's existing-pod match matrix);
        # "partition" is the conflict partition, the engine routing and the
        # dedup gate; "device" brackets the fused cycle from the first upload
        # to the [3, B] result on the card (the round loop syncs with it);
        # "fetch" is the wait for that result at completion; "queue_wait" the
        # hold for a backoff wave; "sync_overlap" the background sync's wall
        # — off the critical path, not part of any cycle's wall;
        # "extender_wait" the extender walk's callout wall (the join of an
        # async walk)
        self.phase_wall: Dict[str, float] = {
            k: 0.0 for k in ("snapshot", "compile", "host_prepare", "partition", "device",
                             "fetch", "extender_wait", "bind", "queue_wait",
                             "sync_overlap")}
        self.cycles = 0
        self.rounds_total = 0
        # host wall spent in the dedup engine's per-round read of its loop
        # condition (seconds, summed over cycles; part of "device")
        self.round_read_s = 0.0
        # per-pod attempt latency (seconds, on ``clock``): the batch's
        # algorithm time (dispatch start → result on the host) plus the
        # pod's own bind or requeue segment, as the reference measures it
        self.attempt_seconds: List[float] = []
        # placed pods that reached later dispatches as carries, counted once
        # per dispatch that chained on them (known at their completion)
        self.carried_pods = 0
        self.chained_dispatches = 0  # dispatches that chained on in-flight batches
        # --- preemption (the reference's scheduler.py:597, :628-677) ---
        # the Evaluator's reprieve sweep runs the C++ pass on the card
        self.preemption = Evaluator(native=self.device.type == "cuda")
        # bind a plain preemptor to its nominated node within the failing
        # attempt (_try_nominated_fast_bind); off = always nominate and requeue
        self.nominated_fast_bind = nominated_fast_bind
        # per profile, an EMA of the batch failure fraction: above 0.25 a
        # batch that may preempt dispatches its candidate mask with the cycle
        self._fail_ema: Dict[str, float] = {}
        # nominator: uid → (node name, request units, pod) for pods holding a
        # nominated node across cycles: their requests are reserved on it in
        # every fused cycle (K13's nominated bundle) and preemption dry runs
        # see them there
        self._nominated: Dict[str, tuple] = {}
        # uid → dispatch seq at which the pod was preemption-fast-bound: its
        # nomination stands in for the not-yet-snapshotted assume until the
        # first dispatch whose snapshot carries the bind (seq strictly
        # greater) purges it
        self._fastbound_noms: Dict[str, int] = {}
        self._dispatch_seq = 0
        # victim deletes go through the eviction gate with override_pdb
        self.eviction_api = EvictionAPI(store)
        # the reference's preemption metrics: PostFilter runs, victims per
        # preemption, pods fast-bound after preempting; PostFilters that
        # degraded on a store fault
        self.preemption_attempts = 0
        self.preemption_victims: List[int] = []
        self.fast_binds = 0
        self.post_filter_errors = 0
        self._unwatch = store.watch(self._on_event)

    def _profile_of(self, pod: v1.Pod) -> str:
        """frameworkForPod (scheduler.go:719): the pod's schedulerName, the
        default profile's name when unset (the reference's _profile_of)."""
        return pod.spec.scheduler_name or DEFAULT_SCHEDULER_NAME

    def _framework(self, profile: Optional[str] = None) -> BatchedFramework:
        """The framework of ``profile`` (when None: the default profile, or
        the first profile when the scheduler holds no default-scheduler) for
        the encoder's current domain_cap; a domain growth rebuilds every
        profile's (the reference's _framework, scheduler.py:859-878)."""
        if profile is None:
            profile = DEFAULT_SCHEDULER_NAME if DEFAULT_SCHEDULER_NAME in self.profiles \
                else next(iter(self.profiles))
        d = self.encoder.domain_cap
        if d != self._fw_domain_cap:
            prev, self._fws = self._fws, {}
            self._fw_domain_cap = d
            for name, old in prev.items():
                self._fws[name] = self._build_framework(name, d, old)
        fw = self._fws.get(profile)
        if fw is None:
            fw = self._fws[profile] = self._build_framework(profile, d)
        return fw

    def _build_framework(self, profile: str, d: int, old=None) -> BatchedFramework:
        """A profile's framework at domain cap ``d``: the gang directory and
        the DRA index reach its plugins through their attach hooks (a
        factory takes only the domain cap); ``old``, the framework it
        replaces, hands its DRA series over (the reference's are
        process-wide metrics)."""
        fw = BatchedFramework(self.profiles[profile](d))
        for pw in fw.plugins:
            for hook, target in (("attach_gang_directory", self.gangs),
                                 ("attach_dra_index", self.dra)):
                attach = getattr(pw.plugin, hook, None)
                if attach is not None:
                    attach(target)
        o, n = (_dra_plugin(old) if old is not None else None), _dra_plugin(fw)
        if o is not None and n is not None:
            n.claims_allocated = o.claims_allocated
            n.allocation_durations = o.allocation_durations
        return fw

    @property
    def dra_plugin(self) -> Optional[DynamicResourcesPlugin]:
        """The live DynamicResources plugin of the default profile (its
        claim series); None when that profile does not run it."""
        return _dra_plugin(self._framework())

    # --- event handlers (eventhandlers.go:251+) ------------------------------

    def _on_event(self, ev: WatchEvent):
        if ev.kind == "Node":
            self._on_node_event(ev)
        elif ev.kind == "Pod":
            self._on_pod_event(ev)
        elif ev.kind == "PodGroup":
            # gang directory first (quorum counts read it), then requeue
            # members whose Coscheduling rejection this change may resolve
            self.gangs.on_group_event(ev.type, ev.obj)
            action = {ADDED: ActionType.ADD, MODIFIED: ActionType.UPDATE,
                      DELETED: ActionType.DELETE}.get(ev.type, ActionType.ALL)
            self.queue.move_all_to_active_or_backoff(
                ClusterEvent(EventResource.POD_GROUP, action))
        elif ev.kind in self._IGNORED_KINDS:
            return
        else:
            if ev.kind in self._DRA_KINDS:
                self.dra.on_event(ev.type, ev.obj)
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
        self.gangs.invalidate_nodes()  # the slice-domain plane is stale
        if ev.type == ADDED:
            self.cache.add_node(node)
            # a (re)added node may land on a freed encoder row whose claim
            # planes were zeroed: re-project its inventory next flush
            self.dra.note_node(node.metadata.name)
            self.queue.move_all_to_active_or_backoff(fwk_events.NODE_ADD)
        elif ev.type == MODIFIED:
            old_info = self.cache._nodes.get(node.metadata.name)
            old = old_info.node if old_info else None
            action = self._node_update_action(old, node)
            self.cache.update_node(node)
            self.queue.move_all_to_active_or_backoff(
                ClusterEvent(EventResource.NODE, action))
        elif ev.type == DELETED:
            # a delete can free an encoder row the next sync reuses: an
            # in-flight carry's rows would then charge the wrong node
            self._node_del_gen += 1
            self.cache.remove_node(node.metadata.name)
            self.queue.move_all_to_active_or_backoff(fwk_events.NODE_DELETE)

    def _on_pod_event(self, ev: WatchEvent):
        pod: v1.Pod = ev.obj
        assigned = bool(pod.spec.node_name)
        # responsibleForPod: only pods naming one of this scheduler's
        # profiles enter the queue;
        # assigned pods always feed the cache (they occupy resources)
        if not assigned and self._profile_of(pod) not in self.profiles:
            return
        if ev.type == DELETED and pod.uid in self._waiting_binds:
            # a gang member deleted while holding its Permit wait: abort the
            # held binding cycle through the unreserve chain (the
            # Coscheduling group-failure hook fails the gang's remaining
            # waiters now instead of timing them out)
            self._cancel_waiting_bind(pod.uid)
        self.gangs.on_pod_event(ev.type, pod, assigned)
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
            self._nominated.pop(pod.uid, None)
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
        """One step (the reference's schedule_cycle, scheduler.py:1066-1221).

        Synchronous mode dispatches, completes and binds one batch.  In
        pipelined mode the popped batch may chain on the newest in-flight
        batches (the tail): every older in-flight batch completes (fetch +
        assume) first, the new batch dispatches, then the completed batches
        bind and the next dispatch's sync starts on a background thread."""
        inflight = self._inflight_q
        stats = CycleStats()
        if self.batch_wait > 0:
            self._await_backoff_wave()
        infos = self.queue.pop_batch(
            self.batch_size,
            group_key=lambda qi: self._profile_of(qi.pod))
        # the gang PreFilter quorum gate: a member whose group is below
        # minMember can never form the gang — rejected here, before any
        # compile or device work
        if infos and self.gangs.active:
            infos = self._gang_prefilter(infos, stats)
        for qi in infos:
            why = _pod_out_of_scope(qi.pod)
            if why is not None:
                raise NotImplementedError(
                    f"pod {qi.pod.key()} needs {why}: outside this slice")
        next_interacts = self._infos_block_deep(infos) if infos else True
        pad = self._pick_bucket(infos, next_interacts)
        if len(infos) > pad:
            self.queue.put_back(infos[pad:])
            infos = infos[:pad]
        tail = self._chain_tail(infos, next_interacts, pad)
        completed = []
        while len(inflight) > tail:
            fl = inflight.pop(0)
            rows = self._complete_or_requeue(fl, stats)
            if rows is not None:
                completed.append((fl, rows))
        nxt = None
        if infos:
            nxt = self._dispatch(infos, prevs=inflight[len(inflight) - tail:],
                                 interacts=next_interacts, pad=pad)
            self.cycles += 1
        for fl, node_row in completed:  # the binds follow the new dispatch
            self._merge(stats, self._bind_phase(fl, node_row))
        if nxt is not None:
            if self.pipeline:
                inflight.append(nxt)
            else:
                rows = self._complete_or_requeue(nxt, stats)
                if rows is not None:
                    self._merge(stats, self._bind_phase(nxt, rows))
        # resolve the gang Permit holds: released members bind now (the last
        # sibling's permit this cycle allowed them), expired ones roll the
        # whole gang back and requeue it atomically
        ws = self._flush_waiting_binds()
        stats.scheduled += ws.scheduled
        stats.unschedulable += ws.unschedulable
        stats.waiting = len(self._waiting_binds)
        stats.in_flight = sum(len(fl.infos) for fl in inflight)
        # the next dispatch's sync, after every cache write of this cycle
        if self.overlap_sync and (inflight or stats.attempted):
            self._spawn_sync_ahead()
        return stats

    def _complete_or_requeue(self, fl: _InFlight, stats: CycleStats) -> Optional[np.ndarray]:
        """``_complete``, with the reference's completion guard for an
        extender batch whose async walk died (scheduler.py:1153-1166):
        nothing was assumed, so every pod requeues through the backoff queue
        (unless it was deleted meanwhile) and the loop goes on → None.  Any
        other fault propagates."""
        try:
            return self._complete(fl)
        except Exception:
            if fl.walk_error is None:
                raise
            for qi in fl.infos:
                if self.store.get("Pod", qi.pod.namespace, qi.pod.metadata.name) is not None:
                    self.queue.requeue_after_error(qi)
            stats.attempted += len(fl.infos)
            return None

    def _gang_prefilter(self, infos: List[QueuedPodInfo],
                        stats: CycleStats) -> List[QueuedPodInfo]:
        """The host PreFilter pass (Coscheduling quorum; the reference's
        _gang_prefilter, scheduler.py:1223): rejected members go straight to
        the unschedulable queue with the plugin's diagnosis — no device work
        — and requeue on sibling-pod / PodGroup events."""
        keep: List[QueuedPodInfo] = []
        cycle = self.queue.scheduling_cycle()
        for qi in infos:
            st = self.gangs.prefilter(qi.pod)
            if st is None or st.is_success():
                keep.append(qi)
                continue
            qi.unschedulable_plugins = {st.plugin or "Coscheduling"}
            stats.attempted += 1
            stats.unschedulable += 1
            self.queue.add_unschedulable(qi, cycle)
        return keep

    @staticmethod
    def _merge(total: CycleStats, s: CycleStats) -> None:
        total.attempted += s.attempted
        total.scheduled += s.scheduled
        total.unschedulable += s.unschedulable
        total.batch_seconds += s.batch_seconds

    def _chain_tail(self, infos, interacts: bool, pad: int) -> int:
        """How many of the newest in-flight batches this dispatch chains on
        (the reference's tail rules, scheduler.py:1126-1149): none when not
        pipelined or when the batch carries something the chain cannot;
        else up to depth − 1 (1 for a sub-bucket), stopping at a batch that
        interacts, an affinity batch under a batch without affinity content
        (its terms would have no tables to land in), a batch dispatched
        before a node delete, or one of another pad tier."""
        if not (infos and self.pipeline) or interacts or self.extenders:
            return 0
        has_aff = any(_pod_has_affinity(qi.pod) for qi in infos)
        limit = 1 if pad < self.batch_size else self.pipeline_depth - 1
        tail = 0
        for fl in reversed(self._inflight_q):
            if (tail >= limit or fl.interacts or (fl.has_aff and not has_aff)
                    or fl.node_del_gen != self._node_del_gen
                    or fl.batch.size != pad):
                break
            tail += 1
        return tail

    @property
    def _chain_affinity_now(self) -> bool:
        """May affinity batches deep-chain now?  On the card always; on the
        CPU while the last dispatch deduped (the reference's
        _chain_affinity_now, scheduler.py:849).  Either way the chain is
        exact; the gate only decides whether it runs."""
        return self.chain_affinity or self._last_dedup

    def _infos_block_deep(self, infos: List[QueuedPodInfo]) -> bool:
        """Must this batch complete the in-flight batches before it
        dispatches (the reference's _infos_block_deep, scheduler.py:3523)?
        Yes for a pod the chain cannot carry, for an affinity pod while the
        affinity chain is off, and for a pod that could preempt and is
        likely to: a retry, or one that fits no node of the current
        snapshot."""
        preempt_qis: List[QueuedPodInfo] = []
        for qi in infos:
            p = qi.pod
            if _pod_blocks_static(p):
                return True
            if not self._chain_affinity_now and _pod_has_affinity(p):
                return True
            if (p.spec.priority or 0) > 0 and p.spec.preemption_policy != "Never":
                if qi.attempts > 1 or qi.unschedulable_plugins:
                    return True
                preempt_qis.append(qi)
        if not preempt_qis:
            return False
        if not self.pipeline or self.extenders:
            return True
        self.join_sync_ahead()  # the fit scan reads the encoder's mirrors
        enc = self.encoder
        valid = np.asarray(enc.node_valid)
        free = enc.allocatable[valid].astype(np.int64) - enc.requested[valid]
        seen_fit: Dict[bytes, bool] = {}
        for qi in preempt_qis:
            req = np.asarray(enc.pod_request_units(qi.pod))
            key = req.tobytes()
            fit = seen_fit.get(key)
            if fit is None:
                fit = bool(np.any(np.all((req == 0) | (req[None, :] <= free), axis=1)))
                seen_fit[key] = fit
            if not fit:
                return True
        return False

    # --- micro-bucket dispatch ------------------------------------------------------

    def bucket_tiers(self) -> List[int]:
        """Pow-2 sub-bucket pads below batch_size, largest first, down to
        max(16, batch_size / 16) (the reference's bucket_tiers)."""
        out: List[int] = []
        t = _pow2(self.batch_size, 1) // 2
        floor = max(16, self.batch_size // 16)
        while t >= floor:
            out.append(t)
            t //= 2
        return out

    def _pick_bucket(self, infos, interacts: bool) -> int:
        """This cycle's dispatch pad (the reference's _pick_bucket):
        batch_size unless the micro-bucket policy is armed and the batch
        can ride the chain; ``_forced_bucket`` overrides (warms)."""
        if self._forced_bucket:
            return max(1, min(self._forced_bucket, self.batch_size))
        if self.latency_target_ms is None or not infos or interacts or not self.pipeline \
                or self.extenders:
            return self.batch_size
        return self._bucket_from_latency()

    def _bucket_from_latency(self) -> int:
        """The largest profiled tier whose latency EMA fits 90% of the
        target (the full batch predicted at twice its largest sub-tier);
        when every profiled tier overruns, one unprofiled tier below the
        smallest (the reference's _bucket_from_latency)."""
        b = self.batch_size
        prof = self._tier_p99
        if not prof:
            return b
        tgt = self.latency_target_ms / 1e3
        cand = dict(prof)
        if b not in cand:
            t = max(cand)
            if 2 * t >= _pow2(b, 1):
                cand[b] = 2.0 * cand[t]
        fit = [t for t, p in cand.items() if p <= 0.9 * tgt]
        if fit:
            return max(fit)
        lower = [t for t in self.bucket_tiers() if t < min(prof)]
        return max(lower) if lower else min(prof)

    # --- the overlapped sync ------------------------------------------------------

    def _spawn_sync_ahead(self) -> None:
        """Start the next dispatch's snapshot sync off the critical path
        (the reference's _spawn_sync_ahead): the cache diff runs here, the
        encoder sync and the deferred-scatter build on a thread."""
        if not self.overlap_sync or self._sync_ahead is not None:
            return
        rec = _SyncAhead()
        changed = self.cache.update_snapshot(self.snapshot)
        rec.node_del_gen = self._node_del_gen

        def _run():
            t_s = time.perf_counter()
            try:
                self.encoder.sync(self.snapshot, changed)
                rec.consumed = self.encoder.capture_dirty()
                rec.dsnap, rec.upd = self.encoder.to_device_deferred(consume_force=False)
                rec.dic_len = len(self.encoder.dic)
            except Exception as e:  # raised again at the next dispatch
                rec.error = e
            rec.wall = time.perf_counter() - t_s

        rec.thread = threading.Thread(target=_run, daemon=True)
        self._sync_ahead = rec
        rec.thread.start()

    def join_sync_ahead(self) -> None:
        """Barrier for readers of the snapshot and the encoder (the
        descheduler and autoscaler driven between cycles, the fit scan, the
        commit): joins the background sync without consuming its payload
        (the reference's join_sync_ahead)."""
        rec = self._sync_ahead
        if rec is not None and rec.thread is not None:
            rec.thread.join()
            rec.thread = None
            self.phase_wall["sync_overlap"] += rec.wall
            rec.wall = 0.0

    def _pop_sync_ahead(self) -> Optional[_SyncAhead]:
        """Join the background sync and take its record (None when none
        ran), raising its error as the dispatch that would have taken it."""
        self.join_sync_ahead()
        rec, self._sync_ahead = self._sync_ahead, None
        if rec is not None and rec.error is not None:
            raise rec.error
        return rec

    def fold_sync_ahead(self) -> None:
        """Join the background sync and fold its payload back: its rows go
        back to the encoder's dirty sets (a caller's own upload then carries
        them) and the next dispatch syncs itself.  The what-if engine calls
        this before it syncs and uploads the encoder."""
        rec = self._pop_sync_ahead()
        if rec is not None and rec.upd is not None:
            self.encoder.restore_dirty(rec.consumed)

    def _take_sync_ahead(self) -> Optional[_SyncAhead]:
        """Join and take the background sync at dispatch: the record, or
        None when none ran or a node delete landed after its capture (the
        payload is then folded back and the dispatch syncs itself)."""
        rec = self._pop_sync_ahead()
        if rec is None:
            return None
        if rec.node_del_gen != self._node_del_gen:
            if rec.upd is not None:
                self.encoder.restore_dirty(rec.consumed)
            self.sync_overlap_counts["fallback_node_delete"] += 1
            return None
        self._unconsumed_prep = rec
        return rec

    def _discard_prep(self) -> None:
        """A dispatch that died between taking the payload and using it
        folds the payload's rows back."""
        prep, self._unconsumed_prep = self._unconsumed_prep, None
        if prep is not None and prep.upd is not None:
            self.encoder.restore_dirty(prep.consumed)

    def _deferred_snapshot(self, prep: Optional[_SyncAhead]):
        """The dispatch-time deferred upload (the reference's
        _deferred_snapshot): the background payload as it is when nothing
        changed since its capture, else its rows folded back and the
        payload rebuilt from the live mirrors."""
        enc = self.encoder
        self._unconsumed_prep = None
        if prep is None:
            return enc.to_device_deferred()
        if not enc.has_dirty() and len(enc.dic) == prep.dic_len \
                and not enc._force_full_once:
            self.sync_overlap_counts["reused"] += 1
            return prep.dsnap, prep.upd
        if prep.upd is not None:
            enc.restore_dirty(prep.consumed)
        self.sync_overlap_counts["merged"] += 1
        return enc.to_device_deferred()

    # --- dispatch ---------------------------------------------------------------

    def _dispatch(self, infos: List[QueuedPodInfo], prevs: Sequence[_InFlight] = (),
                  interacts: bool = True, pad: Optional[int] = None) -> _InFlight:
        """Snapshot → compile → routing → the fused cycle on the device; the
        [3, B] result is fetched in the background (the reference's
        _dispatch_batch with _bg_fetch, scheduler.py:1522-1967).  ``prevs``
        are the chained in-flight batches, oldest first."""
        t0 = time.perf_counter()
        t0_clk = self.clock()
        builds0 = kernel_build.BUILDS
        cycle = self.queue.scheduling_cycle()
        self._dispatch_seq += 1
        pad = pad or self.batch_size
        prep = self._take_sync_ahead() if self.overlap_sync else None
        try:
            changed = self.cache.update_snapshot(self.snapshot)
            self.encoder.sync(self.snapshot, changed)
            # the DRA claim planes: the dirty nodes' (capacity, allocated)
            # into the encoder's mirrors before the deferred upload, so the
            # flush rides the same row-scatter as the node sync
            self.dra.flush_to_encoder(self.encoder)
            # fast-bound nominations whose assume this snapshot now carries:
            # the reservation would count twice from here on (the marks carry
            # the seq of the dispatch before their bind phase)
            for uid, seq in list(self._fastbound_noms.items()):
                if seq < self._dispatch_seq:
                    self._fastbound_noms.pop(uid, None)
                    self._nominated.pop(uid, None)
            t1 = time.perf_counter()
            pods = [qi.pod for qi in infos]
            batch = self.compiler.compile(pods, pad_to=pad)
            # the gang context of this batch: Coscheduling's host_prepare
            # reads the staged pods (the compiled batch carries none), the
            # device mask reads the segment ids
            self.gangs.stage_batch(pods)
            gang_seg = self.gangs.gang_segments(pods, batch.size)
            t_hp = time.perf_counter()
            # the batch's profile (the queue groups a batch by schedulerName)
            profile = self._profile_of(pods[0])
            fw = self._framework(profile)
            host_auxes = fw.host_prepare(batch, self.snapshot, self.encoder,
                                         namespace_labels=self.namespace_labels)
            t2 = time.perf_counter()
            carries, mode, coupling, classes = [], "extender", None, None
            if not self.extenders:
                carries = self._carries(prevs, batch)
                mode, coupling, _info = self.engine_choice(batch, fw=fw)
                if mode == "batch":
                    class_of, rep_rows, _why = self._dedup_classes(batch, host_auxes, fw=fw)
                    if class_of is not None:
                        classes = (class_of, rep_rows)
                self._last_dedup = classes is not None
            t3 = time.perf_counter()
            dsnap, upd = self._deferred_snapshot(prep)
            nom_rows, nom_req = self._nominated_arrays({qi.pod.uid for qi in infos})
        except Exception:
            self._discard_prep()
            raise
        if mode == "extender":
            # the callout wall spent inside is the extender_wait phase
            fl, wait = self._extender_cycle(infos, batch, fw, profile, host_auxes, dsnap, upd,
                                            (nom_rows, nom_req), t0_clk, cycle, builds0)
        else:
            wait = 0.0
            fl = self._fused_dispatch(infos, pods, batch, mode, classes, coupling, host_auxes,
                                      dsnap, upd, carries, gang_seg, (nom_rows, nom_req), fw,
                                      profile, t0_clk, cycle, interacts, builds0)
        t4 = time.perf_counter()
        self.phase_wall["snapshot"] += t1 - t0
        self.phase_wall["compile"] += t_hp - t1
        self.phase_wall["host_prepare"] += t2 - t_hp
        self.phase_wall["partition"] += t3 - t2
        self.phase_wall["device"] += max(t4 - t3 - wait, 0.0)
        return fl

    def _fused_dispatch(self, infos, pods, batch, mode, classes, coupling, host_auxes, dsnap,
                        upd, carries, gang_seg, nominated, fw, profile: str, t0_clk: float,
                        cycle: int, interacts: bool, builds0: int) -> _InFlight:
        """The engines' dispatch: the fused cycle, the in-flight record and
        the start of its fetch, and for a batch that may preempt its
        priority levels (and the speculative candidate mask)."""
        node_row, packed, dbatch, dsnap, dyn = self._fused_cycle(
            batch, mode, classes, coupling, host_auxes, dsnap, upd, carries, gang_seg,
            nominated=nominated, fw=fw)
        self.chained_dispatches += bool(carries)
        fl = _InFlight(infos=infos, batch=batch, dbatch=dbatch, node_row_dev=node_row,
                       packed_dev=packed, t0=t0_clk, cycle=cycle,
                       name_of=dict(self.encoder.row_to_name()), interacts=interacts,
                       node_del_gen=self._node_del_gen, chained=bool(carries),
                       has_aff=bool(batch.has_affinity), builds0=builds0,
                       dsnap=dsnap, dyn=dyn, profile=profile, fw=fw)
        self._start_fetch(fl)
        # a chained batch defers preemption to the retry, so neither the
        # levels nor the speculative mask apply to it; a batch that may
        # preempt takes its levels now, and when recent batches failed often
        # its candidate mask goes out with the cycle (the reference's
        # speculative dispatch, scheduler.py:1859-1877)
        if not carries and any((p.spec.priority or 0) > 0
                               and p.spec.preemption_policy != "Never" for p in pods):
            fl.cand_levels = self._priority_levels()
            if self._fail_ema.get(profile, 0.0) > 0.25:
                self._start_cand_fetch(fl, self._candidate_mask(fl))
        return fl

    def _carries(self, prevs: Sequence[_InFlight], batch) -> List[PrevBatch]:
        """The chained in-flight batches as PrevBatch carries (device
        tensors); their term groups ride only when this batch has affinity
        content and the affinity chain is on."""
        groups = bool(batch.has_affinity) and self._chain_affinity_now
        out = []
        for fl in prevs:
            fl.carried += 1
            db = fl.dbatch
            out.append(PrevBatch(
                rows=fl.node_row_dev, req=db.request, nz=db.non_zero, valid=db.valid,
                label_keys=db.label_keys, label_vals=db.label_vals, ns=db.ns,
                group_present=tuple(fl.batch.group_present),
                **({name: getattr(db, name) for name in AFFINITY_GROUPS} if groups else {})))
        return out

    def _start_fetch(self, fl: _InFlight) -> None:
        """Start the [3, B] result's trip to the host: on the card a
        non_blocking copy into pinned memory and an event, which a
        background thread polls (the reference's _bg_fetch); on the CPU
        the result is on the host already."""
        if fl.packed_dev.device.type != "cuda":
            fl.fetched = fl.packed_dev.numpy().copy()
            fl.fetched_at = self.clock()
            return
        fl.pinned = torch.empty(fl.packed_dev.shape, dtype=fl.packed_dev.dtype,
                                pin_memory=True)
        fl.pinned.copy_(fl.packed_dev, non_blocking=True)
        fl.fetch_event = torch.cuda.Event()
        fl.fetch_event.record()

        def _bg_fetch(rec=fl, clk=self.clock):
            # polling with a sleep releases the GIL; a blocking wait would
            # hold it and stall the main thread's host work
            while not rec.fetch_event.query():
                time.sleep(0.0005)
            rec.fetched = rec.pinned.numpy().copy()
            rec.fetched_at = clk()

        fl.fetch_thread = threading.Thread(target=_bg_fetch, daemon=True)
        fl.fetch_thread.start()

    def _nominated_bundle(self, nominated):
        """The nominated pods' (rows, requests) as a K13 bundle on the card,
        the requests cast f32 → i32 as the reference's reserve_nominated
        does; None when no row is nominated (all −1 add nothing)."""
        if not bool((nominated[0] >= 0).any()):
            return None
        return (torch.from_numpy(nominated[0]).to(self.device),
                torch.from_numpy(nominated[1]).to(self.device).to(torch.int32))

    def _extender_cycle(self, infos, batch, fw, profile: str, host_auxes, dsnap, upd,
                        nominated, t0_clk: float, cycle: int, builds0: int):
        """The extender path's dispatch (the reference's extender branch of
        _dispatch_batch, scheduler.py:1672-1795) → (the in-flight record,
        the callout wall spent here).  The first round rides one program,
        the reference's ``prepare_packed`` (:1030-1039): the deferred
        scatter (K16), the nominated reservations (K13), the plugins'
        prepare at pod rows, ``compute_packed`` (K1 + K2 packed).  The
        first extender dispatch also runs ``compute_packed``,
        ``apply_commits`` and ``diagnose_bits`` once (the reference's
        pre-window warm).  Then the round walk runs here, or on a
        background thread with ``async_extenders`` (its inputs captured
        here, on the dispatch thread), which _complete joins."""
        dsnap = apply_scatter(dsnap, upd)
        self.encoder.commit_device(dsnap)
        dyn = apply_prev_delta(initial_dynamic_state(dsnap), (),
                               nominated=self._nominated_bundle(nominated))
        dbatch = batch_to_device(batch, self.device)
        auxes = fw.prepare(dbatch, dsnap, dyn, host_auxes)
        packed0 = fw.compute_packed(dbatch, dsnap, dyn, auxes)
        if not self._ext_round_warmed:
            self._ext_round_warmed = True
            b = batch.size
            fw.compute_packed(dbatch, dsnap, dyn, auxes)
            fw.apply_commits(dbatch, dsnap, dyn, auxes, np.zeros(b, dtype=bool),
                             np.zeros(b, dtype=np.int32))
            fw.diagnose_bits(dbatch, dsnap, dyn, auxes)
        fl = _InFlight(infos=infos, batch=batch, dbatch=dbatch, node_row_dev=None,
                       packed_dev=None, t0=t0_clk, cycle=cycle,
                       name_of=dict(self.encoder.row_to_name()), interacts=True,
                       node_del_gen=self._node_del_gen, has_aff=bool(batch.has_affinity),
                       builds0=builds0, dsnap=dsnap, dyn=dyn, profile=profile, fw=fw,
                       engine="extender", auxes=auxes)
        pods = [qi.pod for qi in infos]
        if self.async_extenders:
            captured = self._capture_walk_state()

            def _walk(rec=fl, clk=self.clock):
                try:
                    rec.fetched, rec.algo_lat, rec.rounds, _wait = self._assign_with_extenders(
                        fw, batch, dbatch, dsnap, dyn, auxes, pods, t0_clk,
                        packed0=packed0, nom=nominated, captured=captured)
                except Exception as e:  # raised again at _complete: the batch requeues
                    rec.walk_error = e
                rec.fetched_at = clk()

            fl.fetch_thread = threading.Thread(target=_walk, daemon=True)
            fl.fetch_thread.start()
            return fl, 0.0
        fl.fetched, fl.algo_lat, fl.rounds, wait = self._assign_with_extenders(
            fw, batch, dbatch, dsnap, dyn, auxes, pods, t0_clk, packed0=packed0,
            nom=nominated)
        fl.fetched_at = self.clock()
        self.phase_wall["extender_wait"] += wait
        return fl, wait

    def _capture_walk_state(self):
        """Everything the extender walk reads of the live scheduler, copied
        on the dispatch thread before an async walk starts (the reference's
        _capture_walk_state, scheduler.py:2921): row ↔ name maps, the
        encoder's allocatable and requested mirrors, and the node objects
        when an extender is not nodeCacheCapable (it receives manifests)."""
        name_of = dict(self.encoder.row_to_name())
        row_of = dict(self.encoder.node_rows)
        alloc = np.array(self.encoder.allocatable, dtype=np.float64)
        requested = np.array(self.encoder.requested, dtype=np.float64)
        node_objs = None
        if any((e.cfg.filter_verb or e.cfg.prioritize_verb)
               and not e.cfg.node_cache_capable for e in self.extenders):
            node_objs = {name: info.node for name, info in self.cache._nodes.items()
                         if info.node is not None}
        return name_of, row_of, alloc, requested, node_objs

    def _assign_with_extenders(self, fw, batch, dbatch, dsnap, dyn, auxes, pods,
                               t0: float, packed0=None, nom=None, captured=None):
        """The round-based extender assignment (the reference's
        _assign_with_extenders, scheduler.py:2942-3268;
        findNodesThatPassExtenders, scheduler.go:1035, and the extender
        prioritize merge :1146-1185), host code around two device
        programs: each round one ``compute_packed`` plane (the first came
        with the dispatch) is fetched; the host walks the unresolved pods
        in order with their extender callouts; the round's accepts go to
        the device in one ``apply_commits`` when a later round follows.

        Round-exactness: at most one pod commits a node per round, so
        node-local filters checked against the round-start state stay
        valid; a host ledger re-checks the fit with the round's earlier
        accepts applied and defers a pod that no longer fits; a coupled
        reader commits only as its conflict component's first accept of
        the round, and a required-anti-affinity commit closes its
        component for the round.  An extender sees at most ``k_cap``
        feasible nodes (``_num_feasible_nodes``), striped over the batch
        and rotating per round; a pod whose capped windows have not all
        been seen retries for up to that many rounds without progress.

        ``batch`` is the host PodBatch, ``dbatch`` its device copy.  →
        (node_row i32[B], each pod's algorithm latency from ``t0`` to its
        own round's decision, rounds run, callout wall).  The walk reads no
        live scheduler state: ``captured`` (``_capture_walk_state``, taken
        on the dispatch thread) carries it, so an async walk is safe while
        the bind phase and the next sync change the live structures."""
        b = batch.size
        out = np.full(b, -1, dtype=np.int32)
        algo_lat = np.zeros(b)
        if captured is None:  # a synchronous walk: nothing mutates meanwhile
            captured = self._capture_walk_state()
        name_of, row_of, alloc, requested, node_objs = captured
        requested = np.array(requested)  # the walk's own ledger
        info = conflict_components(batch.pods, batch.size,
                                   namespace_labels=self.namespace_labels)
        cpl = coupling_flags(batch, info=info)
        reads, solo, cpl_comp, cpl_multi = cpl.reads, cpl.solo, cpl.comp, cpl.multi
        # per-feasible-set callout fragments: templated pods share mask rows,
        # so the name list and its JSON build once per distinct row per walk
        feas_cache: Dict[tuple, tuple] = {}  # (round, window, mask row bytes) → hit
        names_json_cache: Dict[tuple, bytes] = {}

        def names_bytes(names) -> bytes:
            key = tuple(names)
            v = names_json_cache.get(key)
            if v is None:
                v = names_json_cache[key] = json.dumps(names).encode()
            return v

        # a non-nodeCacheCapable extender receives full node manifests
        # (ExtenderArgs.Nodes, extender.go:416) for both verbs
        node_manifests = None
        if node_objs is not None:
            manifest_cache: Dict[tuple, bytes] = {}

            def node_manifests(names):
                key = tuple(names)
                got = manifest_cache.get(key)
                if got is None:
                    got = manifest_cache[key] = json.dumps(
                        [_node_to_dict(node_objs[n]) for n in names if n in node_objs]).encode()
                return got

        callout_wait = 0.0
        if nom is not None:
            nom_rows = np.asarray(nom[0])
            nom_req = np.asarray(nom[1], dtype=np.float64)
            rows_ = np.clip(nom_rows, 0, requested.shape[0] - 1)
            np.add.at(requested, rows_, np.where((nom_rows >= 0)[:, None], nom_req, 0.0))
        req_pod = np.asarray(batch.request, dtype=np.float64)  # [B, R]
        valid = np.asarray(batch.valid, dtype=bool)
        unresolved = [i for i in range(len(pods)) if valid[i]]
        # the candidate-list bound; the window rotates by k_cap per round
        # (the reference's nextStartNodeIndex analog)
        k_cap = _num_feasible_nodes(len(name_of))
        mode = self.serialize_extender_callouts
        serialize = mode == "always" or (
            mode == "auto" and any(getattr(e.cfg, "managed_resources", None)
                                   for e in self.extenders))
        no_prog_rounds = 0
        rounds = 0
        while unresolved and rounds <= b:
            rounds += 1
            plane = packed0 if rounds == 1 and packed0 is not None \
                else fw.compute_packed(dbatch, dsnap, dyn, auxes)
            scores = plane.cpu().numpy()
            mask = np.isfinite(scores)
            claimed_mask = np.zeros(alloc.shape[0], dtype=bool)
            n_claimed = 0
            claimed_comps: Set[int] = set()  # components with a commit this round
            closed_comps: Set[int] = set()  # components a solo commit closed
            commit = np.zeros(b, dtype=bool)
            choice = np.zeros(b, dtype=np.int32)
            still: List[int] = []

            def window(feas, i):
                """The candidate sampling: at most k_cap rows, the windows
                striped across the batch (pods land in ⌈feasible / k_cap⌉
                groups) and rotating per round → (rows, window count)."""
                if len(feas) <= k_cap:
                    return feas, 1
                n_win = -(-len(feas) // k_cap)
                start = (((i % n_win) + rounds - 1) * k_cap) % len(feas)
                idx = (np.arange(k_cap) + start) % len(feas)
                return feas[idx], n_win

            def callout(i):
                pod = pods[i]
                if serialize and n_claimed:
                    # the serialized cadence: the sent list drops nodes the
                    # round's earlier accepts filled (per pod, never cached)
                    feas = np.where(mask[i])[0]
                    live = np.all((req_pod[i] == 0)
                                  | (req_pod[i] <= alloc[feas] - requested[feas]), axis=1)
                    feas, n_win = window(feas[live], i)
                    row_names = [name_of[r] for r in feas if r in name_of]
                    row_json = None
                else:
                    nfeas = int(np.count_nonzero(mask[i]))
                    n_win = max(1, -(-nfeas // k_cap))
                    key = (rounds, i % n_win, mask[i].tobytes())
                    hit = feas_cache.get(key)
                    if hit is None:
                        feas, n_win = window(np.where(mask[i])[0], i)
                        row_names = [name_of[r] for r in feas if r in name_of]
                        hit = feas_cache[key] = (feas, row_names,
                                                 json.dumps(row_names).encode(), n_win)
                    feas, row_names, row_json, n_win = hit
                # managed-resources gating (extender.go:444-471)
                exts = [e for e in self.extenders if e.is_interested(pod)]
                try:
                    names, names_json = row_names, row_json
                    for ext in exts:
                        names, _failed = ext.filter(pod, names, names_json=names_json,
                                                    node_manifests=node_manifests)
                        names_json = None  # a reply list re-encodes (cached)
                        if not names:
                            break
                    ranked_total: Dict[str, float] = {}
                    echoed = names == row_names
                    if names:
                        pr_json = (row_json if echoed and row_json is not None
                                   else names_bytes(names))
                        for ext in exts:
                            try:
                                for n, sc in ext.prioritize(
                                        pod, names, names_json=pr_json,
                                        node_manifests=node_manifests).items():
                                    ranked_total[n] = ranked_total.get(n, 0.0) + sc
                            except ExtenderError:
                                continue  # prioritize errors are ignored (:1152)
                    # every extender echoed the request list: the approved
                    # rows are the window's rows
                    return names, (feas if echoed else None), ranked_total, None, n_win
                except ExtenderError as e:  # not ignorable: the pod is unschedulable
                    return None, None, None, e, n_win

            if serialize or len(unresolved) <= 1:
                results = {}  # filled on demand, in commit order
            else:
                t_w = self.clock()
                results = dict(zip(unresolved, self._ext_pool().map(callout, unresolved)))
                callout_wait += self.clock() - t_w

            for i in unresolved:
                # rule (c) per component: a required-anti commit closes the
                # component's later rows this round
                if cpl_multi[i] and int(cpl_comp[i]) in closed_comps:
                    still.append(i)
                    continue
                # a reader's row is exact only while no component-mate
                # committed before it this round
                if reads[i] and cpl_multi[i] and int(cpl_comp[i]) in claimed_comps:
                    still.append(i)
                    continue
                if i in results:
                    approved, rows_hint, ranked, err, n_win = results[i]
                else:
                    t_w = self.clock()
                    approved, rows_hint, ranked, err, n_win = callout(i)
                    callout_wait += self.clock() - t_w
                if err is not None:
                    algo_lat[i] = self.clock() - t0
                    continue
                if rows_hint is not None:
                    rows = rows_hint
                else:
                    rows = np.fromiter((row_of[n] for n in approved), dtype=np.int64,
                                       count=len(approved))
                # the ledger re-check: the round's earlier accepts may have
                # filled a node (resource dims only — node-local sets are safe
                # under the one-commit-per-node rule)
                ok = ~claimed_mask[rows]
                ok &= np.all((req_pod[i] == 0)
                             | (req_pod[i] <= alloc[rows] - requested[rows]), axis=1)
                if not ok.any():
                    # nothing left this round: retry when others committed or
                    # a capped window has not been swept, else unschedulable
                    if n_claimed or still or (n_win > 1 and no_prog_rounds < n_win):
                        still.append(i)
                    else:
                        algo_lat[i] = self.clock() - t0
                    continue
                merged = scores[i, rows]
                if ranked:
                    merged = merged + np.fromiter((ranked.get(n, 0.0) for n in approved),
                                                  dtype=np.float64, count=len(approved))
                merged = np.where(ok, merged, -np.inf)
                row = int(rows[int(np.argmax(merged))])
                out[i] = row
                commit[i] = True
                choice[i] = row
                claimed_mask[row] = True
                n_claimed += 1
                requested[row] += req_pod[i]
                algo_lat[i] = self.clock() - t0
                if cpl_multi[i]:
                    claimed_comps.add(int(cpl_comp[i]))
                    if solo[i]:
                        closed_comps.add(int(cpl_comp[i]))  # rule (c)
            if commit.any() and still:
                # the committed state feeds only later rounds
                dyn, auxes = fw.apply_commits(dbatch, dsnap, dyn, auxes, commit, choice)
            no_prog_rounds = 0 if n_claimed else no_prog_rounds + 1
            unresolved = still
        for i in unresolved:  # pods left at the rounds bound
            algo_lat[i] = self.clock() - t0
        return out, algo_lat, rounds, callout_wait

    def _ext_pool(self):
        """The persistent extender-callout pool (the reference's _ext_pool,
        scheduler.py:3270): 16 workers, the reference's extender fan-out,
        kept across rounds and batches with their keep-alive sockets;
        released by close()."""
        with self._ext_pool_lock:
            if self._ext_pool_obj is None:
                from concurrent.futures import ThreadPoolExecutor

                self._ext_pool_obj = ThreadPoolExecutor(
                    max_workers=16, thread_name_prefix="extender-callout")
            return self._ext_pool_obj

    def _fused_cycle(self, batch, mode: str, classes, coupling, host_auxes, dsnap, upd,
                     prevs: Sequence[PrevBatch], gang_seg: np.ndarray, nominated, fw):
        """The device half of a dispatch → (node_row i32[B], packed i32[3, B],
        the device batch, the snapshot, the dynamic state before this
        batch's commits), all on the device.  ``mode`` is the router's
        "batch" or "scan"; ``classes`` the dedup gate's (class_of, rep_rows)
        or None; ``gang_seg`` i32[B] the batch's gang segment ids (−1: no
        gang); ``nominated`` the (rows i32[K], req f32[K, R]) host arrays of
        ``_nominated_arrays``; ``fw`` the batch's profile's framework.  The
        dedup engine is the reference's
        fused_batch dedup branch (scheduler.py:969-1017), the full auction
        its ``classes is None`` branch (:985-997), the scan its fused_greedy
        (:954-967); each ends in the gang mask (K20) and the diagnosis +
        pack (K22)."""
        dev = self.device
        dsnap = apply_scatter(dsnap, upd)
        self.encoder.commit_device(dsnap)
        # the reference's reserve_nominated (scheduler.py:889): the nominated
        # pods' requests at their nominated rows, cast f32 → i32 as there
        # (``astype(requested.dtype)``), into ``requested`` only; then the
        # in-flight carries' requests at their decided rows — one K13 launch
        # for every bundle, into copies: the snapshot stays as the next
        # row-scatter needs it.  No nominated row: no bundle (all rows −1
        # add nothing).
        dyn = apply_prev_delta(initial_dynamic_state(dsnap), prevs,
                               nominated=self._nominated_bundle(nominated))
        dbatch = batch_to_device(batch, dev)
        b = batch.size
        if classes is not None:
            class_of, rep_rows = classes
            rows = dbatch.take(torch.from_numpy(rep_rows).to(dev))
            host = _host_aux_take(fw, host_auxes, rep_rows)
        else:
            rows, host = dbatch, host_auxes
        # the plugin auxes of the rows the engine computes (the class
        # representatives for the dedup engine, every pod otherwise):
        # PodTopologySpread's count tables (K5), InterPodAffinity's count
        # state and existing-pod planes (K9); None for a plugin with nothing
        # to carry for this batch; then the carries chained in (K14, K15),
        # oldest first
        auxes = fw.prepare(rows, dsnap, dyn, host)
        for prev in prevs:
            auxes = fw.chain_prev(rows, dsnap, auxes, prev)
        class_t = None
        if mode == "scan":
            # the diagnosis reads the state before the scan (the reference's
            # fused_greedy diagnoses with the pre-scan dyn and auxes)
            plane = fw.planes(dbatch, dsnap, dyn, auxes)[0]
            res = fw.greedy_assign(dbatch, dsnap, dyn, auxes, np.arange(b), key=self.rng_key)
        else:
            order = torch.arange(b, dtype=torch.int32, device=dev)
            if classes is not None:
                class_t = torch.from_numpy(class_of.astype(np.int64)).to(dev)
                res = fw.batch_assign(dbatch, dsnap, dyn, None, order, coupling,
                                      classes=(class_t, rows, auxes))
            else:
                res = fw.batch_assign(dbatch, dsnap, dyn, auxes, order, coupling,
                                      key=self.rng_key)
            self.round_read_s += res.host_read_s
            # a dispatched batch holds at least one valid pod, so round 0
            # ran; its bit plane carries the dynamic plugins' bits (K6,
            # K10), as the reference diagnoses with the prepared auxes
            plane = res.diag_plane
        node_row = gang_all_or_nothing(res.node_row, torch.from_numpy(gang_seg).to(dev))
        packed = diag_pack(plane, len(fw.filter_names), class_t, node_row, res.rounds)
        return node_row, packed, dbatch, dsnap, dyn

    # --- engine routing (the reference's one shared predicate) -------------------

    def engine_choice(self, batch, fw):
        """(mode, coupling, partition info): "batch" (the auction engines)
        or "scan" — the reference's engine_choice (scheduler.py:2679).
        ``assign_mode="scan"`` always scans (no partition); "batch" always
        takes the auctions.  Under "auto" the conflict partition is first
        relaxed for parallel-safe single-class components; a batch whose
        largest coupled component exceeds ``coupled_fraction_threshold``
        of its valid pods scans unless the dedup precheck admits it.  ``fw``
        is the batch's profile's framework."""
        if self.assign_mode == "scan":
            return "scan", None, None
        info = conflict_components(batch.pods, batch.size,
                                   namespace_labels=self.namespace_labels)
        info = self._relax_parallel_safe(info)
        coupling = coupling_flags(batch, info=info)
        n_valid = max(int(np.asarray(batch.valid).sum()), 1)
        if self.assign_mode == "batch" or info.max_multi <= max(
                1, int(self.coupled_fraction_threshold * n_valid)):
            return "batch", coupling, info
        if self._dedup_precheck(batch, fw):
            return "batch", coupling, info
        return "scan", coupling, info

    def _batch_can_preempt(self, batch) -> bool:
        """Any valid batch pod that could run the preemption dry-run (the
        reference's _batch_can_preempt, scheduler.py:2723)."""
        prios = np.asarray(batch.priority)[np.asarray(batch.valid)]
        return bool(prios.size) and int(prios.max()) > 0 and any(
            (p.spec.priority or 0) > 0 and p.spec.preemption_policy != "Never"
            for p in batch.pods)

    def _class_hooks_ok(self, fw) -> bool:
        """Every dynamic plugin of ``fw`` with per-pod update hooks also has
        the class-level hook the dedup engine needs."""
        for pw in fw.plugins:
            p = pw.plugin
            if p.dynamic and (getattr(p, "update", None) is not None
                              or getattr(p, "update_batch", None) is not None) \
                    and getattr(p, "update_batch_classes", None) is None:
                return False
        return True

    def _dedup_precheck(self, batch, fw) -> bool:
        """The router's scan→auction upgrade check (the reference's
        _dedup_precheck, scheduler.py:2733): class hooks present, no gang
        members, volumes or resource claims, no pod that could preempt, at
        most B/2 identity classes, and no tie-noise key."""
        if self.rng_key is not None or not self._class_hooks_ok(fw):
            return False
        for p in batch.pods:
            if POD_GROUP_LABEL in p.metadata.labels or getattr(p.spec, "volumes", None) \
                    or getattr(p.spec, "resource_claims", None):
                return False
        if self._batch_can_preempt(batch):
            return False
        _class_of, reps = identity_classes(batch)
        return len(reps) * 2 <= batch.size

    def _dedup_classes(self, batch, host_auxes, fw):
        """The identity-class dedup gate (the reference's _dedup_classes,
        scheduler.py:2596-2677): → (class_of i32[B], rep_rows i64[Cp],
        None), or (None, None, reason) when the batch takes the full
        auction, ``reason`` the label the reference counts it under
        (``scheduler_dedup_fallback_total``): "rng_key" (per-pod tie noise
        cannot ride class-shared planes), "class_hook", "preemption",
        "gang_anchor", "pod_indexed_aux" or "heterogeneous".
        A non-None host aux is admitted when its plugin has a rep view
        (``host_aux_take``: InterPodAffinity's match matrix).  Cp is the
        pow-2 bucket of the class count (floor 4), padded with the first
        rep.  ``fw``: the batch's profile's framework; SelectorSpread's pod-indexed counts have no rep view, so its
        batches take the full auction ("pod_indexed_aux")."""
        if self.rng_key is not None:
            return None, None, "rng_key"
        if batch.has_affinity or batch.has_spread:
            if not self._class_hooks_ok(fw):
                return None, None, "class_hook"
            if self._batch_can_preempt(batch):
                return None, None, "preemption"
        for name, aux in (host_auxes or {}).items():
            if aux is None:
                continue
            if name == "Coscheduling":
                # admitted while no batch pod anchors a gang (the anchors are
                # then uniformly negative); a gang-anchoring batch takes the
                # full auction (the reference's "gang_anchor" fallback)
                anchor = np.asarray(aux[1])
                if anchor.size == 0 or int(anchor.max()) < 0:
                    continue
                return None, None, "gang_anchor"
            if not any(pw.plugin.name == name
                       and getattr(pw.plugin, "host_aux_take", None) is not None
                       for pw in fw.plugins):
                return None, None, "pod_indexed_aux"
        class_of, reps = identity_classes(batch)
        if len(reps) * 2 > batch.size:
            return None, None, "heterogeneous"
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

    def _complete(self, fl: _InFlight) -> np.ndarray:
        """Wait for the batch's fetched result and assume every placed pod
        (the reference's _complete, scheduler.py:1969; assume :571) → the
        node rows, −1 for a pod to requeue."""
        t_f = time.perf_counter()
        if fl.fetch_thread is not None:
            fl.fetch_thread.join()
            fl.fetch_thread = None
        if fl.engine == "extender":
            # the walk's join waits on callouts, not a device fetch; a walk
            # that died surfaces here (the caller requeues the batch)
            self.phase_wall["extender_wait"] += time.perf_counter() - t_f
            if fl.walk_error is not None:
                raise fl.walk_error
            node_row = np.array(fl.fetched, dtype=np.int32)
            self.rounds_total += int(fl.rounds)
        else:
            self.phase_wall["fetch"] += time.perf_counter() - t_f
            packed = fl.fetched
            node_row = packed[0].copy()
            self.carried_pods += fl.carried * int((node_row >= 0).sum())
            fl.diag = _unpack_diag(packed[1], len(fl.fw.filter_names))
            self.rounds_total += int(packed[2, 0])
        # the background sync reads cache clones; the assumes below write
        # the cache — join it first
        self.join_sync_ahead()
        fl.node_names = [None] * len(fl.infos)
        for i, qi in enumerate(fl.infos):
            row = int(node_row[i])
            if row < 0:
                continue
            # through the dispatch-time map: a sync since may reuse the row
            name = fl.name_of.get(row)
            info = self.cache._nodes.get(name) if name is not None else None
            if info is None or info.node is None:
                node_row[i] = -1  # node gone since dispatch — retry the pod
                continue
            fl.node_names[i] = name
            self._nominated.pop(qi.pod.uid, None)
            self.cache.assume_pod(qi.pod, name)
        return node_row

    def _bind_phase(self, fl: _InFlight, node_row: np.ndarray) -> CycleStats:
        """The binding cycle of every placed pod (reserve → permit → bind; a
        gang member whose gang is not complete holds at Permit); diagnosis,
        preemption and requeue for every failed one; feed the micro-bucket
        policy's latency profile of the batch's pad tier and the failure EMA
        (the reference's _bind_phase, scheduler.py:2058-2390).

        A failed pod that may preempt — its priority above the lowest
        scheduled pod's, preemptionPolicy not Never, its batch not chained
        (the dry run could neither see nor evict the carried placements: the
        retry blocks the chain and preempts clean), and the gang guard's
        leave (only a gang's last missing member preempts) — runs the
        PostFilter.  Its context (the PDB list, row → node name) and the
        batch's candidate mask are built at the first such pod; the mask was
        dispatched with the cycle when recent batches failed often.  A pod
        fast-bound by its PostFilter counts as scheduled; its nomination
        outlives this phase (marked with this dispatch seq) so that a batch
        dispatched before the bind still sees the claim.  A store fault
        inside the PostFilter degrades that pod to nominate-nothing: it
        requeues with backoff.

        A pod's attempt latency is the reference's (scheduler.py:2093-2111,
        2365-2378): its batch's algorithm time — dispatch start to the
        moment the result reached the host — plus the pod's own bind or
        PostFilter segment.  The wait between the fetch and the bind phase
        (the pipeline's cycles in flight) is not part of it."""
        t0 = time.perf_counter()
        algo = max(fl.fetched_at - fl.t0, 0.0)
        infos = fl.infos
        stats = CycleStats(attempted=len(infos))
        fw = fl.fw
        names = fw.filter_names
        batch_attempts: List[float] = []
        min_sched_prio = pf_ctx = cand_np = None
        fast_bound_uids: List[str] = []
        for i, qi in enumerate(infos):
            t_pod = self.clock()
            row = int(node_row[i])
            held = False
            if row >= 0:
                node_name = fl.node_names[i]
                ok = self._run_reserve_and_bind(fw, qi, node_name)
                if ok is _PERMIT_WAIT:
                    # held at Permit: neither scheduled nor unschedulable yet
                    held = True
                elif ok:
                    self.cache.finish_binding(qi.pod)
                    stats.scheduled += 1
                else:  # reserve / permit / bind failed: roll back
                    self.cache.forget_pod(qi.pod)
                    # a pod deleted mid-cycle consumed its DELETE event
                    # already: requeueing it would leave a ghost
                    if self.store.get("Pod", qi.pod.namespace,
                                      qi.pod.metadata.name) is not None:
                        self.queue.add_unschedulable(qi, fl.cycle)
            else:
                if fl.diag is None:
                    # an extender batch carries no packed diagnosis: one
                    # diagnose_bits over the dispatch-time state for the
                    # whole failing batch (the reference's diag_bits)
                    fl.diag = fw.diagnose_bits(fl.dbatch, fl.dsnap, fl.dyn,
                                               fl.auxes).cpu().numpy()
                row_bits = fl.diag[i]
                if bool(np.all(row_bits)) and self.gangs.is_member(qi.pod):
                    # every filter left the pod a node yet none came back:
                    # the gang mask withdrew its gang (a sibling missed) —
                    # attributed to Coscheduling, as the reference does
                    qi.unschedulable_plugins = {"Coscheduling"}
                else:
                    failing_plugins = {names[k] for k in range(len(names))
                                       if not bool(row_bits[k])}
                    qi.unschedulable_plugins = failing_plugins or set(names)
                if min_sched_prio is None:
                    prios = self.encoder.pod_priority[self.encoder.pod_valid]
                    min_sched_prio = int(prios.min()) if prios.size else 1 << 30
                fast_bound = None
                if (qi.pod.spec.preemption_policy != "Never"
                        and min_sched_prio < (qi.pod.spec.priority or 0)
                        and not fl.chained
                        and self.gangs.allows_preemption(qi.pod)):
                    if pf_ctx is None:
                        pf_ctx = self._post_filter_context(fl)
                    if cand_np is None:
                        cand_np = self._cand_np(fl)
                    try:
                        fast_bound = self._run_post_filter(fw, qi, cand_np[i], pf_ctx)
                    except _PostFilterStoreFault:
                        self.post_filter_errors += 1
                        fast_bound = None
                if fast_bound is not None:
                    # the "scheduled_fast" outcome: bound in this attempt
                    fast_bound_uids.append(qi.pod.uid)
                    stats.scheduled += 1
                    self.fast_binds += 1
                else:
                    stats.unschedulable += 1
                    self.queue.add_unschedulable(qi, fl.cycle)
            # an extender batch decides each pod at its own round
            pod_algo = algo if fl.algo_lat is None else float(fl.algo_lat[i])
            attempt = pod_algo + max(self.clock() - t_pod, 0.0)
            self.attempt_seconds.append(attempt)
            if not held:  # as the reference, a held attempt feeds no tier
                batch_attempts.append(attempt)
        # the fast-bound pods' nominations outlive this phase (a batch
        # dispatched before it runs reads a snapshot without their assumes);
        # the first dispatch with a later seq purges them
        for uid in fast_bound_uids:
            if uid in self._nominated:
                self._fastbound_noms[uid] = self._dispatch_seq
        stats.batch_seconds = self.clock() - fl.t0
        self.phase_wall["bind"] += time.perf_counter() - t0
        # the pad tier's profile: an EMA (α = 0.5) of the batch's largest
        # attempt, from at least half-full batches that built no kernel
        # (the reference's scheduler.py:2355-2378)
        if self.latency_target_ms is not None and batch_attempts \
                and kernel_build.BUILDS == fl.builds0 \
                and 2 * len(batch_attempts) >= fl.batch.size:
            tier, hi = fl.batch.size, max(batch_attempts)
            prev = self._tier_p99.get(tier)
            self._tier_p99[tier] = hi if prev is None else 0.5 * prev + 0.5 * hi
        if stats.attempted:
            # the EMA drives the speculative candidate mask, so it counts
            # the attempts that needed preemption: fast-bound pods too
            frac = (stats.unschedulable + len(fast_bound_uids)) / stats.attempted
            self._fail_ema[fl.profile] = 0.5 * self._fail_ema.get(fl.profile, 0.0) \
                + 0.5 * frac
        return stats

    # --- preemption (DefaultPreemption's PostFilter) ------------------------------

    # static plugins preemption cannot fix (the reference's _STATIC_PLUGINS,
    # scheduler.py:3521): their K1 bits gate the candidate mask
    _STATIC_PLUGINS = ("NodeName", "NodeUnschedulable", "TaintToleration", "NodeAffinity")

    def _nominated_arrays(self, batch_uids: Set[str]):
        """The nominated pods not in this batch as (rows i32[K] (−1 pad),
        requests f32[K, R]) — the reference's _nominated_arrays
        (scheduler.py:3494): K is a sticky pow-2 cap with a floor of twice
        the batch; a nomination whose node left the encoder is dropped."""
        rows, reqs = [], []
        for uid, (node_name, req, _pod) in list(self._nominated.items()):
            if uid in batch_uids:
                continue
            row = self.encoder.node_rows.get(node_name)
            if row is None:
                del self._nominated[uid]
                continue
            rows.append(row)
            reqs.append(req)
        k = max(_pow2(len(rows), 4), getattr(self, "_nom_cap", _pow2(2 * self.batch_size, 4)))
        self._nom_cap = k
        r = self.encoder.cfg.num_resource_dims
        out_rows = np.full(k, -1, dtype=np.int32)
        out_reqs = np.zeros((k, r), dtype=np.float32)
        if rows:
            out_rows[: len(rows)] = rows
            out_reqs[: len(rows)] = np.asarray(reqs, dtype=np.float32)
        return out_rows, out_reqs

    def _priority_levels(self) -> Optional[np.ndarray]:
        """Sorted unique scheduled-pod priorities padded to
        PRIORITY_LEVEL_CAP with i32-max (the reference's _priority_levels,
        scheduler.py:3583); None (the dense form, K29) above the cap."""
        valid = np.asarray(self.encoder.pod_valid)
        u = np.unique(np.asarray(self.encoder.pod_priority)[valid])
        if u.size > PRIORITY_LEVEL_CAP:
            return None
        out = np.full(PRIORITY_LEVEL_CAP, np.iinfo(np.int32).max, dtype=np.int32)
        out[: u.size] = u
        return out

    def _candidate_mask(self, fl: _InFlight) -> torch.Tensor:
        """bool[B, N] on the device: the reference's candidate program
        (``cand_mask``, scheduler.py:1019-1028, via _candidate_mask :3598)
        over the cycle's snapshot and its pre-commit dynamic state.  The
        static filters are K1's bits over the batch rows (live nodes and
        valid rows folded in); then K27 + K28 over ``fl.cand_levels``, or
        K29 without levels."""
        fw = fl.fw
        dbatch, dsnap, dyn = fl.dbatch, fl.dsnap, fl.dyn
        fs_plan = fw.kernel_plans(frozenset())[0]
        bits, _raw = filter_score_planes(dbatch, dsnap, dyn,
                                         *fw.static_inputs(dbatch, dsnap, dyn), fs_plan)
        mask = 0
        for name in self._STATIC_PLUGINS:
            if name in fs_plan.bit_of:  # a static filter the profile runs
                mask |= 1 << fs_plan.bit_of[name]
        levels = None if fl.cand_levels is None else \
            torch.from_numpy(fl.cand_levels).to(self.device)
        return candidate_mask_device(dbatch, dsnap, dyn, bits, mask, levels)

    @staticmethod
    def _start_cand_fetch(fl: _InFlight, cand: torch.Tensor) -> None:
        """Start the speculative mask's trip to the host: a non_blocking
        copy into pinned memory and its event (on the CPU it is there)."""
        if cand.device.type != "cuda":
            fl.cand_np = cand.numpy()
            return
        fl.cand_pinned = torch.empty(cand.shape, dtype=cand.dtype, pin_memory=True)
        fl.cand_pinned.copy_(cand, non_blocking=True)
        fl.cand_event = torch.cuda.Event()
        fl.cand_event.record()

    def _cand_np(self, fl: _InFlight) -> np.ndarray:
        """The batch's candidate mask on the host: the speculative copy when
        it was dispatched, else computed now (one device round per failing
        batch)."""
        if fl.cand_np is None and fl.cand_event is not None:
            fl.cand_event.synchronize()
            fl.cand_np = fl.cand_pinned.numpy().copy()
        if fl.cand_np is None:
            fl.cand_np = self._candidate_mask(fl).cpu().numpy()
        return fl.cand_np

    def _post_filter_context(self, fl: _InFlight):
        """The batch-hoisted PostFilter context (scheduler.py:2238-2256):
        the PDB list and row → node name as an object array, from the
        dispatch-time map (a later sync may reuse a deleted node's row)."""
        name_of = fl.name_of
        names_arr = np.full((max(name_of) + 1) if name_of else 0, None, dtype=object)
        for r, nm in name_of.items():
            names_arr[r] = nm
        return self.store.list("PodDisruptionBudget")[0], names_arr

    def _run_post_filter(self, fw, qi: QueuedPodInfo, cand_row: np.ndarray,
                         pf_ctx) -> Optional[str]:
        """DefaultPreemption's PostFilter (the reference's _run_post_filter,
        scheduler.py:3605; scheduler.go:533-552 → preemption.go:138): the
        candidate nodes from the mask row, the Evaluator's pick, every
        victim evicted through the gate (override_pdb), the nomination
        recorded and written, then the fast bind.  → the node name when the
        pod was fast-bound, else None (nominated and requeued, or nothing to
        preempt).  A store fault raises _PostFilterStoreFault."""
        pod = qi.pod
        if pod.spec.preemption_policy == "Never":
            return None
        self.preemption_attempts += 1
        rows = np.where(cand_row)[0]
        if rows.size == 0:
            return None
        pdbs, names_arr = pf_ctx
        rows = rows[rows < names_arr.size]
        picked = names_arr[rows]
        names = picked[picked != None].tolist()  # noqa: E711 — elementwise
        nominated: Dict[str, List[v1.Pod]] = {}
        for _uid, (nn, _req, npod) in self._nominated.items():
            nominated.setdefault(nn, []).append(npod)
        try:
            cand = self.preemption.preempt(pod, self.snapshot, names, pdbs,
                                           nominated=nominated, extenders=self.extenders)
        except ExtenderError:
            # a non-ignorable extender failure aborts this preemption attempt
            # (preemption.go callExtenders); the pod retries later
            return None
        if cand is None:
            return None
        for victim in cand.victims:
            result = self.eviction_api.evict(
                victim, reason=f"Preempted by {pod.key()}",
                policy="preemption", override_pdb=True, pdbs=pdbs)
            if result.allowed and not result.evicted and result.reason \
                    and result.reason.startswith("store delete failed"):
                raise _PostFilterStoreFault(result.reason)
        self.preemption_victims.append(len(cand.victims))
        pod.status.nominated_node_name = cand.node_name
        self._nominated[pod.uid] = (
            cand.node_name, np.asarray(self.encoder.pod_request_units(pod)), pod)
        try:
            self.store.update("Pod", pod)
        except Exception as e:  # the store's own fault, whatever its type
            raise _PostFilterStoreFault(f"nomination write failed: {e}") from e
        if self._try_nominated_fast_bind(fw, qi, cand):
            return cand.node_name
        return None

    def _try_nominated_fast_bind(self, fw, qi: QueuedPodInfo, cand) -> bool:
        """Bind a successful preemptor to its nominated node in the same
        attempt (the reference's _try_nominated_fast_bind, scheduler.py:3667;
        the nominated-node fast path of scheduler.go:926-935 with no queue
        round trip, exact here because the victims are gone at eviction).
        Only for plain preemptors without scalar requests, after the live
        cache re-checks the static filters and the fit.  The claimable
        guard: when a pod of an in-flight batch could fit the node's
        snapshot-view free space, the preemptor binds only if it fits in
        what its evictions freed; else it stays nominated and requeues."""
        if not self.nominated_fast_bind:
            return False
        pod = qi.pod
        has_anti = bool(self.snapshot.have_pods_with_required_anti_affinity_list)
        if not _is_plain_preemptor(pod, has_anti):
            return False
        if compute_pod_resource_request(pod).scalar_resources:
            return False
        # a preemption-capable extender may veto what the dry run verified
        if any(getattr(e, "supports_preemption", False) and e.is_interested(pod)
               for e in self.extenders):
            return False
        # the live cache: the evictions above flowed through the watch
        info = self.cache._nodes.get(cand.node_name)
        if info is None or info.node is None:
            return False
        node = info.node
        if not (node_name_fits(pod, node) and node_schedulable(pod, node)
                and node_affinity_fits(pod, node)
                and tolerates_all_hard_taints(pod, node)
                and fits_resources(pod, info)):
            return False
        row = self.encoder.node_rows.get(cand.node_name)
        if row is not None and self._inflight_q:
            free_snap = (self.encoder.allocatable[row].astype(np.int64)
                         - self.encoder.requested[row])
            claimable = any(
                bool(np.any(np.all(
                    np.asarray(fl2.batch.request)[np.asarray(fl2.batch.valid)]
                    <= free_snap[None, :], axis=1)))
                for fl2 in self._inflight_q)
            if claimable:
                req = compute_pod_resource_request(pod)
                freed = np.zeros(4, dtype=np.int64)
                for victim in cand.victims:
                    vr = compute_pod_resource_request(victim)
                    freed += (vr.milli_cpu, vr.memory, vr.ephemeral_storage, 1)
                need = np.array([req.milli_cpu, req.memory, req.ephemeral_storage, 1],
                                dtype=np.int64)
                if not bool(np.all(need <= freed)):
                    return False
        pod.status.nominated_node_name = None
        self.cache.assume_pod(pod, cand.node_name)
        ok = self._run_reserve_and_bind(fw, qi, cand.node_name)
        if ok is _PERMIT_WAIT:
            # a gang member whose gang is not complete: no held fast bind —
            # cancel the hold (which forgets the assume) and stay nominated
            self._cancel_waiting_bind(pod.uid)
            pod.status.nominated_node_name = cand.node_name
            return False
        if not ok:
            self.cache.forget_pod(pod)
            pod.status.nominated_node_name = cand.node_name
            return False
        self.cache.finish_binding(pod)
        return True

    # --- the binding cycle and the Permit hold ------------------------------------

    @staticmethod
    def _unreserve(pod: v1.Pod, node_name: str, reserved) -> None:
        """Unreserve the plugins that reserved, in reverse order."""
        for done in reversed(reserved):
            un = getattr(done.plugin, "unreserve", None)
            if un is not None:
                un(None, pod, node_name)

    def _run_reserve_and_bind(self, fw, qi: QueuedPodInfo, node_name: str):
        """Reserve → Permit → PreBind → Bind → PostBind (the reference's
        _run_reserve_and_bind, scheduler.py:3364; scheduler.go:584-698).

        → True (bound), False (rejected, rolled back), or _PERMIT_WAIT: a
        Permit plugin with ``holds_on_wait`` (Coscheduling) left the pod
        pending — the assume and the reserve are kept and the rest of the
        binding cycle waits for _flush_waiting_binds (released when the gang
        completes, rolled back when the wait deadline fires).  A Wait from
        no holding plugin fails the cycle.  On any failure the plugins that
        reserved are unreserved in reverse order."""
        pod = qi.pod
        reserved = []

        def rollback():
            # the waiting-pod entry dies with its binding cycle
            self.waiting_pods.remove(pod.uid)
            self._unreserve(pod, node_name, reserved)

        for pw in fw.reserve_plugins:
            status = pw.plugin.reserve(None, pod, node_name)
            if status is not None and not status.is_success():
                rollback()
                return False
            reserved.append(pw)
        if fw.permit_plugins:
            holding = False
            for pw in fw.permit_plugins:
                status, timeout = pw.plugin.permit(None, pod, node_name)
                if status is not None and status.code == Code.WAIT:
                    self.waiting_pods.add(pod, pw.plugin.name, timeout)
                    holding = holding or getattr(pw.plugin, "holds_on_wait", False)
                elif status is not None and not status.is_success():
                    rollback()
                    return False
            reason = self.waiting_pods.wait_on_permit(pod)
            if reason is not None:
                if holding and self.waiting_pods.get(pod.uid) is not None:
                    # still pending (not rejected): hold the binding cycle
                    # open — gang members keep their node until the last
                    # sibling releases them or the deadline fires
                    self._waiting_binds[pod.uid] = _WaitingBind(
                        qi=qi, node_name=node_name, fw=fw, reserved=reserved,
                        since=self.clock())
                    self.gangs.note_waiting(pod, node_name)
                    return _PERMIT_WAIT
                rollback()
                return False
        return self._finish_bind(fw, pod, node_name, reserved)

    def _finish_bind(self, fw, pod: v1.Pod, node_name: str, reserved) -> bool:
        """The post-Permit half of the binding cycle (PreBind → Bind →
        PostBind; the reference's _finish_bind, scheduler.py:3428), shared
        by the synchronous path and the waiting-bind flush; rolls back
        ``reserved`` on failure."""

        def rollback():
            self.waiting_pods.remove(pod.uid)
            self._unreserve(pod, node_name, reserved)

        for pw in fw.pre_bind_plugins:
            status = pw.plugin.pre_bind(None, pod, node_name)
            if status is not None and not status.is_success():
                rollback()
                return False
        if not self.store.bind_pod(pod.namespace, pod.metadata.name, node_name):
            # the pod was deleted mid-cycle: unreserve too
            rollback()
            return False
        for pw in fw.post_bind_plugins:
            pw.plugin.post_bind(None, pod, node_name)
        return True

    def _cancel_waiting_bind(self, uid: str) -> None:
        """Abort a held binding cycle without finishing it: unreserve in
        reverse, forget the assume, drop the waiting entries."""
        wb = self._waiting_binds.pop(uid, None)
        if wb is None:
            return
        self.waiting_pods.remove(uid)
        self._unreserve(wb.qi.pod, wb.node_name, wb.reserved)
        self.cache.forget_pod(wb.qi.pod)

    def _flush_waiting_binds(self) -> CycleStats:
        """Resolve the binding cycles held open at Permit (the reference's
        _flush_waiting_binds, scheduler.py:2409).

        Allowed pods (the gang's last member released them) finish the
        PreBind → Bind → PostBind half; rejected or expired pods roll back —
        unreserve runs the Coscheduling group-failure hook, which rejects
        every still-waiting sibling, so one member's deadline fails the
        whole gang in this one flush — and every requeued gang pod re-enters
        the active queue together through the group-aware
        PriorityQueue.activate (the atomic gang requeue)."""
        stats = CycleStats()
        if not self._waiting_binds:
            return stats
        requeued: List[v1.Pod] = []
        # to a fixed point: a member's timeout rejects its siblings' entries
        # through the group-failure hook, and those resolve in this flush
        progress = True
        while progress:
            progress = False
            for uid in list(self._waiting_binds):
                wb = self._waiting_binds.get(uid)
                if wb is None:
                    continue  # a sibling's rejection already consumed it
                progress = self._flush_one_waiting(uid, wb, stats, requeued) or progress
        if requeued:
            self.queue.activate(requeued)
        return stats

    def _flush_one_waiting(self, uid: str, wb: _WaitingBind, stats: CycleStats,
                           requeued: List[v1.Pod]) -> bool:
        """Resolve one held binding cycle (the reference's
        _flush_one_waiting, scheduler.py:2442); → True when it left the map."""
        pod = wb.qi.pod
        reason = self.waiting_pods.wait_on_permit(pod)
        if reason is None:
            # allowed: the deferred PreBind → Bind → PostBind half
            del self._waiting_binds[uid]
            ok = self._finish_bind(wb.fw, pod, wb.node_name, wb.reserved)
            # the reference observes the held attempt from the hold's start
            self.attempt_seconds.append(self.clock() - wb.since)
            if ok:
                self.cache.finish_binding(pod)
                stats.scheduled += 1
            else:
                self.cache.forget_pod(pod)
                if self.store.get("Pod", pod.namespace, pod.metadata.name) is not None:
                    self.queue.add_unschedulable(wb.qi, None)
                    requeued.append(pod)
            return True
        if self.waiting_pods.get(uid) is None:
            # rejected or the deadline expired: roll the cycle back; the
            # unreserve chain fires the gang group-failure hook
            del self._waiting_binds[uid]
            self.gangs.note_wait_rejected(pod, reason)
            self._unreserve(pod, wb.node_name, wb.reserved)
            self.cache.forget_pod(pod)
            stats.unschedulable += 1
            if self.store.get("Pod", pod.namespace, pod.metadata.name) is not None:
                self.queue.add_unschedulable(wb.qi, None)
                requeued.append(pod)
            return True
        return False  # still waiting: the hold stays

    def _await_backoff_wave(self) -> None:
        """Hold the cycle briefly while an imminent backoff wave drains into
        the active queue (the reference's batch-formation hysteresis); the
        hold counts as ``queue_wait``."""
        t_wave = time.monotonic()
        real_deadline = t_wave + self.batch_wait
        try:
            while True:
                nxt = self.queue.next_backoff_expiry()
                a, b, _ = self.queue.pending_count()
                eff = self._bucket_from_latency() \
                    if self.latency_target_ms is not None else self.batch_size
                if b == 0 or nxt is None or a >= eff // 2 or a >= b:
                    return
                now = self.clock()
                if time.monotonic() >= real_deadline or nxt - now > self.batch_wait:
                    return
                time.sleep(min(0.02, max(nxt - now, 0.001)))
        finally:
            waited = time.monotonic() - t_wave
            if waited > 0.0005:
                self.phase_wall["queue_wait"] += waited

    def run_until_idle(self, max_cycles: int = 1000,
                       backoff_wait: Optional[float] = None) -> CycleStats:
        """Drive cycles until nothing is attempted, in flight, held at Permit
        or waiting out backoff (up to ``backoff_wait`` seconds of spin)."""
        if backoff_wait is None:
            backoff_wait = 1.2 * self.queue._max_backoff
        total = CycleStats()
        waited = 0.0
        cycles = 0
        while cycles < max_cycles:
            s = self.schedule_cycle()
            if s.attempted == 0 and s.in_flight == 0:
                _a, b, _u = self.queue.pending_count()
                # gang Permit holds resolve on later cycles (release or
                # deadline), so they keep the spin alive up to the budget
                if (b == 0 and s.waiting == 0) or waited >= backoff_wait:
                    break
                time.sleep(0.05)
                waited += 0.05
                continue
            cycles += 1
            if s.scheduled:
                waited = 0.0
            self._merge(total, s)
        return total

    def close(self) -> None:
        """Stop watching the store, release the extender-callout pool and
        join any background sync, raising its error if it failed.  Batches
        still in flight stay unbound (drive ``run_until_idle`` first)."""
        unwatch, self._unwatch = self._unwatch, None
        if unwatch is not None:
            unwatch()
        with self._ext_pool_lock:
            pool, self._ext_pool_obj = self._ext_pool_obj, None
        if pool is not None:
            pool.shutdown(wait=True)
        self._pop_sync_ahead()


__all__ = ["TorchScheduler", "default_plugins"]
