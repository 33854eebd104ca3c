"""GangDirectory: the shared host-side gang-scheduling runtime.

A copy of the JAX package's gang/directory.py (itself after
sigs.k8s.io/scheduler-plugins pkg/coscheduling/core, the PodGroupManager
every extension point consults).  One directory is owned by the scheduler
and wired into its ``CoschedulingPlugin``; it tracks group membership from
the store's watch stream, makes the quorum (PreFilter), all-or-nothing
release (Permit) and group-failure (Unreserve) decisions, writes PodGroup
``status.phase``, and keeps the gang series.

Differences from the reference:
- the port has no metrics registry, so the reference's three gang series
  are plain counters on the directory: ``attempts`` by outcome
  (gang_scheduling_attempts_total{result}), ``timeouts``
  (gang_timeouts_total) and ``wait_durations`` (the observations of
  gang_wait_duration_seconds);
- the chaos kill-point in ``note_waiting`` is left out (the port carries no
  fault injection).

The scheduler attaches its DraIndex's ``pod_claim_demand`` as the
claim-demand resolver (``attach_claim_resolver``), as the reference does:
a fresh gang with pending claims anchors to a slice whose free chips cover
them (``_best_free_slice``).

All deadline math runs on the INJECTED clock (the scheduler's own), never
raw ``time.monotonic()`` — gang-timeout tests drive a fake clock and the
WaitingPodsMap deadlines must agree with it exactly.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..api import objects as v1
from ..framework.interface import Status

# Pods join a group via this label; the value is the PodGroup's name in the
# pod's own namespace (the upstream coscheduling label, shortened).
POD_GROUP_LABEL = "pod-group.scheduling/name"
# Node label naming the TPU slice a node belongs to; the gang score plane
# prefers nodes sharing the gang's anchor slice.
SLICE_LABEL = "tpu.kubernetes.io/slice"
DEFAULT_GANG_TIMEOUT_SECONDS = 60.0
PLUGIN_NAME = "Coscheduling"


@dataclass
class _GroupState:
    """Disjoint membership sets: pending (unbound, not held at Permit),
    waiting (assumed + held at Permit, uid → node), bound (uid → node)."""

    pg: Optional[v1.PodGroup] = None
    pending: Set[str] = field(default_factory=set)
    waiting: Dict[str, str] = field(default_factory=dict)
    bound: Dict[str, str] = field(default_factory=dict)
    first_wait_ts: Optional[float] = None
    quorum_rejected: bool = False  # metric edge-trigger
    failing: bool = False  # _fail_group reentrancy guard
    last_reject_reason: str = ""
    checked_gen: int = -1  # negative PodGroup-lookup cache generation
    # edge-trigger for the release side effects (metric + phase): a group
    # with MORE pods than minMember sees on_permit cross the threshold once
    # per member past the quorum — waiters are re-allowed every time
    # (idempotent), the attempt metric and phase write fire only once per
    # scheduling round
    released: bool = False


class GangDirectory:
    def __init__(self, store, clock=time.monotonic,
                 default_timeout: float = DEFAULT_GANG_TIMEOUT_SECONDS,
                 slice_label: str = SLICE_LABEL):
        self._store = store
        self._clock = clock
        self._default_timeout = default_timeout
        self._slice_label = slice_label
        self._groups: Dict[str, _GroupState] = {}
        self._pg_gen = 0  # bumped on PodGroup watch events (negative cache)
        self._waiting_pods = None  # WaitingPodsMap, bound by the scheduler
        self._staged: List[v1.Pod] = []
        # slice-domain cache: rebuilt when nodes change (invalidate_nodes)
        self._slice_ids: Dict[str, int] = {}
        self._node_gen = 0
        self._slice_cache: Optional[np.ndarray] = None
        self._slice_cache_gen = -1
        self._noop_seg_cache: Dict[int, np.ndarray] = {}
        # pod → pending chip demand (the scheduler wires its
        # DraIndex.pod_claim_demand); None = claim-blind anchor pick
        self._claim_demand = None
        # the reference's gang series (see the module doc)
        self.attempts: Dict[str, int] = {
            "quorum_reject": 0, "scheduled": 0, "timeout": 0, "rejected": 0}
        self.timeouts = 0
        self.wait_durations: List[float] = []

    def bind_runtime(self, waiting_pods) -> None:
        """Wire the scheduler-owned WaitingPodsMap (release/reject target)."""
        self._waiting_pods = waiting_pods

    def attach_claim_resolver(self, fn) -> None:
        """Make the anchor-slice pick consume DRA claim demand: a fresh
        gang anchors to a slice whose free CHIPS cover the gang's pending
        claims, so its members' claims co-allocate into one slice instead
        of scattering across slices that can each host only part of it."""
        self._claim_demand = fn

    # --- membership ----------------------------------------------------------

    @property
    def active(self) -> bool:
        return bool(self._groups)

    def group_key_of(self, pod: v1.Pod) -> Optional[str]:
        name = pod.metadata.labels.get(POD_GROUP_LABEL)
        if not name:
            return None
        return f"{pod.metadata.namespace}/{name}"

    def is_member(self, pod: v1.Pod) -> bool:
        return POD_GROUP_LABEL in pod.metadata.labels

    def _state(self, key: str) -> _GroupState:
        g = self._groups.get(key)
        if g is None:
            g = _GroupState()
            self._groups[key] = g
        if g.pg is None and g.checked_gen != self._pg_gen:
            # lazy store lookup with a negative cache: less() runs on every
            # queue heap compare and must not hit the store per compare for
            # a group that simply doesn't exist (yet)
            ns, _, name = key.partition("/")
            g.pg = self._store.get("PodGroup", ns, name)
            g.checked_gen = self._pg_gen
        return g

    # --- watch hooks (driven by the scheduler's store watch) ------------------

    def on_pod_event(self, ev_type: str, pod: v1.Pod, assigned: bool) -> None:
        key = self.group_key_of(pod)
        if key is None:
            return
        from ..sim.store import DELETED

        g = self._state(key)
        uid = pod.uid
        if ev_type == DELETED:
            g.pending.discard(uid)
            g.waiting.pop(uid, None)
            g.bound.pop(uid, None)
            if g.pg is not None and len(g.bound) < g.pg.min_member:
                g.released = False  # a re-formed gang releases anew
                known = len(g.pending) + len(g.waiting) + len(g.bound)
                if g.waiting and known < g.pg.min_member and not g.failing:
                    # the group can no longer reach quorum: fail the
                    # remaining waiters NOW instead of timing them out
                    g.failing = True
                    try:
                        self._fail_group(key, g,
                                         "rejected (member deleted below "
                                         "quorum)")
                    finally:
                        g.failing = False
            self._maybe_evict(key, g)
        elif assigned:
            self.on_bound(pod, pod.spec.node_name)
        elif uid not in g.bound and uid not in g.waiting:
            g.pending.add(uid)

    def on_group_event(self, ev_type: str, pg: v1.PodGroup) -> None:
        from ..sim.store import DELETED

        self._pg_gen += 1
        g = self._state(pg.key())
        g.pg = None if ev_type == DELETED else pg
        g.checked_gen = self._pg_gen
        if ev_type == DELETED:
            self._maybe_evict(pg.key(), g)

    def _maybe_evict(self, key: str, g: _GroupState) -> None:
        """Drop fully-drained dead group state: no PodGroup object and no
        members left means nothing can reference it again (a later pod
        lazily recreates it) — a long-lived scheduler churning through
        thousands of transient slice jobs must not grow _groups forever.
        (_slice_ids is different: it grows with DISTINCT slice-label
        values, bounded by node-label cardinality, and its ids are
        embedded in cached planes — left alone.)"""
        if g.pg is None and not g.pending and not g.waiting and not g.bound:
            self._groups.pop(key, None)

    def invalidate_nodes(self) -> None:
        """Node add/delete/label change: the slice-domain plane is stale."""
        self._node_gen += 1

    # --- QueueSort (the Coscheduling less-fn) ---------------------------------

    def sort_anchor(self, info) -> Tuple[float, str]:
        """Group cohesion key: members of one group share (group creation
        ts, group key) so the queue-sort heap keeps them ADJACENT — the
        batch pop then drains a gang contiguously.  Non-members anchor on
        their own pod creation timestamp (same wall-clock scale)."""
        key = self.group_key_of(info.pod)
        if key is None:
            return (info.pod.metadata.creation_timestamp, "")
        g = self._state(key)
        ts = (g.pg.metadata.creation_timestamp if g.pg is not None
              else info.pod.metadata.creation_timestamp)
        return (ts, key)

    def less(self, a, b) -> bool:
        """PrioritySort with gang cohesion (coscheduling queue_sort.go:
        priority desc, then group anchor, then per-pod arrival)."""
        pa, pb = a.pod.spec.priority, b.pod.spec.priority
        if pa != pb:
            return pa > pb
        ka, kb = self.sort_anchor(a), self.sort_anchor(b)
        if ka != kb:
            return ka < kb
        return a.initial_attempt_timestamp < b.initial_attempt_timestamp

    def queue_group_key(self, info) -> Optional[str]:
        """PriorityQueue group-cohesion key (group-aware activate/moves)."""
        return self.group_key_of(info.pod)

    # --- PreFilter quorum -----------------------------------------------------

    def prefilter(self, pod: v1.Pod) -> Optional[Status]:
        """None = pass; a Status rejects BEFORE any solver work.  Fewer
        than minMember known members can never form the gang, so the
        rejection is UnschedulableAndUnresolvable (a sibling-pod ADD or
        PodGroup change requeues via the registered cluster events)."""
        key = self.group_key_of(pod)
        if key is None:
            return None
        g = self._state(key)
        if g.pg is None:
            return Status.unschedulable(
                f"PodGroup {key} not found", plugin=PLUGIN_NAME,
                resolvable=False)
        known = len(g.pending) + len(g.waiting) + len(g.bound)
        if known < g.pg.min_member:
            if not g.quorum_rejected:
                g.quorum_rejected = True
                self.attempts["quorum_reject"] += 1
            return Status.unschedulable(
                f"gang {key} has {known}/{g.pg.min_member} members",
                plugin=PLUGIN_NAME, resolvable=False)
        g.quorum_rejected = False
        return None

    # --- Permit: all-or-nothing release --------------------------------------

    def on_permit(self, pod: v1.Pod) -> Tuple[str, float]:
        """→ ("allow", 0) when this member completes the gang (all waiting
        siblings are released), else ("wait", timeout)."""
        key = self.group_key_of(pod)
        if key is None:
            return ("allow", 0.0)
        g = self._state(key)
        if g.pg is None:
            return ("wait", self._default_timeout)
        have = len(g.bound) + len(g.waiting) + 1  # + this pod
        if have >= g.pg.min_member:
            self._release(key, g)
            return ("allow", 0.0)
        timeout = (float(g.pg.schedule_timeout_seconds)
                   if g.pg.schedule_timeout_seconds is not None
                   else self._default_timeout)
        return ("wait", timeout)

    def note_waiting(self, pod: v1.Pod, node_name: str) -> None:
        """A member entered the Permit hold (assumed, reserve kept)."""
        key = self.group_key_of(pod)
        if key is None:
            return
        g = self._state(key)
        g.pending.discard(pod.uid)
        g.waiting[pod.uid] = node_name
        if g.first_wait_ts is None:
            g.first_wait_ts = self._clock()
        self._set_phase(g, v1.POD_GROUP_SCHEDULING)
        # the reference's chaos kill-point ``crash.permit_held`` stands here;
        # the port carries no fault injection

    def note_wait_rejected(self, pod: v1.Pod, reason: str) -> None:
        """Flush-path context for the unreserve that follows: was this a
        Permit deadline expiry (gang timeout) or an ordinary rejection."""
        key = self.group_key_of(pod)
        if key is not None:
            self._state(key).last_reject_reason = reason

    def _release(self, key: str, g: _GroupState) -> None:
        # allowing waiters is idempotent and must run on EVERY threshold
        # crossing (a later member may find fresh waiters); the metric and
        # phase write are edge-triggered via g.released
        if self._waiting_pods is not None:
            for uid in list(g.waiting):
                wp = self._waiting_pods.get(uid)
                if wp is not None:
                    wp.allow(PLUGIN_NAME)
        if g.released:
            return
        g.released = True
        if g.first_wait_ts is not None:
            self.wait_durations.append(
                max(self._clock() - g.first_wait_ts, 0.0))
            g.first_wait_ts = None
        self.attempts["scheduled"] += 1
        self._set_phase(g, v1.POD_GROUP_SCHEDULING)

    # --- Unreserve: group failure ---------------------------------------------

    def on_unreserve(self, pod: v1.Pod) -> None:
        """A member's binding cycle rolled back.  If it was holding the
        Permit wait, the gang cannot complete this round: reject every
        still-waiting sibling (their flush rollback requeues them) and
        mark the group — the coscheduling Unreserve contract."""
        key = self.group_key_of(pod)
        if key is None:
            return
        g = self._state(key)
        was_waiting = pod.uid in g.waiting
        g.waiting.pop(pod.uid, None)
        if pod.uid not in g.bound:
            g.pending.add(pod.uid)
        if was_waiting and not g.failing:
            g.failing = True
            try:
                self._fail_group(key, g, g.last_reject_reason or "rejected")
            finally:
                g.failing = False
                g.last_reject_reason = ""

    def _fail_group(self, key: str, g: _GroupState, reason: str) -> None:
        if self._waiting_pods is not None:
            for uid in list(g.waiting):
                wp = self._waiting_pods.get(uid)
                if wp is not None:
                    wp.reject(PLUGIN_NAME, f"gang {key} {reason}")
        g.pending.update(g.waiting)
        g.waiting.clear()
        g.released = False  # the next full round releases (and counts) anew
        if g.first_wait_ts is not None:
            self.wait_durations.append(
                max(self._clock() - g.first_wait_ts, 0.0))
            g.first_wait_ts = None
        if "timed out" in reason:
            self.timeouts += 1
            self.attempts["timeout"] += 1
        else:
            self.attempts["rejected"] += 1
        self._set_phase(g, v1.POD_GROUP_UNSCHEDULABLE)

    # --- PostBind -------------------------------------------------------------

    def on_bound(self, pod: v1.Pod, node_name: str) -> None:
        key = self.group_key_of(pod)
        if key is None:
            return
        g = self._state(key)
        g.pending.discard(pod.uid)
        g.waiting.pop(pod.uid, None)
        g.bound[pod.uid] = node_name
        if g.pg is not None and len(g.bound) >= g.pg.min_member:
            self._set_phase(g, v1.POD_GROUP_SCHEDULED)

    def _set_phase(self, g: _GroupState, phase: str) -> None:
        pg = g.pg
        if pg is None or pg.phase == phase:
            return
        pg.phase = phase
        try:
            self._store.update("PodGroup", pg)
        except Exception:
            # best-effort status write: a store fault must never take the
            # binding cycle down with it — the phase repairs on the next
            # transition (the reference patches PodGroup status the same
            # lossy way)
            pass

    # --- preemption guard -----------------------------------------------------

    def allows_preemption(self, pod: v1.Pod) -> bool:
        """Never evict victims for a gang that cannot fully place: only
        the LAST missing member (everyone else bound or holding Permit)
        may run the preemption dry-run — an earlier member's evictions
        would free capacity for a gang that may still time out."""
        key = self.group_key_of(pod)
        if key is None:
            return True
        g = self._state(key)
        if g.pg is None:
            return False
        return len(g.bound) + len(g.waiting) >= g.pg.min_member - 1

    # --- solver integration ---------------------------------------------------

    def gang_segments(self, pods: List[v1.Pod], size: int) -> np.ndarray:
        """i32[size] per-pod gang segment id (-1 solo/padding) for the
        device all-or-nothing mask; gang-free batches reuse a cached
        all(-1) array so steady suites allocate nothing per cycle."""
        seg = None
        ids: Dict[str, int] = {}
        for i, pod in enumerate(pods):
            key = self.group_key_of(pod)
            if key is None:
                continue
            if seg is None:
                seg = np.full(size, -1, dtype=np.int32)
            seg[i] = ids.setdefault(key, len(ids))
        if seg is not None:
            return seg
        cached = self._noop_seg_cache.get(size)
        if cached is None:
            cached = np.full(size, -1, dtype=np.int32)
            self._noop_seg_cache[size] = cached
        return cached

    def stage_batch(self, pods: List[v1.Pod]) -> None:
        """Pods of the batch about to dispatch — host_aux reads them (the
        compiled PodBatch carries no pod objects)."""
        self._staged = list(pods)

    def host_aux(self, batch_size: int, encoder) -> Tuple[np.ndarray, np.ndarray]:
        """(slice_dom i32[N], anchor i32[B]) for the Coscheduling score
        plane: anchor[b] is the slice-domain id pod b's gang prefers —
        the slice already hosting bound/waiting members, else the slice
        with the most free CPU (pack a fresh gang into ONE slice) — and
        -2 for non-members (zero plane, shared compiled program)."""
        slice_dom = self._slice_dom(encoder)
        anchor = np.full(batch_size, -2, dtype=np.int32)
        # per-gang pending chip demand over this batch's staged members —
        # the slice the gang anchors to must have room for ALL of them
        demands: Dict[str, int] = {}
        if self._claim_demand is not None:
            for pod in self._staged[:batch_size]:
                key = self.group_key_of(pod)
                if key is not None:
                    demands[key] = demands.get(key, 0) + int(
                        self._claim_demand(pod))
        memo: Dict[str, int] = {}
        best = None  # lazily computed once per call (claim-free gangs)
        for i, pod in enumerate(self._staged[:batch_size]):
            key = self.group_key_of(pod)
            if key is None:
                continue
            a = memo.get(key)
            if a is None:
                g = self._groups.get(key)
                a = -2
                if g is not None:
                    for node in list(g.bound.values()) + list(g.waiting.values()):
                        row = encoder.node_rows.get(node)
                        if row is not None and 0 <= row < slice_dom.shape[0] \
                                and slice_dom[row] >= 0:
                            a = int(slice_dom[row])
                            break
                if a == -2:
                    need = demands.get(key, 0)
                    if need > 0:
                        a = self._best_free_slice(slice_dom, encoder, need)
                    else:
                        if best is None:
                            best = self._best_free_slice(slice_dom, encoder)
                        a = best
                memo[key] = a
            anchor[i] = a
        return slice_dom, anchor

    def _slice_dom(self, encoder) -> np.ndarray:
        n = int(np.shape(encoder.node_valid)[0])
        if (self._slice_cache is not None
                and self._slice_cache_gen == self._node_gen
                and self._slice_cache.shape[0] == n):
            return self._slice_cache
        dom = np.full(n, -1, dtype=np.int32)
        nodes, _ = self._store.list("Node")
        for node in nodes:
            val = node.metadata.labels.get(self._slice_label)
            if val is None:
                continue
            row = encoder.node_rows.get(node.metadata.name)
            if row is None or row >= n:
                continue
            dom[row] = self._slice_ids.setdefault(val, len(self._slice_ids))
        self._slice_cache, self._slice_cache_gen = dom, self._node_gen
        return dom

    def _best_free_slice(self, slice_dom: np.ndarray, encoder,
                         claim_demand: int = 0) -> int:
        valid = np.asarray(encoder.node_valid)
        member = (slice_dom >= 0) & valid
        if not member.any():
            return -2
        free = (np.asarray(encoder.allocatable)[:, 0].astype(np.int64)
                - np.asarray(encoder.requested)[:, 0])
        totals = np.zeros(int(slice_dom.max()) + 1, dtype=np.int64)
        np.add.at(totals, slice_dom[member], free[member])
        if claim_demand > 0:
            # claim-aware pick: among slices whose free CHIPS (the encoder
            # claim planes the DraIndex projects) cover the gang's pending
            # demand, take the most free CPU; if none can, take the most
            # free chips — members still filter per-node, and the Permit
            # timeout fails a truly starved gang atomically
            chips = (np.asarray(encoder.claim_capacity).astype(np.int64)
                     - np.asarray(encoder.claim_allocated))
            chip_tot = np.zeros_like(totals)
            np.add.at(chip_tot, slice_dom[member], chips[member])
            fits = chip_tot >= claim_demand
            if fits.any():
                return int(np.argmax(np.where(fits, totals, -1)))
            return int(np.argmax(chip_tot))
        return int(np.argmax(totals))
