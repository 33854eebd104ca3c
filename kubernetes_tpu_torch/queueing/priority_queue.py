"""Three-queue PriorityQueue with event-driven requeue.

Reference: pkg/scheduler/internal/queue/scheduling_queue.go —
  PriorityQueue :129-170 (activeQ heap by queue-sort less-fn, podBackoffQ heap by
  backoff expiry, unschedulableQ map), Pop :478, AddUnschedulableIfNotPresent
  :387, MoveAllToActiveOrBackoffQueue :608, podMatchesEvent :963,
  flushBackoffQCompleted :426, flushUnschedulableQLeftover :457,
  backoff 1s→10s :54-64, unschedulableQ max stay 60s, Activate :318.

Differences from the reference: batched Pop (``pop_batch``) drains up to K ready
pods in one call — the unit the device path schedules per cycle; no goroutines —
callers drive ``flush()`` from their loop (tests inject a fake clock).
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..api import objects as v1
from ..framework.events import ClusterEvent

DEFAULT_POD_INITIAL_BACKOFF = 1.0  # :54-64
DEFAULT_POD_MAX_BACKOFF = 10.0
DEFAULT_UNSCHEDULABLE_TIME_LIMIT = 60.0  # flushUnschedulableQLeftover


@dataclass
class QueuedPodInfo:
    """Reference framework.QueuedPodInfo."""

    pod: v1.Pod
    timestamp: float = 0.0  # when added to the queue
    initial_attempt_timestamp: float = 0.0
    attempts: int = 0
    unschedulable_plugins: Set[str] = field(default_factory=set)
    # when the pod last entered the ACTIVE queue (vs. timestamp, which is
    # this attempt's overall queue entry incl. backoff/unschedulable time):
    # the attempt span tree's queue_wait splits backoff wait from
    # poppable-but-not-yet-popped wait with these two stamps
    last_activation: float = 0.0


def default_less(a: QueuedPodInfo, b: QueuedPodInfo) -> bool:
    """PrioritySort (queuesort/priority_sort.go): priority desc, then older first."""
    pa, pb = a.pod.spec.priority, b.pod.spec.priority
    if pa != pb:
        return pa > pb
    return a.initial_attempt_timestamp < b.initial_attempt_timestamp


class PriorityQueue:
    def __init__(
        self,
        less: Callable[[QueuedPodInfo, QueuedPodInfo], bool] = default_less,
        clock: Callable[[], float] = time.monotonic,
        pod_initial_backoff: float = DEFAULT_POD_INITIAL_BACKOFF,
        pod_max_backoff: float = DEFAULT_POD_MAX_BACKOFF,
        unschedulable_time_limit: float = DEFAULT_UNSCHEDULABLE_TIME_LIMIT,
        cluster_event_map: Optional[Dict[ClusterEvent, Set[str]]] = None,
        group_key: Optional[Callable[[QueuedPodInfo], Optional[str]]] = None,
    ):
        self._less = less
        self._clock = clock
        # gang cohesion (the gang subsystem): pods sharing a non-None
        # group key move out of backoff/unschedulableQ TOGETHER — one
        # member trickling back alone just burns a Permit-timeout round
        # per member (the thrash the coscheduling subsystem exists to stop)
        self._group_key = group_key
        self._initial_backoff = pod_initial_backoff
        self._max_backoff = pod_max_backoff
        self._unschedulable_limit = unschedulable_time_limit
        # ClusterEvent → plugin names that registered it (scheduler.go:347-362)
        self._cluster_event_map = cluster_event_map or {}
        self._seq = itertools.count()
        self._active: List[Tuple[object, int, QueuedPodInfo]] = []  # heap
        self._backoff: List[Tuple[float, int, QueuedPodInfo]] = []  # heap by expiry
        self._unschedulable: Dict[str, QueuedPodInfo] = {}  # uid → info
        self._in_active: Set[str] = set()
        self._in_backoff: Set[str] = set()
        self._moves: int = 0  # moveRequestCycle analog
        # Debounce: move_all_to_active_or_backoff only records the event; the
        # O(unschedulable) match scan runs once per flush() over the deduped
        # pending set.  A 128-pod bind burst otherwise triggers 128 full scans
        # (each bind's watch event calls move_all — eventhandlers.go analog).
        self._pending_events: List[ClusterEvent] = []

    # --- sort key ------------------------------------------------------------

    class _Key:
        __slots__ = ("info", "less")

        def __init__(self, info, less):
            self.info, self.less = info, less

        def __lt__(self, other):
            return self.less(self.info, other.info)

    def _push_active(self, info: QueuedPodInfo, event: Optional[str] = None):
        """``event`` labels queue_incoming_pods (metrics.go's per-event
        inflow accounting); None = internal churn (pop_batch put-back),
        not a queue entry."""
        uid = info.pod.uid
        if uid in self._in_active:
            return
        info.last_activation = self._clock()
        heapq.heappush(
            self._active, (self._Key(info, self._less), next(self._seq), info)
        )
        self._in_active.add(uid)

    # --- public API ----------------------------------------------------------

    def add(self, pod: v1.Pod) -> None:
        now = self._clock()
        info = QueuedPodInfo(
            pod=pod, timestamp=now, initial_attempt_timestamp=now
        )
        self._push_active(info, "PodAdd")

    def __len__(self) -> int:
        self.flush()
        return len(self._active)

    def unschedulable_pods(self) -> List[v1.Pod]:
        """Pods parked in unschedulableQ — the cluster-autoscaler's demand
        signal (upstream reads the same queue via the scheduler's
        nominator/listers).  Pending event moves apply first (like
        pending_count): a pod a recorded cluster event — e.g. NODE_ADD
        from the autoscaler's own scale-up — has already queued back to
        active must not still read as parked demand."""
        self._apply_pending_moves()
        return [info.pod for info in self._unschedulable.values()]

    def pending_count(self) -> Tuple[int, int, int]:
        self._apply_pending_moves()
        return len(self._active), len(self._backoff), len(self._unschedulable)

    def pop(self) -> Optional[QueuedPodInfo]:
        self.flush()
        while self._active:
            _, _, info = heapq.heappop(self._active)
            uid = info.pod.uid
            if uid in self._in_active:
                self._in_active.discard(uid)
                info.attempts += 1
                return info
        return None

    def pop_batch(self, max_size: int, group_key=None) -> List[QueuedPodInfo]:
        """Drain up to max_size ready pods — the device batch unit.

        ``group_key(info)``: when given, the batch holds only pods sharing
        the HEAD pod's key (e.g. schedulerName — one framework per dispatch,
        profile/profile.go:45); non-matching pods are pushed back untouched."""
        out = []
        put_back = []
        key = None
        while len(out) < max_size and len(put_back) < max_size:
            # the put_back bound keeps the scan O(batch) even when another
            # profile dominates the queue (no full-heap drain per cycle)
            info = self.pop()
            if info is None:
                break
            if group_key is not None:
                k = group_key(info)
                if key is None:
                    key = k
                elif k != key:
                    put_back.append(info)
                    continue
            out.append(info)
        # through put_back(): attempts un-counted AND last_activation
        # preserved — a pod repeatedly riding profile-mismatch put-backs
        # must not have its active-wait attribution restamped every cycle
        self.put_back(put_back)
        return out

    def put_back(self, infos: Sequence[QueuedPodInfo]) -> None:
        """Return pods popped this cycle to the active queue untouched — the
        scheduler's micro-bucket split dispatches only the head of a popped
        batch and hands the tail straight back.  pop() counted an attempt
        for each; undo it (the pod was never dispatched).  ``timestamp``
        AND ``last_activation`` are deliberately preserved: the pod's
        queue-wait accounting (including the active-wait split the
        queue_wait span reports) must keep covering the time it spent
        riding put-back tails — _push_active would otherwise restamp
        activation every cycle."""
        for info in infos:
            info.attempts -= 1
            la = info.last_activation
            self._push_active(info)
            info.last_activation = la

    def add_unschedulable(self, info: QueuedPodInfo, pod_scheduling_cycle: Optional[int] = None) -> None:
        """AddUnschedulableIfNotPresent (:387): a move since the cycle started
        sends the pod to backoff instead of unschedulableQ."""
        uid = info.pod.uid
        if uid in self._in_active or uid in self._in_backoff or uid in self._unschedulable:
            return
        info.timestamp = self._clock()
        if pod_scheduling_cycle is not None and self._moves > pod_scheduling_cycle:
            self._push_backoff(info, "ScheduleAttemptFailure")
        else:
            self._unschedulable[uid] = info

    def requeue_after_error(self, info: QueuedPodInfo) -> None:
        """Transient-error requeue: straight to the backoff heap.

        An INTERNAL error (store outage mid-cycle, bind transport fault) is
        retriable on a timer — no cluster event will ever arrive to move the
        pod out of unschedulableQ, so parking it there strands it for the
        60s leftover flush.  The reference routes framework errors the same
        way (handleSchedulingFailure → podBackoffQ)."""
        uid = info.pod.uid
        if uid in self._in_active or uid in self._in_backoff \
                or uid in self._unschedulable:
            return
        info.timestamp = self._clock()
        self._push_backoff(info, "SchedulingError")

    def scheduling_cycle(self) -> int:
        return self._moves

    def _backoff_time(self, info: QueuedPodInfo) -> float:
        d = self._initial_backoff * (2 ** max(info.attempts - 1, 0))
        return info.timestamp + min(d, self._max_backoff)

    def _push_backoff(self, info: QueuedPodInfo, event: Optional[str] = None):
        uid = info.pod.uid
        if uid in self._in_backoff:
            return
        heapq.heappush(
            self._backoff, (self._backoff_time(info), next(self._seq), info)
        )
        self._in_backoff.add(uid)

    def activate(self, pods: Sequence[v1.Pod]) -> None:
        """Activate (:318): force named pods from backoff/unschedulable to
        active — expanded to every queued member of the named pods' groups
        (group_key), so a gang re-enters the active queue as ONE unit."""
        uids = {p.uid for p in pods}
        uids |= self._group_sibling_uids(
            self._groups_of_pods(pods) if self._group_key else set())
        self._remove_from_backoff(uids, to_active=True)
        for uid in list(self._unschedulable):
            if uid in uids:
                self._push_active(self._unschedulable.pop(uid),
                                  "ForceActivate")

    def _groups_of_pods(self, pods: Sequence[v1.Pod]) -> Set[str]:
        # group_key reads info.pod only; a transient wrapper is enough
        return {
            k for k in (self._group_key(QueuedPodInfo(pod=p)) for p in pods)
            if k is not None
        }

    def _group_sibling_uids(self, groups: Set[str]) -> Set[str]:
        """uids of every backoff/unschedulableQ member of ``groups``."""
        if not groups:
            return set()
        out: Set[str] = set()
        for info in self._unschedulable.values():
            if self._group_key(info) in groups:
                out.add(info.pod.uid)
        for _, _, info in self._backoff:
            if info.pod.uid in self._in_backoff \
                    and self._group_key(info) in groups:
                out.add(info.pod.uid)
        return out

    def _remove_from_backoff(self, uids: Set[str], to_active: bool):
        kept = []
        for expiry, seq, info in self._backoff:
            if info.pod.uid in uids and info.pod.uid in self._in_backoff:
                self._in_backoff.discard(info.pod.uid)
                if to_active:
                    self._push_active(info, "ForceActivate")
            else:
                kept.append((expiry, seq, info))
        heapq.heapify(kept)
        self._backoff = kept

    def move_all_to_active_or_backoff(self, event: ClusterEvent) -> None:
        """MoveAllToActiveOrBackoffQueue (:608) + podMatchesEvent (:963).

        The move counter bumps immediately (AddUnschedulableIfNotPresent's
        backoff-vs-unschedulable decision depends on it) but the scan is
        deferred to flush(), which every pop() runs first — observable
        behavior is unchanged, repeated events within one burst cost one scan."""
        self._moves += 1
        self._pending_events.append(event)

    def _apply_pending_moves(self) -> None:
        if not self._pending_events:
            return
        events, self._pending_events = self._pending_events, []
        seen = set()
        deduped = []
        for ev in events:
            k = (ev.resource, ev.action_type)
            if k not in seen:
                seen.add(k)
                deduped.append(ev)
        moved = []
        for uid, info in self._unschedulable.items():
            ev = next((ev for ev in deduped
                       if self._pod_matches_event(info, ev)), None)
            if ev is not None:
                moved.append((uid, ev.label or "ClusterEvent"))
        # Gang cohesion: an event that moves ANY member moves the WHOLE
        # group, and the group bypasses the per-pod backoff gate — members
        # re-dispatch together or the stragglers burn the released members'
        # Permit wait one timeout at a time.
        moved_groups: Set[str] = set()
        if self._group_key is not None and moved:
            for uid, _ in moved:
                g = self._group_key(self._unschedulable[uid])
                if g is not None:
                    moved_groups.add(g)
            if moved_groups:
                moved_uids = {u for u, _ in moved}
                label_of = {
                    self._group_key(self._unschedulable[u]): lbl
                    for u, lbl in moved
                }
                for uid, info in self._unschedulable.items():
                    g = self._group_key(info)
                    if g in moved_groups and uid not in moved_uids:
                        moved.append((uid, label_of[g]))
                backoff_sibs = self._group_sibling_uids(moved_groups) \
                    - {u for u, _ in moved}
                if backoff_sibs:
                    self._remove_from_backoff(backoff_sibs, to_active=True)
        for uid, label in moved:
            info = self._unschedulable.pop(uid)
            if self._group_key is not None \
                    and self._group_key(info) in moved_groups:
                self._push_active(info, label)
            elif self._clock() < self._backoff_time(info):
                self._push_backoff(info, label)
            else:
                self._push_active(info, label)

    def _pod_matches_event(self, info: QueuedPodInfo, event: ClusterEvent) -> bool:
        if event.is_wildcard():
            return True
        if not info.unschedulable_plugins:
            return True  # no diagnosis recorded — be permissive
        for registered, plugins in self._cluster_event_map.items():
            if registered.match(event) and (plugins & info.unschedulable_plugins):
                return True
        return False

    def update(self, old: v1.Pod, new: v1.Pod) -> None:
        """Pod spec update may make it schedulable: move out of unschedulableQ."""
        info = self._unschedulable.pop(new.uid, None)
        if info is not None:
            info.pod = new
            if self._clock() < self._backoff_time(info):
                self._push_backoff(info, "PodUpdate")
            else:
                self._push_active(info, "PodUpdate")

    def delete(self, pod: v1.Pod) -> None:
        self._in_active.discard(pod.uid)
        self._in_backoff.discard(pod.uid)
        self._unschedulable.pop(pod.uid, None)

    # --- flush loops (reference: goroutines at 1s / 30s) ----------------------

    def next_backoff_expiry(self) -> Optional[float]:
        """Expiry time of the soonest still-backed-off pod, or None.  Flushes
        first, so already-expired pods are in the active queue, not here —
        the scheduler's batch-formation hysteresis peeks at this."""
        self.flush()
        return self._backoff[0][0] if self._backoff else None

    def flush(self) -> None:
        self._apply_pending_moves()
        now = self._clock()
        while self._backoff:
            expiry, _, info = self._backoff[0]
            if expiry > now:
                break
            heapq.heappop(self._backoff)
            if info.pod.uid in self._in_backoff:
                self._in_backoff.discard(info.pod.uid)
                self._push_active(info, "BackoffComplete")
        for uid, info in list(self._unschedulable.items()):
            if now - info.timestamp > self._unschedulable_limit:
                del self._unschedulable[uid]
                if now < self._backoff_time(info):
                    self._push_backoff(info, "UnschedulableTimeout")
                else:
                    self._push_active(info, "UnschedulableTimeout")
