"""Scheduler cache: authoritative in-scheduler cluster state + assumed-pod lifecycle.

Reference: pkg/scheduler/internal/cache/cache.go (cacheImpl :56-75, UpdateSnapshot
:197-276) and interface.go:59. Responsibilities:

- node add/update/remove, pod add/update/remove from the watch stream
- optimistic **assume** (scheduler-local placement before the bind write lands),
  finishBinding starts a TTL (default 15 min, scheduler.go:64-66) after which an
  unconfirmed assumed pod expires and its resources are released
- O(changed) snapshot refresh via per-NodeInfo generation numbers: only NodeInfos
  whose generation exceeds the snapshot's high-water mark are re-encoded (the
  Pythonic equivalent of the reference's generation-sorted doubly-linked list)
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ..api import objects as v1
from .node_info import NodeInfo, next_generation

DEFAULT_ASSUME_TTL_SECONDS = 15 * 60.0


class SchedulerCacheError(Exception):
    pass


@dataclass
class _PodState:
    pod: v1.Pod
    deadline: Optional[float] = None  # set by finish_binding
    binding_finished: bool = False


@dataclass
class Snapshot:
    """Immutable per-cycle host view (reference internal/cache/snapshot.go:29-40)."""

    node_info_map: Dict[str, NodeInfo] = field(default_factory=dict)
    node_info_list: List[NodeInfo] = field(default_factory=list)
    have_pods_with_affinity_list: List[NodeInfo] = field(default_factory=list)
    have_pods_with_required_anti_affinity_list: List[NodeInfo] = field(default_factory=list)
    generation: int = 0

    def num_nodes(self) -> int:
        return len(self.node_info_list)

    def get(self, name: str) -> Optional[NodeInfo]:
        return self.node_info_map.get(name)


class Cache:
    """Single-writer cache (the event-ingest path), snapshot-reader scheduling path."""

    def __init__(self, ttl: float = DEFAULT_ASSUME_TTL_SECONDS, clock=time.monotonic):
        self._ttl = ttl
        self._clock = clock
        self._nodes: Dict[str, NodeInfo] = {}
        self._pod_states: Dict[str, _PodState] = {}  # pod uid -> state
        self._assumed_pods: Set[str] = set()

    # --- nodes --------------------------------------------------------------

    def add_node(self, node: v1.Node) -> None:
        info = self._nodes.get(node.metadata.name)
        if info is None:
            info = NodeInfo()
            self._nodes[node.metadata.name] = info
            # pods may have arrived before their node (reference cache.go AddPod
            # creating an imaginary node entry)
        info.set_node(node)

    def update_node(self, node: v1.Node) -> None:
        self.add_node(node)

    def remove_node(self, name: str) -> None:
        info = self._nodes.get(name)
        if info is None:
            return
        if info.pods:
            # keep entry for remaining (possibly stale) pods; clear node object
            info.node = None
            info.generation = next_generation()
        else:
            del self._nodes[name]

    # --- pods ---------------------------------------------------------------

    def assume_pod(self, pod: v1.Pod, node_name: str) -> None:
        """Optimistically place pod on node before the bind completes
        (reference cache.go AssumePod; scheduler.go:424,571)."""
        uid = pod.uid
        if uid in self._pod_states:
            raise SchedulerCacheError(f"pod {pod.key()} already assumed/added")
        # assume on a COPY: the caller's (queued) pod must keep NodeName empty so
        # a failed bind can be retried anywhere (the reference assumes on a
        # deep-copied pod, scheduler.go:566-581).  A pod+spec shallow copy is
        # enough here: only spec.node_name diverges, and the shared sub-objects
        # (metadata, containers) are treated as immutable by the cache — a full
        # deepcopy measured ~1 ms/pod, 20% of a 128-pod batch's host budget.
        assumed = copy.copy(pod)
        assumed.spec = copy.copy(pod.spec)
        assumed.spec.node_name = node_name
        self._add_pod_to_node(assumed)
        self._pod_states[uid] = _PodState(pod=assumed)
        self._assumed_pods.add(uid)

    def finish_binding(self, pod: v1.Pod) -> None:
        uid = pod.uid
        st = self._pod_states.get(uid)
        if st is None or uid not in self._assumed_pods:
            return
        st.binding_finished = True
        st.deadline = self._clock() + self._ttl

    def forget_pod(self, pod: v1.Pod) -> None:
        """Binding failed — roll the assume back (reference scheduler.go:676-689)."""
        uid = pod.uid
        if uid not in self._assumed_pods:
            raise SchedulerCacheError(f"pod {pod.key()} not assumed")
        self._remove_pod_from_node(self._pod_states[uid].pod)
        del self._pod_states[uid]
        self._assumed_pods.discard(uid)

    def add_pod(self, pod: v1.Pod) -> None:
        """Watch-confirmed scheduled pod (Add event with nodeName set)."""
        uid = pod.uid
        st = self._pod_states.get(uid)
        if st is not None and uid in self._assumed_pods:
            # confirmation of an assumed pod
            if st.pod.spec.node_name != pod.spec.node_name:
                # scheduled somewhere else than we assumed — fix up
                self._remove_pod_from_node(st.pod)
                self._add_pod_to_node(pod)
            self._assumed_pods.discard(uid)
            self._pod_states[uid] = _PodState(pod=pod)
            return
        if st is not None:
            return  # duplicate add
        self._add_pod_to_node(pod)
        self._pod_states[uid] = _PodState(pod=pod)

    def update_pod(self, old: v1.Pod, new: v1.Pod) -> None:
        st = self._pod_states.get(old.uid)
        if st is None:
            self.add_pod(new)
            return
        self._remove_pod_from_node(st.pod)
        self._add_pod_to_node(new)
        self._pod_states[new.uid] = _PodState(pod=new)

    def remove_pod(self, pod: v1.Pod) -> None:
        st = self._pod_states.pop(pod.uid, None)
        self._assumed_pods.discard(pod.uid)
        if st is not None:
            self._remove_pod_from_node(st.pod)

    def is_assumed(self, pod: v1.Pod) -> bool:
        return pod.uid in self._assumed_pods

    def cleanup_expired(self, now: Optional[float] = None) -> List[v1.Pod]:
        """Expire assumed pods whose binding never confirmed (cache.go cleanup)."""
        now = self._clock() if now is None else now
        expired = []
        for uid in list(self._assumed_pods):
            st = self._pod_states[uid]
            if st.binding_finished and st.deadline is not None and now >= st.deadline:
                expired.append(st.pod)
                self.remove_pod(st.pod)
        return expired

    def _add_pod_to_node(self, pod: v1.Pod) -> None:
        name = pod.spec.node_name
        info = self._nodes.get(name)
        if info is None:
            info = NodeInfo()  # node not seen yet; imaginary entry
            self._nodes[name] = info
        info.add_pod(pod)

    def _remove_pod_from_node(self, pod: v1.Pod) -> None:
        info = self._nodes.get(pod.spec.node_name)
        if info is not None:
            info.remove_pod(pod)
            if info.node is None and not info.pods:
                del self._nodes[pod.spec.node_name]

    # --- snapshot -----------------------------------------------------------

    def node_count(self) -> int:
        return sum(1 for n in self._nodes.values() if n.node is not None)

    def pod_count(self) -> int:
        return sum(len(n.pods) for n in self._nodes.values())

    def update_snapshot(self, snapshot: Snapshot) -> List[str]:
        """Refresh snapshot in place; returns names of changed nodes (O(changed)).

        Reference: cache.go:197-276 — only NodeInfos with generation > the
        snapshot's high-water mark are cloned; removed nodes are pruned.
        """
        changed: List[str] = []
        max_gen = snapshot.generation
        for name, info in self._nodes.items():
            if info.node is None:
                continue
            if info.generation > snapshot.generation:
                snapshot.node_info_map[name] = info.clone()
                changed.append(name)
                max_gen = max(max_gen, info.generation)
        removed = [
            name
            for name in snapshot.node_info_map
            if name not in self._nodes or self._nodes[name].node is None
        ]
        for name in removed:
            del snapshot.node_info_map[name]
            changed.append(name)
        if changed:
            snapshot.node_info_list = list(snapshot.node_info_map.values())
            snapshot.have_pods_with_affinity_list = [
                n for n in snapshot.node_info_list if n.pods_with_affinity
            ]
            snapshot.have_pods_with_required_anti_affinity_list = [
                n for n in snapshot.node_info_list if n.pods_with_required_anti_affinity
            ]
        snapshot.generation = max_gen
        return changed
