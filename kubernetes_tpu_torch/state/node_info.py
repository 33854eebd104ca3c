"""Host-side per-node aggregate state.

Reference: ``framework.NodeInfo`` (pkg/scheduler/framework/types.go:365-405) — Pods,
PodsWithAffinity, PodsWithRequiredAntiAffinity, UsedPorts, Requested /
NonZeroRequested / Allocatable resource vectors, ImageStates, PVCRefCounts, and a
Generation for O(changed) snapshotting. This is the authoritative host mirror that
feeds the device encoder; the sequential parity oracle also reads it directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..api import objects as v1
from ..api.resource import (
    Resource,
    compute_pod_resource_request,
    compute_pod_resource_request_non_zero,
)

# Global generation counter (reference types.go nextGeneration; single-writer cache).
_generation = 0


def next_generation() -> int:
    global _generation
    _generation += 1
    return _generation


@dataclass
class PodInfo:
    """Pod plus pre-parsed affinity terms (reference types.go PodInfo)."""

    pod: v1.Pod
    required_affinity_terms: List[v1.PodAffinityTerm] = field(default_factory=list)
    required_anti_affinity_terms: List[v1.PodAffinityTerm] = field(default_factory=list)
    preferred_affinity_terms: List[v1.WeightedPodAffinityTerm] = field(default_factory=list)
    preferred_anti_affinity_terms: List[v1.WeightedPodAffinityTerm] = field(default_factory=list)

    @classmethod
    def of(cls, pod: v1.Pod) -> "PodInfo":
        info = cls(pod=pod)
        aff = pod.spec.affinity
        if aff is not None:
            if aff.pod_affinity is not None:
                info.required_affinity_terms = list(aff.pod_affinity.required)
                info.preferred_affinity_terms = list(aff.pod_affinity.preferred)
            if aff.pod_anti_affinity is not None:
                info.required_anti_affinity_terms = list(aff.pod_anti_affinity.required)
                info.preferred_anti_affinity_terms = list(aff.pod_anti_affinity.preferred)
        return info

    def has_affinity_constraints(self) -> bool:
        return bool(self.required_affinity_terms or self.required_anti_affinity_terms
                    or self.preferred_affinity_terms or self.preferred_anti_affinity_terms)


def _pod_host_ports(pod: v1.Pod) -> Set[Tuple[str, str, int]]:
    ports = set()
    for c in pod.spec.containers:
        for p in c.ports:
            if p.host_port > 0:
                ip = p.host_ip or "0.0.0.0"
                ports.add((ip, p.protocol or "TCP", p.host_port))
    return ports


def host_ports_conflict(a: Set[Tuple[str, str, int]], b: Set[Tuple[str, str, int]]) -> bool:
    """Reference: framework.HostPortInfo — 0.0.0.0 conflicts with any IP on same
    (proto, port); distinct concrete IPs don't conflict."""
    for ip1, proto1, port1 in a:
        for ip2, proto2, port2 in b:
            if proto1 == proto2 and port1 == port2:
                if ip1 == "0.0.0.0" or ip2 == "0.0.0.0" or ip1 == ip2:
                    return True
    return False


@dataclass
class NodeInfo:
    node: Optional[v1.Node] = None
    pods: List[PodInfo] = field(default_factory=list)
    pods_with_affinity: List[PodInfo] = field(default_factory=list)
    pods_with_required_anti_affinity: List[PodInfo] = field(default_factory=list)
    requested: Resource = field(default_factory=Resource)
    non_zero_requested: Resource = field(default_factory=Resource)
    allocatable: Resource = field(default_factory=Resource)
    used_ports: Set[Tuple[str, str, int]] = field(default_factory=set)
    image_states: Dict[str, int] = field(default_factory=dict)  # image name -> bytes
    pvc_ref_counts: Dict[str, int] = field(default_factory=dict)  # ns/name -> count
    generation: int = 0

    @classmethod
    def of(cls, node: v1.Node, pods: List[v1.Pod] = ()) -> "NodeInfo":
        info = cls()
        info.set_node(node)
        for p in pods:
            info.add_pod(p)
        return info

    def set_node(self, node: v1.Node) -> None:
        self.node = node
        self.allocatable = Resource.from_resource_list(node.status.allocatable)
        self.image_states = {
            name: img.size_bytes
            for img in node.status.images
            for name in img.names
        }
        self.generation = next_generation()

    def add_pod(self, pod: v1.Pod) -> None:
        self.add_pod_info(PodInfo.of(pod))

    def add_pod_info(self, pi: PodInfo) -> None:
        self.pods.append(pi)
        if pi.has_affinity_constraints():
            self.pods_with_affinity.append(pi)
        if pi.required_anti_affinity_terms:
            self.pods_with_required_anti_affinity.append(pi)
        self.requested.add(compute_pod_resource_request(pi.pod))
        self.non_zero_requested.add(compute_pod_resource_request_non_zero(pi.pod))
        self.used_ports |= _pod_host_ports(pi.pod)
        for vol in pi.pod.spec.volumes:
            if vol.pvc_name:
                key = f"{pi.pod.namespace}/{vol.pvc_name}"
                self.pvc_ref_counts[key] = self.pvc_ref_counts.get(key, 0) + 1
        self.generation = next_generation()

    def remove_pod(self, pod: v1.Pod) -> bool:
        for i, pi in enumerate(self.pods):
            if pi.pod.uid == pod.uid:
                del self.pods[i]
                self.pods_with_affinity = [
                    p for p in self.pods_with_affinity if p.pod.uid != pod.uid
                ]
                self.pods_with_required_anti_affinity = [
                    p for p in self.pods_with_required_anti_affinity if p.pod.uid != pod.uid
                ]
                self.requested.sub(compute_pod_resource_request(pi.pod))
                self.non_zero_requested.sub(compute_pod_resource_request_non_zero(pi.pod))
                # Rebuild ports (another pod may share a (proto, port) on another IP).
                self.used_ports = set()
                for q in self.pods:
                    self.used_ports |= _pod_host_ports(q.pod)
                for vol in pi.pod.spec.volumes:
                    if vol.pvc_name:
                        key = f"{pi.pod.namespace}/{vol.pvc_name}"
                        n = self.pvc_ref_counts.get(key, 0) - 1
                        if n <= 0:
                            self.pvc_ref_counts.pop(key, None)
                        else:
                            self.pvc_ref_counts[key] = n
                self.generation = next_generation()
                return True
        return False

    @property
    def node_name(self) -> str:
        return self.node.metadata.name if self.node else ""

    def clone(self) -> "NodeInfo":
        c = NodeInfo(
            node=self.node,
            pods=list(self.pods),
            pods_with_affinity=list(self.pods_with_affinity),
            pods_with_required_anti_affinity=list(self.pods_with_required_anti_affinity),
            requested=self.requested.clone(),
            non_zero_requested=self.non_zero_requested.clone(),
            allocatable=self.allocatable.clone(),
            used_ports=set(self.used_ports),
            image_states=dict(self.image_states),
            pvc_ref_counts=dict(self.pvc_ref_counts),
            generation=self.generation,
        )
        return c
