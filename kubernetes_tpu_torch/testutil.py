"""Declarative object builders for tests and benchmarks.

Reference: pkg/scheduler/testing/wrappers.go:139-144 (``st.MakePod().Name("p")
.Req(...).Obj()`` style). Fluent builders returning api objects.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .api import objects as v1


class PodWrapper:
    def __init__(self):
        self._pod = v1.Pod()
        self._pod.spec.containers = [v1.Container(name="c0", image="pause")]

    def obj(self) -> v1.Pod:
        return self._pod

    def name(self, n: str) -> "PodWrapper":
        self._pod.metadata.name = n
        return self

    def namespace(self, ns: str) -> "PodWrapper":
        self._pod.metadata.namespace = ns
        return self

    def uid(self, uid: str) -> "PodWrapper":
        self._pod.metadata.uid = uid
        return self

    def label(self, k: str, v: str) -> "PodWrapper":
        self._pod.metadata.labels[k] = v
        return self

    def labels(self, labels: Dict[str, str]) -> "PodWrapper":
        self._pod.metadata.labels.update(labels)
        return self

    def creation_timestamp(self, t: float) -> "PodWrapper":
        self._pod.metadata.creation_timestamp = t
        return self

    def req(self, requests: Dict[str, object]) -> "PodWrapper":
        """Set requests on the (single) default container."""
        self._pod.spec.containers[0].resources.requests = dict(requests)
        return self

    def container_req(self, requests: Dict[str, object]) -> "PodWrapper":
        """Append an extra container with the given requests."""
        idx = len(self._pod.spec.containers)
        self._pod.spec.containers.append(
            v1.Container(
                name=f"c{idx}",
                image="pause",
                resources=v1.ResourceRequirements(requests=dict(requests)),
            )
        )
        return self

    def init_req(self, requests: Dict[str, object]) -> "PodWrapper":
        idx = len(self._pod.spec.init_containers)
        self._pod.spec.init_containers.append(
            v1.Container(
                name=f"init{idx}",
                image="pause",
                resources=v1.ResourceRequirements(requests=dict(requests)),
            )
        )
        return self

    def overhead(self, rl: Dict[str, object]) -> "PodWrapper":
        self._pod.spec.overhead = dict(rl)
        return self

    def node(self, name: str) -> "PodWrapper":
        self._pod.spec.node_name = name
        return self

    def node_selector(self, sel: Dict[str, str]) -> "PodWrapper":
        self._pod.spec.node_selector = dict(sel)
        return self

    def node_affinity_in(self, key: str, values: List[str]) -> "PodWrapper":
        self._require_node_affinity().node_selector_terms.append(
            v1.NodeSelectorTerm(
                match_expressions=[
                    v1.NodeSelectorRequirement(key=key, operator=v1.OP_IN, values=values)
                ]
            )
        )
        return self

    def preferred_node_affinity(
        self, weight: int, key: str, values: List[str]
    ) -> "PodWrapper":
        aff = self._ensure_affinity()
        if aff.node_affinity is None:
            aff.node_affinity = v1.NodeAffinity()
        aff.node_affinity.preferred.append(
            v1.PreferredSchedulingTerm(
                weight=weight,
                preference=v1.NodeSelectorTerm(
                    match_expressions=[
                        v1.NodeSelectorRequirement(
                            key=key, operator=v1.OP_IN, values=values
                        )
                    ]
                ),
            )
        )
        return self

    def pod_affinity(
        self, topology_key: str, labels: Dict[str, str], anti: bool = False,
        weight: Optional[int] = None, namespaces: Optional[List[str]] = None,
    ) -> "PodWrapper":
        """Add a required (weight=None) or preferred pod (anti-)affinity exact-match term."""
        aff = self._ensure_affinity()
        term = v1.PodAffinityTerm(
            label_selector=v1.LabelSelector(match_labels=dict(labels)),
            topology_key=topology_key,
            namespaces=list(namespaces or []),
        )
        target_attr = "pod_anti_affinity" if anti else "pod_affinity"
        pa = getattr(aff, target_attr)
        if pa is None:
            pa = v1.PodAffinity()
            setattr(aff, target_attr, pa)
        if weight is None:
            pa.required.append(term)
        else:
            pa.preferred.append(
                v1.WeightedPodAffinityTerm(weight=weight, pod_affinity_term=term)
            )
        return self

    def toleration(
        self, key: str, value: str = "", effect: str = "",
        operator: str = v1.TOLERATION_OP_EQUAL,
        toleration_seconds: Optional[int] = None,
    ) -> "PodWrapper":
        self._pod.spec.tolerations.append(
            v1.Toleration(key=key, operator=operator, value=value,
                          effect=effect,
                          toleration_seconds=toleration_seconds)
        )
        return self

    def priority(self, p: int) -> "PodWrapper":
        self._pod.spec.priority = p
        return self

    def scheduler_name(self, n: str) -> "PodWrapper":
        self._pod.spec.scheduler_name = n
        return self

    def host_port(self, port: int, protocol: str = "TCP", host_ip: str = "") -> "PodWrapper":
        self._pod.spec.containers[0].ports.append(
            v1.ContainerPort(
                container_port=port, host_port=port, protocol=protocol, host_ip=host_ip
            )
        )
        return self

    def topology_spread(
        self,
        max_skew: int,
        topology_key: str,
        when_unsatisfiable: str = v1.DO_NOT_SCHEDULE,
        labels: Optional[Dict[str, str]] = None,
        min_domains: Optional[int] = None,
    ) -> "PodWrapper":
        self._pod.spec.topology_spread_constraints.append(
            v1.TopologySpreadConstraint(
                max_skew=max_skew,
                topology_key=topology_key,
                when_unsatisfiable=when_unsatisfiable,
                label_selector=v1.LabelSelector(match_labels=dict(labels or {})),
                min_domains=min_domains,
            )
        )
        return self

    def pvc(self, claim_name: str) -> "PodWrapper":
        self._pod.spec.volumes.append(
            v1.Volume(name=f"vol-{claim_name}", pvc_name=claim_name)
        )
        return self

    def claim(self, claim_name: str, name: str = "") -> "PodWrapper":
        """Reference an existing ResourceClaim by object name."""
        self._pod.spec.resource_claims.append(
            v1.PodResourceClaim(name=name or claim_name,
                                resource_claim_name=claim_name)
        )
        return self

    def claim_template(self, template_name: str, name: str = "") -> "PodWrapper":
        """Reference a ResourceClaimTemplate (claim stamped per pod)."""
        self._pod.spec.resource_claims.append(
            v1.PodResourceClaim(name=name or template_name,
                                resource_claim_template_name=template_name)
        )
        return self

    def nominated_node_name(self, n: str) -> "PodWrapper":
        self._pod.status.nominated_node_name = n
        return self

    def terminating(self) -> "PodWrapper":
        self._pod.metadata.deletion_timestamp = 1.0
        return self

    def phase(self, p: str) -> "PodWrapper":
        self._pod.status.phase = p
        return self

    def owner_reference(self, kind: str, name: str, uid: str = "") -> "PodWrapper":
        self._pod.metadata.owner_references.append(
            v1.OwnerReference(kind=kind, name=name, uid=uid or name, controller=True)
        )
        return self

    def _ensure_affinity(self) -> v1.Affinity:
        if self._pod.spec.affinity is None:
            self._pod.spec.affinity = v1.Affinity()
        return self._pod.spec.affinity

    def _require_node_affinity(self) -> v1.NodeSelector:
        aff = self._ensure_affinity()
        if aff.node_affinity is None:
            aff.node_affinity = v1.NodeAffinity()
        if aff.node_affinity.required is None:
            aff.node_affinity.required = v1.NodeSelector()
        return aff.node_affinity.required


class NodeWrapper:
    def __init__(self):
        self._node = v1.Node()
        self.capacity({"cpu": "32", "memory": "64Gi", "pods": "110"})

    def obj(self) -> v1.Node:
        return self._node

    def name(self, n: str) -> "NodeWrapper":
        self._node.metadata.name = n
        # the kubelet labels every node with its hostname on registration
        self._node.metadata.labels.setdefault("kubernetes.io/hostname", n)
        return self

    def label(self, k: str, v: str) -> "NodeWrapper":
        self._node.metadata.labels[k] = v
        return self

    def capacity(self, rl: Dict[str, object]) -> "NodeWrapper":
        self._node.status.capacity = dict(rl)
        self._node.status.allocatable = dict(rl)
        return self

    def allocatable(self, rl: Dict[str, object]) -> "NodeWrapper":
        self._node.status.allocatable = dict(rl)
        return self

    def taint(self, key: str, value: str = "", effect: str = v1.TAINT_NO_SCHEDULE) -> "NodeWrapper":
        self._node.spec.taints.append(v1.Taint(key=key, value=value, effect=effect))
        return self

    def unschedulable(self, u: bool = True) -> "NodeWrapper":
        self._node.spec.unschedulable = u
        return self

    def image(self, name: str, size_bytes: int) -> "NodeWrapper":
        self._node.status.images.append(
            v1.ContainerImage(names=[name], size_bytes=size_bytes)
        )
        return self


def make_pod() -> PodWrapper:
    return PodWrapper()


def make_node() -> NodeWrapper:
    return NodeWrapper()
