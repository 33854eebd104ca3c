"""API object model — the subset of v1.Pod / v1.Node (+ friends) the scheduler reads.

Reference: staging/src/k8s.io/api/core/v1/types.go. Python dataclasses with
k8s-manifest-compatible ``from_dict`` constructors (camelCase keys), so workloads and
componentconfig written for the reference load unchanged. Only fields the scheduling
path consumes are modeled; unknown manifest fields are ignored rather than rejected.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

_uid_counter = itertools.count(1)


def _new_uid() -> str:
    return f"uid-{next(_uid_counter)}"


def _parse_time(v, default=None) -> Optional[float]:
    """Accept epoch numbers or RFC3339 strings ('2026-01-01T00:00:00Z') → epoch float."""
    if v is None:
        return default
    if isinstance(v, (int, float)):
        return float(v)
    from datetime import datetime

    s = str(v).replace("Z", "+00:00")
    return datetime.fromisoformat(s).timestamp()


# --- metadata ---------------------------------------------------------------


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=_new_uid)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = field(default_factory=time.time)
    resource_version: int = 0
    owner_references: List["OwnerReference"] = field(default_factory=list)
    deletion_timestamp: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Mapping) -> "ObjectMeta":
        return cls(
            name=d.get("name", ""),
            namespace=d.get("namespace", "default"),
            uid=d.get("uid") or _new_uid(),
            labels=dict(d.get("labels") or {}),
            annotations=dict(d.get("annotations") or {}),
            creation_timestamp=_parse_time(d.get("creationTimestamp"), time.time()),
            owner_references=[
                OwnerReference.from_dict(o) for o in d.get("ownerReferences") or []
            ],
            deletion_timestamp=_parse_time(d.get("deletionTimestamp")),
        )


@dataclass
class OwnerReference:
    api_version: str = "v1"
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = False

    @classmethod
    def from_dict(cls, d: Mapping) -> "OwnerReference":
        return cls(
            api_version=d.get("apiVersion", "v1"),
            kind=d.get("kind", ""),
            name=d.get("name", ""),
            uid=d.get("uid", ""),
            controller=bool(d.get("controller", False)),
        )


# --- selectors --------------------------------------------------------------

# LabelSelector operators (apimachinery metav1.LabelSelectorOperator).
OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"
# NodeSelector-only operators (core v1.NodeSelectorOperator).
OP_GT = "Gt"
OP_LT = "Lt"


@dataclass
class LabelSelectorRequirement:
    key: str = ""
    operator: str = OP_EXISTS
    values: List[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Mapping) -> "LabelSelectorRequirement":
        return cls(
            key=d.get("key", ""),
            operator=d.get("operator", OP_EXISTS),
            values=[str(v) for v in d.get("values") or []],
        )


@dataclass
class LabelSelector:
    """metav1.LabelSelector: AND of match_labels and match_expressions.

    An empty selector matches everything; None (absent) matches nothing.
    """

    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[LabelSelectorRequirement] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> Optional["LabelSelector"]:
        if d is None:
            return None
        return cls(
            match_labels={k: str(v) for k, v in (d.get("matchLabels") or {}).items()},
            match_expressions=[
                LabelSelectorRequirement.from_dict(e)
                for e in d.get("matchExpressions") or []
            ],
        )


@dataclass
class NodeSelectorRequirement:
    key: str = ""
    operator: str = OP_EXISTS
    values: List[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Mapping) -> "NodeSelectorRequirement":
        return cls(
            key=d.get("key", ""),
            operator=d.get("operator", OP_EXISTS),
            values=[str(v) for v in d.get("values") or []],
        )


@dataclass
class NodeSelectorTerm:
    """OR-ed term; inside a term, expressions AND together (v1.NodeSelectorTerm)."""

    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)
    match_fields: List[NodeSelectorRequirement] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Mapping) -> "NodeSelectorTerm":
        return cls(
            match_expressions=[
                NodeSelectorRequirement.from_dict(e)
                for e in d.get("matchExpressions") or []
            ],
            match_fields=[
                NodeSelectorRequirement.from_dict(e)
                for e in d.get("matchFields") or []
            ],
        )


@dataclass
class NodeSelector:
    node_selector_terms: List[NodeSelectorTerm] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> Optional["NodeSelector"]:
        if d is None:
            return None
        return cls(
            node_selector_terms=[
                NodeSelectorTerm.from_dict(t)
                for t in d.get("nodeSelectorTerms") or []
            ]
        )


@dataclass
class PreferredSchedulingTerm:
    weight: int = 1
    preference: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)

    @classmethod
    def from_dict(cls, d: Mapping) -> "PreferredSchedulingTerm":
        return cls(
            weight=int(d.get("weight", 1)),
            preference=NodeSelectorTerm.from_dict(d.get("preference") or {}),
        )


# --- affinity ---------------------------------------------------------------


@dataclass
class NodeAffinity:
    required: Optional[NodeSelector] = None  # requiredDuringSchedulingIgnoredDuringExecution
    preferred: List[PreferredSchedulingTerm] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> Optional["NodeAffinity"]:
        if d is None:
            return None
        return cls(
            required=NodeSelector.from_dict(
                d.get("requiredDuringSchedulingIgnoredDuringExecution")
            ),
            preferred=[
                PreferredSchedulingTerm.from_dict(t)
                for t in d.get("preferredDuringSchedulingIgnoredDuringExecution") or []
            ],
        )


@dataclass
class PodAffinityTerm:
    label_selector: Optional[LabelSelector] = None
    namespaces: List[str] = field(default_factory=list)
    topology_key: str = ""
    namespace_selector: Optional[LabelSelector] = None

    @classmethod
    def from_dict(cls, d: Mapping) -> "PodAffinityTerm":
        return cls(
            label_selector=LabelSelector.from_dict(d.get("labelSelector")),
            namespaces=[str(n) for n in d.get("namespaces") or []],
            topology_key=d.get("topologyKey", ""),
            namespace_selector=LabelSelector.from_dict(d.get("namespaceSelector")),
        )


@dataclass
class WeightedPodAffinityTerm:
    weight: int = 1
    pod_affinity_term: PodAffinityTerm = field(default_factory=PodAffinityTerm)

    @classmethod
    def from_dict(cls, d: Mapping) -> "WeightedPodAffinityTerm":
        return cls(
            weight=int(d.get("weight", 1)),
            pod_affinity_term=PodAffinityTerm.from_dict(d.get("podAffinityTerm") or {}),
        )


@dataclass
class PodAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> Optional["PodAffinity"]:
        if d is None:
            return None
        return cls(
            required=[
                PodAffinityTerm.from_dict(t)
                for t in d.get("requiredDuringSchedulingIgnoredDuringExecution") or []
            ],
            preferred=[
                WeightedPodAffinityTerm.from_dict(t)
                for t in d.get("preferredDuringSchedulingIgnoredDuringExecution") or []
            ],
        )


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAffinity] = None

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> Optional["Affinity"]:
        if d is None:
            return None
        return cls(
            node_affinity=NodeAffinity.from_dict(d.get("nodeAffinity")),
            pod_affinity=PodAffinity.from_dict(d.get("podAffinity")),
            pod_anti_affinity=PodAffinity.from_dict(d.get("podAntiAffinity")),
        )


# --- taints & tolerations ---------------------------------------------------

TAINT_NO_SCHEDULE = "NoSchedule"
TAINT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
TAINT_NO_EXECUTE = "NoExecute"

TOLERATION_OP_EXISTS = "Exists"
TOLERATION_OP_EQUAL = "Equal"


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = TAINT_NO_SCHEDULE
    # v1.Taint.TimeAdded: set for NoExecute taints by the node lifecycle
    # controller; tolerationSeconds countdowns anchor on it so a controller
    # restart resumes the SAME deadline instead of granting a fresh window
    time_added: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Mapping) -> "Taint":
        return cls(
            key=d.get("key", ""),
            value=str(d.get("value", "")),
            effect=d.get("effect", TAINT_NO_SCHEDULE),
            time_added=_parse_time(d.get("timeAdded")),
        )


@dataclass
class Toleration:
    key: str = ""
    operator: str = TOLERATION_OP_EQUAL
    value: str = ""
    effect: str = ""  # empty matches all effects
    toleration_seconds: Optional[int] = None

    @classmethod
    def from_dict(cls, d: Mapping) -> "Toleration":
        return cls(
            key=d.get("key", ""),
            operator=d.get("operator", TOLERATION_OP_EQUAL),
            value=str(d.get("value", "")),
            effect=d.get("effect", ""),
            toleration_seconds=d.get("tolerationSeconds"),
        )

    def tolerates(self, taint: Taint) -> bool:
        """Reference: component-helpers scheduling/corev1 Toleration.ToleratesTaint."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == TOLERATION_OP_EXISTS:
            return True
        # Equal (default): empty key with Exists already handled; empty key+Equal
        # matches only empty taint key (handled by key check above).
        return self.value == taint.value


# --- topology spread --------------------------------------------------------

DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"


@dataclass
class TopologySpreadConstraint:
    max_skew: int = 1
    topology_key: str = ""
    when_unsatisfiable: str = DO_NOT_SCHEDULE
    label_selector: Optional[LabelSelector] = None
    min_domains: Optional[int] = None

    @classmethod
    def from_dict(cls, d: Mapping) -> "TopologySpreadConstraint":
        return cls(
            max_skew=int(d.get("maxSkew", 1)),
            topology_key=d.get("topologyKey", ""),
            when_unsatisfiable=d.get("whenUnsatisfiable", DO_NOT_SCHEDULE),
            label_selector=LabelSelector.from_dict(d.get("labelSelector")),
            min_domains=d.get("minDomains"),
        )


# --- pod --------------------------------------------------------------------


@dataclass
class ContainerPort:
    container_port: int = 0
    host_port: int = 0
    host_ip: str = ""
    protocol: str = "TCP"

    @classmethod
    def from_dict(cls, d: Mapping) -> "ContainerPort":
        return cls(
            container_port=int(d.get("containerPort", 0)),
            host_port=int(d.get("hostPort", 0)),
            host_ip=d.get("hostIP", ""),
            protocol=d.get("protocol", "TCP"),
        )


@dataclass
class ResourceRequirements:
    requests: Dict[str, object] = field(default_factory=dict)
    limits: Dict[str, object] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> "ResourceRequirements":
        d = d or {}
        return cls(
            requests=dict(d.get("requests") or {}),
            limits=dict(d.get("limits") or {}),
        )


@dataclass
class Container:
    name: str = ""
    image: str = ""
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    ports: List[ContainerPort] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Mapping) -> "Container":
        return cls(
            name=d.get("name", ""),
            image=d.get("image", ""),
            resources=ResourceRequirements.from_dict(d.get("resources")),
            ports=[ContainerPort.from_dict(p) for p in d.get("ports") or []],
        )


@dataclass
class Volume:
    name: str = ""
    pvc_name: Optional[str] = None  # persistentVolumeClaim.claimName
    host_path: Optional[str] = None
    gce_pd_name: Optional[str] = None
    aws_ebs_volume_id: Optional[str] = None

    @classmethod
    def from_dict(cls, d: Mapping) -> "Volume":
        pvc = d.get("persistentVolumeClaim") or {}
        hp = d.get("hostPath") or {}
        gce = d.get("gcePersistentDisk") or {}
        ebs = d.get("awsElasticBlockStore") or {}
        return cls(
            name=d.get("name", ""),
            pvc_name=pvc.get("claimName"),
            host_path=hp.get("path"),
            gce_pd_name=gce.get("pdName"),
            aws_ebs_volume_id=ebs.get("volumeID"),
        )


@dataclass
class PodResourceClaim:
    """spec.resourceClaims entry: a pod-local name bound to either an
    existing ResourceClaim or a ResourceClaimTemplate the claim controller
    stamps a per-pod claim from (resource.k8s.io DRA)."""

    name: str = ""
    resource_claim_name: Optional[str] = None
    resource_claim_template_name: Optional[str] = None

    @classmethod
    def from_dict(cls, d: Mapping) -> "PodResourceClaim":
        return cls(
            name=d.get("name", ""),
            resource_claim_name=d.get("resourceClaimName"),
            resource_claim_template_name=d.get("resourceClaimTemplateName"),
        )


@dataclass
class PodSpec:
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    node_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    priority: int = 0
    priority_class_name: str = ""
    scheduler_name: str = "default-scheduler"
    topology_spread_constraints: List[TopologySpreadConstraint] = field(
        default_factory=list
    )
    overhead: Dict[str, object] = field(default_factory=dict)
    volumes: List[Volume] = field(default_factory=list)
    host_network: bool = False
    preemption_policy: str = "PreemptLowerPriority"  # or "Never"
    resource_claims: List[PodResourceClaim] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Mapping) -> "PodSpec":
        return cls(
            containers=[Container.from_dict(c) for c in d.get("containers") or []],
            init_containers=[
                Container.from_dict(c) for c in d.get("initContainers") or []
            ],
            node_name=d.get("nodeName", ""),
            node_selector={
                k: str(v) for k, v in (d.get("nodeSelector") or {}).items()
            },
            affinity=Affinity.from_dict(d.get("affinity")),
            tolerations=[Toleration.from_dict(t) for t in d.get("tolerations") or []],
            priority=int(d.get("priority", 0)),
            priority_class_name=d.get("priorityClassName", ""),
            scheduler_name=d.get("schedulerName", "default-scheduler"),
            topology_spread_constraints=[
                TopologySpreadConstraint.from_dict(t)
                for t in d.get("topologySpreadConstraints") or []
            ],
            overhead=dict(d.get("overhead") or {}),
            volumes=[Volume.from_dict(v) for v in d.get("volumes") or []],
            host_network=bool(d.get("hostNetwork", False)),
            preemption_policy=d.get("preemptionPolicy", "PreemptLowerPriority"),
            resource_claims=[
                PodResourceClaim.from_dict(c)
                for c in d.get("resourceClaims") or []
            ],
        )


POD_PENDING = "Pending"
POD_RUNNING = "Running"
POD_SUCCEEDED = "Succeeded"
POD_FAILED = "Failed"


@dataclass
class PodStatus:
    phase: str = POD_PENDING
    nominated_node_name: str = ""
    conditions: List[Dict] = field(default_factory=list)
    pod_ip: str = ""

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> "PodStatus":
        d = d or {}
        return cls(
            phase=d.get("phase", POD_PENDING),
            nominated_node_name=d.get("nominatedNodeName", ""),
            conditions=list(d.get("conditions") or []),
            pod_ip=str(d.get("podIP", "")),
        )


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    kind = "Pod"

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def uid(self) -> str:
        return self.metadata.uid

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @classmethod
    def from_dict(cls, d: Mapping) -> "Pod":
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=PodSpec.from_dict(d.get("spec") or {}),
            status=PodStatus.from_dict(d.get("status")),
        )


# --- node -------------------------------------------------------------------


@dataclass
class ContainerImage:
    names: List[str] = field(default_factory=list)
    size_bytes: int = 0

    @classmethod
    def from_dict(cls, d: Mapping) -> "ContainerImage":
        return cls(
            names=[str(n) for n in d.get("names") or []],
            size_bytes=int(d.get("sizeBytes", 0)),
        )


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: List[Taint] = field(default_factory=list)
    pod_cidr: str = ""

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> "NodeSpec":
        d = d or {}
        return cls(
            unschedulable=bool(d.get("unschedulable", False)),
            taints=[Taint.from_dict(t) for t in d.get("taints") or []],
            pod_cidr=d.get("podCIDR", ""),
        )


@dataclass
class NodeStatus:
    capacity: Dict[str, object] = field(default_factory=dict)
    allocatable: Dict[str, object] = field(default_factory=dict)
    images: List[ContainerImage] = field(default_factory=list)
    conditions: List[Dict] = field(default_factory=list)
    # v1.NodeStatus.volumesAttached (AttachedVolume names), maintained by
    # the attach-detach controller (controllers/volumebinder.py)
    volumes_attached: List[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> "NodeStatus":
        d = d or {}
        cap = dict(d.get("capacity") or {})
        alloc = dict(d.get("allocatable") or cap)
        return cls(
            capacity=cap,
            allocatable=alloc,
            images=[ContainerImage.from_dict(i) for i in d.get("images") or []],
            conditions=list(d.get("conditions") or []),
            volumes_attached=[
                (v.get("name") if isinstance(v, Mapping) else str(v))
                for v in d.get("volumesAttached") or []
            ],
        )


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    kind = "Node"

    @property
    def name(self) -> str:
        return self.metadata.name

    @classmethod
    def from_dict(cls, d: Mapping) -> "Node":
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=NodeSpec.from_dict(d.get("spec")),
            status=NodeStatus.from_dict(d.get("status")),
        )


# --- policy / misc objects the scheduler consumes ---------------------------


@dataclass
class PodDisruptionBudget:
    """policy/v1 PDB: spec (minAvailable/maxUnavailable, int or percent) +
    the status the disruption controller maintains and preemption reads
    (pkg/controller/disruption/disruption.go)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    min_available: Optional[object] = None  # int | "NN%" | None
    max_unavailable: Optional[object] = None  # int | "NN%" | None
    # status
    disruptions_allowed: int = 0
    current_healthy: int = 0
    desired_healthy: int = 0
    expected_pods: int = 0

    kind = "PodDisruptionBudget"

    @classmethod
    def from_dict(cls, d: Mapping) -> "PodDisruptionBudget":
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            selector=LabelSelector.from_dict(spec.get("selector")),
            min_available=spec.get("minAvailable"),
            max_unavailable=spec.get("maxUnavailable"),
            disruptions_allowed=int(status.get("disruptionsAllowed", 0)),
            current_healthy=int(status.get("currentHealthy", 0)),
            desired_healthy=int(status.get("desiredHealthy", 0)),
            expected_pods=int(status.get("expectedPods", 0)),
        )


@dataclass
class Eviction:
    """policy/v1 Eviction — the pods/{name}/eviction subresource body.

    Reference: staging/src/k8s.io/api/policy/v1/types.go Eviction.  The
    metadata names the pod to evict; deleteOptions passes through to the
    delete (only gracePeriodSeconds is modeled — the sim terminates pods
    instantly either way).  Handled by descheduler/evictions.py (the gate)
    and served at POST pods/{name}/eviction by the apiserver (429
    TooManyRequests when a matching PDB has no budget, exactly the
    reference handler's contract)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    grace_period_seconds: Optional[int] = None  # deleteOptions.gracePeriodSeconds

    kind = "Eviction"

    @classmethod
    def from_dict(cls, d: Mapping) -> "Eviction":
        opts = d.get("deleteOptions") or {}
        # both the wire form (deleteOptions.gracePeriodSeconds) and the
        # generic serializer's flat camelCase field round-trip
        gps = opts.get("gracePeriodSeconds", d.get("gracePeriodSeconds"))
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            grace_period_seconds=(None if gps is None else int(gps)),
        )


# PodGroup phases (the coscheduling CRD's PodGroupStatus.Phase subset the
# gang subsystem drives; see the JAX package's gang/).
POD_GROUP_PENDING = "Pending"
POD_GROUP_SCHEDULING = "Scheduling"
POD_GROUP_SCHEDULED = "Scheduled"
POD_GROUP_UNSCHEDULABLE = "Unschedulable"


@dataclass
class PodGroup:
    """scheduling.x-k8s.io/v1alpha1 PodGroup — the gang-scheduling unit.

    Reference: sigs.k8s.io/scheduler-plugins apis/scheduling/v1alpha1
    (PodGroupSpec.MinMember / ScheduleTimeoutSeconds, PodGroupStatus.Phase).
    Pods join a group via the ``pod-group.scheduling/name`` label
    (gang.POD_GROUP_LABEL); the group schedules all-or-nothing once at
    least ``min_member`` members exist.
    """

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    min_member: int = 1
    schedule_timeout_seconds: Optional[int] = None  # None → subsystem default
    phase: str = POD_GROUP_PENDING  # status.phase

    kind = "PodGroup"

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @classmethod
    def from_dict(cls, d: Mapping) -> "PodGroup":
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        sts = spec.get("scheduleTimeoutSeconds")
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            min_member=int(spec.get("minMember", 1)),
            schedule_timeout_seconds=(None if sts is None else int(sts)),
            phase=status.get("phase", POD_GROUP_PENDING),
        )


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    volume_name: str = ""
    storage_class_name: Optional[str] = None
    phase: str = "Pending"  # Bound once volume_name set
    requested_storage: object = 0  # spec.resources.requests.storage quantity
    access_modes: List[str] = field(default_factory=list)

    kind = "PersistentVolumeClaim"

    @classmethod
    def from_dict(cls, d: Mapping) -> "PersistentVolumeClaim":
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            volume_name=spec.get("volumeName", ""),
            storage_class_name=spec.get("storageClassName"),
            phase=status.get("phase", "Pending"),
            requested_storage=((spec.get("resources") or {}).get("requests") or {}).get("storage", 0),
            access_modes=[str(x) for x in spec.get("accessModes") or []],
        )


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    capacity: Dict[str, object] = field(default_factory=dict)
    node_affinity: Optional[NodeSelector] = None
    storage_class_name: str = ""
    claim_ref: Optional[str] = None  # "namespace/name" of the bound PVC
    access_modes: List[str] = field(default_factory=list)

    kind = "PersistentVolume"

    @classmethod
    def from_dict(cls, d: Mapping) -> "PersistentVolume":
        spec = d.get("spec") or {}
        na = (spec.get("nodeAffinity") or {}).get("required")
        cr = spec.get("claimRef") or {}
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            capacity=dict(spec.get("capacity") or {}),
            node_affinity=NodeSelector.from_dict(na),
            storage_class_name=spec.get("storageClassName", ""),
            claim_ref=(
                f"{cr.get('namespace', '')}/{cr.get('name', '')}" if cr else None
            ),
            access_modes=[str(x) for x in spec.get("accessModes") or []],
        )


@dataclass
class PriorityClass:
    """scheduling.k8s.io/v1 PriorityClass — resolved into pod.spec.priority at
    admission (the reference's Priority admission plugin)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: bool = False
    preemption_policy: str = "PreemptLowerPriority"

    kind = "PriorityClass"

    @classmethod
    def from_dict(cls, d: Mapping) -> "PriorityClass":
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            value=int(d.get("value", 0)),
            global_default=bool(d.get("globalDefault", False)),
            preemption_policy=d.get("preemptionPolicy", "PreemptLowerPriority"),
        )


VOLUME_BINDING_IMMEDIATE = "Immediate"
VOLUME_BINDING_WAIT = "WaitForFirstConsumer"


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    volume_binding_mode: str = VOLUME_BINDING_IMMEDIATE
    provisioner: str = ""
    # storagev1 AllowedTopologies ([]TopologySelectorTerm): terms OR, a
    # term's matchLabelExpressions AND — exactly NodeSelector semantics with
    # In operators, so it is modeled as one (used by topology-aware dynamic
    # provisioning, volumebinding/binder.go checkVolumeProvisions)
    allowed_topologies: Optional[NodeSelector] = None

    kind = "StorageClass"

    @classmethod
    def from_dict(cls, d: Mapping) -> "StorageClass":
        terms = []
        for t in d.get("allowedTopologies") or []:
            reqs = [
                NodeSelectorRequirement(
                    key=e.get("key", ""), operator=OP_IN,
                    values=[str(v) for v in e.get("values") or []],
                )
                for e in t.get("matchLabelExpressions") or []
            ]
            terms.append(NodeSelectorTerm(match_expressions=reqs))
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            volume_binding_mode=d.get("volumeBindingMode", VOLUME_BINDING_IMMEDIATE),
            provisioner=d.get("provisioner", ""),
            allowed_topologies=NodeSelector(node_selector_terms=terms) if terms else None,
        )


@dataclass
class CSINode:
    """storage.k8s.io/v1 CSINode — per-driver attach limits the scheduler reads."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    driver_limits: Dict[str, int] = field(default_factory=dict)  # driver → count

    kind = "CSINode"

    @classmethod
    def from_dict(cls, d: Mapping) -> "CSINode":
        spec = d.get("spec") or {}
        limits = {}
        for drv in spec.get("drivers") or []:
            alloc = drv.get("allocatable") or {}
            if "count" in alloc:
                limits[drv.get("name", "")] = int(alloc["count"])
        return cls(metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
                   driver_limits=limits)


@dataclass
class Service:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Dict[str, str] = field(default_factory=dict)

    kind = "Service"

    @classmethod
    def from_dict(cls, d: Mapping) -> "Service":
        spec = d.get("spec") or {}
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            selector={k: str(v) for k, v in (spec.get("selector") or {}).items()},
        )


@dataclass
class PodTemplateSpec:
    """spec.template of workload controllers."""

    labels: Dict[str, str] = field(default_factory=dict)
    spec: PodSpec = field(default_factory=PodSpec)

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> "PodTemplateSpec":
        d = d or {}
        meta = d.get("metadata") or {}
        return cls(
            labels=dict(meta.get("labels") or {}),
            spec=PodSpec.from_dict(d.get("spec") or {}),
        )


@dataclass
class ReplicaSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    replicas: int = 1
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    status_replicas: int = 0
    status_ready_replicas: int = 0

    kind = "ReplicaSet"

    @classmethod
    def from_dict(cls, d: Mapping) -> "ReplicaSet":
        spec = d.get("spec") or {}
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            selector=LabelSelector.from_dict(spec.get("selector")),
            replicas=int(spec.get("replicas", 1)),
            template=PodTemplateSpec.from_dict(spec.get("template")),
        )


@dataclass
class Deployment:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    replicas: int = 1
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    status_updated_replicas: int = 0

    kind = "Deployment"

    @classmethod
    def from_dict(cls, d: Mapping) -> "Deployment":
        spec = d.get("spec") or {}
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            selector=LabelSelector.from_dict(spec.get("selector")),
            replicas=int(spec.get("replicas", 1)),
            template=PodTemplateSpec.from_dict(spec.get("template")),
        )


@dataclass
class StatefulSet:
    """apps/v1 StatefulSet — ordered, stable-identity replicas
    (pkg/controller/statefulset)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    replicas: int = 1
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    status_replicas: int = 0
    status_ready_replicas: int = 0

    kind = "StatefulSet"

    @classmethod
    def from_dict(cls, d: Mapping) -> "StatefulSet":
        spec = d.get("spec") or {}
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            selector=LabelSelector.from_dict(spec.get("selector")),
            replicas=int(spec.get("replicas", 1)),
            template=PodTemplateSpec.from_dict(spec.get("template")),
        )


@dataclass
class DaemonSet:
    """apps/v1 DaemonSet — one pod per (eligible) node (pkg/controller/daemon)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    status_desired: int = 0
    status_current: int = 0

    kind = "DaemonSet"

    @classmethod
    def from_dict(cls, d: Mapping) -> "DaemonSet":
        spec = d.get("spec") or {}
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            selector=LabelSelector.from_dict(spec.get("selector")),
            template=PodTemplateSpec.from_dict(spec.get("template")),
        )


@dataclass
class Job:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    completions: int = 1
    parallelism: int = 1
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    status_succeeded: int = 0
    status_active: int = 0
    completed: bool = False
    # batch/v1 JobSpec.ttlSecondsAfterFinished + JobStatus.completionTime
    # (consumed by the TTL-after-finished controller)
    ttl_seconds_after_finished: Optional[int] = None
    completion_time: Optional[float] = None

    kind = "Job"

    @classmethod
    def from_dict(cls, d: Mapping) -> "Job":
        spec = d.get("spec") or {}
        ttl = spec.get("ttlSecondsAfterFinished")
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            completions=int(spec.get("completions", 1)),
            parallelism=int(spec.get("parallelism", 1)),
            template=PodTemplateSpec.from_dict(spec.get("template")),
            ttl_seconds_after_finished=(None if ttl is None else int(ttl)),
        )


@dataclass
class Namespace:
    """core/v1 Namespace (reference: pkg/apis/core/types.go Namespace;
    deletion semantics in pkg/controller/namespace)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    finalizers: List[str] = field(default_factory=lambda: ["kubernetes"])
    status_phase: str = "Active"  # Active | Terminating

    kind = "Namespace"

    @classmethod
    def from_dict(cls, d: Mapping) -> "Namespace":
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            finalizers=[str(f) for f in (spec.get("finalizers")
                                         or ["kubernetes"])],
            status_phase=str(status.get("phase", "Active")),
        )


@dataclass
class ResourceQuota:
    """core/v1 ResourceQuota: spec.hard limits; status mirrors hard + observed
    used (reference: pkg/apis/core/types.go ResourceQuota; controller at
    pkg/controller/resourcequota)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    hard: Dict[str, str] = field(default_factory=dict)
    status_hard: Dict[str, str] = field(default_factory=dict)
    status_used: Dict[str, str] = field(default_factory=dict)

    kind = "ResourceQuota"

    @classmethod
    def from_dict(cls, d: Mapping) -> "ResourceQuota":
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            hard={k: str(v) for k, v in (spec.get("hard") or {}).items()},
            status_hard={k: str(v)
                         for k, v in (status.get("hard") or {}).items()},
            status_used={k: str(v)
                         for k, v in (status.get("used") or {}).items()},
        )


@dataclass
class EndpointAddress:
    ip: str = ""
    node_name: str = ""
    target_name: str = ""  # backing pod's name (targetRef)

    @classmethod
    def from_dict(cls, d: Mapping) -> "EndpointAddress":
        ref = d.get("targetRef") or {}
        return cls(
            ip=str(d.get("ip", "")),
            node_name=str(d.get("nodeName", "")),
            target_name=str(ref.get("name", "")),
        )


@dataclass
class EndpointSubset:
    addresses: List[EndpointAddress] = field(default_factory=list)
    not_ready_addresses: List[EndpointAddress] = field(default_factory=list)
    ports: List[int] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Mapping) -> "EndpointSubset":
        return cls(
            addresses=[EndpointAddress.from_dict(a)
                       for a in d.get("addresses") or []],
            not_ready_addresses=[EndpointAddress.from_dict(a)
                                 for a in d.get("notReadyAddresses") or []],
            ports=[int(p.get("port", 0)) if isinstance(p, Mapping) else int(p)
                   for p in d.get("ports") or []],
        )


@dataclass
class Endpoints:
    """core/v1 Endpoints (reference: pkg/controller/endpoint)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    subsets: List[EndpointSubset] = field(default_factory=list)

    kind = "Endpoints"

    @classmethod
    def from_dict(cls, d: Mapping) -> "Endpoints":
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            subsets=[EndpointSubset.from_dict(s)
                     for s in d.get("subsets") or []],
        )


@dataclass
class Endpoint:
    """discovery/v1 Endpoint (one entry of an EndpointSlice)."""

    addresses: List[str] = field(default_factory=list)
    ready: bool = True
    node_name: str = ""
    target_name: str = ""

    @classmethod
    def from_dict(cls, d: Mapping) -> "Endpoint":
        cond = d.get("conditions") or {}
        ref = d.get("targetRef") or {}
        return cls(
            addresses=[str(a) for a in d.get("addresses") or []],
            ready=bool(cond.get("ready", True)),
            node_name=str(d.get("nodeName", "")),
            target_name=str(ref.get("name", "")),
        )


@dataclass
class EndpointSlice:
    """discovery/v1 EndpointSlice, ≤100 endpoints per slice (reference:
    pkg/controller/endpointslice; maxEndpointsPerSlice default)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    address_type: str = "IPv4"
    endpoints: List[Endpoint] = field(default_factory=list)
    ports: List[int] = field(default_factory=list)

    kind = "EndpointSlice"

    @classmethod
    def from_dict(cls, d: Mapping) -> "EndpointSlice":
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            address_type=str(d.get("addressType", "IPv4")),
            endpoints=[Endpoint.from_dict(e)
                       for e in d.get("endpoints") or []],
            ports=[int(p.get("port", 0)) if isinstance(p, Mapping) else int(p)
                   for p in d.get("ports") or []],
        )


@dataclass
class CronJob:
    """batch/v1 CronJob (reference: pkg/apis/batch/types.go CronJobSpec;
    controller at pkg/controller/cronjob)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    schedule: str = "* * * * *"
    suspend: bool = False
    concurrency_policy: str = "Allow"  # Allow | Forbid | Replace
    starting_deadline_seconds: Optional[int] = None
    job_template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    job_completions: int = 1
    job_parallelism: int = 1
    last_schedule_time: Optional[float] = None

    kind = "CronJob"

    @classmethod
    def from_dict(cls, d: Mapping) -> "CronJob":
        spec = d.get("spec") or {}
        jt = (spec.get("jobTemplate") or {}).get("spec") or {}
        sd = spec.get("startingDeadlineSeconds")
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            schedule=str(spec.get("schedule", "* * * * *")),
            suspend=bool(spec.get("suspend", False)),
            concurrency_policy=str(spec.get("concurrencyPolicy", "Allow")),
            starting_deadline_seconds=(None if sd is None else int(sd)),
            job_template=PodTemplateSpec.from_dict(jt.get("template")),
            job_completions=int(jt.get("completions", 1)),
            job_parallelism=int(jt.get("parallelism", 1)),
        )


@dataclass
class ServiceAccount:
    """core/v1 ServiceAccount (reference: pkg/controller/serviceaccount
    ensures 'default' per namespace)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    secrets: List[str] = field(default_factory=list)

    kind = "ServiceAccount"

    @classmethod
    def from_dict(cls, d: Mapping) -> "ServiceAccount":
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            secrets=[str(s) for s in d.get("secrets") or []],
        )


def node_is_ready(node: Node) -> bool:
    """Ready unless the Ready condition says "False"/"Unknown".

    A node with NO Ready condition counts ready: hand-built test nodes and
    freshly-registered kubelets haven't reported yet, and treating them as
    dead would mask the whole cluster before the first heartbeat (the
    lifecycle controller only ever writes Unknown for nodes whose LEASE
    went stale)."""
    for c in node.status.conditions:
        if c.get("type") == "Ready":
            return c.get("status") not in ("False", "Unknown")
    return True


def is_pod_terminating(pod: Pod) -> bool:
    return pod.metadata.deletion_timestamp is not None


def is_pod_terminal(pod: Pod) -> bool:
    return pod.status.phase in (POD_SUCCEEDED, POD_FAILED)
