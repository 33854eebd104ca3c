"""resource.k8s.io API objects: the DRA kind family.

A copy of the JAX package's dra/api.py (the port imports nothing of it).

Reference: staging/src/k8s.io/api/resource/v1alpha2 —
  - DeviceClass: admin-curated selector over device attributes (the
    structured-parameters "class" every request names);
  - ResourceSlice: a driver's per-node device inventory publication
    (named devices + attributes: slice, host, chip index, memory);
  - ResourceClaim: a user's request for devices, carrying the allocation
    result (node + named devices) once the scheduler decides;
  - ResourceClaimTemplate: per-pod claim stamping source (the claim
    controller creates one ResourceClaim per referencing pod).

Device identity is ``"<pool>/<device-name>"`` — pool is the ResourceSlice
name, which for TPU inventories is the slice the chips belong to, so an
allocated device string pins (slice, chip) exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

from ..api.objects import ObjectMeta

# claim lifecycle (status.state): Pending → Allocated (devices + node
# written by the scheduler's PreBind) → Reserved (consumed by a running
# pod).  Deallocation returns the claim to Pending with an empty result.
CLAIM_PENDING = "Pending"
CLAIM_ALLOCATED = "Allocated"
CLAIM_RESERVED = "Reserved"

# well-known device attribute keys published by the TPU driver
ATTR_SLICE = "slice"
ATTR_HOST = "host"
ATTR_CHIP_INDEX = "chipIndex"
ATTR_MEMORY = "memoryGiB"


@dataclass
class Device:
    """One named device in a ResourceSlice (resource.k8s.io BasicDevice)."""

    name: str = ""
    attributes: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Mapping) -> "Device":
        return cls(
            name=d.get("name", ""),
            attributes={k: str(v) for k, v in (d.get("attributes") or {}).items()},
        )


@dataclass
class DeviceClass:
    """Selector over device attributes; requests name a class, the
    allocator admits only devices whose attributes match every selector
    entry (CEL structured parameters collapsed to equality matching)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selectors: Dict[str, str] = field(default_factory=dict)

    kind = "DeviceClass"

    @property
    def name(self) -> str:
        return self.metadata.name

    def key(self) -> str:
        return self.metadata.name

    def matches(self, device: Device) -> bool:
        return all(
            device.attributes.get(k) == v for k, v in self.selectors.items()
        )

    @classmethod
    def from_dict(cls, d: Mapping) -> "DeviceClass":
        spec = d.get("spec") or {}
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            selectors={
                k: str(v) for k, v in (spec.get("selectors") or {}).items()
            },
        )


@dataclass
class ResourceSlice:
    """A node's published device inventory.  ``pool`` is the TPU slice the
    devices belong to (upstream's pool concept specialized: one pool per
    slice, sliced across its member hosts' ResourceSlices)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    node_name: str = ""
    pool: str = ""
    driver: str = "tpu.kubernetes.io"
    devices: List[Device] = field(default_factory=list)

    kind = "ResourceSlice"

    @property
    def name(self) -> str:
        return self.metadata.name

    def key(self) -> str:
        return self.metadata.name

    @classmethod
    def from_dict(cls, d: Mapping) -> "ResourceSlice":
        spec = d.get("spec") or {}
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            node_name=spec.get("nodeName", ""),
            pool=(spec.get("pool") or {}).get("name", ""),
            driver=spec.get("driver", "tpu.kubernetes.io"),
            devices=[Device.from_dict(x) for x in spec.get("devices") or []],
        )


@dataclass
class DeviceRequest:
    """spec.devices.requests[0] collapsed: one request per claim (the
    exactly-one-request shape every TPU workload uses)."""

    name: str = "devices"
    device_class_name: str = ""
    count: int = 1

    @classmethod
    def from_dict(cls, d: Mapping) -> "DeviceRequest":
        return cls(
            name=d.get("name", "devices"),
            device_class_name=d.get("deviceClassName", ""),
            count=int(d.get("count", 1)),
        )


@dataclass
class ResourceClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    request: DeviceRequest = field(default_factory=DeviceRequest)
    # status.allocation — written atomically by PreBind, cleared on
    # deallocation; devices are "<pool>/<device-name>" strings
    state: str = CLAIM_PENDING
    allocated_node: str = ""
    allocated_devices: List[str] = field(default_factory=list)
    reserved_for: str = ""  # consuming pod uid (status.reservedFor)

    kind = "ResourceClaim"

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @classmethod
    def from_dict(cls, d: Mapping) -> "ResourceClaim":
        spec = d.get("spec") or {}
        reqs = (spec.get("devices") or {}).get("requests") or []
        status = d.get("status") or {}
        alloc = status.get("allocation") or {}
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            request=(DeviceRequest.from_dict(reqs[0]) if reqs
                     else DeviceRequest()),
            state=status.get("state", CLAIM_PENDING),
            allocated_node=alloc.get("nodeName", ""),
            allocated_devices=[str(x) for x in alloc.get("devices") or []],
            reserved_for=status.get("reservedFor", ""),
        )


@dataclass
class ResourceClaimTemplate:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    request: DeviceRequest = field(default_factory=DeviceRequest)

    kind = "ResourceClaimTemplate"

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @classmethod
    def from_dict(cls, d: Mapping) -> "ResourceClaimTemplate":
        spec = (d.get("spec") or {}).get("spec") or {}
        reqs = (spec.get("devices") or {}).get("requests") or []
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            request=(DeviceRequest.from_dict(reqs[0]) if reqs
                     else DeviceRequest()),
        )


def stamped_claim_name(pod_name: str, podclaim_name: str) -> str:
    """Deterministic name for a template-stamped claim: idempotent across
    controller restarts (the reference uses generateName + an owner-ref
    lookup; a deterministic name gives the same exactly-once property
    without a list scan)."""
    return f"{pod_name}-{podclaim_name}"


def pod_claim_names(pod) -> List[Optional[str]]:
    """ResourceClaim object names a pod references, in spec order.
    Template references resolve to the stamped name; a malformed entry
    (neither claim nor template) yields None so callers can fail the pod
    rather than silently skip it."""
    out: List[Optional[str]] = []
    for pc in getattr(pod.spec, "resource_claims", []) or []:
        if pc.resource_claim_name:
            out.append(pc.resource_claim_name)
        elif pc.resource_claim_template_name:
            out.append(stamped_claim_name(pod.metadata.name, pc.name))
        else:
            out.append(None)
    return out
