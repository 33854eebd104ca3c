"""Resource quantity parsing and the scheduler's int64 resource vector.

Reference semantics: apimachinery's ``resource.Quantity`` (suffix grammar) and the
scheduler's ``framework.Resource`` struct (reference
``pkg/scheduler/framework/types.go:416-425``): MilliCPU, Memory, EphemeralStorage,
AllowedPodNumber, plus a map of scalar/extended resources. All values are held as
int64 — milli-units for CPU and HugePages-compatible integer units elsewhere — so
device tensors can be exact int64/float64 vectors.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from decimal import Decimal
from typing import Dict, Mapping, Optional

# Canonical resource names (reference: pkg/apis/core/types.go ResourceName consts).
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"
HUGEPAGES_PREFIX = "hugepages-"
ATTACHABLE_VOLUMES_PREFIX = "attachable-volumes-"

DEFAULT_MILLI_CPU_REQUEST = 100  # 0.1 core — reference pkg/scheduler/util/pod_resources.go
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024  # 200 MB

_BIN_SUFFIX = {
    "Ki": Decimal(1024),
    "Mi": Decimal(1024**2),
    "Gi": Decimal(1024**3),
    "Ti": Decimal(1024**4),
    "Pi": Decimal(1024**5),
    "Ei": Decimal(1024**6),
}
_DEC_SUFFIX = {
    "n": Decimal("1e-9"),
    "u": Decimal("1e-6"),
    "m": Decimal("1e-3"),
    "": Decimal(1),
    "k": Decimal("1e3"),
    "M": Decimal("1e6"),
    "G": Decimal("1e9"),
    "T": Decimal("1e12"),
    "P": Decimal("1e15"),
    "E": Decimal("1e18"),
}

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>\d+(?:\.\d*)?|\.\d+)(?:[eE](?P<exp>[+-]?\d+))?"
    r"(?P<suffix>Ki|Mi|Gi|Ti|Pi|Ei|n|u|m|k|M|G|T|P|E)?$"
)


def parse_quantity_exact(s) -> Decimal:
    """Parse a Kubernetes quantity string ('100m', '2Gi', '1.5', '2e3') exactly.

    Decimal arithmetic matches apimachinery resource.Quantity (which is
    inf.Dec-backed) — float rounding would inflate values like '9m' under
    MilliValue's round-up. Accepts ints/floats pass-through for convenience when
    building synthetic objects.
    """
    if isinstance(s, int):
        return Decimal(s)
    if isinstance(s, float):
        return Decimal(repr(s))
    return _parse_quantity_str(str(s).strip())


from functools import lru_cache as _lru_cache


@_lru_cache(maxsize=8192)
def _parse_quantity_str(s: str) -> Decimal:
    """Cached string→Decimal core: quantity strings repeat massively ("1",
    "2Gi", "100m"…) and preemption dry-runs re-derive pod requests per
    candidate — this was 385k regex parses in one profiled cycle.  Decimal
    is immutable, so sharing results is safe."""
    m = _QUANTITY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity: {s!r}")
    value = Decimal(m.group("sign") + m.group("num"))
    if m.group("exp"):
        value = value.scaleb(int(m.group("exp")))
    suffix = m.group("suffix") or ""
    if suffix in _BIN_SUFFIX:
        value *= _BIN_SUFFIX[suffix]
    else:
        value *= _DEC_SUFFIX[suffix]
    return value


def parse_quantity(s) -> float:
    """Quantity → float (convenience; use the *_milli/_int exact paths for accounting)."""
    return float(parse_quantity_exact(s))


def _ceil_decimal(v: Decimal) -> int:
    iv = int(v)
    return iv if iv == v or v < 0 else iv + 1


def quantity_to_milli(s) -> int:
    """Quantity → integer milli-units (ceil, matching Quantity.MilliValue rounding up)."""
    return _ceil_decimal(parse_quantity_exact(s) * 1000)


def quantity_to_int(s) -> int:
    """Quantity → integer units (ceil for fractional, e.g. '1.5Gi' of memory)."""
    return _ceil_decimal(parse_quantity_exact(s))


def is_scalar_resource_name(name: str) -> bool:
    """Extended/scalar resources tracked in the ScalarResources map.

    Reference: pkg/scheduler/framework/types.go:518-536 (Add switch default) and
    helper.IsScalarResourceName.
    """
    return name not in (CPU, MEMORY, EPHEMERAL_STORAGE, PODS)


@dataclass
class Resource:
    """int64 resource vector (reference pkg/scheduler/framework/types.go:416-425)."""

    milli_cpu: int = 0
    memory: int = 0
    ephemeral_storage: int = 0
    allowed_pod_number: int = 0
    scalar_resources: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def from_resource_list(cls, rl: Optional[Mapping[str, object]]) -> "Resource":
        """Build from a k8s ResourceList mapping (reference types.go:446-466 Add)."""
        r = cls()
        r.add_resource_list(rl)
        return r

    def add_resource_list(self, rl: Optional[Mapping[str, object]]) -> None:
        if not rl:
            return
        for name, q in rl.items():
            if name == CPU:
                self.milli_cpu += quantity_to_milli(q)
            elif name == MEMORY:
                self.memory += quantity_to_int(q)
            elif name == EPHEMERAL_STORAGE:
                self.ephemeral_storage += quantity_to_int(q)
            elif name == PODS:
                self.allowed_pod_number += quantity_to_int(q)
            else:
                self.scalar_resources[name] = self.scalar_resources.get(
                    name, 0
                ) + quantity_to_int(q)

    def set_max_resource_list(self, rl: Optional[Mapping[str, object]]) -> None:
        """Per-dimension max — used for initContainers (reference types.go:470-490)."""
        if not rl:
            return
        for name, q in rl.items():
            if name == CPU:
                self.milli_cpu = max(self.milli_cpu, quantity_to_milli(q))
            elif name == MEMORY:
                self.memory = max(self.memory, quantity_to_int(q))
            elif name == EPHEMERAL_STORAGE:
                self.ephemeral_storage = max(
                    self.ephemeral_storage, quantity_to_int(q)
                )
            elif name == PODS:
                self.allowed_pod_number = max(
                    self.allowed_pod_number, quantity_to_int(q)
                )
            else:
                self.scalar_resources[name] = max(
                    self.scalar_resources.get(name, 0), quantity_to_int(q)
                )

    def add(self, other: "Resource") -> "Resource":
        self.milli_cpu += other.milli_cpu
        self.memory += other.memory
        self.ephemeral_storage += other.ephemeral_storage
        self.allowed_pod_number += other.allowed_pod_number
        for k, v in other.scalar_resources.items():
            self.scalar_resources[k] = self.scalar_resources.get(k, 0) + v
        return self

    def sub(self, other: "Resource") -> "Resource":
        self.milli_cpu -= other.milli_cpu
        self.memory -= other.memory
        self.ephemeral_storage -= other.ephemeral_storage
        self.allowed_pod_number -= other.allowed_pod_number
        for k, v in other.scalar_resources.items():
            self.scalar_resources[k] = self.scalar_resources.get(k, 0) - v
        return self

    def clone(self) -> "Resource":
        return Resource(
            milli_cpu=self.milli_cpu,
            memory=self.memory,
            ephemeral_storage=self.ephemeral_storage,
            allowed_pod_number=self.allowed_pod_number,
            scalar_resources=dict(self.scalar_resources),
        )

    def get(self, name: str) -> int:
        if name == CPU:
            return self.milli_cpu
        if name == MEMORY:
            return self.memory
        if name == EPHEMERAL_STORAGE:
            return self.ephemeral_storage
        if name == PODS:
            return self.allowed_pod_number
        return self.scalar_resources.get(name, 0)

    def resource_names(self):
        names = [CPU, MEMORY, EPHEMERAL_STORAGE, PODS]
        names.extend(self.scalar_resources.keys())
        return names


def compute_pod_resource_request(pod) -> Resource:
    """Total request = max(sum(app containers), max(init containers)) + overhead.

    Reference: pkg/scheduler/framework/plugins/noderesources/fit.go:162-178
    (computePodResourceRequest) and types.go CalculateResource.

    Cached per pod object: NodeInfo add/remove/clone in preemption dry-runs
    re-derive the same pod's vector hundreds of times per scheduling attempt.
    The cache is keyed on a cheap fingerprint of the resource lists (not
    object identity alone), so in-place mutation of container resources —
    testutil builders and direct spec edits — invalidates it instead of
    silently serving stale vectors.
    """
    cached = getattr(pod, "_cached_resource_request", None)
    if cached is not None:
        # identity fast path: the request-dict objects themselves unchanged
        # (the hot case — preemption dry-runs call this hundreds of times per
        # attempt); fall back to the content fingerprint only on identity
        # miss, so in-place dict mutation still invalidates
        if _identity_match(cached[0], _resource_identity(pod)) or \
                cached[1] == _resource_fingerprint(pod):
            return cached[2]
    fp = _resource_fingerprint(pod)
    r = _compute_pod_resource_request(pod)
    try:
        pod._cached_resource_request = (_resource_identity(pod), fp, r)
    except (AttributeError, TypeError):
        pass  # __slots__/frozen pod stand-ins can't carry the cache
    return r


def _resource_identity(pod) -> tuple:
    """Object identities of everything the request computation reads.  All
    in-repo mutation paths REPLACE these dicts (testutil ``.req()`` assigns a
    fresh dict; store updates replace whole objects), so an identity match
    means unchanged content without paying the per-call fingerprint.  Code
    that mutates a requests dict's VALUES in place must replace the dict (or
    delete ``pod._cached_resource_request``) — same contract as the
    reference's immutable-spec assumption, but enforced at dict granularity.

    Holds the dict OBJECTS (matched via ``is``), not bare ``id()`` values: a
    cached id of a freed dict could be reused by a new dict with different
    content, serving a stale Resource; live references make reuse impossible.
    """
    return (
        tuple(c.resources.requests for c in pod.spec.containers),
        tuple(c.resources.requests for c in pod.spec.init_containers),
        pod.spec.overhead,
    )


def _identity_match(a: tuple, b: tuple) -> bool:
    """Element-wise ``is`` over two _resource_identity tuples."""
    ca, ia, oa = a
    cb, ib, ob = b
    return (
        oa is ob
        and len(ca) == len(cb) and all(x is y for x, y in zip(ca, cb))
        and len(ia) == len(ib) and all(x is y for x, y in zip(ia, ib))
    )


def _resource_fingerprint(pod) -> tuple:
    """Cheap content hash of everything _compute_pod_resource_request reads:
    container/initContainer request lists + overhead.  One pass over small
    dicts — far cheaper than re-parsing quantity strings."""
    return (
        tuple(tuple(sorted((c.resources.requests or {}).items()))
              for c in pod.spec.containers),
        tuple(tuple(sorted((c.resources.requests or {}).items()))
              for c in pod.spec.init_containers),
        tuple(sorted((pod.spec.overhead or {}).items())),
    )


def _compute_pod_resource_request(pod) -> Resource:
    r = Resource()
    for c in pod.spec.containers:
        r.add_resource_list(c.resources.requests)
    for c in pod.spec.init_containers:
        r.set_max_resource_list(c.resources.requests)
    if pod.spec.overhead:
        r.add_resource_list(pod.spec.overhead)
    return r


def compute_pod_resource_request_non_zero(pod) -> Resource:
    """Like compute_pod_resource_request but with cpu/memory floors for scoring
    (cached per pod object like compute_pod_resource_request).

    Reference: pkg/scheduler/util/pod_resources.go GetNonzeroRequests — pods with no
    request are treated as 100m CPU / 200MB memory so spreading still works — and
    pkg/scheduler/framework/types.go:738-746 (calculateResource adds pod overhead to
    the non-zero cpu/memory totals too).
    """
    cached = getattr(pod, "_cached_resource_request_nz", None)
    if cached is not None:
        if _identity_match(cached[0], _resource_identity(pod)) or \
                cached[1] == _resource_fingerprint(pod):
            return cached[2]
    r = _compute_pod_resource_request_non_zero(pod)
    try:
        pod._cached_resource_request_nz = (
            _resource_identity(pod), _resource_fingerprint(pod), r
        )
    except (AttributeError, TypeError):
        pass  # __slots__/frozen pod stand-ins can't carry the cache
    return r


def _compute_pod_resource_request_non_zero(pod) -> Resource:
    r = Resource()
    for c in pod.spec.containers:
        req = dict(c.resources.requests or {})
        if CPU not in req:
            req[CPU] = f"{DEFAULT_MILLI_CPU_REQUEST}m"
        if MEMORY not in req:
            req[MEMORY] = DEFAULT_MEMORY_REQUEST
        r.add_resource_list(req)
    for c in pod.spec.init_containers:
        r.set_max_resource_list(c.resources.requests)
    if pod.spec.overhead:
        r.add_resource_list(pod.spec.overhead)
    return r
