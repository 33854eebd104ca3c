"""DRA index: store-fed device inventory + claim allocation ledger.

A copy of the JAX package's dra/index.py (the port imports nothing of it).

The scheduling-path analog of the reference DynamicResources plugin's
claim/slice listers plus its in-flight assume cache
(pkg/scheduler/framework/plugins/dynamicresources): it tracks

  - DeviceClass selectors and per-node ResourceSlice inventories,
  - claim allocation state from the store (authoritative), and
  - in-flight Reserve assumptions not yet written back (released by
    Unreserve, superseded by the PreBind store write),

and projects the per-node chip totals into the encoder's
``claim_capacity``/``claim_allocated`` planes (state/encoding.py) so
Filter/Score run device-resident.  Event-driven with a store fallback:
watch drops under chaos never desynchronize the ledger because PreBind
applies its own successful writes directly (``apply_claim``), and watch
replays are idempotent keyed diffs.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

from ..sim.store import DELETED
from .api import (
    CLAIM_PENDING,
    DeviceClass,
    ResourceClaim,
    ResourceSlice,
    pod_claim_names,
)


def pod_has_claims(pod) -> bool:
    return bool(getattr(pod.spec, "resource_claims", None))


class DraIndex:
    def __init__(self, store=None):
        self.store = store
        # one lock for ledger + dirty set: writers are the watch thread,
        # the bind phase (reserve/apply), and the dispatch-time flush
        self._lock = threading.RLock()
        self._classes: Dict[str, DeviceClass] = {}
        self._slices: Dict[str, ResourceSlice] = {}  # slice name → obj
        self._node_slices: Dict[str, Set[str]] = {}  # node → slice names
        self._claims: Dict[str, ResourceClaim] = {}  # ns/name → claim
        # store-backed allocations: node → {"pool/device"}; claim key →
        # (node, devices) for the reverse diff on claim update/delete
        self._alloc: Dict[str, Set[str]] = {}
        self._claim_alloc: Dict[str, Tuple[str, List[str]]] = {}
        # in-flight Reserve assumptions: claim key → (node, devices)
        self._assumed: Dict[str, Tuple[str, List[str]]] = {}
        self._assumed_by_pod: Dict[str, List[str]] = {}  # pod uid → keys
        self._dirty: Set[str] = set()  # node names pending an encoder write
        self._primed = False

    # --- store feed ----------------------------------------------------------

    def prime(self) -> None:
        """Initial list (informer-style): called lazily on first flush so
        construction order vs. store population doesn't matter."""
        if self.store is None or self._primed:
            return
        self._primed = True
        for obj in self.store.list("DeviceClass")[0]:
            self.apply_class(obj)
        for obj in self.store.list("ResourceSlice")[0]:
            self.apply_slice(obj)
        for obj in self.store.list("ResourceClaim")[0]:
            self.apply_claim(obj)

    def on_event(self, ev_type: str, obj) -> None:
        kind = getattr(obj, "kind", "")
        with self._lock:  # reentrant: one lock span per delivered event
            if kind == "DeviceClass":
                if ev_type == DELETED:
                    self._classes.pop(obj.metadata.name, None)
                else:
                    self.apply_class(obj)
            elif kind == "ResourceSlice":
                if ev_type == DELETED:
                    self.remove_slice(obj.metadata.name)
                else:
                    self.apply_slice(obj)
            elif kind == "ResourceClaim":
                if ev_type == DELETED:
                    self.remove_claim(obj.key())
                else:
                    self.apply_claim(obj)

    def apply_class(self, dc: DeviceClass) -> None:
        with self._lock:
            self._classes[dc.metadata.name] = dc

    def apply_slice(self, sl: ResourceSlice) -> None:
        with self._lock:
            prev = self._slices.get(sl.metadata.name)
            if prev is not None and prev.node_name != sl.node_name:
                self._node_slices.get(prev.node_name, set()).discard(
                    sl.metadata.name)
                self._dirty.add(prev.node_name)
            self._slices[sl.metadata.name] = sl
            self._node_slices.setdefault(sl.node_name, set()).add(
                sl.metadata.name)
            self._dirty.add(sl.node_name)

    def remove_slice(self, name: str) -> None:
        with self._lock:
            sl = self._slices.pop(name, None)
            if sl is None:
                return
            self._node_slices.get(sl.node_name, set()).discard(name)
            self._dirty.add(sl.node_name)

    def apply_claim(self, claim: ResourceClaim) -> None:
        """Idempotent keyed diff — safe for watch replays AND for PreBind's
        direct apply of its own store write (the path that keeps the ledger
        exact when chaos drops the watch event)."""
        with self._lock:
            key = claim.key()
            self._drop_alloc(key)
            self._claims[key] = claim
            if claim.allocated_devices and claim.allocated_node:
                node = claim.allocated_node
                self._claim_alloc[key] = (node, list(claim.allocated_devices))
                self._alloc.setdefault(node, set()).update(
                    claim.allocated_devices)
                self._dirty.add(node)
            # the authoritative allocation supersedes any in-flight assume
            if key in self._assumed:
                anode, _ = self._assumed.pop(key)
                self._dirty.add(anode)

    def remove_claim(self, key: str) -> None:
        with self._lock:
            self._drop_alloc(key)
            self._claims.pop(key, None)
            if key in self._assumed:
                anode, _ = self._assumed.pop(key)
                self._dirty.add(anode)

    def _drop_alloc(self, key: str) -> None:
        prev = self._claim_alloc.pop(key, None)
        if prev is None:
            return
        node, devices = prev
        held = self._alloc.get(node)
        if held is not None:
            held.difference_update(devices)
        self._dirty.add(node)

    # --- encoder projection --------------------------------------------------

    def note_node(self, name: str) -> None:
        """A node (re)appeared or its encoder row churned: re-project its
        planes on the next flush (encode_node never touches them, and
        remove_node zeroes a freed row)."""
        with self._lock:
            if name in self._node_slices:
                self._dirty.add(name)

    def node_capacity(self, name: str) -> int:
        with self._lock:
            return sum(len(self._slices[s].devices)
                       for s in self._node_slices.get(name, ()))

    def node_allocated(self, name: str) -> int:
        with self._lock:
            held = set(self._alloc.get(name, ()))
            for anode, devs in self._assumed.values():
                if anode == name:
                    held.update(devs)
            return len(held)

    def flush_to_encoder(self, encoder) -> None:
        """Write dirty nodes' (capacity, allocated) into the encoder claim
        planes.  Nodes without a row yet stay dirty and retry next flush."""
        with self._lock:
            self.prime()
            if not self._dirty:
                return
            pending, self._dirty = self._dirty, set()
            for name in pending:
                cap = sum(len(self._slices[s].devices)
                          for s in self._node_slices.get(name, ()))
                held = set(self._alloc.get(name, ()))
                for anode, devs in self._assumed.values():
                    if anode == name:
                        held.update(devs)
                if not encoder.set_claim_row(name, cap, len(held)):
                    self._dirty.add(name)

    # --- claim resolution (host_prepare) -------------------------------------

    def claim_of(self, namespace: str, name: str) -> Optional[ResourceClaim]:
        with self._lock:
            hit = self._claims.get(f"{namespace}/{name}")
        if hit is None and self.store is not None:
            hit = self.store.get("ResourceClaim", namespace, name)
            if hit is not None:
                with self._lock:
                    self.apply_claim(hit)
        return hit

    def resolve(self, pod) -> Tuple[int, Optional[str], bool]:
        """(pending chip demand, pinned node name | None, resolvable).

        Unresolvable (missing claim — template not stamped yet, claim
        reserved by another pod, claims pinned to two different nodes)
        means UnschedulableAndUnresolvable until a claim event requeues."""
        demand = 0
        pinned: Optional[str] = None
        for cname in pod_claim_names(pod):
            if cname is None:
                return 0, None, False
            claim = self.claim_of(pod.namespace, cname)
            if claim is None:
                return 0, None, False
            if claim.reserved_for and claim.reserved_for != pod.uid:
                return 0, None, False
            if claim.allocated_node:
                if pinned is not None and pinned != claim.allocated_node:
                    return 0, None, False
                pinned = claim.allocated_node
            else:
                demand += claim.request.count
        return demand, pinned, True

    def pod_claim_demand(self, pod) -> int:
        """Pending (not-yet-allocated) chip demand — the gang anchor-slice
        resolver: allocated claims already count in ``claim_allocated``, so
        adding them here would double-count against free."""
        demand, _pinned, ok = self.resolve(pod)
        return demand if ok else 0

    def pod_chips(self, pod) -> int:
        """Chips a (bound) pod holds on its node — released by a whatif
        victim fork exactly as a real eviction's deallocation would."""
        total = 0
        node = pod.spec.node_name
        if not node:
            return 0
        for cname in pod_claim_names(pod):
            if cname is None:
                continue
            with self._lock:
                claim = self._claims.get(f"{pod.namespace}/{cname}")
            if claim is not None and claim.allocated_node == node:
                total += len(claim.allocated_devices)
        return total

    # --- named-device selection (Reserve / Unreserve) ------------------------

    def _free_devices(self, node: str, dc: Optional[DeviceClass]) -> List[str]:
        held = set(self._alloc.get(node, ()))
        for anode, devs in self._assumed.values():
            if anode == node:
                held.update(devs)
        out = []
        for sname in sorted(self._node_slices.get(node, ())):
            sl = self._slices[sname]
            for dev in sl.devices:
                if dc is not None and not dc.matches(dev):
                    continue
                full = f"{sl.pool}/{dev.name}"
                if full not in held:
                    out.append(full)
        return out

    def reserve(self, pod, node_name: str):
        """All-or-nothing named-device assume for every claim of ``pod``
        (the AssumePodVolumes discipline): a failure on a later claim rolls
        back the earlier claims' assumes before returning.

        Returns (decisions, None) on success — [(claim, devices)] for the
        claims this pod newly allocates — or (None, reason)."""
        decisions: List[Tuple[ResourceClaim, List[str]]] = []
        taken: List[str] = []
        with self._lock:
            def fail(reason: str):
                for key in taken:
                    anode, _ = self._assumed.pop(key)
                    self._dirty.add(anode)
                by_pod = self._assumed_by_pod.get(pod.uid)
                if by_pod:
                    self._assumed_by_pod[pod.uid] = [
                        k for k in by_pod if k not in taken]
                return None, reason

            for cname in pod_claim_names(pod):
                if cname is None:
                    return fail("malformed resourceClaims entry")
                key = f"{pod.namespace}/{cname}"
                claim = self._claims.get(key)
                if claim is None and self.store is not None:
                    claim = self.store.get(
                        "ResourceClaim", pod.namespace, cname)
                if claim is None:
                    return fail(f"ResourceClaim {cname} not found")
                if claim.reserved_for and claim.reserved_for != pod.uid:
                    return fail(
                        f"claim {cname} reserved for another pod")
                if claim.allocated_node:
                    if claim.allocated_node != node_name:
                        return fail(
                            f"claim {cname} already allocated to "
                            f"{claim.allocated_node}")
                    continue  # idempotent: allocation already persisted
                if key in self._assumed:
                    return fail(f"claim {cname} assumed by another pod")
                dc = self._classes.get(claim.request.device_class_name)
                if dc is None and claim.request.device_class_name:
                    return fail(
                        f"DeviceClass {claim.request.device_class_name} "
                        f"not found")
                free = self._free_devices(node_name, dc)
                if len(free) < claim.request.count:
                    return fail(
                        f"node {node_name}: {len(free)} free devices, "
                        f"claim {cname} needs {claim.request.count}")
                devices = free[:claim.request.count]
                self._assumed[key] = (node_name, devices)
                self._assumed_by_pod.setdefault(pod.uid, []).append(key)
                taken.append(key)
                self._dirty.add(node_name)
                decisions.append((claim, devices))
        return decisions, None

    def unreserve(self, pod) -> None:
        with self._lock:
            for key in self._assumed_by_pod.pop(pod.uid, []):
                hit = self._assumed.pop(key, None)
                if hit is not None:
                    self._dirty.add(hit[0])

    def forget_pod(self, pod) -> None:
        """Drop assume bookkeeping after a successful PreBind (apply_claim
        already superseded the entries; this clears the per-pod list)."""
        with self._lock:
            self._assumed_by_pod.pop(pod.uid, None)

    # --- introspection -------------------------------------------------------

    def allocated_claims(self) -> List[ResourceClaim]:
        with self._lock:
            return [c for c in self._claims.values() if c.allocated_devices]


def deallocated(claim: ResourceClaim) -> ResourceClaim:
    """A copy of ``claim`` with the allocation result cleared (the rollback
    write and the claim controller's repair arm share this shape)."""
    import copy

    out = copy.copy(claim)
    out.state = CLAIM_PENDING
    out.allocated_node = ""
    out.allocated_devices = []
    out.reserved_for = ""
    return out
