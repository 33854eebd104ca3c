"""DynamicResources: ResourceClaim scheduling over the claim planes.

Reference: the JAX package's dra/plugin.py (:48-296), after
pkg/scheduler/framework/plugins/dynamicresources/ — PreFilter resolves the
pod's claims, Filter rejects nodes that cannot satisfy them, Reserve
allocates in the in-memory assume cache, PreBind writes the allocation into
the claim's status, Unreserve deallocates.

Per-node chip inventory lives in two encoder planes (``claim_capacity`` /
``claim_allocated``, projected by dra/index.py), so the device half reads
the snapshot only: ``host_prepare`` resolves each pod's claims on the host
(demand, pin, block), ``prepare`` uploads them with ``free = capacity −
allocated``, the filter writes its bit of K1's pass-bit plane through K24,
the score adds into K2's total through K25, and the engines take each
placed pod's chips from ``free`` through K26 (the auction's rounds through
``update_batch_classes``, the scan's steps through ``update``).  The host
side stays authoritative for NAMES: Reserve picks concrete devices
("pool/chip") in the DraIndex assume cache, PreBind persists them with
exactly-once rollback.

Differences from the reference:
- the port has no metrics registry, so the plugin keeps the reference's two
  series as plain counters on itself: ``claims_allocated`` by result
  (dra_claims_allocated_total{result}: allocated / conflict / error /
  rollback) and ``allocation_durations`` (the observations of
  dra_allocation_duration_seconds);
- the chaos kill-point between a pod's claim commits is left out (the port
  carries no fault injection);
- the aux carries the snapshot's ``claim_capacity`` (K25 reads it beside
  ``free``), and the engines take the chips in place from an
  ``engine_copy`` of ``free`` where the reference's update is functional.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..framework.events import ActionType, ClusterEvent, EventResource
from ..framework.interface import Plugin, Status
from ..kernels.dra import (
    dra_filter_bits,
    dra_filter_plane,
    dra_normalize,
    dra_raw_plane,
    dra_score_into,
    dra_take,
)
from ..plugins.helpers import node_tensor
from ..sim.store import StaleResourceVersion
from .api import CLAIM_RESERVED, ResourceClaim
from .index import DraIndex, deallocated, pod_has_claims

# store-write retry bound for the claim-status CAS loop (a conflict means
# re-read + re-stamp; anything still conflicting after this is a live
# writer fighting us and the binding cycle should fail and requeue)
_CAS_RETRIES = 8

CLAIM_RESULTS = ("allocated", "conflict", "error", "rollback")


class DraAux(NamedTuple):
    demand: torch.Tensor  # i32[B] pending chips the pod's claims need
    pinned: torch.Tensor  # i32[B] node row an allocated claim pins to; -1 free
    blocked: torch.Tensor  # bool[B] unresolvable claims (missing/foreign)
    free: torch.Tensor  # i32[N] free chips (capacity − allocated), engine-carried
    capacity: torch.Tensor  # i32[N] the snapshot's claim_capacity


class DynamicResourcesPlugin(Plugin):
    name = "DynamicResources"
    dynamic = True

    def __init__(self, index: Optional[DraIndex] = None):
        self.index = index
        # pod uid → [(claim, named devices)] picked at Reserve, consumed at
        # PreBind/Unreserve — the _decisions idiom VolumeBinding pinned
        self._decisions: Dict[str, List[Tuple[ResourceClaim, List[str]]]] = {}
        # the reference's DRA series (see the module doc)
        self.claims_allocated: Dict[str, int] = {k: 0 for k in CLAIM_RESULTS}
        self.allocation_durations: List[float] = []

    def events_to_register(self):
        return [
            ClusterEvent(EventResource.RESOURCE_CLAIM, ActionType.ALL),
            ClusterEvent(EventResource.RESOURCE_SLICE, ActionType.ALL),
            ClusterEvent(EventResource.DEVICE_CLASS, ActionType.ALL),
            ClusterEvent(EventResource.NODE, ActionType.ADD),
        ]

    # --- PreFilter (host): resolve claims → per-pod demand/pin/block ---------

    def host_prepare(self, batch, snapshot, encoder, namespace_labels=None):
        """{"demand", "pinned", "blocked"} numpy arrays over the batch, or
        None for a claim-free batch (the common case): no aux at all, so the
        identity-class dedup stays available (a non-None host aux routes the
        batch to the full auction)."""
        if self.index is None:
            return None
        if not any(pod_has_claims(p) for p in batch.pods):
            return None
        b = batch.size
        demand = np.zeros(b, dtype=np.int32)
        pinned = np.full(b, -1, dtype=np.int32)
        blocked = np.zeros(b, dtype=bool)
        rows = encoder.node_rows
        for i, pod in enumerate(batch.pods):
            if not pod_has_claims(pod):
                continue
            dem, pin_node, ok = self.index.resolve(pod)
            if not ok:
                blocked[i] = True
                continue
            demand[i] = dem
            if pin_node is not None:
                row = rows.get(pin_node)
                if row is None:
                    blocked[i] = True  # allocated to a node we can't see
                else:
                    pinned[i] = row
        return {"demand": demand, "pinned": pinned, "blocked": blocked}

    def prepare(self, batch, snap, dyn, host_aux=None):
        """The device aux, or None for a claim-free batch (its filter passes
        every node and its score is the constant 0 ``kernel_plans`` folds
        in).  ``free`` is computed from the snapshot once per engine run."""
        if host_aux is None:
            return None
        dev = snap.device

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

        capacity = snap.claim_capacity.to(torch.int32).contiguous()
        return DraAux(
            demand=up(host_aux["demand"], np.int32),
            pinned=up(host_aux["pinned"], np.int32),
            blocked=up(host_aux["blocked"], np.bool_),
            free=(capacity - snap.claim_allocated).to(torch.int32).contiguous(),
            capacity=capacity,
        )

    # --- Filter: the reference's plane, and its bit through K24 --------------

    def filter(self, batch, snap, dyn, aux: DraAux = None):
        if aux is None:
            return torch.ones((batch.valid.shape[0], snap.num_nodes), dtype=torch.bool,
                              device=snap.device)
        return dra_filter_plane(aux.demand, aux.pinned, aux.blocked, aux.free)

    def filter_bits(self, aux: DraAux, bits, bit: int):
        """Clear this filter's ``bit`` of the pass-bit plane where the row's
        claims do not fit (K24)."""
        return dra_filter_bits(bits, bit, aux.demand, aux.pinned, aux.blocked, aux.free)

    # --- Score: tight-pack claims onto already-busy inventory -----------------

    def score(self, batch, snap, dyn, aux: DraAux = None, mask=None):
        """Post-placement chip utilization ×100 — claims pack onto the
        fullest satisfying inventory so whole slices stay free for gangs.
        Nodes without inventory (or demand-free pods) score 0."""
        if aux is None:
            return torch.zeros((batch.valid.shape[0], snap.num_nodes),
                               dtype=torch.float32, device=snap.device)
        return dra_raw_plane(aux.capacity, aux.free, aux.demand)

    def normalize(self, scores, mask):
        return dra_normalize(scores, mask)

    def score_into(self, aux: DraAux, bits, full: int, total, weight: float):
        """Add weight · floor(normalize(score)) into ``total`` (K25)."""
        return dra_score_into(bits, full, total, aux.capacity, aux.free, aux.demand,
                              weight)

    # --- the engines: working copies, scan rows, the device assume (K26) ------

    def engine_copy(self, aux: DraAux) -> DraAux:
        """The aux with its own ``free``, which an engine takes chips from in
        place (the snapshot-derived free must not leak into the next run)."""
        return aux._replace(free=aux.free.clone())

    def row(self, aux: DraAux, i: int) -> DraAux:
        """Pod i's row of a full-batch aux (the exact scan's step); ``free``
        is shared, so the step's updates show through."""
        return aux._replace(demand=aux.demand[i:i + 1], pinned=aux.pinned[i:i + 1],
                            blocked=aux.blocked[i:i + 1])

    def update(self, aux: DraAux, i: int, node_row, batch, snap):
        """Pod i placed at ``node_row`` (i32[1] on the device, written there
        by K17, or an int; below 0: not placed) takes its chips (K26)."""
        if aux is None:
            return None
        dra_take(aux.free, node_tensor(node_row, aux.free.device), aux.demand[i:i + 1])
        return aux

    def update_batch_classes(self, aux: DraAux, commit, choice, class_of):
        """One auction round's commits take their chips (K26): pod b's
        demand is its class row's (``class_of``; the full auction runs at
        identity classes, and a batch with claims never reaches the dedup
        engine).  The reference's update_batch / update_batch_classes fold
        a float32 one-hot contraction; the integer sum is equal."""
        if aux is None:
            return None
        dra_take(aux.free, choice, aux.demand, commit=commit, class_of=class_of)
        return aux

    # --- Reserve / Unreserve / PreBind (host binding cycle) -------------------

    def reserve(self, state, pod, node_name: str) -> Status:
        """Pick named devices for every pending claim in the DraIndex assume
        cache — all-or-nothing (index.reserve rolls back partial assumes)."""
        if self.index is None or not pod_has_claims(pod):
            return Status.success()
        decisions, reason = self.index.reserve(pod, node_name)
        if reason is not None:
            self.claims_allocated["conflict"] += 1
            return Status.unschedulable(reason, plugin=self.name)
        if decisions:
            self._decisions[pod.uid] = decisions
        return Status.success()

    def unreserve(self, state, pod, node_name: str) -> None:
        if self.index is None:
            return
        self._decisions.pop(pod.uid, None)
        self.index.unreserve(pod)

    def pre_bind(self, state, pod, node_name: str) -> Status:
        """Persist each claim's allocation (named devices + reservedFor)
        with CAS; a terminal failure mid-pod deallocates the claims already
        written THIS cycle before failing — so a pod's claims land in the
        store all-or-nothing (exactly-once: a retry of a fully-written pod
        sees its own allocation and completes).  The reference's chaos
        kill-point after each commit is left out (see the module doc)."""
        decisions = self._decisions.pop(pod.uid, [])
        if self.index is None or not decisions:
            return Status.success()
        store = self.index.store
        t0 = time.monotonic()
        written: List[ResourceClaim] = []
        try:
            for claim, devices in decisions:
                ok, fresh, why = self._commit_claim(
                    store, claim, devices, pod, node_name)
                if not ok:
                    self._rollback(store, written)
                    self.claims_allocated["error"] += 1
                    return Status.error(
                        f"claim {claim.metadata.name}: {why}",
                        plugin=self.name)
                self.index.apply_claim(fresh)
                written.append(fresh)
                self.claims_allocated["allocated"] += 1
        finally:
            self.allocation_durations.append(time.monotonic() - t0)
        self.index.forget_pod(pod)
        return Status.success()

    def _commit_claim(self, store, claim: ResourceClaim, devices: List[str],
                      pod, node_name: str):
        """(ok, fresh claim, reason) — CAS loop with fresh re-reads, so a
        conflict storm retries against the claim that actually won, never
        double-writes."""
        last = "no attempt"
        for _ in range(_CAS_RETRIES):
            fresh = store.get("ResourceClaim", claim.namespace,
                              claim.metadata.name)
            if fresh is None:
                return False, None, "claim deleted mid-bind"
            if fresh.allocated_node:
                # someone's allocation landed — ours (a resent write whose
                # first attempt succeeded, or crash-recovery completing) is
                # success; anyone else's is a lost race
                if (fresh.allocated_node == node_name
                        and fresh.reserved_for == pod.uid):
                    return True, fresh, ""
                return False, None, (
                    f"allocated to {fresh.allocated_node} "
                    f"for {fresh.reserved_for or 'nobody'}")
            if fresh.reserved_for and fresh.reserved_for != pod.uid:
                return False, None, f"reserved for {fresh.reserved_for}"
            fresh.state = CLAIM_RESERVED
            fresh.allocated_node = node_name
            fresh.allocated_devices = list(devices)
            fresh.reserved_for = pod.uid
            try:
                store.update("ResourceClaim", fresh,
                             expected_rv=fresh.metadata.resource_version)
                return True, fresh, ""
            except StaleResourceVersion as e:
                last = str(e)  # a conflict: re-read, retry
            except Exception as e:  # terminal store fault
                return False, None, str(e)
        return False, None, f"CAS retries exhausted: {last}"

    def _rollback(self, store, written: List[ResourceClaim]) -> None:
        """Deallocate the claims THIS cycle already wrote (reverse order).
        Best-effort CAS: a claim whose rollback write keeps failing stays
        reserved for a pod that will never bind — the claim controller's
        repair arm converges it, preserving exactly-once."""
        for claim in reversed(written):
            for _ in range(_CAS_RETRIES):
                fresh = store.get("ResourceClaim", claim.namespace,
                                  claim.metadata.name)
                if fresh is None or fresh.reserved_for != claim.reserved_for:
                    break  # gone or re-owned: nothing of ours to undo
                bare = deallocated(fresh)
                try:
                    store.update("ResourceClaim", bare,
                                 expected_rv=fresh.metadata.resource_version)
                    self.index.apply_claim(bare)
                    self.claims_allocated["rollback"] += 1
                    break
                except StaleResourceVersion:
                    continue
                except Exception:
                    # terminal rollback failure: the claim controller's
                    # repair arm owns convergence from here
                    break
