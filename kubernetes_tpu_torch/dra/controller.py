"""ResourceClaim controller: template stamping + allocation repair.

A copy of the JAX package's dra/controller.py (the port imports nothing of
it).

Reference: pkg/controller/resourceclaim/controller.go — one ResourceClaim
stamped per pod referencing a ResourceClaimTemplate, and stale
reservations cleaned up when the consuming pod is gone.

Exactly-once discipline: stamped names are deterministic
(api.stamped_claim_name), so a re-run after a crash finds the claim it
already created instead of stamping a duplicate; the repair arm
deallocates a claim only when its reserved-for pod can never consume it
(missing, or bound to a DIFFERENT node) — a live unbound pod keeps its
claim untouched, because its PreBind may be mid-flight (a crash between a
pod's claim commits leaves exactly this state, and either the retried
binding completes the allocation or this arm returns it to Pending)."""

from __future__ import annotations

import dataclasses

from ..api.objects import ObjectMeta
from ..sim.store import ObjectStore, StaleResourceVersion
from .api import ResourceClaim, stamped_claim_name
from .index import deallocated


class ResourceClaimController:
    def __init__(self, store: ObjectStore, index=None):
        self.store = store
        self.index = index  # optional: a scheduler's DraIndex to keep warm

    def sync_once(self) -> bool:
        changed = False
        pods, _ = self.store.list("Pod")
        claims, _ = self.store.list("ResourceClaim")
        templates = {
            t.key(): t for t in self.store.list("ResourceClaimTemplate")[0]
        }
        claim_keys = {c.key() for c in claims}
        pods_by_uid = {p.uid: p for p in pods}

        # --- stamp claims from templates ------------------------------------
        for pod in pods:
            for pc in getattr(pod.spec, "resource_claims", None) or []:
                if not pc.resource_claim_template_name:
                    continue
                name = stamped_claim_name(pod.metadata.name, pc.name)
                key = f"{pod.namespace}/{name}"
                if key in claim_keys:
                    continue
                tpl = templates.get(
                    f"{pod.namespace}/{pc.resource_claim_template_name}")
                if tpl is None:
                    continue  # template not created yet: next sync
                claim = ResourceClaim(
                    metadata=ObjectMeta(name=name, namespace=pod.namespace),
                    request=dataclasses.replace(tpl.request),
                )
                try:
                    self.store.create("ResourceClaim", claim)
                except ValueError:
                    pass  # a concurrent stamper won: same deterministic name
                claim_keys.add(key)
                if self.index is not None:
                    self.index.apply_claim(claim)
                changed = True

        # --- repair stale reservations --------------------------------------
        for claim in claims:
            if not claim.reserved_for and not claim.allocated_node:
                continue
            pod = pods_by_uid.get(claim.reserved_for) \
                if claim.reserved_for else None
            if pod is not None and (
                    not pod.spec.node_name
                    or pod.spec.node_name == claim.allocated_node):
                continue  # consumer live (bound here or PreBind mid-flight)
            if self._deallocate(claim):
                changed = True
        return changed

    def _deallocate(self, claim: ResourceClaim) -> bool:
        for _ in range(8):
            fresh = self.store.get(
                "ResourceClaim", claim.namespace, claim.metadata.name)
            if fresh is None or (
                    fresh.reserved_for != claim.reserved_for
                    or fresh.allocated_node != claim.allocated_node):
                return False  # re-owned or already repaired: exactly once
            bare = deallocated(fresh)
            try:
                self.store.update(
                    "ResourceClaim", bare,
                    expected_rv=fresh.metadata.resource_version)
            except StaleResourceVersion:
                continue
            if self.index is not None:
                self.index.apply_claim(bare)
            return True
        return False
