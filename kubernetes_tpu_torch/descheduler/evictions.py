"""The shared eviction gate: preemption's victim deletes go through here.

Reference: the JAX package's descheduler/evictions.py (``EvictionAPI``),
itself after pkg/registry/core/pod/storage/eviction.go (the Eviction
subresource REST handler): an eviction request checks every matching
PodDisruptionBudget's ``status.disruptionsAllowed``, and either deletes the
pod (atomically draining one unit of budget so a burst of evictions cannot
overshoot) or refuses.  Preemption (``TorchScheduler._run_post_filter``)
passes ``override_pdb=True``: the dry run already minimized PDB violations
in its ranking, and the reference's preemption may violate budgets as a
last resort, so the gate records the violation ("overridden") and drains
the budget instead of refusing.

Exactly once: the pod delete is the store's atomic pop — a pod already gone
returns "missing" and consumes no budget.  Where the reference increments
its descheduler_evictions metric and logs, the port counts the same
(policy, result) pairs in ``EvictionAPI.results``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..api import objects as v1
from ..api.labels import match_label_selector


@dataclass
class EvictionResult:
    """Outcome of one gate pass.

    ``allowed`` is the PDB-gate verdict (True in dry-run when the eviction
    WOULD proceed); ``evicted`` is whether the pod was actually deleted;
    ``reason`` explains a refusal; ``blocking_pdb`` names the exhausted
    budget ("ns/name") when refused or overridden."""

    allowed: bool
    evicted: bool = False
    reason: str = ""
    blocking_pdb: Optional[str] = None


# one process-wide budget lock shared by every EvictionAPI instance: the
# read-modify-write on a PDB's disruptionsAllowed must serialize across
# every gate over the same store
_BUDGET_LOCK = threading.Lock()


class EvictionAPI:
    """PDB-consulting eviction gate over an ObjectStore-shaped store."""

    def __init__(self, store, recorder=None):
        self._store = store
        self._recorder = recorder
        self._lock = _BUDGET_LOCK
        # (policy, result) → count: evicted, overridden, refused, missing,
        # dry_run, error
        self.results: Dict[Tuple[str, str], int] = {}

    def _count(self, policy: str, result: str) -> None:
        key = (policy, result)
        self.results[key] = self.results.get(key, 0) + 1

    # --- gate queries ---------------------------------------------------------

    def matching_pdbs(
        self, pod: v1.Pod,
        pdbs: Optional[Sequence[v1.PodDisruptionBudget]] = None,
    ) -> List[v1.PodDisruptionBudget]:
        if pdbs is None:
            pdbs = self._store.list("PodDisruptionBudget")[0]
        return [
            p for p in pdbs
            if p.metadata.namespace == pod.namespace
            and p.selector is not None
            and match_label_selector(p.selector, pod.metadata.labels)
        ]

    def blocking_pdb(
        self, pod: v1.Pod,
        pdbs: Optional[Sequence[v1.PodDisruptionBudget]] = None,
    ) -> Optional[v1.PodDisruptionBudget]:
        """The first matching PDB with no disruption budget left, else None."""
        for p in self.matching_pdbs(pod, pdbs):
            if p.disruptions_allowed <= 0:
                return p
        return None

    def can_evict(
        self, pod: v1.Pod,
        pdbs: Optional[Sequence[v1.PodDisruptionBudget]] = None,
    ) -> bool:
        return self.blocking_pdb(pod, pdbs) is None

    # --- the gate -------------------------------------------------------------

    def evict(
        self,
        pod: v1.Pod,
        reason: str = "",
        policy: str = "api",
        dry_run: bool = False,
        override_pdb: bool = False,
        pdbs: Optional[Sequence[v1.PodDisruptionBudget]] = None,
    ) -> EvictionResult:
        """One eviction through the gate.

        ``pdbs`` lets batch callers (preemption's per-victim loop) reuse
        one PDB list instead of re-listing per pod; the budget write-back
        still goes through the store.  ``override_pdb`` proceeds past an
        exhausted budget but records it (result "overridden").
        """
        with self._lock:
            if self._store.get("Pod", pod.namespace,
                               pod.metadata.name) is None:
                # the reference 404s before any PDB math; this is also the
                # exactly-once guard for racing eviction paths
                self._count(policy, "missing")
                return EvictionResult(allowed=True, evicted=False,
                                      reason="pod already gone")
            if pdbs is None:
                # ONE list per eviction, shared by the gate check and the
                # budget drain — both run under the budget lock
                pdbs = self._store.list("PodDisruptionBudget")[0]
            blocking = self.blocking_pdb(pod, pdbs)
            if blocking is not None and not override_pdb:
                why = (f"Cannot evict pod as it would violate the pod's "
                       f"disruption budget "
                       f"{blocking.metadata.namespace}/"
                       f"{blocking.metadata.name}")
                self._count(policy, "refused")
                self._event(pod, "Warning", "EvictionBlocked",
                            f"{why} ({reason})" if reason else why)
                return EvictionResult(
                    allowed=False, reason=why,
                    blocking_pdb=blocking.metadata.namespace + "/"
                    + blocking.metadata.name)
            if dry_run:
                self._count(policy, "dry_run")
                return EvictionResult(allowed=True)
            # drain one budget unit from every matching PDB NOW (the
            # reference decrements disruptionsAllowed in the same
            # GuaranteedUpdate as the delete): a burst inside one
            # disruption-controller resync interval sees the drained value
            self._consume_budget(pod, pdbs)
            try:
                gone = self._store.delete(
                    "Pod", pod.namespace, pod.metadata.name)
            except Exception as e:
                # store fault past the client's own retries: surface it as
                # a result (callers abandon their plan) — the budget unit
                # stays drained until the next disruption-controller sync,
                # which recomputes it from live pods (safe: under-, never
                # over-admits disruptions)
                self._count(policy, "error")
                return EvictionResult(
                    allowed=True, evicted=False,
                    reason=f"store delete failed: {type(e).__name__}: {e}")
            if gone is None:
                self._count(policy, "missing")
                return EvictionResult(allowed=True, evicted=False,
                                      reason="pod already gone")
            result = "overridden" if blocking is not None else "evicted"
            self._count(policy, result)
            self._event(pod, "Normal", "Evicted",
                        f"Evicted by {policy}: {reason}" if reason
                        else f"Evicted by {policy}")
            return EvictionResult(
                allowed=True, evicted=True,
                blocking_pdb=(blocking.metadata.namespace + "/"
                              + blocking.metadata.name)
                if blocking is not None else None)

    def _consume_budget(self, pod: v1.Pod, pdbs) -> None:
        for pdb in self.matching_pdbs(pod, pdbs):
            if pdb.disruptions_allowed <= 0:
                continue  # overridden eviction: nothing left to drain
            pdb.disruptions_allowed -= 1
            try:
                self._store.update("PodDisruptionBudget", pdb)
            except Exception:
                # best-effort write-back: the disruption controller's next
                # sync recomputes the status from live pods either way
                pass

    def _event(self, pod: v1.Pod, etype: str, evreason: str, msg: str) -> None:
        if self._recorder is None:
            return
        try:
            self._recorder.eventf(pod, etype, evreason, msg)
        except Exception:
            # the recorder is best-effort by contract: an event write must
            # never fail the eviction itself
            pass
