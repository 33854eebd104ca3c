"""Descheduler controller loop: propose → score on the device → apply.

Reference: the JAX package's descheduler/controller.py (``ScoredPlan``
:34, ``DeschedulerController`` :46-338).  The run-once interface
(``sync_once``) lets a harness or a test drive the loop between scheduler
cycles.  It holds a scheduler reference: the what-if planner reuses the
scheduler's encoder and engines for its counterfactual solves, and so runs
while the scheduler is quiescent (in-flight pipelined batches are flushed
first).

Plan application is fail-stop: victims are evicted one gate call at a
time, and the FIRST refusal or store fault abandons the rest of the plan
(outcome "abandoned"); the next sync re-plans from the actual state.

Where the reference counts ``descheduler_plans`` by (policy, outcome) and
observes ``descheduler_planner_duration``, the port counts the same pairs
in ``DeschedulerController.plans`` and keeps the planner's solve times in
``planner.durations``.  The reference's chaos kill-point inside the apply
loop is not carried (the port has no chaos module).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..gang import SLICE_LABEL
from .evictions import EvictionAPI
from .planner import Prediction, WhatIfPlanner
from .policies import CandidatePlan, PolicyContext, default_policies


@dataclass
class ScoredPlan:
    plan: CandidatePlan
    viable: bool
    prediction: Optional[Prediction] = None
    slices_freed: int = 0
    replacements_found: int = 0

    @property
    def displaced(self) -> int:
        return len(self.plan.victims)


class DeschedulerController:
    name = "descheduler"

    def __init__(self, store, scheduler, eviction_api: Optional[EvictionAPI] = None,
                 policies: Optional[List[object]] = None,
                 dry_run: bool = False,
                 max_evictions_per_sync: int = 16,
                 min_interval: float = 0.0,
                 clock=None,
                 slice_label: Optional[str] = None):
        self.store = store
        self.scheduler = scheduler
        self.clock = clock or getattr(scheduler, "clock", time.monotonic)
        self.evictions = eviction_api or EvictionAPI(store)
        self.planner = WhatIfPlanner(scheduler)
        self.policies = list(policies) if policies is not None else default_policies()
        self.dry_run = dry_run
        # rate limiting: a hard per-sync eviction cap plus a minimum spacing
        # between eviction-performing syncs
        self.max_evictions_per_sync = max_evictions_per_sync
        self.min_interval = min_interval
        self._last_active = float("-inf")
        self.slice_label = slice_label or SLICE_LABEL
        # dry-run observability: the last sync's scored plans per policy
        self.last_plans: Dict[str, ScoredPlan] = {}
        # (policy, outcome) → count: applied, abandoned, dry_run, no_fit
        self.plans: Dict[Tuple[str, str], int] = {}
        # policies whose propose raised, with the error (the loop goes on)
        self.errors: List[Tuple[str, str]] = []
        # per-sync cache of the slice → bound-pod-uids occupancy map
        self._occupancy: Optional[Dict[str, List[str]]] = None

    def _count(self, policy: str, outcome: str) -> None:
        key = (policy, outcome)
        self.plans[key] = self.plans.get(key, 0) + 1

    # --- scoring --------------------------------------------------------------

    def score(self, plan: CandidatePlan) -> ScoredPlan:
        """Score one candidate: the pending-only solve decides viability;
        the scoreboard is (slices freed, pods displaced, replacements
        found)."""
        if plan.no_solve:
            return ScoredPlan(plan=plan, viable=bool(plan.victims),
                              slices_freed=self._slices_freed(plan))
        return self._scored(plan, self.planner.predict(plan.pending, plan.victims))

    def _scored(self, plan: CandidatePlan,
                prediction: Optional[Prediction]) -> ScoredPlan:
        """The viability verdict from a (possibly grouped) prediction."""
        if prediction is None:
            return ScoredPlan(plan=plan, viable=False)
        viable = True
        if plan.require_all_pending and prediction.unplaced:
            viable = False
        if viable and plan.post_check is not None:
            viable = bool(plan.post_check(prediction.placements))
        return ScoredPlan(plan=plan, viable=viable, prediction=prediction,
                          slices_freed=self._slices_freed(plan))

    def _best_in_group(self, group: List[CandidatePlan], budget: int):
        """The cheapest viable plan of one competing group →
        ``(ScoredPlan | None, budget_limited)``.  A group's solvable
        candidates share a pending set by construction, so they go through
        ONE K-fork ``WhatIfEngine.evaluate`` and the verdicts are read in
        cost order; ``no_solve`` plans (drain) and groups whose candidates
        carry different pending sets are scored one by one."""
        group = sorted(group, key=lambda pl: len(pl.victims))
        budget_limited = False
        prepared: List[CandidatePlan] = []
        for plan in group:
            if plan.no_solve and len(plan.victims) > budget:
                # drain evictions are independent: chunk to the budget so a
                # big node drains across syncs instead of never
                plan = dataclasses.replace(plan, victims=plan.victims[:budget])
            if len(plan.victims) > budget:
                budget_limited = True
                continue
            prepared.append(plan)
        solvable = [p for p in prepared if not p.no_solve and p.pending]
        preds: Dict[int, Prediction] = {}
        if len(solvable) > 1 and all(
                [q.uid for q in p.pending] == [q.uid for q in solvable[0].pending]
                for p in solvable[1:]):
            got = self._predict_group(solvable)
            if got is not None:
                preds = got
        for plan in prepared:
            if plan.no_solve:
                scored = ScoredPlan(plan=plan, viable=bool(plan.victims),
                                    slices_freed=self._slices_freed(plan))
            elif id(plan) in preds:
                scored = self._scored(plan, preds[id(plan)])
            else:
                scored = self.score(plan)
            if scored.viable:
                # the first viable plan in cost order is the group's minimal
                # victim set
                return scored, budget_limited
        return None, budget_limited

    def _predict_group(self, solvable: List[CandidatePlan]
                       ) -> Optional[Dict[int, Prediction]]:
        """All of a group's candidate victim sets as ONE K-fork evaluate
        over the shared pending batch; None when the engine refuses."""
        from ..whatif import ForkSpec

        t0 = self.clock()
        preds = self.planner.engine.evaluate(
            list(solvable[0].pending),
            [ForkSpec(victims=list(p.victims), note="descheduler") for p in solvable])
        if preds is None:
            return None
        self.planner.durations.append(max(self.clock() - t0, 0.0))
        return {id(p): pr for p, pr in zip(solvable, preds)}

    def _score_replacements(self, scored: ScoredPlan) -> None:
        """A second solve on the WINNING plan only: pending + victim clones,
        counting how many displaced workloads find a home elsewhere."""
        plan = scored.plan
        if not plan.replacements:
            return
        combined = self.planner.predict(list(plan.pending) + list(plan.replacements),
                                        plan.victims)
        if combined is None:
            return
        scored.replacements_found = sum(
            1 for clone in plan.replacements if combined.placements.get(clone.uid) is not None)

    def _slices_freed(self, plan: CandidatePlan) -> int:
        """Slices whose every bound pod is in the victim set.  The occupancy
        map is plan-independent and rebuilt at most once per sync."""
        victims = {v.uid for v in plan.victims}
        occupants = self._occupancy
        if occupants is None:
            nodes, _ = self.store.list("Node")
            pods, _ = self.store.list("Pod")
            occupants = {}
            slice_of: Dict[str, str] = {}
            for node in nodes:
                val = node.metadata.labels.get(self.slice_label)
                if val is not None:
                    slice_of[node.metadata.name] = val
                    occupants.setdefault(val, [])
            for p in pods:
                sl = slice_of.get(p.spec.node_name or "")
                if sl is not None:
                    occupants[sl].append(p.uid)
            self._occupancy = occupants
        return sum(1 for uids in occupants.values()
                   if uids and all(uid in victims for uid in uids))

    # --- the loop -------------------------------------------------------------

    def sync_once(self) -> bool:
        now = self.clock()
        if now - self._last_active < self.min_interval:
            return False
        # planner quiescence: complete in-flight pipelined batches (empty
        # cycles fetch and bind without new dispatch work); if the pipeline
        # will not drain, skip this sync rather than plan blind
        for _ in range(4):
            if not self.scheduler._inflight_q:
                break
            self.scheduler.schedule_cycle()
        if self.scheduler._inflight_q:
            return False
        # a drain cycle may have started a background sync
        self.scheduler.join_sync_ahead()
        budget = self.max_evictions_per_sync
        self.last_plans = {}
        self._occupancy = None  # fresh store state this sync
        changed = False
        for policy in self.policies:
            if budget <= 0:
                break
            try:
                plans = policy.propose(PolicyContext(
                    self.store, self.scheduler.gangs, self.evictions, self.clock,
                    dry_run=self.dry_run))
            except Exception as e:
                # one broken policy must not take the loop down
                self.errors.append((policy.name, f"{type(e).__name__}: {e}"))
                continue
            by_group: Dict[str, List[CandidatePlan]] = {}
            for i, plan in enumerate(plans):
                by_group.setdefault(plan.group or f"#{i}", []).append(plan)
            any_viable = False
            budget_limited = False
            for group in by_group.values():
                if budget <= 0:
                    budget_limited = True
                    break
                best, limited = self._best_in_group(group, budget)
                budget_limited = budget_limited or limited
                if best is None:
                    continue
                any_viable = True
                self._score_replacements(best)
                self.last_plans[policy.name] = best
                if self.dry_run:
                    self._count(policy.name, "dry_run")
                    continue
                applied = self._apply(best)
                changed = changed or applied > 0
                budget -= applied
                if applied:
                    self._last_active = now
            if plans and not any_viable and not budget_limited:
                # only genuine no-placement outcomes count as no_fit
                self._count(policy.name, "no_fit")
        return changed

    def _apply(self, scored: ScoredPlan) -> int:
        """Evict the plan's victims through the gate; fail-stop on the first
        refusal or fault (outcome "abandoned")."""
        plan = scored.plan
        applied = 0
        for victim in plan.victims:
            try:
                result = self.evictions.evict(victim, reason=plan.note, policy=plan.policy)
            except Exception:
                self._count(plan.policy, "abandoned")
                return applied
            if not result.evicted:
                # a refusal mid-plan (budget raced since scoring) or a store
                # fault surfaced as a result: the next sync re-plans
                self._count(plan.policy, "abandoned")
                return applied
            applied += 1
        self._occupancy = None  # evictions changed the occupancy map
        self._count(plan.policy, "applied")
        return applied
