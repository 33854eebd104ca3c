"""Cluster-autoscaler controller: demand → simulate → scale.

Reference: the JAX package's autoscaler/controller.py (``ScaleDecision``
:50, ``ClusterAutoscaler`` :61-535), itself after kubernetes/autoscaler
cluster-autoscaler core:
  ScaleUp (core/scaleup): unschedulable pods are packed against each
    group's template node and the expander picks the cheapest option;
  ScaleDown (core/scaledown): an underutilized node is eligible only when
    every resident pod provably reschedules elsewhere (simulator/drain),
    then the node drains and is removed.

Both halves run through the whatif engine (whatif/engine.py): a scale-up
candidate set {add M₁, M₂, …} is ONE K-fork evaluate over node-add forks,
and a scale-down candidate is a node-remove + victim-mask fork whose
pending set is the displaced pods' replacement clones.  A scale-down
drains through the shared PDB-aware ``EvictionAPI`` — a blocked budget
refuses it outright, never half-drains.

Exactly-once under store faults: scale-ups materialize deterministically
named nodes (autoscaler/api.py) and recount live membership every sync,
so a fault mid-apply resumes where it stopped — the decision's node set is
created once, never duplicated.  Where the reference counts
``autoscaler_scale_decisions`` by (direction, result), the port counts the
same pairs in ``ClusterAutoscaler.decisions``.  The reference's chaos
kill-point inside the scale-up apply is not carried (the port has no chaos
module).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..api import objects as v1
from ..api.resource import compute_pod_resource_request, parse_quantity
from ..descheduler import EvictionAPI, clone_for_replacement
from ..gang import POD_GROUP_LABEL, SLICE_LABEL
from ..whatif import ForkSpec, WhatIfEngine
from .api import (
    NodeGroup,
    materialize_nodes,
    member_nodes,
    next_node_index,
    next_slice_index,
)


@dataclass
class ScaleDecision:
    """One sync's verdict (for tests and the record)."""

    direction: str  # "up" | "down"
    group: str
    result: str  # applied | dry_run | no_fit | at_max | error | blocked | no_replacement
    count: int = 0  # nodes added / removed
    note: str = ""


class ClusterAutoscaler:
    name = "cluster-autoscaler"

    def __init__(self, store, scheduler,
                 eviction_api: Optional[EvictionAPI] = None,
                 clock=None,
                 dry_run: bool = False,
                 max_scale_downs_per_sync: int = 1,
                 scale_down_utilization_threshold: float = 0.5,
                 max_simulated_sizes: int = 6,
                 min_interval: float = 0.0,
                 slice_label: Optional[str] = None,
                 expander: str = "least-cost"):
        if expander not in ("least-cost", "least-waste"):
            raise ValueError(f"unknown expander {expander!r}; "
                             f"expected 'least-cost' or 'least-waste'")
        self.store = store
        self.scheduler = scheduler
        self.clock = clock or getattr(scheduler, "clock", time.monotonic)
        self.evictions = eviction_api or EvictionAPI(store)
        self.engine = WhatIfEngine(scheduler)
        self.dry_run = dry_run
        # disruption pacing: at most this many nodes leave per sync, spaced
        # by min_interval between active syncs
        self.max_scale_downs_per_sync = max_scale_downs_per_sync
        self.scale_down_utilization_threshold = scale_down_utilization_threshold
        # the K of one scale-up evaluate (candidate sizes per group ramp
        # est → 2·est → … → headroom)
        self.max_simulated_sizes = max_simulated_sizes
        self.min_interval = min_interval
        self.slice_label = slice_label or SLICE_LABEL
        # how to pick among groups whose simulated scale-up places the whole
        # demand: least-cost (count × costPerNode) or least-waste (the
        # unused fraction of the ADDED capacity, then cost)
        self.expander = expander
        self._last_active = float("-inf")
        self.last_decisions: List[ScaleDecision] = []
        # (direction, result) → count
        self.decisions: Dict[Tuple[str, str], int] = {}

    def _count(self, direction: str, result: str) -> None:
        key = (direction, result)
        self.decisions[key] = self.decisions.get(key, 0) + 1

    # --- demand ---------------------------------------------------------------

    def _demand(self) -> List[v1.Pod]:
        """Unschedulable demand: starved PodGroups' unbound members plus
        plain parked pods.  Only pods the scheduler has actually FAILED
        count — a transiently pending pod must not trigger a scale-up."""
        parked = {p.uid: p for p in self.scheduler.queue.unschedulable_pods()}
        groups, _ = self.store.list("PodGroup")
        pods, _ = self.store.list("Pod")
        members_by_group: Dict[Tuple[str, str], List[v1.Pod]] = {}
        for p in pods:
            g = p.metadata.labels.get(POD_GROUP_LABEL)
            if g:
                members_by_group.setdefault((p.namespace, g), []).append(p)
        demand: Dict[str, v1.Pod] = {}
        for pg in groups:
            members = members_by_group.get((pg.namespace, pg.name), [])
            if len(members) < pg.min_member:
                continue  # below quorum: capacity cannot help yet
            unbound = [p for p in members if not p.spec.node_name]
            if not unbound:
                continue
            starved = (pg.phase == v1.POD_GROUP_UNSCHEDULABLE
                       or any(p.uid in parked for p in unbound))
            if starved:
                # the WHOLE unbound remainder: a gang binds all-or-nothing
                for p in unbound:
                    demand[p.uid] = p
        for uid, p in parked.items():
            if uid not in demand and POD_GROUP_LABEL not in p.metadata.labels:
                demand[uid] = p
        ordered = self.engine.order_pending(list(demand.values()))
        batch = self.scheduler.batch_size
        if len(ordered) <= batch:
            return ordered
        # the engine solves at most one batch — truncate on a GANG boundary:
        # a gang split by a plain prefix cut can never pass the solve's
        # all-or-nothing mask
        prefix = ordered[:batch]
        gangs = self.scheduler.gangs
        full_c: Dict[str, int] = {}
        for p in ordered:
            k = gangs.group_key_of(p)
            if k is not None:
                full_c[k] = full_c.get(k, 0) + 1
        pre_c: Dict[str, int] = {}
        for p in prefix:
            k = gangs.group_key_of(p)
            if k is not None:
                pre_c[k] = pre_c.get(k, 0) + 1
        return [p for p in prefix
                if gangs.group_key_of(p) is None
                or pre_c[gangs.group_key_of(p)] == full_c[gangs.group_key_of(p)]]

    # --- the loop -------------------------------------------------------------

    def sync_once(self) -> bool:
        now = self.clock()
        if now - self._last_active < self.min_interval:
            return False
        # engine quiescence: flush in-flight pipelined batches first
        for _ in range(4):
            if not self.scheduler._inflight_q:
                break
            self.scheduler.schedule_cycle()
        if self.scheduler._inflight_q:
            return False
        self.scheduler.join_sync_ahead()
        groups, _ = self.store.list("NodeGroup")
        if not groups:
            return False
        self.last_decisions = []
        demand = self._demand()
        if demand:
            # zero-add baseline first: when the demand already fits the
            # CURRENT cluster (an earlier scale-up landed, the pods have not
            # retried yet), adding more nodes would over-provision
            baseline = self.engine.evaluate_one(demand, ForkSpec(note="baseline"))
            if baseline is None:
                return False  # engine refused; retry next sync
            if baseline.unplaced == 0:
                return False
            changed = self._scale_up(groups, demand, baseline.placed)
        else:
            # never shrink while ANY pod is queued or held at Permit: fresh
            # empty nodes would read as underutilized and flap back down
            a, b, u = self.scheduler.queue.pending_count()
            if a or b or u or self.scheduler._waiting_binds:
                return False
            changed = self._scale_down(groups)
        if changed:
            self._last_active = now
        return changed

    # --- scale-up -------------------------------------------------------------

    @staticmethod
    def _demand_totals(pending: List[v1.Pod]) -> Dict[str, float]:
        """Total pending demand per resource (cpu in milli; extended and
        device resources included)."""
        need: Dict[str, float] = {"cpu": 0.0, "memory": 0.0, "pods": float(len(pending))}
        for p in pending:
            r = compute_pod_resource_request(p)
            need["cpu"] += r.milli_cpu
            need["memory"] += r.memory
            for res, amt in r.scalar_resources.items():
                need[res] = need.get(res, 0.0) + float(amt)
        return need

    @staticmethod
    def _template_caps(group: NodeGroup) -> Dict[str, float]:
        """One template node's capacity per resource (cpu in milli), zero
        or absent resources dropped."""
        caps: Dict[str, float] = {}
        for res, q in group.capacity.items():
            v = float(parse_quantity(q))
            if res == "cpu":
                v *= 1000.0
            if v > 0:
                caps[res] = v
        return caps

    def _estimate_nodes(self, group: NodeGroup, pending: List[v1.Pod]) -> int:
        """Binpacking lower bound: per resource, total pending demand over
        one template node's capacity."""
        need = self._demand_totals(pending)
        caps = self._template_caps(group)
        est = 1
        for res, n in need.items():
            cap = caps.get(res, 0.0)
            if cap > 0 and n > 0:
                est = max(est, -(-int(n) // int(cap)))
        return int(est)

    def _waste_of(self, group: NodeGroup, count: int, need: Dict[str, float]) -> float:
        """Unused fraction of the ADDED capacity, averaged over the template's
        resources (upstream expander/waste); 0.0 = the demand fills the new
        nodes, 1.0 = they would sit empty."""
        caps = self._template_caps(group)
        fracs = []
        for res, cap in caps.items():
            total = cap * count
            if total <= 0:
                continue
            fracs.append(max(0.0, 1.0 - min(need.get(res, 0.0) / total, 1.0)))
        return sum(fracs) / len(fracs) if fracs else 1.0

    def _candidate_counts(self, group: NodeGroup, est: int, headroom: int) -> List[int]:
        """Candidate node counts for one group's evaluate: the estimate
        rounded up to whole slices, doubling toward the group's headroom."""
        s = max(group.slice_size, 1)
        cands: List[int] = []
        cur = max(est, 1)
        while len(cands) < self.max_simulated_sizes:
            rounded = min(-(-cur // s) * s, headroom)
            if rounded >= 1 and rounded not in cands:
                cands.append(rounded)
            if rounded >= headroom:
                break
            cur = max(cur * 2, rounded + 1)
        return sorted(cands)

    def _scale_up(self, groups: List[NodeGroup], demand: List[v1.Pod],
                  base_placed: int = 0) -> bool:
        """The cheapest group / count whose fork places the WHOLE demand;
        when none does, the candidate placing the MOST pods beyond the
        zero-add baseline, the cheaper breaking ties."""
        nodes, _ = self.store.list("Node")
        need = self._demand_totals(demand)
        best = None  # (expander key, group, nodes)
        best_partial = None  # (placed, cost, group, nodes)
        any_headroom = False
        for group in sorted(groups, key=lambda g: (g.cost_per_node, g.metadata.name)):
            size = len(member_nodes(group, nodes))
            headroom = group.max_size - size
            if headroom <= 0:
                continue
            any_headroom = True
            counts = self._candidate_counts(group, self._estimate_nodes(group, demand),
                                            headroom)
            start_idx = next_node_index(group, nodes)
            start_slice = next_slice_index(group, nodes, self.slice_label)
            forks = [ForkSpec(add_nodes=materialize_nodes(group, count, start_idx,
                                                          start_slice, self.slice_label),
                              note=f"scale-up {group.name}+{count}")
                     for count in counts]
            try:
                preds = self.engine.evaluate(demand, forks)
            except Exception as e:
                # one group's unbuildable fork (a name collision, encoding
                # capacity) must not take the loop down — the engine rolled
                # its scratch rows back
                self._count("up", "error")
                self.last_decisions.append(ScaleDecision(
                    "up", group.name, "error", note=f"{type(e).__name__}: {e}"))
                continue
            if preds is None:
                return False  # engine refused (pipeline not quiescent)
            for count, fork, pred in zip(counts, forks, preds):
                cost = count * group.cost_per_node
                if pred.unplaced == 0:
                    if self.expander == "least-waste":
                        key = (self._waste_of(group, count, need), cost, group.name)
                    else:
                        key = (cost, group.name)
                    if best is None or key < best[0]:
                        best = (key, group, fork.add_nodes)
                    break  # ascending counts: the first viable is the cheapest
                if pred.placed > base_placed and (
                        best_partial is None
                        or (pred.placed, -cost) > (best_partial[0], -best_partial[1])):
                    best_partial = (pred.placed, cost, group, fork.add_nodes)
        if best is not None:
            _key, group, new_nodes = best
            note = f"add {len(new_nodes)} × {group.name} for {len(demand)} pending pods"
        elif best_partial is not None:
            placed, _cost, group, new_nodes = best_partial
            note = (f"add {len(new_nodes)} × {group.name}: places {placed}/{len(demand)} "
                    f"pending pods (partial)")
        else:
            result = "no_fit" if any_headroom else "at_max"
            self._count("up", result)
            self.last_decisions.append(ScaleDecision(
                "up", "", result, note=f"{len(demand)} pods unplaceable"))
            return False
        decision = ScaleDecision("up", group.name, "applied", count=len(new_nodes), note=note)
        if self.dry_run:
            decision.result = "dry_run"
            self.last_decisions.append(decision)
            return False
        created = 0
        for node in new_nodes:
            if self.store.get("Node", "", node.metadata.name) is not None:
                continue  # an earlier (faulted) apply created it: exactly once
            try:
                self.store.create("Node", node)
                created += 1
            except ValueError:
                continue  # raced into existence — the same exactly-once guard
            except Exception as e:
                # a store fault mid-apply: stop here; the next sync recounts
                # live membership and resumes with the SAME names
                self._count("up", "error")
                decision.result = "error"
                decision.count = created
                decision.note = f"{note}: {type(e).__name__}: {e}"
                self.last_decisions.append(decision)
                return created > 0
        self._count("up", "applied")
        decision.count = created
        self.last_decisions.append(decision)
        return created > 0

    # --- scale-down -----------------------------------------------------------

    def _utilization(self, node: v1.Node, pods_on: List[v1.Pod]) -> float:
        cap = float(parse_quantity(node.status.allocatable.get("cpu", 0)))
        if cap <= 0:
            return 1.0
        used = sum(compute_pod_resource_request(p).milli_cpu for p in pods_on) / 1000.0
        return used / cap

    def _scale_down(self, groups: List[NodeGroup]) -> bool:
        nodes, _ = self.store.list("Node")
        pods, _ = self.store.list("Pod")
        by_node: Dict[str, List[v1.Pod]] = {}
        for p in pods:
            if p.spec.node_name:
                by_node.setdefault(p.spec.node_name, []).append(p)
        downs = 0
        changed = False
        for group in groups:
            members = member_nodes(group, nodes)
            spare = len(members) - group.min_size
            cands = []
            for node in members:
                pods_on = by_node.get(node.metadata.name, [])
                if any(POD_GROUP_LABEL in p.metadata.labels for p in pods_on):
                    continue  # never break a placed gang for capacity
                util = self._utilization(node, pods_on)
                if util < self.scale_down_utilization_threshold:
                    cands.append((util, node, pods_on))
            cands.sort(key=lambda t: (t[0], t[1].metadata.name))
            for _util, node, pods_on in cands:
                if downs >= self.max_scale_downs_per_sync or spare <= 0:
                    break
                verdict = self._try_scale_down(group, node, pods_on)
                self.last_decisions.append(verdict)
                if verdict.result in ("applied", "dry_run"):
                    downs += 1
                    spare -= 1
                    changed = changed or verdict.result == "applied"
        return changed

    def _try_scale_down(self, group: NodeGroup, node: v1.Node,
                        pods_on: List[v1.Pod]) -> ScaleDecision:
        name = node.metadata.name
        decision = ScaleDecision("down", group.name, "", count=1, note=name)
        # JOINT budget pre-check: a drain evicts every resident pod, so each
        # matching PDB must afford the node's whole matching count at once
        pdbs = self.store.list("PodDisruptionBudget")[0]
        pdb_load: Dict[str, Tuple[object, int]] = {}
        for p in pods_on:
            for pdb in self.evictions.matching_pdbs(p, pdbs):
                key = f"{pdb.metadata.namespace}/{pdb.metadata.name}"
                pdb_load[key] = (pdb, pdb_load.get(key, (pdb, 0))[1] + 1)
        blocked = next((key for key, (pdb, cnt) in pdb_load.items()
                        if pdb.disruptions_allowed < cnt), None)
        if blocked is not None:
            self._count("down", "blocked")
            decision.result = "blocked"
            decision.note = (f"{name}: pdb {blocked} cannot afford "
                             f"{pdb_load[blocked][1]} disruptions")
            return decision
        if pods_on:
            # the what-if proof: every displaced pod's replacement clone
            # re-places with the node removed and its pods masked out
            clones = [clone_for_replacement(p) for p in pods_on]
            pred = self.engine.evaluate_one(clones, ForkSpec(
                victims=list(pods_on), remove_nodes=[name], note=f"scale-down {name}"))
            if pred is None or pred.unplaced:
                self._count("down", "no_replacement")
                decision.result = "no_replacement"
                decision.note = (f"{name}: {pred.unplaced if pred else len(clones)} "
                                 f"displaced pods don't re-place")
                return decision
        if self.dry_run:
            decision.result = "dry_run"
            return decision
        # apply: cordon → drain through the shared eviction gate → delete; a
        # refusal or fault mid-drain aborts (uncordon back)
        try:
            node.spec.unschedulable = True
            self.store.update("Node", node)
            for p in pods_on:
                r = self.evictions.evict(p, reason=f"scale-down {name}", policy="autoscaler")
                if not r.evicted:
                    node.spec.unschedulable = False
                    self.store.update("Node", node)
                    self._count("down", "blocked")
                    decision.result = "blocked"
                    decision.note = f"{name}: drain refused ({r.reason})"
                    return decision
            self.store.delete("Node", "", name)
        except Exception as e:
            self._count("down", "error")
            decision.result = "error"
            decision.note = f"{name}: {type(e).__name__}: {e}"
            # best-effort uncordon: a node stranded cordoned but undeleted
            # would leak capacity while its pods re-trigger scale-ups
            try:
                live = self.store.get("Node", "", name)
                if live is not None and live.spec.unschedulable:
                    live.spec.unschedulable = False
                    self.store.update("Node", live)
            except Exception:
                pass  # the next sync re-evaluates from live state
            return decision
        self._count("down", "applied")
        decision.result = "applied"
        return decision
