"""Descheduler policies: candidate eviction-set enumeration.

Reference: the JAX package's descheduler/policies.py (``CandidatePlan``
:32, ``PolicyContext`` :63, ``clone_for_replacement`` :84,
``SliceDefragmentation`` :110, ``SpreadViolationRepair`` :236,
``NodeDrainPolicy`` :324, ``default_policies`` :370), itself after
sigs.k8s.io/descheduler (RemovePodsViolatingTopologySpread, the node-drain
flow of kubectl drain) with the north-star framing: "which evictions free a
slice at least cost" is a batched counterfactual solve
(descheduler/planner.py).  The policies only ENUMERATE candidate plans;
the controller scores each on the device and applies the cheapest viable
plan through the eviction gate.

All three policies are PDB-aware by construction: a candidate whose
victims include a budget-blocked pod is skipped (defrag needs the WHOLE
slice) or the protected pod is left out (drain defers it to a later sync).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..api import objects as v1
from ..api.labels import match_label_selector
from ..gang import POD_GROUP_LABEL, SLICE_LABEL

# Nodes annotated with this (value "true") are drained by NodeDrainPolicy:
# cordoned, then evicted through the gate over however many syncs the PDB
# budgets take.
DRAIN_ANNOTATION = "descheduler.tpu.kubernetes.io/drain"


@dataclass
class CandidatePlan:
    """One candidate eviction set, before scoring."""

    policy: str
    victims: List[v1.Pod]
    # pods the plan intends to make schedulable (solved with the victims
    # masked); empty = no placement requirement (drain)
    pending: List[v1.Pod] = field(default_factory=list)
    # victim clones for a SECOND solve on the winning plan only (scoring
    # "replacement placements found" without perturbing the pending solve)
    replacements: List[v1.Pod] = field(default_factory=list)
    note: str = ""  # target slice / node / constraint, for logs
    # plans sharing a group compete (the controller applies the cheapest
    # viable plan PER group per sync): defrag groups by waiting gang,
    # spread by constraint, drain by node
    group: str = ""
    # what the plan frees (the slice / node name)
    target: str = ""
    # every pending pod must place for the plan to be viable (defrag)
    require_all_pending: bool = True
    # optional extra validation over the predicted placements
    post_check: Optional[Callable[[Dict[str, Optional[str]]], bool]] = None
    # drain plans skip the counterfactual solve
    no_solve: bool = False


class PolicyContext:
    """What a policy may read: the store, the gang directory and the
    eviction gate (for PDB pre-checks only — policies never evict).
    ``dry_run`` mirrors the controller's mode: a previewing policy writes
    no side effects (the drain cordon) either."""

    def __init__(self, store, gangs, evictions, clock, dry_run=False):
        self.store = store
        self.gangs = gangs
        self.evictions = evictions
        self.clock = clock
        self.dry_run = dry_run
        self._pdbs = None

    @property
    def pdbs(self):
        if self._pdbs is None:
            self._pdbs = self.store.list("PodDisruptionBudget")[0]
        return self._pdbs


def clone_for_replacement(pod: v1.Pod) -> v1.Pod:
    """A what-if stand-in for an evicted / displaced pod's
    controller-recreated replacement: same spec and labels, fresh
    identity, unbound.  The cluster autoscaler's scale-down proof uses the
    same stand-in."""
    clone = copy.deepcopy(pod)
    clone.metadata.uid = f"whatif-{pod.uid}"
    clone.metadata.name = f"whatif-{pod.metadata.name}"
    clone.spec.node_name = ""
    clone.status.nominated_node_name = ""
    return clone


def _evictable(ctx: PolicyContext, pod: v1.Pod) -> bool:
    """Never plan around pods the gate would refuse, pods already
    terminating, or DaemonSet-owned pods (their controller re-places them
    on the same node at once)."""
    if pod.metadata.deletion_timestamp is not None:
        return False
    if any(ref.kind == "DaemonSet" for ref in pod.metadata.owner_references or []):
        return False
    return ctx.evictions.can_evict(pod, ctx.pdbs)


class SliceDefragmentation:
    """Compact stragglers off TPU slices so waiting gangs get whole
    ``tpu.kubernetes.io/slice`` groups — driven by PodGroup demand.

    For up to ``max_gangs_per_sync`` waiting gangs (oldest first), every
    slice whose stragglers are all evictable yields one candidate plan
    (evict the stragglers, pending = the gang's unbound members), grouped
    by gang.  Slices are earmarked as they are claimed: a gang that already
    has a whole-free slice earmarks it and proposes nothing, and later
    gangs' candidates exclude slices earlier gangs claimed."""

    name = "defrag"

    def __init__(self, slice_label: Optional[str] = None,
                 max_candidate_slices: int = 4,
                 max_gangs_per_sync: int = 8):
        self.slice_label = slice_label or SLICE_LABEL
        self.max_candidate_slices = max_candidate_slices
        self.max_gangs_per_sync = max_gangs_per_sync

    def propose(self, ctx: PolicyContext) -> List[CandidatePlan]:
        gangs = self._waiting_gangs(ctx)
        if not gangs:
            return []
        nodes, _ = ctx.store.list("Node")
        by_slice: Dict[str, List[v1.Node]] = {}
        for node in nodes:
            val = node.metadata.labels.get(self.slice_label)
            if val is not None:
                by_slice.setdefault(val, []).append(node)
        pods, _ = ctx.store.list("Pod")
        bound_by_node: Dict[str, List[v1.Pod]] = {}
        for p in pods:
            if p.spec.node_name:
                bound_by_node.setdefault(p.spec.node_name, []).append(p)
        plans: List[CandidatePlan] = []
        earmarked: set = set()
        for group_key, members in gangs[: self.max_gangs_per_sync]:
            member_uids = {p.uid for p in members}
            need = sum(1 for p in members if not p.spec.node_name)
            candidates: List[CandidatePlan] = []
            has_free = False
            for slice_name, slice_nodes in sorted(by_slice.items()):
                if slice_name in earmarked:
                    continue
                if len(slice_nodes) < need:
                    # an undersized slice can never seat the gang one per
                    # host: neither a free claim nor a candidate
                    continue
                stragglers: List[v1.Pod] = []
                blocked = False
                for node in slice_nodes:
                    if node.spec.unschedulable:
                        blocked = True  # a cordoned host cannot host the gang
                        break
                    for p in bound_by_node.get(node.metadata.name, []):
                        if p.uid in member_uids:
                            continue
                        if POD_GROUP_LABEL in p.metadata.labels:
                            # NEVER evict another gang's member to seat this
                            # one: the slice is disqualified outright
                            blocked = True
                            break
                        stragglers.append(p)
                    if blocked:
                        break
                if blocked:
                    continue
                if not stragglers:
                    # a whole-free slice is available: the gang waits on the
                    # scheduler, not on fragmentation — claim it, evict
                    # nothing for this gang
                    earmarked.add(slice_name)
                    has_free = True
                    break
                if not all(_evictable(ctx, p) for p in stragglers):
                    continue  # one protected straggler disqualifies it
                candidates.append(CandidatePlan(
                    policy=self.name, group=group_key, target=slice_name,
                    victims=list(stragglers),
                    pending=[p for p in members if not p.spec.node_name],
                    note=f"slice {slice_name} for gang {group_key}",
                ))
            if has_free or not candidates:
                continue
            candidates.sort(key=lambda pl: len(pl.victims))
            candidates = candidates[: self.max_candidate_slices]
            # the victims' replacement clones, for the candidates kept only
            # (a deep copy a victim: on a fragmented cluster every slice is
            # a candidate, and all but a few are cut above)
            for pl in candidates:
                pl.replacements = [clone_for_replacement(p) for p in pl.victims]
            # claim the cheapest candidate's slice so later gangs do not
            # compete for the same stragglers within this sync
            earmarked.add(candidates[0].target)
            plans.extend(candidates)
        return plans

    def _waiting_gangs(self, ctx: PolicyContext):
        groups, _ = ctx.store.list("PodGroup")
        pods, _ = ctx.store.list("Pod")
        # one pass over the pods, not one scan per PodGroup (members keep
        # the store's order)
        members_of: Dict[tuple, List[v1.Pod]] = {}
        for p in pods:
            g = p.metadata.labels.get(POD_GROUP_LABEL)
            if g is not None:
                members_of.setdefault((p.namespace, g), []).append(p)
        waiting = []
        for pg in groups:
            if pg.phase == v1.POD_GROUP_SCHEDULED:
                continue
            members = members_of.get((pg.namespace, pg.name), [])
            unbound = [p for p in members if not p.spec.node_name]
            if not unbound or len(members) < pg.min_member:
                continue  # below quorum: freeing a slice cannot help yet
            waiting.append((pg.metadata.creation_timestamp or 0.0, pg.key(), members))
        waiting.sort(key=lambda t: (t[0], t[1]))
        return [(key, members) for _, key, members in waiting]


class SpreadViolationRepair:
    """Evict one pod from the most-crowded domain of a drifted
    PodTopologySpread constraint (actual skew above maxSkew), PROVIDED the
    counterfactual solve lands its replacement in a less-crowded domain."""

    name = "spread"

    def propose(self, ctx: PolicyContext) -> List[CandidatePlan]:
        pods, _ = ctx.store.list("Pod")
        nodes, _ = ctx.store.list("Node")
        node_by_name = {n.metadata.name: n for n in nodes}
        plans: List[CandidatePlan] = []
        seen = set()
        for pod in pods:
            if not pod.spec.node_name:
                continue
            for tsc in pod.spec.topology_spread_constraints:
                if tsc.when_unsatisfiable != v1.DO_NOT_SCHEDULE:
                    continue
                sig = (pod.namespace, tsc.topology_key, _selector_sig(tsc.label_selector))
                if sig in seen:
                    continue
                seen.add(sig)
                plan = self._repair_one(ctx, pod, tsc, pods, node_by_name)
                if plan is not None:
                    plans.append(plan)
        return plans

    def _repair_one(self, ctx, owner, tsc, pods, node_by_name):
        counts: Dict[str, int] = {}
        domain_pods: Dict[str, List[v1.Pod]] = {}
        for node in node_by_name.values():
            val = node.metadata.labels.get(tsc.topology_key)
            if val is not None:
                counts.setdefault(val, 0)
        if len(counts) < 2:
            return None
        for p in pods:
            if not p.spec.node_name or p.namespace != owner.namespace:
                continue
            node = node_by_name.get(p.spec.node_name)
            if node is None:
                continue
            val = node.metadata.labels.get(tsc.topology_key)
            if val is None:
                continue
            if tsc.label_selector is not None and match_label_selector(
                    tsc.label_selector, p.metadata.labels):
                counts[val] += 1
                domain_pods.setdefault(val, []).append(p)
        if not counts:
            return None
        max_dom = max(counts, key=lambda d: (counts[d], d))
        skew = counts[max_dom] - min(counts.values())
        if skew <= tsc.max_skew:
            return None
        # the youngest matching pod in the crowded domain the gate allows
        candidates = sorted(
            (p for p in domain_pods.get(max_dom, []) if _evictable(ctx, p)),
            key=lambda p: -(p.metadata.creation_timestamp or 0.0))
        if not candidates:
            return None
        victim = candidates[0]
        clone = clone_for_replacement(victim)
        crowded_nodes = {n.metadata.name for n in node_by_name.values()
                         if n.metadata.labels.get(tsc.topology_key) == max_dom}

        def replacement_leaves_domain(placements) -> bool:
            target = placements.get(clone.uid)
            return target is not None and target not in crowded_nodes

        return CandidatePlan(
            policy=self.name, victims=[victim], pending=[clone],
            group=f"{owner.namespace}/{tsc.topology_key}/"
                  f"{_selector_sig(tsc.label_selector)}",
            note=f"{tsc.topology_key} skew {skew} > {tsc.max_skew} in {max_dom}",
            require_all_pending=True, post_check=replacement_leaves_domain)


class NodeDrainPolicy:
    """Cordon + evict for maintenance: nodes carrying the drain annotation
    are cordoned, then their pods leave through the gate — PDB-refused pods
    stay for a later sync, so a drain never zeroes a protected workload."""

    name = "drain"

    def propose(self, ctx: PolicyContext) -> List[CandidatePlan]:
        nodes, _ = ctx.store.list("Node")
        pods, _ = ctx.store.list("Pod")
        by_node: Dict[str, List[v1.Pod]] = {}
        for p in pods:
            if p.spec.node_name:
                by_node.setdefault(p.spec.node_name, []).append(p)
        plans: List[CandidatePlan] = []
        for node in nodes:
            if node.metadata.annotations.get(DRAIN_ANNOTATION) != "true":
                continue
            if not node.spec.unschedulable and not ctx.dry_run:
                node.spec.unschedulable = True  # cordon first
                ctx.store.update("Node", node)
            victims = [p for p in by_node.get(node.metadata.name, []) if _evictable(ctx, p)]
            if not victims:
                continue
            plans.append(CandidatePlan(
                policy=self.name, victims=victims, group=node.metadata.name,
                target=node.metadata.name, note=f"drain {node.metadata.name}",
                no_solve=True))
        return plans


def _selector_sig(sel: Optional[v1.LabelSelector]) -> tuple:
    if sel is None:
        return ()
    return (tuple(sorted(sel.match_labels.items())),
            tuple((e.key, e.operator, tuple(e.values)) for e in sel.match_expressions))


def default_policies() -> List[object]:
    return [SliceDefragmentation(), SpreadViolationRepair(), NodeDrainPolicy()]
