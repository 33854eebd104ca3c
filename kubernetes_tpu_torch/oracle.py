"""Sequential host oracle, filter half: reference-exact plugin filter
semantics in plain Python, one (pod, node) at a time over host NodeInfos.

Reference: the JAX package's oracle.py (``fits_resources`` :63,
``tolerates_all_hard_taints`` :83, ``node_affinity_fits`` :93,
``node_name_fits`` :106, ``node_ports_fit`` :110, ``node_schedulable`` :114,
the topology-spread prefilter and fit :124-195, the inter-pod affinity
prefilter and fit :265-358, ``Oracle.feasible_nodes`` :529-569), itself
the straight-line reimplementation of the Go scheduler's filter plugins.
Preemption's serial dry run (``preemption.select_victims_on_node``) and the
nominated-node fast bind's live re-check (``TorchScheduler.
_try_nominated_fast_bind``) call these; the oracle's score half is not
ported (nothing in the port calls it).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

from .api import objects as v1
from .api.labels import (
    affinity_term_matches,
    match_label_selector,
    match_node_selector,
)
from .api.resource import compute_pod_resource_request
from .state.node_info import NodeInfo, PodInfo, _pod_host_ports, host_ports_conflict

UNSCHEDULABLE_TAINT = "node.kubernetes.io/unschedulable"


# --- individual plugin semantics (filter) ------------------------------------

def fits_resources(pod: v1.Pod, info: NodeInfo) -> bool:
    """fit.go:255-328 fitsRequest."""
    req = compute_pod_resource_request(pod)
    alloc, used = info.allocatable, info.requested
    if len(info.pods) + 1 > alloc.allowed_pod_number:
        return False
    checks = [
        (req.milli_cpu, alloc.milli_cpu - used.milli_cpu),
        (req.memory, alloc.memory - used.memory),
        (req.ephemeral_storage, alloc.ephemeral_storage - used.ephemeral_storage),
    ]
    for want, free in checks:
        if want > 0 and want > free:
            return False
    for name, want in req.scalar_resources.items():
        if want > 0 and want > alloc.scalar_resources.get(name, 0) - used.scalar_resources.get(name, 0):
            return False
    return True


def tolerates_all_hard_taints(pod: v1.Pod, node: v1.Node) -> bool:
    """taint_toleration.go:64-82 (NoSchedule/NoExecute only)."""
    for taint in node.spec.taints:
        if taint.effect == v1.TAINT_PREFER_NO_SCHEDULE:
            continue
        if not any(t.tolerates(taint) for t in pod.spec.tolerations):
            return False
    return True


def node_affinity_fits(pod: v1.Pod, node: v1.Node) -> bool:
    """nodeaffinity Filter: nodeSelector AND requiredDuringScheduling."""
    if pod.spec.node_selector:
        for k, want in pod.spec.node_selector.items():
            if node.metadata.labels.get(k) != want:
                return False
    aff = pod.spec.affinity
    if aff and aff.node_affinity and aff.node_affinity.required is not None:
        if not match_node_selector(aff.node_affinity.required, node):
            return False
    return True


def node_name_fits(pod: v1.Pod, node: v1.Node) -> bool:
    return not pod.spec.node_name or pod.spec.node_name == node.metadata.name


def node_ports_fit(pod: v1.Pod, info: NodeInfo) -> bool:
    return not host_ports_conflict(_pod_host_ports(pod), info.used_ports)


def node_schedulable(pod: v1.Pod, node: v1.Node) -> bool:
    if not node.spec.unschedulable:
        return True
    fake = v1.Taint(key=UNSCHEDULABLE_TAINT, effect=v1.TAINT_NO_SCHEDULE)
    return any(t.tolerates(fake) for t in pod.spec.tolerations)


# --- topology spread ----------------------------------------------------------


def _spread_constraints(pod: v1.Pod, when: str) -> List[v1.TopologySpreadConstraint]:
    return [c for c in pod.spec.topology_spread_constraints if c.when_unsatisfiable == when]


def _count_matching(info: NodeInfo, selector, ns: str) -> int:
    """countPodsMatchSelector: same namespace, non-terminating."""
    n = 0
    for pi in info.pods:
        p = pi.pod
        if p.namespace != ns or p.metadata.deletion_timestamp is not None:
            continue
        if selector is not None and match_label_selector(selector, p.metadata.labels):
            n += 1
    return n


def _spread_counts(
    pod: v1.Pod, node_infos: List[NodeInfo], constraints
) -> Tuple[Dict[Tuple[str, str], int], Dict[str, int]]:
    """TpPairToMatchNum over affinity-eligible nodes holding all keys
    (filtering.go:256-289); also per-key domain counts."""
    pair_counts: Dict[Tuple[str, str], int] = {}
    domains: Dict[str, int] = {}
    for info in node_infos:
        node = info.node
        if node is None or not node_affinity_fits(pod, node):
            continue
        if any(c.topology_key not in node.metadata.labels for c in constraints):
            continue
        for c in constraints:
            pair = (c.topology_key, node.metadata.labels[c.topology_key])
            if pair not in pair_counts:
                pair_counts[pair] = 0
                domains[c.topology_key] = domains.get(c.topology_key, 0) + 1
            pair_counts[pair] += _count_matching(info, c.label_selector, pod.namespace)
    return pair_counts, domains


def topology_spread_fits(
    pod: v1.Pod, info: NodeInfo, node_infos: List[NodeInfo],
    enable_min_domains: bool = True,
    prefilter=None,
) -> bool:
    """filtering.go:343-358. ``prefilter`` carries the per-pod counts computed
    once per cycle (PreFilter), mirroring the reference's CycleState reuse."""
    constraints = _spread_constraints(pod, v1.DO_NOT_SCHEDULE)
    if not constraints:
        return True
    node = info.node
    if prefilter is None:
        prefilter = _spread_counts(pod, node_infos, constraints)
    pair_counts, domains = prefilter
    for c in constraints:
        if c.topology_key not in node.metadata.labels:
            return False
        self_match = 1 if (
            c.label_selector is not None
            and match_label_selector(c.label_selector, pod.metadata.labels)
        ) else 0
        key_counts = [v for (k, _), v in pair_counts.items() if k == c.topology_key]
        min_match = min(key_counts) if key_counts else (1 << 31)
        if enable_min_domains and c.min_domains:
            if domains.get(c.topology_key, 0) < c.min_domains:
                min_match = 0
        match_num = pair_counts.get(
            (c.topology_key, node.metadata.labels[c.topology_key]), 0
        )
        if match_num + self_match - min_match > c.max_skew:
            return False
    return True


# --- inter-pod affinity -------------------------------------------------------


def _term_matches_all(terms, owner: v1.Pod, target: v1.Pod, ns_labels) -> bool:
    if not terms:
        return False
    return all(affinity_term_matches(t, owner, target, ns_labels) for t in terms)


@dataclass
class InterPodPreFilterState:
    """preFilterState (filtering.go:44-55): the three topologyPair→count maps
    plus the incoming pod's parsed terms, built ONCE per cycle."""

    pod_info: PodInfo
    exist_anti_pairs: Dict[Tuple[str, str], int] = field(default_factory=dict)
    aff_counts: Dict[Tuple[str, str], int] = field(default_factory=dict)
    anti_counts: Dict[Tuple[str, str], int] = field(default_factory=dict)
    self_match_all: bool = False


def interpod_prefilter(
    pod: v1.Pod, node_infos: List[NodeInfo],
    namespace_labels: Optional[Mapping[str, Mapping[str, str]]] = None,
) -> InterPodPreFilterState:
    pi = PodInfo.of(pod)
    s = InterPodPreFilterState(pod_info=pi)
    # existing pods' required anti-affinity vs incoming (getExistingAntiAffinityCounts)
    for other in node_infos:
        if other.node is None:
            continue
        olabels = other.node.metadata.labels
        for epi in other.pods_with_required_anti_affinity:
            for term in epi.required_anti_affinity_terms:
                if affinity_term_matches(term, epi.pod, pod, namespace_labels):
                    tv = olabels.get(term.topology_key)
                    if tv is not None:
                        key = (term.topology_key, tv)
                        s.exist_anti_pairs[key] = s.exist_anti_pairs.get(key, 0) + 1
        # incoming's maps (getIncomingAffinityAntiAffinityCounts)
        if pi.required_affinity_terms or pi.required_anti_affinity_terms:
            for epi in other.pods:
                if pi.required_affinity_terms and _term_matches_all(
                    pi.required_affinity_terms, pod, epi.pod, namespace_labels
                ):
                    for term in pi.required_affinity_terms:
                        tv = olabels.get(term.topology_key)
                        if tv is not None:
                            key = (term.topology_key, tv)
                            s.aff_counts[key] = s.aff_counts.get(key, 0) + 1
                for term in pi.required_anti_affinity_terms:
                    if affinity_term_matches(term, pod, epi.pod, namespace_labels):
                        tv = olabels.get(term.topology_key)
                        if tv is not None:
                            key = (term.topology_key, tv)
                            s.anti_counts[key] = s.anti_counts.get(key, 0) + 1
    s.self_match_all = _term_matches_all(
        pi.required_affinity_terms, pod, pod, namespace_labels
    )
    return s


def interpod_affinity_fits(
    pod: v1.Pod, info: NodeInfo, node_infos: List[NodeInfo],
    namespace_labels: Optional[Mapping[str, Mapping[str, str]]] = None,
    prefilter: Optional[InterPodPreFilterState] = None,
) -> bool:
    """filtering.go:308-360 (three satisfy* checks) against the prefilter maps."""
    s = prefilter or interpod_prefilter(pod, node_infos, namespace_labels)
    pi = s.pod_info
    labels = info.node.metadata.labels

    # satisfyExistingPodsAntiAffinity (:308-320)
    if s.exist_anti_pairs:
        for key, value in labels.items():
            if s.exist_anti_pairs.get((key, value), 0) > 0:
                return False

    # satisfyPodAntiAffinity (:323-335)
    for term in pi.required_anti_affinity_terms:
        tv = labels.get(term.topology_key)
        if tv is not None and s.anti_counts.get((term.topology_key, tv), 0) > 0:
            return False

    # satisfyPodAffinity (:338-360)
    if pi.required_affinity_terms:
        pods_exist = True
        for term in pi.required_affinity_terms:
            tv = labels.get(term.topology_key)
            if tv is None:
                return False
            if s.aff_counts.get((term.topology_key, tv), 0) <= 0:
                pods_exist = False
        if not pods_exist:
            return bool(not s.aff_counts and s.self_match_all)
    return True



# --- the oracle ------------------------------------------------------------------


class Oracle:
    """One-pod-at-a-time reference filters over host NodeInfos (the
    reference's default OracleConfig: minDomains on)."""

    def __init__(self, namespace_labels: Optional[Mapping[str, Mapping[str, str]]] = None):
        self.namespace_labels = namespace_labels

    def feasible_nodes(self, pod: v1.Pod, node_infos: List[NodeInfo]) -> List[NodeInfo]:
        # PreFilter once per pod (the reference's CycleState), Filter per node
        hard_constraints = _spread_constraints(pod, v1.DO_NOT_SCHEDULE)
        spread_state = (
            _spread_counts(pod, node_infos, hard_constraints)
            if hard_constraints else None
        )
        ipa_state = interpod_prefilter(pod, node_infos, self.namespace_labels)
        out = []
        for info in node_infos:
            node = info.node
            if node is None:
                continue
            if not node_name_fits(pod, node):
                continue
            if not v1.node_is_ready(node):
                # node-lifecycle mask: a NotReady host is out of the
                # schedulable universe entirely (no toleration escape —
                # matches the device path's node_valid & node_ready gate)
                continue
            if not node_schedulable(pod, node):
                continue
            if not node_affinity_fits(pod, node):
                continue
            if not tolerates_all_hard_taints(pod, node):
                continue
            if not node_ports_fit(pod, info):
                continue
            if not fits_resources(pod, info):
                continue
            if not topology_spread_fits(
                pod, info, node_infos, prefilter=spread_state,
            ):
                continue
            if not interpod_affinity_fits(
                pod, info, node_infos, self.namespace_labels, prefilter=ipa_state
            ):
                continue
            out.append(info)
        return out
