"""Host-side pod–pod conflict partitioner for the hybrid assignment engine.

A copy of the JAX package's framework/conflict.py (host numpy, no device
code); its two term-signature helpers come from state/affinity_index.py, as
in the reference.

The pre-round-6 dispatch heuristic was all-or-nothing: a batch whose
coupled-pod fraction exceeded ``coupled_fraction_threshold`` abandoned the
parallel batch engine for the greedy-sequential scan WHOLESALE — serializing
even the pods in that batch that interact with nothing.  This module builds
the actual interaction graph instead:

  * pod (anti)affinity: pod A interacts with pod B when any of A's four term
    groups matches B (``affinity_term_matches`` — selector + namespace
    resolution), in either direction (A's commit writes tables B's filter or
    score reads, or vice versa);
  * topology spread: A's constraint selector matches B in A's namespace
    (B's commit bumps A's count tables);
  * gang membership: same PodGroup (the all-or-nothing mask couples them).

Connected components of that graph are the true serialization units:
independent components and all uncoupled pods commit in parallel
batch_assign rounds; only genuinely coupled chains serialize — bounded by
COMPONENT size, not batch size (framework/runtime.py batch_assign).

Pods are deduplicated into identity CLASSES first (namespace + labels +
constraint signatures + gang): templated workloads collapse to a handful of
classes, so the pairwise matching is O(classes²) Python instead of O(B²).
A batch with more than ``class_cap`` distinct classes falls back to the
sound over-approximation (every coupled pod in one component — exactly the
old wholesale behavior after the dispatch router's threshold).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..api.labels import affinity_term_matches, match_label_selector
from ..state.affinity_index import _selector_signature, _term_signature


@dataclass
class ConflictInfo:
    """Per-pod component assignment over a compiled batch.

    comp  — i32[B]: component id (the smallest member pod index); every
            singleton (uncoupled or conflict-free) pod keeps its own index.
    multi — bool[B]: pod shares its component with ≥1 other pod — only these
            pods need any serialization in the engine.
    sizes — multi-component sizes (for the coupled_component_size histogram).
    exact — False when the class-cap fallback merged all coupled pods.
    single_class_reps — component root → representative pod, for multi
            components made of exactly ONE identity class with no gang
            membership.  TPUScheduler's parallel-safe relaxation inspects
            these reps against the live topology (engine_choice): a class
            whose only intra-class effects are used-node-mask-equivalent
            (required anti over singleton domains) or plane-uniform
            (affinity over a single live domain) commits in parallel
            auction rounds like plain pods.
    """

    comp: np.ndarray
    multi: np.ndarray
    sizes: List[int]
    exact: bool = True
    single_class_reps: Optional[dict] = None

    @property
    def max_multi(self) -> int:
        return max(self.sizes, default=0)


def _pod_terms(pod):
    """All four (anti)affinity term groups of a pod, flattened."""
    aff = pod.spec.affinity
    out = []
    if aff is not None:
        if aff.pod_affinity is not None:
            out += list(aff.pod_affinity.required)
            out += [wt.pod_affinity_term for wt in aff.pod_affinity.preferred]
        if aff.pod_anti_affinity is not None:
            out += list(aff.pod_anti_affinity.required)
            out += [wt.pod_affinity_term
                    for wt in aff.pod_anti_affinity.preferred]
    return out


def _class_key(pod, gang_id):
    terms = tuple(sorted(
        repr(_term_signature(t, pod.namespace)) for t in _pod_terms(pod)
    ))
    spreads = tuple(
        (c.topology_key, repr(_selector_signature(c.label_selector)))
        for c in pod.spec.topology_spread_constraints
    )
    return (
        pod.namespace,
        tuple(sorted(pod.metadata.labels.items())),
        terms,
        spreads,
        gang_id,
    )


class _UnionFind:
    def __init__(self, n: int):
        self.p = list(range(n))

    def find(self, x: int) -> int:
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[max(ra, rb)] = min(ra, rb)


def _interacts(a, b, namespace_labels) -> bool:
    """Does placing a pod of class-rep ``a`` affect class-rep ``b``'s
    filter/score planes (or vice versa)?  Symmetric by construction of the
    caller (checked both ways)."""
    for term in _pod_terms(a):
        if affinity_term_matches(term, a, b, namespace_labels):
            return True
    for c in a.spec.topology_spread_constraints:
        if b.namespace == a.namespace and match_label_selector(
                c.label_selector, b.metadata.labels):
            return True
    return False


def conflict_components(pods, size: int, namespace_labels=None,
                        gang_of=None, class_cap: int = 64) -> ConflictInfo:
    """Partition a batch's pods into interaction components.

    ``pods`` — the batch's real pods (≤ size); padding rows get singleton
    components.  ``gang_of`` — optional pod → gang-id callable (defaults to
    the POD_GROUP_LABEL label).
    """
    comp = np.arange(size, dtype=np.int32)
    multi = np.zeros(size, dtype=bool)
    if not pods:
        return ConflictInfo(comp=comp, multi=multi, sizes=[])
    if gang_of is None:
        from ..gang import POD_GROUP_LABEL

        def gang_of(p):
            return p.metadata.labels.get(POD_GROUP_LABEL)

    keys = [_class_key(p, gang_of(p)) for p in pods]
    class_of: dict = {}
    members: List[List[int]] = []
    reps = []
    for i, k in enumerate(keys):
        c = class_of.get(k)
        if c is None:
            c = class_of[k] = len(members)
            members.append([])
            reps.append(pods[i])
        members[c].append(i)
    k_classes = len(members)

    coupled = [
        bool(_pod_terms(r) or r.spec.topology_spread_constraints
             or gang_of(r) is not None)
        for r in reps
    ]
    if k_classes > class_cap:
        # sound over-approximation: all coupled pods one component (the
        # router's threshold then sends the batch to the scan — the exact
        # pre-partitioner behavior)
        idxs = [i for c, m in zip(coupled, members) if c for i in m]
        if len(idxs) >= 2:
            root = min(idxs)
            for i in idxs:
                comp[i] = root
                multi[i] = True
        return ConflictInfo(comp=comp, multi=multi,
                            sizes=[len(idxs)] if len(idxs) >= 2 else [],
                            exact=False)

    uf = _UnionFind(k_classes)
    self_edge = [False] * k_classes
    for a in range(k_classes):
        if not coupled[a]:
            continue
        for b2 in range(k_classes):
            hit = (
                (gang_of(reps[a]) is not None
                 and gang_of(reps[a]) == gang_of(reps[b2]))
                or _interacts(reps[a], reps[b2], namespace_labels)
            )
            if not hit:
                continue
            if a == b2:
                self_edge[a] = True
            else:
                uf.union(a, b2)

    # class-component → pod indices (a class joins a multi component when it
    # is edge-connected to another class, or self-interacts with ≥2 pods)
    groups: dict = {}
    for c in range(k_classes):
        root = uf.find(c)
        groups.setdefault(root, []).append(c)
    sizes: List[int] = []
    single_class_reps: dict = {}
    for root, classes in groups.items():
        idxs = [i for c in classes for i in members[c]]
        linked = len(classes) > 1 or any(self_edge[c] for c in classes)
        if linked and len(idxs) >= 2:
            rep = min(idxs)
            for i in idxs:
                comp[i] = rep
                multi[i] = True
            sizes.append(len(idxs))
            if len(classes) == 1 and gang_of(reps[classes[0]]) is None:
                single_class_reps[rep] = reps[classes[0]]
    return ConflictInfo(comp=comp, multi=multi, sizes=sizes,
                        single_class_reps=single_class_reps)
