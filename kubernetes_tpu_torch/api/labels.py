"""Host-side label/selector evaluation.

Reference semantics: apimachinery ``labels.Selector`` / ``metav1.LabelSelectorAsSelector``
and core v1 ``NodeSelectorRequirement`` matching (component-helpers
scheduling/corev1/nodeaffinity). These host-side evaluators are the parity oracle for
the compiled tensor versions in ``state/selectors.py``.
"""

from __future__ import annotations

from typing import Mapping, Optional

from .objects import (
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_GT,
    OP_IN,
    OP_LT,
    OP_NOT_IN,
    LabelSelector,
    NodeSelector,
    NodeSelectorTerm,
    Node,
)


def match_label_selector(
    selector: Optional[LabelSelector], labels: Mapping[str, str]
) -> bool:
    """metav1 LabelSelector match: None → matches nothing; empty → everything."""
    if selector is None:
        return False
    for k, v in selector.match_labels.items():
        if labels.get(k) != v:
            return False
    for req in selector.match_expressions:
        has = req.key in labels
        val = labels.get(req.key)
        if req.operator == OP_IN:
            if not has or val not in req.values:
                return False
        elif req.operator == OP_NOT_IN:
            if has and val in req.values:
                return False
        elif req.operator == OP_EXISTS:
            if not has:
                return False
        elif req.operator == OP_DOES_NOT_EXIST:
            if has:
                return False
        else:
            return False
    return True


def _match_node_selector_requirement(req, labels: Mapping[str, str]) -> bool:
    has = req.key in labels
    val = labels.get(req.key)
    if req.operator == OP_IN:
        return has and val in req.values
    if req.operator == OP_NOT_IN:
        # apimachinery labels.Requirement.Matches: NotIn matches when the key is
        # absent (reference: labels/selector.go Matches, selection.NotIn case).
        return (not has) or val not in req.values
    if req.operator == OP_EXISTS:
        return has
    if req.operator == OP_DOES_NOT_EXIST:
        return not has
    if req.operator in (OP_GT, OP_LT):
        # Reference: nodeaffinity.go — both label value and the single requirement
        # value must parse as integers.
        if not has or len(req.values) != 1:
            return False
        try:
            lhs = int(val)
            rhs = int(req.values[0])
        except (TypeError, ValueError):
            return False
        return lhs > rhs if req.operator == OP_GT else lhs < rhs
    return False


def match_node_selector_term(
    term: NodeSelectorTerm, node: Node
) -> bool:
    """All expressions AND all fields must match (empty term matches nothing)."""
    if not term.match_expressions and not term.match_fields:
        return False
    for req in term.match_expressions:
        if not _match_node_selector_requirement(req, node.metadata.labels):
            return False
    for req in term.match_fields:
        # Only metadata.name is a valid field selector (reference nodeaffinity.go).
        fields = {"metadata.name": node.metadata.name}
        if not _match_node_selector_requirement(req, fields):
            return False
    return True


def affinity_term_matches(
    term,
    owner_pod,
    target_pod,
    namespace_labels: Optional[Mapping[str, Mapping[str, str]]] = None,
) -> bool:
    """framework.AffinityTerm.Matches semantics (framework/types.go):

    target matches when (target.ns ∈ term.namespaces — defaulted to owner's ns when
    both namespaces and namespaceSelector are unset — OR namespaceSelector matches
    the target namespace's labels) AND labelSelector matches target's labels.
    An empty-but-set namespaceSelector selects every namespace.
    """
    ns_ok = False
    if term.namespaces:
        ns_ok = target_pod.namespace in term.namespaces
    elif term.namespace_selector is None:
        ns_ok = target_pod.namespace == owner_pod.namespace
    if not ns_ok and term.namespace_selector is not None:
        # an empty-but-set selector matches every namespace — match_label_selector
        # already returns True for the empty non-None selector
        labels = (namespace_labels or {}).get(target_pod.namespace, {})
        ns_ok = match_label_selector(term.namespace_selector, labels)
    if not ns_ok:
        return False
    return match_label_selector(term.label_selector, target_pod.metadata.labels)


def match_node_selector(selector: Optional[NodeSelector], node: Node) -> bool:
    """Terms OR together; nil selector matches everything, empty terms list nothing."""
    if selector is None:
        return True
    return any(
        match_node_selector_term(t, node) for t in selector.node_selector_terms
    )
