"""NodeGroup: the cluster autoscaler's scalable capacity unit.

Reference: the JAX package's autoscaler/api.py (``NodeGroup`` :31-69,
``member_nodes`` :72, ``next_node_index`` :86, ``next_slice_index`` :102,
``materialize_nodes`` :112), itself after kubernetes/autoscaler
cluster-autoscaler's cloudprovider.NodeGroup (MinSize / MaxSize /
TemplateNodeInfo).  The group is an API object whose template carries the
TPU host shape — capacity, labels, taints, and the
``tpu.kubernetes.io/slice`` topology: ``slice_size`` > 0 batches new hosts
into fresh whole slices, so a scaled-up group is immediately
gang-anchorable.

Membership: live nodes carry ``autoscaler.tpu.kubernetes.io/node-group`` =
group name; the controller derives the current size from that label —
exactly-once falls out of deterministic node names plus a live recount.
The port has no API scheme, so the reference's scheme round trip is not
carried; ``from_dict`` is.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping

from ..api import objects as v1

# live nodes are tied to their group by this label
NODE_GROUP_LABEL = "autoscaler.tpu.kubernetes.io/node-group"


@dataclass
class NodeGroup:
    """autoscaling.x-k8s.io/v1alpha1 NodeGroup — min / max size and the
    template node shape scale-ups materialize."""

    metadata: v1.ObjectMeta = field(default_factory=v1.ObjectMeta)
    min_size: int = 0
    max_size: int = 1
    # template node shape
    capacity: Dict[str, object] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    taints: List[v1.Taint] = field(default_factory=list)
    # > 0: new hosts are batched into fresh slices of this many
    slice_size: int = 0
    # relative cost unit for the least-cost expander: count × cost_per_node
    cost_per_node: float = 1.0

    kind = "NodeGroup"

    @property
    def name(self) -> str:
        return self.metadata.name

    @classmethod
    def from_dict(cls, d: Mapping) -> "NodeGroup":
        spec = d.get("spec") or {}
        tmpl = spec.get("template") or {}
        return cls(
            metadata=v1.ObjectMeta.from_dict(d.get("metadata") or {}),
            min_size=int(spec.get("minSize", 0)),
            max_size=int(spec.get("maxSize", 1)),
            capacity=dict(tmpl.get("capacity") or {}),
            labels=dict(tmpl.get("labels") or {}),
            taints=[v1.Taint.from_dict(t) for t in tmpl.get("taints") or []],
            slice_size=int(tmpl.get("sliceSize", 0)),
            cost_per_node=float(spec.get("costPerNode", 1.0)),
        )


def member_nodes(group: NodeGroup, nodes: List[v1.Node]) -> List[v1.Node]:
    """Live nodes belonging to the group (label-tagged membership)."""
    return [n for n in nodes if n.metadata.labels.get(NODE_GROUP_LABEL) == group.name]


def _trailing_index(name: str, prefix: str) -> int:
    """The numeric suffix of ``{prefix}{i}``; −1 when not ours."""
    if not name.startswith(prefix):
        return -1
    tail = name[len(prefix):]
    return int(tail) if tail.isdigit() else -1


def next_node_index(group: NodeGroup, nodes: List[v1.Node]) -> int:
    """1 + the highest ``{group}-{i}`` node index in the cluster.

    Deterministic naming is the exactly-once mechanism: a scale-up retried
    after a store fault proposes the SAME names, and already-created nodes
    are detected instead of duplicated.  Scans ALL nodes by name, not just
    labelled members, so a same-named node without the group label is
    skipped over instead of colliding with the simulation's encode."""
    prefix = f"{group.name}-"
    return 1 + max((_trailing_index(n.metadata.name, prefix) for n in nodes), default=-1)


def next_slice_index(group: NodeGroup, nodes: List[v1.Node], slice_label: str) -> int:
    prefix = f"{group.name}-slice-"
    return 1 + max((_trailing_index(n.metadata.labels.get(slice_label, ""), prefix)
                    for n in nodes), default=-1)


def materialize_nodes(group: NodeGroup, count: int, start_index: int,
                      start_slice: int, slice_label: str) -> List[v1.Node]:
    """``count`` template nodes with deterministic names and slice labels —
    the SAME objects the simulation forks and the apply creates, so a
    simulated placement on an added node names the real node it becomes."""
    out: List[v1.Node] = []
    for i in range(count):
        idx = start_index + i
        labels = dict(group.labels)
        labels[NODE_GROUP_LABEL] = group.name
        if group.slice_size > 0:
            labels[slice_label] = f"{group.name}-slice-{start_slice + i // group.slice_size}"
        out.append(v1.Node(
            metadata=v1.ObjectMeta(name=f"{group.name}-{idx}", labels=labels),
            spec=v1.NodeSpec(taints=list(group.taints)),
            status=v1.NodeStatus(capacity=dict(group.capacity),
                                 allocatable=dict(group.capacity)),
        ))
    return out
