"""Cluster autoscaler on the whatif engine.

Reference: the JAX package's autoscaler/ (its ``__init__`` :1-30).  Layers:

  api.py        — the NodeGroup object (min / max size, the template node
                  shape with the ``tpu.kubernetes.io/slice`` topology) and
                  deterministic node materialization
  controller.py — demand watch (starved PodGroups + the unschedulable
                  queue), K-fork scale-up simulation, eviction-gated
                  scale-down
"""

from .api import (
    NODE_GROUP_LABEL,
    NodeGroup,
    materialize_nodes,
    member_nodes,
    next_node_index,
    next_slice_index,
)
from .controller import ClusterAutoscaler, ScaleDecision

__all__ = [
    "NODE_GROUP_LABEL",
    "NodeGroup",
    "materialize_nodes",
    "member_nodes",
    "next_node_index",
    "next_slice_index",
    "ClusterAutoscaler",
    "ScaleDecision",
]
