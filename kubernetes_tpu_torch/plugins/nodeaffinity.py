"""NodeAffinity as a batched tensor program (plain torch).

Reference: pkg/scheduler/framework/plugins/nodeaffinity/node_affinity.go
  Filter — pod.spec.nodeSelector (AND of exact matches) AND
           requiredDuringSchedulingIgnoredDuringExecution (OR of terms)
  Score  — Σ weights of matching preferredDuringScheduling terms
  NormalizeScore — DefaultNormalizeScore (not reversed)

matchFields(metadata.name) works because the encoder interns the node name as the
pseudo-label "metadata.name" (state/encoding.py).
"""

from __future__ import annotations

from ..framework.events import ActionType, ClusterEvent, EventResource
from ..framework.interface import Plugin
from .helpers import (
    default_normalize,
    label_selector_matrix,
    node_selector_matrix,
    weighted_term_matrix,
)


class NodeAffinityPlugin(Plugin):
    name = "NodeAffinity"

    def events_to_register(self):
        return [ClusterEvent(EventResource.NODE, ActionType.ADD | ActionType.UPDATE_NODE_LABEL)]

    def filter(self, batch, snap, dyn, aux=None):
        sel_ok = label_selector_matrix(
            batch.node_selector, snap.node_label_keys, snap.node_label_vals,
            snap.numeric, vals_num=snap.node_label_num,
        )
        aff_ok = node_selector_matrix(
            batch.node_affinity, snap.node_label_keys, snap.node_label_vals,
            snap.numeric, vals_num=snap.node_label_num,
        )
        return sel_ok & aff_ok  # [B, N]

    def score(self, batch, snap, dyn, aux=None, mask=None):
        return weighted_term_matrix(
            batch.pref_req_key, batch.pref_req_op, batch.pref_req_vals,
            batch.pref_req_num, batch.pref_valid, batch.pref_weight,
            snap.node_label_keys, snap.node_label_vals, snap.numeric,
            vals_num=snap.node_label_num,
        )

    def normalize(self, scores, mask):
        return default_normalize(scores, mask)
