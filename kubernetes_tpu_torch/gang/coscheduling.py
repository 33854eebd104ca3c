"""Coscheduling plugin: the framework-facing shell over GangDirectory.

Reference: the JAX package's gang/coscheduling.py (:54-108), after
sigs.k8s.io/scheduler-plugins pkg/coscheduling/coscheduling.go — QueueSort
(group cohesion), PreFilter (quorum), Permit (all-or-nothing Wait/Allow),
PostBind (phase), Unreserve (group reject).  Host hooks delegate to the
scheduler-owned GangDirectory (``attach_gang_directory``); the device side
contributes one score plane preferring nodes in the gang's anchor slice
(GangDirectory.host_aux), added into the cycle's total by K21.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..framework import events as fwk_events
from ..framework.events import ActionType, ClusterEvent, EventResource
from ..framework.interface import Code, Plugin, Status
from ..kernels.cosched import cosched_match_plane, cosched_score_into
from ..plugins.helpers import default_normalize
from .directory import GangDirectory


class CoschedAux(NamedTuple):
    """The anchor-slice score's device inputs: slice_dom i32[N] (the node's
    slice-domain id, −1 outside every slice), anchor i32[C] (the slice each
    row's gang prefers; below 0: none)."""

    slice_dom: torch.Tensor
    anchor: torch.Tensor


class CoschedulingPlugin(Plugin):
    name = "Coscheduling"
    # Permit Wait from this plugin HOLDS the binding cycle across scheduling
    # cycles (assume + reserve kept, bind deferred) instead of failing it —
    # see TorchScheduler._run_reserve_and_bind / _flush_waiting_binds.
    holds_on_wait = True

    def __init__(self):
        self._dir: GangDirectory = None

    def attach_gang_directory(self, directory: GangDirectory) -> None:
        self._dir = directory

    def events_to_register(self):
        # a quorum-rejected member becomes schedulable when a sibling pod
        # appears or the PodGroup changes; capacity frees on pod delete /
        # node add
        return [
            fwk_events.POD_GROUP_CHANGE,
            ClusterEvent(EventResource.POD, ActionType.ADD | ActionType.DELETE),
            fwk_events.NODE_ADD,
        ]

    # --- host extension points -----------------------------------------------

    def less(self, a, b) -> bool:
        if self._dir is None:
            from ..queueing.priority_queue import default_less

            return default_less(a, b)
        return self._dir.less(a, b)

    def pre_filter(self, state, pod):
        if self._dir is None:
            return None
        return self._dir.prefilter(pod)

    def reserve(self, state, pod, node_name) -> Status:
        # membership in the reserve chain is what routes rollbacks through
        # unreserve (the group-failure hook); admission itself is Permit's
        return Status.success()

    def unreserve(self, state, pod, node_name) -> None:
        if self._dir is not None:
            self._dir.on_unreserve(pod)

    def permit(self, state, pod, node_name):
        if self._dir is None:
            return Status.success(), 0.0
        decision, timeout = self._dir.on_permit(pod)
        if decision == "wait":
            return Status(code=Code.WAIT), timeout
        return Status.success(), 0.0

    def post_bind(self, state, pod, node_name) -> None:
        if self._dir is not None:
            self._dir.on_bound(pod, node_name)

    # --- device score: prefer the gang's anchor slice -------------------------

    def host_prepare(self, batch, snapshot, encoder, namespace_labels=None):
        """(slice_dom i32[N], anchor i32[B]) on the host (the reference's
        host_prepare): −2 anchors for every row without a directory."""
        b = int(batch.valid.shape[0])
        if self._dir is None:
            n = int(np.shape(encoder.node_valid)[0])
            return (np.full(n, -1, dtype=np.int32),
                    np.full(b, -2, dtype=np.int32))
        return self._dir.host_aux(b, encoder)

    def host_aux_take(self, aux, rows):
        """Row-gather the pod-indexed half of the host aux (the identity-class
        rep view; the slice-domain plane is node-indexed and shared)."""
        slice_dom, anchor = aux
        return (slice_dom, np.asarray(anchor)[np.asarray(rows)])

    def prepare(self, batch, snap, dyn, host_aux):
        """The device aux, or None when no row anchors a gang: the
        reference's plane is then all False and normalizes to 0 — the
        constant ``kernel_plans`` folds in."""
        if host_aux is None:
            return None
        slice_dom, anchor = host_aux
        anchor = np.asarray(anchor)
        if anchor.size == 0 or int(anchor.max()) < 0:
            return None
        dev = snap.device
        return CoschedAux(
            slice_dom=torch.from_numpy(np.ascontiguousarray(slice_dom, np.int32)).to(dev),
            anchor=torch.from_numpy(np.ascontiguousarray(anchor, np.int32)).to(dev))

    def score(self, batch, snap, dyn, aux=None, mask=None):
        """Raw score: 1 where the node lies in the row's anchor slice."""
        if aux is None:
            return torch.zeros((batch.valid.shape[0], snap.num_nodes),
                               dtype=torch.float32, device=snap.device)
        return cosched_match_plane(aux.anchor, aux.slice_dom)

    def normalize(self, scores, mask):
        return default_normalize(scores, mask)

    def score_into(self, aux: CoschedAux, bits, full: int, total, weight: float):
        """Add weight · floor(normalize(score)) into ``total`` (K21)."""
        return cosched_score_into(bits, full, total, aux.anchor, aux.slice_dom, weight)

    def engine_copy(self, aux: CoschedAux) -> CoschedAux:
        return aux  # nothing in it changes while an engine runs

    def row(self, aux: CoschedAux, i: int) -> CoschedAux:
        """Pod i's row of a full-batch aux (the exact scan's step)."""
        return aux._replace(anchor=aux.anchor[i:i + 1])
