"""The pass-through halves of the plugins whose live content the port does
not carry yet: the four volume plugins and DynamicResources.

For every batch the port admits (no volumes, no resource claims) the JAX
plugins take their ``aux is None`` branch: an all-pass filter, an all-zero
score plane, and each plugin's own ``normalize`` of that plane.  These
classes give exactly those planes; the scheduler's scope guard raises
NotImplementedError for anything that would need the live halves (ROADMAP
Queue A items 8b, 8c).  PodTopologySpread, InterPodAffinity and
Coscheduling are live (plugins/podtopologyspread.py,
plugins/interpodaffinity.py, gang/coscheduling.py).
"""

from __future__ import annotations

import torch

from ..framework.events import ActionType, ClusterEvent, EventResource
from ..framework.interface import Plugin


def _ones(batch, snap):
    return torch.ones((batch.valid.shape[0], snap.num_nodes), dtype=torch.bool,
                      device=snap.device)


def _zeros(batch, snap):
    return torch.zeros((batch.valid.shape[0], snap.num_nodes),
                       dtype=torch.float32, device=snap.device)


class _PassFilter(Plugin):
    """An all-pass filter plane (the JAX plugin's ``aux is None`` branch)."""

    def filter(self, batch, snap, dyn, aux=None):
        return _ones(batch, snap)


class _PassScore(Plugin):
    """An all-zero raw score plane (the JAX plugin's ``aux is None`` branch)."""

    def score(self, batch, snap, dyn, aux=None, mask=None):
        return _zeros(batch, snap)


class VolumeRestrictionsPlugin(_PassFilter):
    name = "VolumeRestrictions"

    def events_to_register(self):
        return [ClusterEvent(EventResource.POD, ActionType.DELETE)]


class NodeVolumeLimitsPlugin(_PassFilter):
    name = "NodeVolumeLimits"

    def events_to_register(self):
        return [
            ClusterEvent(EventResource.CSI_NODE, ActionType.ALL),
            ClusterEvent(EventResource.POD, ActionType.DELETE),
        ]


class VolumeBindingPlugin(_PassFilter):
    name = "VolumeBinding"

    def events_to_register(self):
        return [
            ClusterEvent(EventResource.PVC, ActionType.ALL),
            ClusterEvent(EventResource.PV, ActionType.ALL),
            ClusterEvent(EventResource.STORAGE_CLASS, ActionType.ALL),
            ClusterEvent(EventResource.NODE, ActionType.ADD | ActionType.UPDATE_NODE_LABEL),
        ]


class VolumeZonePlugin(_PassFilter):
    name = "VolumeZone"

    def events_to_register(self):
        return [
            ClusterEvent(EventResource.PVC, ActionType.ALL),
            ClusterEvent(EventResource.PV, ActionType.ALL),
            ClusterEvent(EventResource.NODE, ActionType.ADD | ActionType.UPDATE_NODE_LABEL),
        ]


class DynamicResourcesPlugin(_PassFilter, _PassScore):
    name = "DynamicResources"
    dynamic = True

    def events_to_register(self):
        return [
            ClusterEvent(EventResource.RESOURCE_CLAIM, ActionType.ALL),
            ClusterEvent(EventResource.RESOURCE_SLICE, ActionType.ALL),
            ClusterEvent(EventResource.DEVICE_CLASS, ActionType.ALL),
            ClusterEvent(EventResource.NODE, ActionType.ADD),
        ]

    def normalize(self, scores, mask):
        return torch.where(mask, scores, 0.0)  # already 0..MAX_NODE_SCORE
