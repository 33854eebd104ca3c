"""The pass-through halves of the plugins whose live content the port does
not carry yet: the four volume plugins.

For every batch the port admits (no volumes) the JAX plugins take their
``aux is None`` branch: an all-pass filter.  These classes give exactly that
plane; the scheduler's scope guard raises NotImplementedError for a pod
that would need the live halves (ROADMAP Queue A item 8c).
PodTopologySpread, InterPodAffinity, Coscheduling and DynamicResources are
live (plugins/podtopologyspread.py, plugins/interpodaffinity.py,
gang/coscheduling.py, dra/plugin.py).
"""

from __future__ import annotations

import torch

from ..framework.events import ActionType, ClusterEvent, EventResource
from ..framework.interface import Plugin


def _ones(batch, snap):
    return torch.ones((batch.valid.shape[0], snap.num_nodes), dtype=torch.bool,
                      device=snap.device)


class _PassFilter(Plugin):
    """An all-pass filter plane (the JAX plugin's ``aux is None`` branch)."""

    def filter(self, batch, snap, dyn, aux=None):
        return _ones(batch, snap)


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
