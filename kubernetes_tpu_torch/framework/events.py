"""Cluster event taxonomy for event-driven requeue.

Reference: pkg/scheduler/framework/types.go:42-84 (ActionType bitmask, ClusterEvent)
and pkg/scheduler/internal/queue/events.go. A plugin registers the events that could
make a pod it rejected schedulable; MoveAllToActiveOrBackoffQueue only requeues pods
whose failing plugins registered the incoming event (scheduling_queue.go:963
podMatchesEvent).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class ActionType(enum.IntFlag):
    ADD = 1 << 0
    DELETE = 1 << 1
    UPDATE_NODE_ALLOCATABLE = 1 << 2
    UPDATE_NODE_LABEL = 1 << 3
    UPDATE_NODE_TAINT = 1 << 4
    UPDATE_NODE_CONDITION = 1 << 5
    UPDATE = (
        UPDATE_NODE_ALLOCATABLE
        | UPDATE_NODE_LABEL
        | UPDATE_NODE_TAINT
        | UPDATE_NODE_CONDITION
    )
    ALL = ADD | DELETE | UPDATE


class EventResource(str, enum.Enum):
    POD = "Pod"
    NODE = "Node"
    PVC = "PersistentVolumeClaim"
    PV = "PersistentVolume"
    STORAGE_CLASS = "StorageClass"
    CSI_NODE = "CSINode"
    SERVICE = "Service"
    POD_GROUP = "PodGroup"
    RESOURCE_CLAIM = "ResourceClaim"
    RESOURCE_SLICE = "ResourceSlice"
    DEVICE_CLASS = "DeviceClass"
    WILDCARD = "*"


@dataclass(frozen=True)
class ClusterEvent:
    resource: EventResource
    action_type: ActionType
    label: str = ""

    def is_wildcard(self) -> bool:
        return self.resource == EventResource.WILDCARD and self.action_type == ActionType.ALL

    def match(self, other: "ClusterEvent") -> bool:
        """Does a registered event (self) cover an incoming event (other)?"""
        if self.is_wildcard():
            return True
        return self.resource == other.resource and bool(
            self.action_type & other.action_type
        )


# Common event instances (internal/queue/events.go)
WILDCARD_EVENT = ClusterEvent(EventResource.WILDCARD, ActionType.ALL, "WildCardEvent")
NODE_ADD = ClusterEvent(EventResource.NODE, ActionType.ADD, "NodeAdd")
NODE_DELETE = ClusterEvent(EventResource.NODE, ActionType.DELETE, "NodeDelete")
POD_ADD = ClusterEvent(EventResource.POD, ActionType.ADD, "PodAdd")
POD_DELETE = ClusterEvent(EventResource.POD, ActionType.DELETE, "PodDelete")
POD_UPDATE = ClusterEvent(EventResource.POD, ActionType.UPDATE, "PodUpdate")
NODE_ALLOCATABLE_CHANGE = ClusterEvent(
    EventResource.NODE, ActionType.UPDATE_NODE_ALLOCATABLE, "NodeAllocatableChange"
)
NODE_LABEL_CHANGE = ClusterEvent(
    EventResource.NODE, ActionType.UPDATE_NODE_LABEL, "NodeLabelChange"
)
NODE_TAINT_CHANGE = ClusterEvent(
    EventResource.NODE, ActionType.UPDATE_NODE_TAINT, "NodeTaintChange"
)
NODE_CONDITION_CHANGE = ClusterEvent(
    EventResource.NODE, ActionType.UPDATE_NODE_CONDITION, "NodeConditionChange"
)
POD_GROUP_CHANGE = ClusterEvent(
    EventResource.POD_GROUP, ActionType.ADD | ActionType.UPDATE, "PodGroupChange"
)
PVC_ADD = ClusterEvent(EventResource.PVC, ActionType.ADD, "PvcAdd")
PV_ADD = ClusterEvent(EventResource.PV, ActionType.ADD, "PvAdd")
SERVICE_ADD = ClusterEvent(EventResource.SERVICE, ActionType.ADD, "ServiceAdd")
