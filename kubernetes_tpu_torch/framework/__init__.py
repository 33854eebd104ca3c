"""Batched Scheduling Framework (reference: pkg/scheduler/framework), in torch.

A plugin's Filter produces a ``bool[B, N]`` feasibility mask and its Score a
``float32[B, N]`` plane for a whole ``PodBatch`` against a ``DeviceSnapshot``;
the runtime composes them and runs the assignment engine.
"""

from .interface import (  # noqa: F401
    Code,
    Status,
    CycleState,
    Plugin,
    MAX_NODE_SCORE,
    MIN_NODE_SCORE,
    MAX_TOTAL_SCORE,
)
from .events import ClusterEvent, ActionType, EventResource  # noqa: F401
from .podbatch import PodBatch, PodBatchCompiler  # noqa: F401
