"""Plugin API: extension points, Status codes, CycleState.

Reference: pkg/scheduler/framework/interface.go — QueueSortPlugin :305,
PreFilterPlugin :338, FilterPlugin :361, PostFilterPlugin :379, PreScorePlugin :398,
ScorePlugin :416, ReservePlugin :433, PermitPlugin :469, PreBindPlugin :449,
BindPlugin :482, PostBindPlugin :458; MaxNodeScore :101; Status codes :~150.

Design delta vs the reference: Filter/Score are *batched* — one call covers the whole
``[B pods, N nodes]`` plane as a pure jnp function, so they can be jit-fused into a
single device program.  Host-only extension points (queue sort less-fn, reserve,
permit, bind) keep per-pod Python signatures.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Optional

MAX_NODE_SCORE = 100  # framework/interface.go:101
MIN_NODE_SCORE = 0
MAX_TOTAL_SCORE = (1 << 63) - 1


class Code(enum.IntEnum):
    """Status codes (framework/interface.go Status)."""

    SUCCESS = 0
    ERROR = 1
    UNSCHEDULABLE = 2
    UNSCHEDULABLE_AND_UNRESOLVABLE = 3
    WAIT = 4
    SKIP = 5


@dataclass
class Status:
    code: Code = Code.SUCCESS
    reasons: tuple = ()
    plugin: str = ""

    @classmethod
    def success(cls) -> "Status":
        return cls()

    @classmethod
    def unschedulable(cls, *reasons: str, plugin: str = "", resolvable: bool = True) -> "Status":
        code = Code.UNSCHEDULABLE if resolvable else Code.UNSCHEDULABLE_AND_UNRESOLVABLE
        return cls(code=code, reasons=tuple(reasons), plugin=plugin)

    @classmethod
    def error(cls, *reasons: str, plugin: str = "") -> "Status":
        return cls(code=Code.ERROR, reasons=tuple(reasons), plugin=plugin)

    def is_success(self) -> bool:
        return self.code == Code.SUCCESS

    def is_rejected(self) -> bool:
        return self.code in (Code.UNSCHEDULABLE, Code.UNSCHEDULABLE_AND_UNRESOLVABLE)

    def message(self) -> str:
        return "; ".join(self.reasons)


class DynamicState(NamedTuple):
    """Cluster arrays that mutate *within* a batch as pods are greedily assigned
    (the device-side analog of the reference's ``assume``, scheduler.go:424,571).
    Plugins read these instead of the frozen DeviceSnapshot fields."""

    requested: Any  # i32[N, R]
    non_zero: Any  # i32[N, 2]


class CycleState:
    """Per-scheduling-cycle scratchpad (framework/cycle_state.go).

    In the batched design one CycleState covers one PodBatch cycle; plugins stash
    precomputed host/device data under their own keys (the analog of
    PreFilter writing plugin state read back by Filter/Score).
    """

    def __init__(self):
        self._data: Dict[str, Any] = {}
        self.skip_filter_plugins: set = set()
        self.skip_score_plugins: set = set()

    def write(self, key: str, value: Any) -> None:
        self._data[key] = value

    def read(self, key: str) -> Any:
        return self._data.get(key)

    def clone(self) -> "CycleState":
        c = CycleState()
        c._data = dict(self._data)
        c.skip_filter_plugins = set(self.skip_filter_plugins)
        c.skip_score_plugins = set(self.skip_score_plugins)
        return c


class Plugin:
    """Base for batched plugins.

    Subclasses override any subset (mirroring the Go interfaces):

      name: str  (class attr)
      events_to_register() -> list[ClusterEvent]       # EnqueueExtensions
      pre_filter(state, batch, snap) -> Optional[Status]
      filter(state, batch, snap) -> bool[B, N]          # pure jnp
      pre_score(state, batch, snap, mask) -> None
      score(state, batch, snap) -> f32[B, N]            # pure jnp, any scale
      normalize(scores: f32[B, N], mask) -> f32[B, N]   # → [0, MAX_NODE_SCORE]
      # host-side, per pod:
      less(pod_info_a, pod_info_b) -> bool              # QueueSort
      reserve(state, pod, node_name) -> Status
      unreserve(state, pod, node_name) -> None
      permit(state, pod, node_name) -> (Status, timeout_s)
      pre_bind(state, pod, node_name) -> Status
      bind(state, pod, node_name) -> Status
      post_bind(state, pod, node_name) -> None
      post_filter(state, batch_or_pod, snap, filtered) -> (result, Status)
    """

    name: str = "Plugin"
    # dynamic plugins read DynamicState / scan-updated aux; static plugins are
    # precomputed once per batch outside the assignment scan
    dynamic: bool = False

    # feature-detection helpers used by the runtime registry
    def has(self, method: str) -> bool:
        return type(self).__dict__.get(method) is not None or any(
            method in klass.__dict__ for klass in type(self).__mro__[1:-1]
            if klass is not Plugin
        )

    def events_to_register(self):
        return []


@dataclass
class PluginWithWeight:
    plugin: Plugin
    weight: int = 1
