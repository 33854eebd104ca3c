"""Permit "Wait" support: the waiting-pods map (a copy of the JAX
package's framework/waiting_pods.py).

Reference: pkg/scheduler/framework/runtime/waiting_pods_map.go — a Permit plugin
may return Wait with a timeout; the binding cycle blocks in WaitOnPermit until
every waiting plugin allows (or any rejects / the timeout fires).

Clock contract: every deadline is computed AND checked against the single
injected ``clock`` (the scheduler's own) — no raw ``time.monotonic()`` or
``time.sleep`` anywhere in the deadline math, so gang-timeout behavior is
exactly reproducible under a fake clock (the wait is re-polled by the
scheduler's cycle loop, never slept on).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from ..api import objects as v1


@dataclass
class WaitingPod:
    pod: v1.Pod
    pending_plugins: Dict[str, float] = field(default_factory=dict)  # plugin → deadline
    rejected: Optional[str] = None  # rejecting plugin message

    def allow(self, plugin: str) -> None:
        self.pending_plugins.pop(plugin, None)

    def reject(self, plugin: str, msg: str = "") -> None:
        self.rejected = f"{plugin}: {msg}"

    def is_allowed(self) -> bool:
        return not self.pending_plugins and self.rejected is None


class WaitingPodsMap:
    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._pods: Dict[str, WaitingPod] = {}

    def add(self, pod: v1.Pod, plugin: str, timeout: float) -> WaitingPod:
        wp = self._pods.get(pod.uid)
        if wp is None:
            wp = WaitingPod(pod=pod)
            self._pods[pod.uid] = wp
        wp.pending_plugins[plugin] = self._clock() + timeout
        return wp

    def get(self, uid: str) -> Optional[WaitingPod]:
        return self._pods.get(uid)

    def remove(self, uid: str) -> None:
        self._pods.pop(uid, None)

    def next_deadline(self) -> Optional[float]:
        """Earliest pending-plugin deadline across all waiting pods (on the
        injected clock's scale), or None — lets a driving loop know when a
        gang hold can next expire without polling blind."""
        deadlines = [
            dl for wp in self._pods.values()
            for dl in wp.pending_plugins.values()
        ]
        return min(deadlines) if deadlines else None

    def wait_on_permit(self, pod: v1.Pod) -> Optional[str]:
        """→ None (allowed) or a rejection reason. Expired waits reject
        (the reference's timeout behavior)."""
        wp = self._pods.get(pod.uid)
        if wp is None:
            return None
        now = self._clock()
        for plugin, deadline in list(wp.pending_plugins.items()):
            if now >= deadline:
                wp.reject(plugin, "timed out waiting on permit")
        result = wp.rejected if not wp.is_allowed() and wp.rejected else (
            None if wp.is_allowed() else
            f"still waiting on {sorted(wp.pending_plugins)}"
        )
        if wp.is_allowed() or wp.rejected:
            self.remove(pod.uid)
        return result
