"""Object store + watch fan-out (the etcd/apiserver stand-in), trimmed.

Reference behaviors mirrored:
  - monotonically increasing resourceVersion per write (etcd3 store semantics)
  - LIST returns a consistent snapshot + the rv to start WATCH from
  - WATCH delivers ordered Added/Modified/Deleted events from a given rv
    (storage/etcd3/watcher.go:118; watch cache cacher.go)
  - binding subresource: POST pods/{name}/binding → sets spec.nodeName
    (plugins/defaultbinder)

The port keeps only what the scheduling cycle drives: create / update /
delete / get / list / watch / bind_pod, with the same event order and
resourceVersion rules as the JAX package's store.  No write-ahead log, no
fault injection, no quota admission, no follower mode.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


class StaleResourceVersion(ValueError):
    """CAS precondition failed in ObjectStore.update (409 Conflict analog)."""


@dataclass
class WatchEvent:
    type: str
    kind: str
    obj: object
    resource_version: int


class ObjectStore:
    """Thread-safe store; watchers receive events synchronously in rv order."""

    CLUSTER_SCOPED = {"Node", "PersistentVolume", "StorageClass", "CSINode",
                      "PriorityClass", "Namespace", "DeviceClass",
                      "ResourceSlice"}

    def __init__(self):
        self._lock = threading.RLock()
        self._rv = 0
        self._objects: Dict[Tuple[str, str, str], object] = {}
        self._log: List[WatchEvent] = []  # full event history (bounded use: sim)
        self._watchers: List[Callable[[WatchEvent], None]] = []
        # cached globalDefault PriorityClass (priority admission on create)
        self._default_priority_class = None

    @classmethod
    def _key(cls, kind: str, obj) -> Tuple[str, str, str]:
        meta = obj.metadata
        ns = "" if kind in cls.CLUSTER_SCOPED else getattr(meta, "namespace", "")
        return (kind, ns, meta.name)

    def _emit(self, ev: WatchEvent) -> None:
        self._log.append(ev)
        for w in list(self._watchers):
            w(ev)

    # --- CRUD ----------------------------------------------------------------

    def create(self, kind: str, obj) -> int:
        with self._lock:
            if kind == "Pod":
                self._admit_pod(obj)
            key = self._key(kind, obj)
            if key in self._objects:
                raise ValueError(f"{key} already exists")
            self._rv += 1
            obj.metadata.resource_version = self._rv
            self._objects[key] = obj
            if kind == "PriorityClass" and getattr(obj, "global_default", False):
                self._default_priority_class = obj
            self._emit(WatchEvent(ADDED, kind, obj, self._rv))
            return self._rv

    def update(self, kind: str, obj, expected_rv=None) -> int:
        """``expected_rv`` (when not None) is a compare-and-swap
        precondition checked under the store lock."""
        with self._lock:
            key = self._key(kind, obj)
            if key not in self._objects:
                raise KeyError(key)
            if expected_rv is not None:
                cur_rv = self._objects[key].metadata.resource_version
                if str(expected_rv) != str(cur_rv):
                    raise StaleResourceVersion(
                        f"{key}: submitted resourceVersion {expected_rv}, "
                        f"current {cur_rv}")
            self._rv += 1
            obj.metadata.resource_version = self._rv
            self._objects[key] = obj
            if kind == "PriorityClass" and getattr(obj, "global_default", False):
                self._default_priority_class = obj
            self._emit(WatchEvent(MODIFIED, kind, obj, self._rv))
            return self._rv

    def delete(self, kind: str, namespace: str, name: str) -> Optional[object]:
        if kind in self.CLUSTER_SCOPED:
            namespace = ""
        with self._lock:
            obj = self._objects.pop((kind, namespace, name), None)
            if obj is None:
                return None
            if obj is self._default_priority_class:
                self._default_priority_class = next(
                    (o for (k, _, _), o in self._objects.items()
                     if k == "PriorityClass" and o.global_default), None)
            self._rv += 1
            self._emit(WatchEvent(DELETED, kind, obj, self._rv))
            return obj

    def current_rv(self) -> int:
        with self._lock:
            return self._rv

    def get(self, kind: str, namespace: str, name: str) -> Optional[object]:
        if kind in self.CLUSTER_SCOPED:
            namespace = ""
        with self._lock:
            return self._objects.get((kind, namespace, name))

    def list(self, kind: str) -> Tuple[List[object], int]:
        with self._lock:
            objs = [o for (k, _, _), o in self._objects.items() if k == kind]
            return objs, self._rv

    # --- watch ---------------------------------------------------------------

    def watch(self, handler: Callable[[WatchEvent], None], since_rv: int = 0):
        """Replays history after since_rv, then subscribes (list+watch
        contract).  Returns the unsubscribe function."""
        with self._lock:
            for ev in self._log:
                if ev.resource_version > since_rv:
                    handler(ev)
            self._watchers.append(handler)

            def unwatch():
                with self._lock:
                    if handler in self._watchers:
                        self._watchers.remove(handler)

            return unwatch

    def _admit_pod(self, pod) -> None:
        """Priority admission: resolve priorityClassName → spec.priority
        (reference: plugin/pkg/admission/priority)."""
        spec = pod.spec
        if spec.priority:
            return
        name = spec.priority_class_name
        if name:
            pc = self._objects.get(("PriorityClass", "", name))
        else:
            pc = self._default_priority_class
        if pc is not None:
            spec.priority = pc.value
            spec.preemption_policy = pc.preemption_policy

    # --- binding subresource --------------------------------------------------

    def bind_pod(self, namespace: str, name: str, node_name: str) -> bool:
        with self._lock:
            pod = self.get("Pod", namespace, name)
            if pod is None:
                return False
            pod.spec.node_name = node_name
            self._rv += 1
            pod.metadata.resource_version = self._rv
            self._emit(WatchEvent(MODIFIED, "Pod", pod, self._rv))
            return True
