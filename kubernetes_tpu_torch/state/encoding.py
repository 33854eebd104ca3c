"""Struct-of-arrays encoding of cluster state for the device compute path.

The snapshot is mirrored into padded, fixed-shape int32/float32 host numpy
arrays, incrementally updated from the cache's changed-node list (the analog
of cache.go:197-276 generation snapshotting), and uploaded to the device
either as whole tensors or as row-scatter updates — so a large cluster does
not re-upload per cycle.  The numpy mirrors behave byte for byte like the
JAX package's encoder (the parity tests compare them); the device side holds
``torch`` tensors on an explicit device.

Shape discipline: capacities are rounded up to powers of two and grown by
doubling, exactly as in the reference encoder, so every tier the JAX
package uses is a tier the port uses.

Encoded semantic notes:
- node "metadata.name" and "kubernetes.io/hostname" are injected as labels so
  matchFields and hostname topology work uniformly.
- host ports are encoded as (proto*2^16+port, hostIP id) pairs; the filter
  implements the exact HostPortInfo wildcard rule.
- taint effects: NoSchedule=0, PreferNoSchedule=1, NoExecute=2.
- resource units per state/units.py; requests ceil, allocatable floor; a pod's
  "pods" dimension request is always 1.

The existing-pod affinity index (state/affinity_index.py) lives here:
``sync`` applies each scheduled pod's term contributions where the
reference does, and its ``aff_*`` group tables ride the deferred
row-scatter like the node and pod rows; growing its group or domain axis
is a shape change, as in the reference.

Left out on purpose: node-axis sharding (single device).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..api import objects as v1
from ..api.resource import (
    Resource,
    compute_pod_resource_request,
    compute_pod_resource_request_non_zero,
)
from ..device import resolve_device
from ..kernels.scatter import scatter_rows
from .cache import Snapshot
from .affinity_index import AffinityIndex
from .dictionary import MISSING, Dictionary, _parse_numeric
from .node_info import NodeInfo
from . import units

EFFECT_CODE = {
    v1.TAINT_NO_SCHEDULE: 0,
    v1.TAINT_PREFER_NO_SCHEDULE: 1,
    v1.TAINT_NO_EXECUTE: 2,
}
_PROTO_CODE = {"TCP": 0, "UDP": 1, "SCTP": 2}

HOSTNAME_LABEL = "kubernetes.io/hostname"


def _pow2(n: int, minimum: int = 8) -> int:
    return units.pow2_round_up(n, minimum)


@dataclass
class EncodingConfig:
    min_nodes: int = 64
    min_pods: int = 256
    label_cap: int = 16
    pod_label_cap: int = 8
    taint_cap: int = 8
    port_cap: int = 8
    image_cap: int = 8
    extended_resource_cap: int = 4  # spare scalar-resource dims beyond the base 4
    topo_key_cap: int = 8  # registered topology keys (zone/hostname/region/…)

    @property
    def num_resource_dims(self) -> int:
        return units.NUM_BASE_DIMS + self.extended_resource_cap


class EncodingCapacityError(Exception):
    """A per-object cap (labels/taints/ports/images/extended resources) overflowed.

    Raise rather than truncate: silent truncation would corrupt filter semantics.
    """


@dataclass
class DeviceSnapshot:
    """The tensor view handed to the plugin programs (all shapes static)."""

    # nodes
    node_valid: torch.Tensor  # bool[N]
    node_name_ids: torch.Tensor  # i32[N]
    allocatable: torch.Tensor  # i32[N, R]
    requested: torch.Tensor  # i32[N, R]
    non_zero_requested: torch.Tensor  # i32[N, 2] (cpu milli, mem KiB)
    node_label_keys: torch.Tensor  # i32[N, L]
    node_label_vals: torch.Tensor  # i32[N, L]
    node_label_num: torch.Tensor  # f32[N, L] (NaN = not a number)
    node_topo: torch.Tensor  # i32[N, K]
    taint_keys: torch.Tensor  # i32[N, T]
    taint_vals: torch.Tensor  # i32[N, T]
    taint_effects: torch.Tensor  # i32[N, T] (-1 pad)
    ports: torch.Tensor  # i32[N, P] (proto<<16 | port, -1 pad)
    ports_ip: torch.Tensor  # i32[N, P]
    image_ids: torch.Tensor  # i32[N, I]
    image_sizes: torch.Tensor  # f32[N, I] bytes
    unschedulable: torch.Tensor  # bool[N]
    node_ready: torch.Tensor  # bool[N]
    claim_capacity: torch.Tensor  # i32[N]
    claim_allocated: torch.Tensor  # i32[N]
    # scheduled pods
    pod_valid: torch.Tensor  # bool[P]
    pod_node: torch.Tensor  # i32[P]
    pod_ns: torch.Tensor  # i32[P]
    pod_label_keys: torch.Tensor  # i32[P, PL]
    pod_label_vals: torch.Tensor  # i32[P, PL]
    pod_priority: torch.Tensor  # i32[P]
    pod_request: torch.Tensor  # i32[P, R]
    pod_non_zero: torch.Tensor  # i32[P, 2]
    # existing-pod affinity groups (state/affinity_index.py)
    aff_valid: torch.Tensor  # bool[G]
    aff_kind: torch.Tensor  # i32[G]
    aff_weight: torch.Tensor  # f32[G]
    aff_slot: torch.Tensor  # i32[G]
    aff_counts: torch.Tensor  # f32[G, D]
    # dictionary numeric side-table
    numeric: torch.Tensor  # f32[num_ids]

    @property
    def num_nodes(self) -> int:
        return self.node_valid.shape[0]

    @property
    def num_pods(self) -> int:
        return self.pod_valid.shape[0]

    @property
    def device(self) -> torch.device:
        return self.node_valid.device


SNAPSHOT_FIELDS = tuple(f.name for f in fields(DeviceSnapshot))


@dataclass
class PendingScatter:
    """Deferred row-scatter payload (see to_device_deferred): each group is
    None or ``(rows i32[k], vals tuple)`` with k pow2-padded by repeating the
    first row (idempotent for a row set); numeric is a full replacement or
    None.  Tensors live on the encoder's device."""

    node_rows: object = None
    pod_rows: object = None
    aff_rows: object = None
    numeric: object = None


def live_nodes(snap: DeviceSnapshot) -> torch.Tensor:
    """bool[N] schedulable universe: encoded (node_valid) AND Ready
    (node_ready) — every feasibility composition starts from it."""
    return snap.node_valid & snap.node_ready


def apply_scatter(dsnap: DeviceSnapshot, upd: Optional[PendingScatter]) -> DeviceSnapshot:
    """Apply a PendingScatter: a new DeviceSnapshot whose dirty rows carry
    the payload's values — one ``scatter_rows`` call (K16 on the card) per
    array group.  Out of place, like the reference's functional
    ``.at[rows].set``: an in-flight batch of the pipelined scheduler still
    reads the snapshot this one replaces."""
    if upd is None:
        return dsnap
    out = {k: getattr(dsnap, k) for k in _NODE_ARRAYS + _POD_ARRAYS + _AFF_ARRAYS}
    for names, group in ((_NODE_ARRAYS, upd.node_rows), (_POD_ARRAYS, upd.pod_rows),
                         (_AFF_ARRAYS, upd.aff_rows)):
        if group is None:
            continue
        rows, vals = group
        out.update(zip(names, scatter_rows([out[k] for k in names], rows, vals)))
    numeric = dsnap.numeric if upd.numeric is None else upd.numeric
    return DeviceSnapshot(**out, numeric=numeric)


def _put(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


class ClusterEncoder:
    """Maintains host numpy mirrors + device tensors; applies incremental updates.

    ``device`` defaults to ``"cuda"``; only an explicit ``"cpu"`` runs the
    device side on the host."""

    def __init__(self, dic: Optional[Dictionary] = None,
                 cfg: Optional[EncodingConfig] = None, device="cuda"):
        self.device = resolve_device(device)
        self.dic = dic or Dictionary()
        self.cfg = cfg or EncodingConfig()
        self.extended_index: Dict[str, int] = {}
        # Topology registry: constraint topology keys get a compact slot k, and
        # each distinct label value under that key gets a compact domain index
        self.topo_key_strings: List[str] = []
        self._topo_slots: Dict[str, int] = {}
        self.topo_value_maps: List[Dict[str, int]] = []
        self.node_rows: Dict[str, int] = {}
        self._row_to_name: Dict[int, str] = {}  # kept in lockstep with node_rows
        self._free_node_rows: List[int] = []
        self.pod_rows: Dict[str, int] = {}  # pod uid -> row
        self._free_pod_rows: List[int] = []
        self._pods_by_node: Dict[str, List[str]] = {}  # node name -> pod uids
        self._pod_owner: Dict[str, str] = {}  # pod uid -> owning node name
        self._n = self.cfg.min_nodes
        self._p = self.cfg.min_pods
        self._alloc_arrays()
        # incremental existing-pod affinity groups (state/affinity_index.py)
        self.aff = AffinityIndex(self)
        self._device: Optional[DeviceSnapshot] = None
        self._uploaded_numeric_len = -1
        self._dirty_node_rows: set = set()
        self._dirty_pod_rows: set = set()
        self._scatter_bucket: Dict[str, int] = {}
        self._scatter_bucket.setdefault("aff_valid", 8)
        self._numeric_min = 1024  # floor for the numeric side-table pow2 size
        self._shape_changed = True
        self._force_full_once = False  # see force_full_next

    # affinity-group arrays live on the index; exposed here so the generic
    # array-group upload machinery reads them by name like the other mirrors
    @property
    def aff_valid(self):
        return self.aff.aff_valid

    @property
    def aff_kind(self):
        return self.aff.aff_kind

    @property
    def aff_weight(self):
        return self.aff.aff_weight

    @property
    def aff_slot(self):
        return self.aff.aff_slot

    @property
    def aff_counts(self):
        return self.aff.aff_counts

    # --- allocation ---------------------------------------------------------

    def _alloc_arrays(self):
        n, p, cfg = self._n, self._p, self.cfg
        r = cfg.num_resource_dims
        self.node_valid = np.zeros(n, dtype=bool)
        self.node_name_ids = np.full(n, MISSING, dtype=np.int32)
        self.allocatable = np.zeros((n, r), dtype=np.int32)
        self.requested = np.zeros((n, r), dtype=np.int32)
        self.non_zero_requested = np.zeros((n, 2), dtype=np.int32)
        self.node_label_keys = np.full((n, cfg.label_cap), MISSING, dtype=np.int32)
        self.node_label_vals = np.full((n, cfg.label_cap), MISSING, dtype=np.int32)
        self.node_label_num = np.full((n, cfg.label_cap), np.nan, dtype=np.float32)
        self.node_topo = np.full((n, cfg.topo_key_cap), MISSING, dtype=np.int32)
        self.taint_keys = np.full((n, cfg.taint_cap), MISSING, dtype=np.int32)
        self.taint_vals = np.full((n, cfg.taint_cap), MISSING, dtype=np.int32)
        self.taint_effects = np.full((n, cfg.taint_cap), MISSING, dtype=np.int32)
        self.ports = np.full((n, cfg.port_cap), MISSING, dtype=np.int32)
        self.ports_ip = np.full((n, cfg.port_cap), MISSING, dtype=np.int32)
        self.image_ids = np.full((n, cfg.image_cap), MISSING, dtype=np.int32)
        self.image_sizes = np.zeros((n, cfg.image_cap), dtype=np.float32)
        self.unschedulable = np.zeros(n, dtype=bool)
        self.node_ready = np.ones(n, dtype=bool)
        self.claim_capacity = np.zeros(n, dtype=np.int32)
        self.claim_allocated = np.zeros(n, dtype=np.int32)
        self.pod_valid = np.zeros(p, dtype=bool)
        self.pod_node = np.full(p, MISSING, dtype=np.int32)
        self.pod_ns = np.full(p, MISSING, dtype=np.int32)
        self.pod_label_keys = np.full((p, cfg.pod_label_cap), MISSING, dtype=np.int32)
        self.pod_label_vals = np.full((p, cfg.pod_label_cap), MISSING, dtype=np.int32)
        self.pod_priority = np.zeros(p, dtype=np.int32)
        self.pod_request = np.zeros((p, r), dtype=np.int32)
        self.pod_non_zero = np.zeros((p, 2), dtype=np.int32)

    def _grow_nodes(self, need: int):
        old = {k: getattr(self, k).copy() for k in _NODE_ARRAYS}
        self._n = _pow2(need, self._n * 2)
        p_save = {k: getattr(self, k) for k in _POD_ARRAYS}
        self._alloc_arrays()
        for k, v in old.items():
            getattr(self, k)[: v.shape[0]] = v
        for k, v in p_save.items():
            setattr(self, k, v)
        self._shape_changed = True

    def _grow_pods(self, need: int):
        old = {k: getattr(self, k).copy() for k in _POD_ARRAYS}
        self._p = _pow2(need, self._p * 2)
        n_save = {k: getattr(self, k) for k in _NODE_ARRAYS}
        self._alloc_arrays()
        for k, v in old.items():
            getattr(self, k)[: v.shape[0]] = v
        for k, v in n_save.items():
            setattr(self, k, v)
        self._shape_changed = True

    def reserve(self, n_nodes: int = 0, n_pods: int = 0, n_ids: int = 0):
        """Pre-size tiers (same contract as the reference's reserve)."""
        if n_nodes > self._n:
            self._grow_nodes(n_nodes)
        if n_pods > self._p:
            self._grow_pods(n_pods)
        if n_ids:
            self._numeric_min = max(self._numeric_min, _pow2(n_ids, 1024))

    # --- resource helpers ----------------------------------------------------

    def _resource_units(self, r: Resource, ceil: bool) -> List[int]:
        for name in r.scalar_resources:
            if name not in self.extended_index:
                idx = units.NUM_BASE_DIMS + len(self.extended_index)
                if idx >= self.cfg.num_resource_dims:
                    raise EncodingCapacityError(
                        f"too many extended resources (cap "
                        f"{self.cfg.extended_resource_cap}): {name}"
                    )
                self.extended_index[name] = idx
        return units.resource_to_units(
            r, self.cfg.num_resource_dims, self.extended_index, ceil=ceil
        )

    def pod_request_units(self, pod: v1.Pod) -> np.ndarray:
        """i32[R] request vector for a pod (pods dim = 1)."""
        r = compute_pod_resource_request(pod)
        vec = self._resource_units(r, ceil=True)
        vec[units.DIM_PODS] = 1
        return np.asarray(vec, dtype=np.int32)

    def pod_non_zero_units(self, pod: v1.Pod) -> np.ndarray:
        r = compute_pod_resource_request_non_zero(pod)
        vec = self._resource_units(r, ceil=True)
        return np.asarray([vec[units.DIM_CPU], vec[units.DIM_MEMORY]], dtype=np.int32)

    # --- label encoding ------------------------------------------------------

    def _encode_labels(self, labels: Dict[str, str], cap: int, what: str):
        if len(labels) > cap:
            raise EncodingCapacityError(
                f"{what} has {len(labels)} labels > cap {cap}; raise EncodingConfig"
            )
        keys = np.full(cap, MISSING, dtype=np.int32)
        vals = np.full(cap, MISSING, dtype=np.int32)
        for i, (k, val) in enumerate(labels.items()):
            keys[i] = self.dic.intern(k)
            vals[i] = self.dic.intern(val)
        return keys, vals

    def _encode_label_nums(self, labels: Dict[str, str], cap: int) -> np.ndarray:
        """f32[cap] Atoi-parity numeric parse of each label VALUE, NaN otherwise."""
        nums = np.full(cap, np.nan, dtype=np.float32)
        for i, val in enumerate(labels.values()):
            nums[i] = _parse_numeric(val)
        return nums

    # --- node encoding -------------------------------------------------------

    def encode_node(self, info: NodeInfo) -> int:
        """(Re-)encode one NodeInfo into its row; returns the row index."""
        name = info.node_name
        row = self.node_rows.get(name)
        if row is None:
            if self._free_node_rows:
                row = self._free_node_rows.pop()
            else:
                row = len(self.node_rows)
                if row >= self._n:
                    self._grow_nodes(row + 1)
            self.node_rows[name] = row
            self._row_to_name[row] = name
        node = info.node
        cfg = self.cfg
        labels = dict(node.metadata.labels)
        labels.setdefault(HOSTNAME_LABEL, name)
        labels["metadata.name"] = name
        lk, lv = self._encode_labels(labels, cfg.label_cap, f"node {name}")
        self.node_label_keys[row] = lk
        self.node_label_vals[row] = lv
        self.node_label_num[row] = self._encode_label_nums(labels, cfg.label_cap)
        for k, key in enumerate(self.topo_key_strings):
            val = labels.get(key)
            self.node_topo[row, k] = (
                MISSING if val is None else self._domain_index(k, val)
            )

        self.node_valid[row] = True
        self.node_name_ids[row] = self.dic.intern(name)
        self.unschedulable[row] = node.spec.unschedulable
        self.node_ready[row] = v1.node_is_ready(node)
        self.allocatable[row] = self._resource_units(info.allocatable, ceil=False)
        self.requested[row] = self._resource_units(info.requested, ceil=True)
        # pods dimension of "requested" = live pod count
        self.requested[row, units.DIM_PODS] = len(info.pods)
        nz = self._resource_units(info.non_zero_requested, ceil=True)
        self.non_zero_requested[row] = (nz[units.DIM_CPU], nz[units.DIM_MEMORY])

        if len(node.spec.taints) > cfg.taint_cap:
            raise EncodingCapacityError(f"node {name}: too many taints")
        self.taint_keys[row] = MISSING
        self.taint_vals[row] = MISSING
        self.taint_effects[row] = MISSING
        for i, t in enumerate(node.spec.taints):
            self.taint_keys[row, i] = self.dic.intern(t.key)
            self.taint_vals[row, i] = self.dic.intern(t.value)
            self.taint_effects[row, i] = EFFECT_CODE.get(t.effect, 0)

        ports = sorted(
            {(_PROTO_CODE.get(proto, 0) * 65536 + port, self.dic.intern(ip))
             for (ip, proto, port) in info.used_ports}
        )
        if len(ports) > cfg.port_cap:
            raise EncodingCapacityError(f"node {name}: too many host ports")
        self.ports[row] = MISSING
        self.ports_ip[row] = MISSING
        for i, (code, ip_id) in enumerate(ports):
            self.ports[row, i] = code
            self.ports_ip[row, i] = ip_id

        self.image_ids[row] = MISSING
        self.image_sizes[row] = 0.0
        img_items = list(info.image_states.items())
        if len(img_items) > cfg.image_cap:
            # images beyond the cap only weaken ImageLocality scoring; keep largest
            img_items.sort(key=lambda kv: -kv[1])
            img_items = img_items[: cfg.image_cap]
        for i, (img, size) in enumerate(img_items):
            self.image_ids[row, i] = self.dic.intern(img)
            self.image_sizes[row, i] = float(size)

        self._dirty_node_rows.add(row)
        return row

    # --- topology registry ---------------------------------------------------

    def _domain_index(self, slot: int, value: str) -> int:
        m = self.topo_value_maps[slot]
        idx = m.get(value)
        if idx is None:
            idx = len(m)
            m[value] = idx
        return idx

    def topo_slot(self, key: str) -> int:
        """Slot of topology key, registering (and backfilling all nodes) on first
        use. Called at PodBatch compile time for spread/affinity topology keys."""
        slot = self._topo_slots.get(key)
        if slot is not None:
            return slot
        slot = len(self.topo_key_strings)
        if slot >= self.cfg.topo_key_cap:
            raise EncodingCapacityError(
                f"too many topology keys (cap {self.cfg.topo_key_cap}): {key}"
            )
        self._topo_slots[key] = slot
        self.topo_key_strings.append(key)
        self.topo_value_maps.append({})
        key_id = self.dic.lookup(key)
        for name, row in self.node_rows.items():
            val_id = MISSING
            if key_id != MISSING:
                hit = np.where(self.node_label_keys[row] == key_id)[0]
                if hit.size:
                    val_id = int(self.node_label_vals[row, hit[0]])
            self.node_topo[row, slot] = (
                MISSING if val_id == MISSING
                else self._domain_index(slot, self.dic.string(val_id))
            )
            self._dirty_node_rows.add(row)
        return slot

    @property
    def domain_cap(self) -> int:
        """Power-of-two bound on compact domain indices across all topo keys."""
        return _pow2(max((len(m) for m in self.topo_value_maps), default=1), 8)

    def remove_node(self, name: str):
        row = self.node_rows.pop(name, None)
        if row is None:
            return
        self._row_to_name.pop(row, None)
        self.node_valid[row] = False
        self.claim_capacity[row] = 0
        self.claim_allocated[row] = 0
        self._free_node_rows.append(row)
        self._dirty_node_rows.add(row)
        for uid in self._pods_by_node.pop(name, []):
            if self._pod_owner.get(uid) == name:
                self._remove_pod_row(uid)

    # --- DRA claim planes (dra/index.py is the writer) -----------------------

    def set_claim_row(self, name: str, capacity: int, allocated: int) -> bool:
        """Write a node's claim planes by NAME (the reference's
        set_claim_row); False when the node has no row yet (the index
        retries on its next flush once the node encodes).  No-change writes
        skip the dirty mark, so a steady-state flush uploads nothing."""
        row = self.node_rows.get(name)
        if row is None:
            return False
        if (self.claim_capacity[row] == capacity
                and self.claim_allocated[row] == allocated):
            return True
        self.claim_capacity[row] = capacity
        self.claim_allocated[row] = allocated
        self._dirty_node_rows.add(row)
        return True

    # --- scheduled-pod encoding ---------------------------------------------

    def _encode_pod(self, pod: v1.Pod, node_row: int) -> int:
        uid = pod.uid
        row = self.pod_rows.get(uid)
        if row is None:
            if self._free_pod_rows:
                row = self._free_pod_rows.pop()
            else:
                row = len(self.pod_rows)
                if row >= self._p:
                    self._grow_pods(row + 1)
            self.pod_rows[uid] = row
        cfg = self.cfg
        lk, lv = self._encode_labels(
            pod.metadata.labels, cfg.pod_label_cap, f"pod {pod.key()}"
        )
        ns = self.dic.intern(pod.namespace)
        req = self.pod_request_units(pod)
        nz = self.pod_non_zero_units(pod)
        # skip the dirty mark when nothing changed (sync re-encodes every pod
        # of a changed node)
        if (
            self.pod_valid[row]
            and self.pod_node[row] == node_row
            and self.pod_ns[row] == ns
            and self.pod_priority[row] == pod.spec.priority
            and np.array_equal(self.pod_label_keys[row], lk)
            and np.array_equal(self.pod_label_vals[row], lv)
            and np.array_equal(self.pod_request[row], req)
            and np.array_equal(self.pod_non_zero[row], nz)
        ):
            return row
        self.pod_label_keys[row] = lk
        self.pod_label_vals[row] = lv
        self.pod_valid[row] = True
        self.pod_node[row] = node_row
        self.pod_ns[row] = ns
        self.pod_priority[row] = pod.spec.priority
        self.pod_request[row] = req
        self.pod_non_zero[row] = nz
        self._dirty_pod_rows.add(row)
        return row

    def _remove_pod_row(self, uid: str):
        row = self.pod_rows.pop(uid, None)
        self._pod_owner.pop(uid, None)
        self.aff.remove_pod(uid)
        if row is None:
            return
        self.pod_valid[row] = False
        self._free_pod_rows.append(row)
        self._dirty_pod_rows.add(row)

    # --- snapshot sync -------------------------------------------------------

    def sync(self, snapshot: Snapshot, changed_nodes: Sequence[str]):
        """Apply a cache snapshot refresh: re-encode changed nodes + their pods.

        Removal is ownership-gated: a pod that MOVED between two changed nodes
        may be re-encoded under its new node before or after its old node is
        processed; only the current owner may free the row.
        """
        for name in changed_nodes:
            info = snapshot.node_info_map.get(name)
            if info is None:
                self.remove_node(name)
                continue
            row = self.encode_node(info)
            new_uids = {pi.pod.uid for pi in info.pods}
            for uid in self._pods_by_node.get(name, []):
                if uid not in new_uids and self._pod_owner.get(uid) == name:
                    self._remove_pod_row(uid)
            for pi in info.pods:
                self._encode_pod(pi.pod, row)
                self._pod_owner[pi.pod.uid] = name
                self.aff.set_pod(pi, row)
            self._pods_by_node[name] = list(new_uids)

    def full_sync(self, snapshot: Snapshot):
        self.sync(snapshot, [n.node_name for n in snapshot.node_info_list])

    # --- device upload -------------------------------------------------------

    def force_full_next(self) -> None:
        """Make the next dispatch-time ``to_device_deferred`` take the
        full-upload path (the reference's force_full_next; the perf
        harness's warms use it)."""
        self._force_full_once = True

    def to_device_deferred(self, consume_force: bool = True):
        """Like to_device, but returns the row-scatter payload instead of
        applying it: ``(dsnap, upd)`` where ``upd`` is None (a full upload
        happened; dsnap is current) or a PendingScatter the caller applies
        with ``apply_scatter`` and then adopts with ``commit_device``.  The
        gates (small-tier full upload, scatter bucket overflow, dirty
        fraction) are the reference's, so the port takes the scatter path
        on exactly the cycles the JAX scheduler does.

        ``consume_force=False`` is the overlapped sync's background build:
        it neither honours nor clears ``force_full_next()`` — the flag may
        be set while the thread runs, and only the dispatch-time build may
        consume it."""
        if consume_force and self._force_full_once:
            self._force_full_once = False
            return self.to_device(force_full=True), None
        if self._n <= _SMALL_NODE_TIER:
            return self.to_device(force_full=True), None
        numeric, use_scatter = self._upload_gate()
        bucket = self._scatter_bucket.get("node_valid", 256)
        pbucket = self._scatter_bucket.get("pod_valid", 256)
        abucket = self._scatter_bucket.get("aff_valid", 8)
        force_full = (
            len(self._dirty_node_rows) > bucket
            or len(self._dirty_pod_rows) > pbucket
            or len(self.aff.dirty) > abucket
        )
        if not use_scatter or force_full:
            return self.to_device(force_full=force_full), None
        d = self._device
        upd = PendingScatter(
            node_rows=self._gather_rows(_NODE_ARRAYS, self._dirty_node_rows),
            pod_rows=self._gather_rows(_POD_ARRAYS, self._dirty_pod_rows),
            aff_rows=self._gather_rows(_AFF_ARRAYS, self.aff.dirty),
            numeric=_put(numeric, self.device),
        )
        self._uploaded_numeric_len = len(self.dic)
        self._dirty_node_rows.clear()
        self._dirty_pod_rows.clear()
        self.aff.dirty.clear()
        return d, upd

    def _upload_gate(self):
        """(padded numeric table, use_scatter) — the one place that decides
        between a full upload and row-scatters."""
        numeric = self.dic.numeric_table(min_size=self._numeric_min)
        n_num = _pow2(numeric.shape[0], self._numeric_min)
        numeric = np.pad(numeric, (0, n_num - numeric.shape[0]), constant_values=np.nan)
        dirty_frac = (
            (len(self._dirty_node_rows) + len(self._dirty_pod_rows))
            / max(self._n + self._p, 1)
        )
        use_scatter = (
            self._device is not None
            and not self._shape_changed
            and self._device.numeric.shape[0] == n_num
            and dirty_frac < 0.5
        )
        return numeric, use_scatter

    def _gather_rows(self, names: List[str], dirty: set):
        """(padded row indices, per-array value rows) for one array group,
        as device tensors.  The pad length is the reference's sticky pow-2
        high-water mark; an empty dirty set yields a no-op payload (row 0
        onto itself) at the same shape."""
        rows = np.fromiter(dirty, dtype=np.int32, count=len(dirty))
        rows.sort()
        floor = self._scatter_bucket.get(names[0], 256)
        k = max(_pow2(max(rows.shape[0], 1), 32), floor)
        self._scatter_bucket[names[0]] = k
        padded = np.full(k, rows[0] if rows.shape[0] else 0, dtype=np.int32)
        padded[: rows.shape[0]] = rows
        vals = tuple(_put(getattr(self, k_)[padded], self.device) for k_ in names)
        return (_put(padded.astype(np.int64), self.device), vals)

    def has_dirty(self) -> bool:
        """Any mirror rows dirtied since the last upload consumed them."""
        return bool(self._dirty_node_rows or self._dirty_pod_rows or self.aff.dirty)

    def capture_dirty(self):
        """Copies of the dirty-row sets an imminent to_device_deferred will
        consume: the overlapped sync keeps them so that a discarded payload
        can be undone (restore_dirty)."""
        return (set(self._dirty_node_rows), set(self._dirty_pod_rows),
                set(self.aff.dirty))

    def restore_dirty(self, saved) -> None:
        """Re-mark the rows of a to_device_deferred payload the caller
        discarded without applying: they never reached the device, so they
        ride the next payload.  The numeric table's high-water mark is
        invalidated too (the discarded build stamped it as uploaded)."""
        n, p, a = saved
        self._dirty_node_rows |= n
        self._dirty_pod_rows |= p
        self.aff.dirty |= a
        self._uploaded_numeric_len = -1

    def commit_device(self, dsnap: DeviceSnapshot):
        """Adopt an updated DeviceSnapshot as the current device state."""
        self._device = dsnap

    def to_device(self, force_full: bool = False) -> DeviceSnapshot:
        """Upload: whole tensors when shapes changed or dirt is large, else
        row-scatter updates into a copy of the current tensors."""
        numeric, use_scatter = self._upload_gate()
        if force_full:
            use_scatter = False
        numeric_stale = len(self.dic) != self._uploaded_numeric_len
        if not use_scatter:
            self._device = DeviceSnapshot(
                **{k: _put(getattr(self, k), self.device)
                   for k in _NODE_ARRAYS + _POD_ARRAYS + _AFF_ARRAYS},
                numeric=_put(numeric, self.device),
            )
        else:
            d = self._device
            upd = PendingScatter(
                node_rows=self._scatter_rows(_NODE_ARRAYS, self._dirty_node_rows),
                pod_rows=self._scatter_rows(_POD_ARRAYS, self._dirty_pod_rows),
                aff_rows=self._scatter_rows(_AFF_ARRAYS, self.aff.dirty),
                numeric=_put(numeric, self.device) if numeric_stale else None,
            )
            self._device = apply_scatter(d, upd)
        self._uploaded_numeric_len = len(self.dic)
        self._dirty_node_rows.clear()
        self._dirty_pod_rows.clear()
        self.aff.dirty.clear()
        self._shape_changed = False
        return self._device

    def _scatter_rows(self, names: List[str], dirty: set):
        """Eager-path row payload: None for an untouched group, else the
        dirty rows padded to a pow-2 length (min 32) by repeating the first
        row — identical values, so the duplicates are harmless."""
        if not dirty:
            return None
        rows = np.fromiter(dirty, dtype=np.int32, count=len(dirty))
        rows.sort()
        k = _pow2(rows.shape[0], 32)
        padded = np.full(k, rows[0], dtype=np.int32)
        padded[: rows.shape[0]] = rows
        vals = tuple(_put(getattr(self, k_)[padded], self.device) for k_ in names)
        return (_put(padded.astype(np.int64), self.device), vals)

    def row_to_name(self) -> Dict[int, str]:
        """Live row → node-name view (maintained incrementally; do not mutate)."""
        return self._row_to_name


_NODE_ARRAYS = [
    "node_valid", "node_name_ids", "allocatable", "requested", "non_zero_requested",
    "node_label_keys", "node_label_vals", "node_label_num", "node_topo",
    "taint_keys", "taint_vals",
    "taint_effects", "ports", "ports_ip", "image_ids", "image_sizes", "unschedulable",
    "node_ready", "claim_capacity", "claim_allocated",
]
_POD_ARRAYS = [
    "pod_valid", "pod_node", "pod_ns", "pod_label_keys", "pod_label_vals",
    "pod_priority", "pod_request", "pod_non_zero",
]
_AFF_ARRAYS = [
    "aff_valid", "aff_kind", "aff_weight", "aff_slot", "aff_counts",
]
# the node-row arrays, in the reference's order: a what-if node-add fork
# captures and activates template rows of each (whatif/fork.py)
NODE_ARRAYS = _NODE_ARRAYS

# node tiers at or below this take the always-full upload path in
# to_device_deferred (the reference's small-cluster rule)
_SMALL_NODE_TIER = 1024
