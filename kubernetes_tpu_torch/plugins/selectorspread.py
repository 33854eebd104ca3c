"""SelectorSpread (non-default in v1.24): spread pods of the same Service /
ReplicaSet across nodes and zones.

Reference: the JAX package's plugins/selectorspread.py (:29-147), after
pkg/scheduler/framework/plugins/selectorspread/selector_spread.go — PreScore
merges the selectors of every Service / ReplicaSet owning the pod
(helper.DefaultSelector: requirements AND together); Score = count of
matching pods on the node; NormalizeScore inverts against the max and
blends a zone score with weight 2/3 when zones exist.

Counts are host work per batch over the snapshot (the listers are API-object
lookups): ``host_prepare`` returns the reference's ``counts`` /
``zone_counts`` f32[B, N] and ``has_zone`` bool[N]: the owners' selectors
looked up once per distinct (namespace, labels) of the batch's pods, the
counts computed once per distinct (namespace, selector list) — one
ReplicaSet's replicas share both — from one pass that groups the
snapshot's pods by (namespace, labels); the values equal the reference's
loops exactly.
``prepare`` uploads them.  The score — the masked row maxima, the invert,
the 2/3 zone blend and the floor — is mask-dependent, so it runs over each
round's final mask (every filter bit set) inside the engines through K32
(kernels/selectorspread.py), on the full auction's [C, N] rows and on the
exact scan's one row.  The counts do not move with the batch's own commits
(no ``update``), as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..api import objects as v1
from ..api.labels import match_label_selector
from ..framework.events import ActionType, ClusterEvent, EventResource
from ..framework.interface import Plugin
from ..kernels.selectorspread import selector_spread_score, selector_spread_score_plain

ZONE_KEYS = ("topology.kubernetes.io/zone", "failure-domain.beta.kubernetes.io/zone")


class SelectorSpreadAux(NamedTuple):
    """The device tables: counts / zone_counts f32[C, N] (matching pods on
    the node / in its zone, per row), has_zone bool[N]."""

    counts: torch.Tensor
    zone_counts: torch.Tensor
    has_zone: torch.Tensor


def _selector_key(sels) -> tuple:
    """A hashable form of a selector list (the AND of its selectors)."""
    return tuple(
        (tuple(sorted(s.match_labels.items())),
         tuple((r.key, r.operator, tuple(r.values)) for r in s.match_expressions))
        for s in sels)


class SelectorSpreadPlugin(Plugin):
    name = "SelectorSpread"
    dynamic = True  # mask-dependent score inside the engines (no carried state)

    def __init__(self, store=None):
        self.store = store

    def events_to_register(self):
        return [
            ClusterEvent(EventResource.POD, ActionType.ALL),
            ClusterEvent(EventResource.SERVICE, ActionType.ALL),
        ]

    def _selectors_for(self, pod: v1.Pod, services=None, replica_sets=None):
        """helper.DefaultSelector: label selectors of every owning object
        (Services by equality selector, ReplicaSets by label selector, in
        the pod's namespace).  ``services`` / ``replica_sets``: the store's
        lists, when the caller fetched them already."""
        sels = []
        if self.store is None:
            return sels
        if services is None:
            services = self.store.list("Service")[0]
        if replica_sets is None:
            replica_sets = self.store.list("ReplicaSet")[0]
        for svc in services:
            if svc.metadata.namespace != pod.namespace or not svc.selector:
                continue
            if all(pod.metadata.labels.get(k) == val for k, val in svc.selector.items()):
                sels.append(v1.LabelSelector(match_labels=dict(svc.selector)))
        for rs in replica_sets:
            if rs.metadata.namespace != pod.namespace or rs.selector is None:
                continue
            if match_label_selector(rs.selector, pod.metadata.labels):
                sels.append(rs.selector)
        return sels

    def host_prepare(self, batch, snapshot, encoder, namespace_labels=None):
        """{"counts", "zone_counts": f32[B, N], "has_zone": bool[N]} on the
        host — the reference's host_prepare (:61-98), value for value: per
        batch pod with selectors, the pods of its namespace on each node
        matching all of them (terminating pods skipped), and their sum over
        the node's zone (either zone label key)."""
        b, n = batch.size, encoder._n
        counts = np.zeros((b, n), dtype=np.float32)
        zone_counts = np.zeros((b, n), dtype=np.float32)
        has_zone = np.zeros(n, dtype=bool)
        zone_idx = np.full(n, -1, dtype=np.int64)
        zones = {}
        rows = []
        for info in snapshot.node_info_list:
            r = encoder.node_rows.get(info.node_name)
            if r is None:
                continue
            rows.append((r, info))
            labels = info.node.metadata.labels
            z = labels.get(ZONE_KEYS[0]) or labels.get(ZONE_KEYS[1])
            has_zone[r] = z is not None
            if z is not None:
                zone_idx[r] = zones.setdefault(z, len(zones))
        keyed = {}
        if self.store is not None:
            services = self.store.list("Service")[0]
            replica_sets = self.store.list("ReplicaSet")[0]
            # a pod's selectors depend on its namespace and labels only:
            # one lookup per distinct (namespace, labels) in the batch
            by_labels = {}
            for i, pod in enumerate(batch.pods):
                lkey = (pod.namespace, frozenset(pod.metadata.labels.items()))
                if lkey not in by_labels:
                    sels = self._selectors_for(pod, services, replica_sets)
                    by_labels[lkey] = (sels, (pod.namespace, _selector_key(sels)))
                sels, key = by_labels[lkey]
                if sels:
                    keyed.setdefault(key, (sels, []))[1].append(i)
        if not keyed:
            return {"counts": counts, "zone_counts": zone_counts, "has_zone": has_zone}
        # the snapshot's live pods, grouped by (namespace, labels): per-row counts
        groups = {}
        for r, info in rows:
            for pi in info.pods:
                p = pi.pod
                if p.metadata.deletion_timestamp:
                    continue
                labels = p.metadata.labels
                gkey = (p.namespace, frozenset(labels.items()))
                g = groups.get(gkey)
                if g is None:
                    g = groups[gkey] = (labels, np.zeros(n, dtype=np.int64))
                g[1][r] += 1
        zoned = zone_idx >= 0
        for (ns, _sk), (sels, idxs) in keyed.items():
            row = np.zeros(n, dtype=np.int64)
            for (gns, _lk), (labels, cnt) in groups.items():
                if gns == ns and all(match_label_selector(s, labels) for s in sels):
                    row += cnt
            by_zone = np.bincount(zone_idx[zoned], weights=row[zoned],
                                  minlength=len(zones))
            zrow = np.zeros(n, dtype=np.float64)
            zrow[zoned] = by_zone[zone_idx[zoned]]
            counts[idxs] = row.astype(np.float32)
            zone_counts[idxs] = zrow.astype(np.float32)
        return {"counts": counts, "zone_counts": zone_counts, "has_zone": has_zone}

    def prepare(self, batch, snap, dyn, host_aux=None) -> SelectorSpreadAux:
        """The host tables on the device (all zero without a host half, as
        the reference: every node then scores 100)."""
        dev = snap.device
        if host_aux is None:
            z = torch.zeros((batch.valid.shape[0], snap.num_nodes), dtype=torch.float32,
                            device=dev)
            return SelectorSpreadAux(z, z, torch.zeros(snap.num_nodes, dtype=torch.bool,
                                                       device=dev))
        return SelectorSpreadAux(*(torch.from_numpy(np.ascontiguousarray(host_aux[k])).to(dev)
                                   for k in ("counts", "zone_counts", "has_zone")))

    def score(self, batch, snap, dyn, aux: SelectorSpreadAux = None, mask=None):
        """The reference's score (:109-145): floor of the blended node / zone
        score over ``mask`` (all nodes when None)."""
        if mask is None:
            mask = torch.ones(aux.counts.shape, dtype=torch.bool, device=aux.counts.device)
        return selector_spread_score_plain(mask, aux.counts, aux.zone_counts, aux.has_zone)

    def normalize(self, scores, mask):
        return scores

    def score_into(self, aux: SelectorSpreadAux, bits, full: int, total, weight: float):
        """Add weight · score over the final mask (all ``full`` bits) into
        ``total`` (K32)."""
        return selector_spread_score(bits, full, total, aux.counts, aux.zone_counts,
                                     aux.has_zone, weight)

    def engine_copy(self, aux: SelectorSpreadAux) -> SelectorSpreadAux:
        return aux  # nothing in it changes while an engine runs

    def row(self, aux: SelectorSpreadAux, i: int) -> SelectorSpreadAux:
        """Pod i's row of a full-batch aux (the exact scan's step)."""
        return aux._replace(counts=aux.counts[i:i + 1], zone_counts=aux.zone_counts[i:i + 1])


__all__ = ["SelectorSpreadPlugin", "SelectorSpreadAux", "ZONE_KEYS"]
