"""The existing-pod side of InterPodAffinity: an incrementally maintained
index of the scheduled pods' own affinity terms (host numpy, no device
code).

A copy of the JAX package's state/affinity_index.py.  Each scheduled pod's
term contributions are applied once when the pod lands on a node (assume /
bind, through ``ClusterEncoder.sync``'s changed-node list) and reverted when
it leaves (forget / delete / node delete), so per-cycle host work is
O(batch delta).  The tables are the encoder's ``aff_*`` mirrors, uploaded
by the same deferred row-scatter as the node and pod rows
(state/encoding.py ``to_device_deferred``); InterPodAffinity's ``prepare``
expands them into the ``[C, N]`` block and score planes on the device
(kernel K9, kernels/interpodaffinity.py).

Group model: two terms with equal ``_term_signature`` match exactly the same
target pods, so all owners of one signature aggregate into ONE count row
``counts[g, domain_value]`` under the term's topology-key slot.  ``kind`` 0
= required-anti BLOCK rows, 1 = SCORE rows (preferred ±weight), 2 =
existing required affinity scored with hardPodAffinityWeight.

``rebuild`` recomputes everything from a snapshot: the resync path, and the
oracle the tests hold the incremental path to.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api.labels import affinity_term_matches
from . import units
from .dictionary import MISSING

KIND_BLOCK = 0
KIND_SCORE = 1
# existing pods' REQUIRED affinity terms score via hardPodAffinityWeight —
# stored weight-free (1.0) so the index never depends on a plugin arg
# (profiles may configure different weights over ONE shared index); the
# plugin multiplies at expansion time (a trace-time constant)
KIND_SCORE_REQ = 2

_MATCH_CACHE_CAP = 8192  # (group, pod-identity) memo bound; cleared on overflow


def _pow2(x: int, minimum: int = 8) -> int:
    return units.pow2_round_up(x, minimum)


def _selector_signature(sel) -> Optional[tuple]:
    """Hashable identity of a LabelSelector's match semantics."""
    if sel is None:
        return None
    return (
        tuple(sorted(sel.match_labels.items())),
        tuple(
            (e.key, e.operator, tuple(e.values)) for e in sel.match_expressions
        ),
    )


def _term_signature(term, owner_ns: str) -> tuple:
    """Two terms with equal signatures match exactly the same target pods
    (affinity_term_matches semantics: namespaces list, namespaceSelector, the
    owner-namespace default when both are unset, and the label selector)."""
    if term.namespaces:
        ns_key = ("list", tuple(sorted(term.namespaces)))
        if term.namespace_selector is not None:
            ns_key = ns_key + ("sel", _selector_signature(term.namespace_selector))
    elif term.namespace_selector is not None:
        ns_key = ("sel", _selector_signature(term.namespace_selector))
    else:
        ns_key = ("owner", owner_ns)
    return (term.topology_key, ns_key, _selector_signature(term.label_selector))


class _OwnerStub:
    """Minimal owner-pod stand-in for affinity_term_matches: the namespace
    default is the ONLY owner attribute the match reads, and the signature
    registry guarantees all owners of a group share it."""

    __slots__ = ("namespace",)

    def __init__(self, namespace: str):
        self.namespace = namespace


class AffinityIndex:
    """Registry of deduplicated existing-pod affinity term groups plus their
    incrementally maintained per-domain count tables.

    Owned by ClusterEncoder; the numpy arrays below are uploaded to device as
    the ``_AFF_ARRAYS`` scatter group.  Group rows are sticky (never reused):
    signature-count churn grows G by pow-2 doubling, which recompiles the
    fused programs O(log) times per run, exactly like the node/pod tiers.
    """

    def __init__(self, encoder):
        self.enc = encoder
        self._sig_row: Dict[tuple, int] = {}
        # per-row host metadata (parallel to the device arrays)
        self._row_term: List[object] = []  # representative term
        self._row_owner: List[_OwnerStub] = []
        self._row_total: List[int] = []  # live contribution count
        # uid -> tuple of (group_row, domain_val) contributions
        self._contrib: Dict[str, Tuple[Tuple[int, int], ...]] = {}
        # per-row batch-match memo: (ns, labels-key) -> bool
        self._match_cache: List[Dict[tuple, bool]] = []
        self._g = 8
        self._d = 8
        self.dirty: set = set()
        self._alloc()

    # --- array management -----------------------------------------------------

    def _alloc(self):
        g, d = self._g, self._d
        self.aff_valid = np.zeros(g, dtype=bool)
        self.aff_kind = np.zeros(g, dtype=np.int32)
        self.aff_weight = np.zeros(g, dtype=np.float32)
        self.aff_slot = np.full(g, MISSING, dtype=np.int32)
        self.aff_counts = np.zeros((g, d), dtype=np.float32)

    def _grow(self, g: Optional[int] = None, d: Optional[int] = None):
        old = (self.aff_valid, self.aff_kind, self.aff_weight, self.aff_slot,
               self.aff_counts)
        self._g = _pow2(g, self._g) if g else self._g
        self._d = _pow2(d, self._d) if d else self._d
        self._alloc()
        og = old[0].shape[0]
        self.aff_valid[:og] = old[0]
        self.aff_kind[:og] = old[1]
        self.aff_weight[:og] = old[2]
        self.aff_slot[:og] = old[3]
        self.aff_counts[:og, : old[4].shape[1]] = old[4]
        # a tier shape change invalidates every compiled program over the
        # DeviceSnapshot — same contract as node/pod tier growth
        self.enc._shape_changed = True
        self.dirty.update(range(og))

    @property
    def num_groups(self) -> int:
        return len(self._row_term)

    @property
    def live_groups(self) -> int:
        return sum(1 for t in self._row_total if t > 0)

    # --- group registry -------------------------------------------------------

    def _row_of(self, kind: int, weight: float, term, owner_ns: str) -> int:
        sig = (kind, weight, _term_signature(term, owner_ns))
        row = self._sig_row.get(sig)
        if row is not None:
            return row
        row = len(self._row_term)
        if row >= self._g:
            self._grow(g=row + 1)
        self._sig_row[sig] = row
        self._row_term.append(term)
        self._row_owner.append(_OwnerStub(owner_ns))
        self._row_total.append(0)
        self._match_cache.append({})
        self.aff_valid[row] = True
        self.aff_kind[row] = kind
        self.aff_weight[row] = weight
        slot = self.enc.topo_slot(term.topology_key)
        self.aff_slot[row] = slot
        # Reserve the count-table width for the slot's WHOLE live domain
        # space up front: topo_slot backfills every node at registration, so
        # the value map is already complete — growing lazily per observed
        # contribution instead crossed a pow2 (= full program recompile)
        # whenever a hostname-keyed suite filled new nodes MID-WINDOW
        # (measured two ~2s in-window compiles in the scaled anti suite).
        # Nodes added later (churn) still grow the width O(log) times.
        need = len(self.enc.topo_value_maps[slot])
        if need > self._d:
            self._grow(d=need)
        self.dirty.add(row)
        return row

    # --- incremental maintenance ---------------------------------------------

    def _pod_contributions(self, pi, node_row: int) -> Tuple[Tuple[int, int], ...]:
        """(group_row, domain_val) per term of a scheduled pod on node_row.
        Terms whose topology key is absent on the node contribute nothing
        (same skip as the old walk)."""
        out: List[Tuple[int, int]] = []
        enc = self.enc
        ns = pi.pod.namespace

        def add(term, kind, weight):
            row = self._row_of(kind, weight, term, ns)
            val = int(enc.node_topo[node_row, int(self.aff_slot[row])])
            if val == MISSING:
                return
            out.append((row, val))

        for term in pi.required_anti_affinity_terms:
            add(term, KIND_BLOCK, 0.0)
        for term in pi.required_affinity_terms:
            add(term, KIND_SCORE_REQ, 1.0)
        for wt in pi.preferred_affinity_terms:
            add(wt.pod_affinity_term, KIND_SCORE, float(wt.weight))
        for wt in pi.preferred_anti_affinity_terms:
            add(wt.pod_affinity_term, KIND_SCORE, -float(wt.weight))
        return tuple(out)

    def _apply(self, contribs, sign: int):
        for row, val in contribs:
            if val >= self._d:
                self._grow(d=val + 1)
            self.aff_counts[row, val] += sign
            self._row_total[row] += sign
            self.dirty.add(row)

    def set_pod(self, pi, node_row: int) -> None:
        """(Re-)apply one scheduled pod's contributions (idempotent: the old
        contributions are reverted first, so node-label/topology changes and
        pod moves re-home the counts)."""
        uid = pi.pod.uid
        if not pi.has_affinity_constraints():
            if uid in self._contrib:
                self.remove_pod(uid)
            return
        new = self._pod_contributions(pi, node_row)
        old = self._contrib.get(uid)
        if old == new:
            return
        if old:
            self._apply(old, -1)
        self._apply(new, +1)
        if new:
            self._contrib[uid] = new
        else:
            self._contrib.pop(uid, None)

    def remove_pod(self, uid: str) -> None:
        old = self._contrib.pop(uid, None)
        if old:
            self._apply(old, -1)

    def contributions(self, uid: str) -> Tuple[Tuple[int, int], ...]:
        """A scheduled pod's live (group_row, domain_val) contributions —
        what remove_pod would subtract.  The what-if engine masks exactly
        these cells out of a forked ``aff_counts`` so an affinity-carrying
        victim's fork equals the post-eviction state bit-for-bit."""
        return self._contrib.get(uid, ())

    def rebuild(self, snapshot) -> None:
        """Resync/repair path: recompute every count from the snapshot's
        sparse affinity lists into the SAME registry rows (registry stays
        sticky so device shapes and row meanings are stable).  Also the
        parity oracle for the incremental path."""
        self.aff_counts[:] = 0.0
        for i in range(len(self._row_total)):
            self._row_total[i] = 0
        self._contrib.clear()
        self.dirty.update(range(self.num_groups))
        enc = self.enc
        seen = set()
        for info in (list(snapshot.have_pods_with_required_anti_affinity_list)
                     + list(snapshot.have_pods_with_affinity_list)):
            row = enc.node_rows.get(info.node_name)
            if row is None:
                continue
            for pi in info.pods:
                if pi.pod.uid in seen or not pi.has_affinity_constraints():
                    continue
                seen.add(pi.pod.uid)
                self.set_pod(pi, row)

    # --- per-batch host work --------------------------------------------------

    def match_batch(self, pods, size: int, namespace_labels=None):
        """→ host_aux {"match": bool[G, B]} for InterPodAffinityPlugin, or
        None when no live group exists (the plugin then compiles the
        affinity-free program variant, as before).

        Cost: O(live groups × distinct pod identities) Python matches with a
        per-group memo — templated batches hit the cache after the first pod.
        """
        live = [g for g in range(self.num_groups) if self._row_total[g] > 0]
        if not live:
            return None
        # per-pod memo keys hoisted out of the group loop: they depend only
        # on the pod (O(batch) sorts, not O(groups × batch))
        keys = [
            (pod.namespace, tuple(sorted(pod.metadata.labels.items())))
            for pod in pods
        ]
        m = np.zeros((self._g, size), dtype=bool)
        for g in live:
            term = self._row_term[g]
            owner = self._row_owner[g]
            cache = self._match_cache[g]
            if len(cache) > _MATCH_CACHE_CAP:
                cache.clear()
            row = m[g]
            for i, pod in enumerate(pods):
                hit = cache.get(keys[i])
                if hit is None:
                    hit = affinity_term_matches(term, owner, pod, namespace_labels)
                    cache[keys[i]] = hit
                row[i] = hit
        if not m.any():
            return None
        return {"match": m}
