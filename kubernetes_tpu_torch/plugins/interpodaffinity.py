"""InterPodAffinity as batched tensor programs over per-term count state.

Reference: the JAX package's plugins/interpodaffinity.py, itself after
pkg/scheduler/framework/plugins/interpodaffinity/
  filtering.go:187-266 — PreFilter counts, per (topologyKey, value), the
      existing pods matching ALL of the incoming pod's required affinity
      terms, and those matching each of its required anti-affinity terms
  filtering.go:308-360 — Filter: the satisfy* checks, with the "first pod in
      a series" escape (no matching pod anywhere and the pod matches itself)
  scoring.go:49-123   — PreScore: weighted pair counts from the incoming
      pod's preferred terms (±) and the existing pods' own terms
  scoring.go:255+     — NormalizeScore: 100·(s−min)/(max−min)

Each of the pod's four term groups keeps its count state in one of two
forms, chosen statically (``_use_planes``): per-node planes ``[B, T, N]``
for dense domains (hostname keys), per-domain tables ``[B, T, D+1]``
otherwise (the batch's ``ipa_domain_bucket`` D plus the trash slot of nodes
without the key).  The existing pods' own terms come from the encoder's
incremental affinity index (state/affinity_index.py) through
``host_prepare``'s ``[G, B]`` match matrix.

The arithmetic lives beside its kernels in kernels/interpodaffinity.py:
``prepare`` counts and expands through K9, the dedup engine folds
``filter`` into K1's bit plane through K10 and ``score`` + ``normalize``
into K2's total through K11, and ``update_batch_classes`` runs K12 once per
auction round; the deep pipeline's ``chain_prev`` folds a still-in-flight
batch's placements in through K15.  The full auction runs the same kernels
at one class per pod (the reference's ``update_batch`` is
``update_batch_classes`` at identity classes); the exact scan runs K10 and
K11 on one pod's ``row`` per step (the reference's ``filter_row`` and
``score_row``) and ``update`` through K19.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..framework.events import ActionType, ClusterEvent, EventResource
from ..framework.interface import Plugin
from ..framework.podbatch import AFFINITY_GROUPS
from ..kernels.interpodaffinity import (
    OwnTerms,
    ipa_chain_prev,
    ipa_existing_planes,
    ipa_filter_bits,
    ipa_filter_plane,
    ipa_normalize,
    ipa_prepare_counts,
    ipa_raw_plane,
    ipa_score_combine,
    ipa_update_classes,
    ipa_update_row,
)
from ..ops.segment import check_count_bound
from ..state.dictionary import MISSING
from .helpers import flat_selector_matrix, node_tensor

DEFAULT_HARD_POD_AFFINITY_WEIGHT = 1  # apis/config InterPodAffinityArgs default


class IPAAux(NamedTuple):
    # the reference's IPAAux fields, in its order (class rows C on the pod axis)
    dom_aff: torch.Tensor  # i32[C, T1, N] domain of each node under each term; D = trash
    dom_anti: torch.Tensor  # i32[C, T2, N]
    dom_paff: torch.Tensor  # i32[C, T3, N]
    dom_panti: torch.Tensor  # i32[C, T4, N]
    aff_cnt: torch.Tensor  # i32[C, T1, N or D+1]
    anti_cnt: torch.Tensor  # i32[C, T2, N or D+1]
    paff_cnt: torch.Tensor  # i32[C, T3, N or D+1]
    panti_cnt: torch.Tensor  # i32[C, T4, N or D+1]
    aff_total: torch.Tensor  # i32[C] Σ affinityCounts (the len() == 0 test)
    self_match_all: torch.Tensor  # bool[C]
    exist_anti_block: torch.Tensor  # bool[C, N]
    score_static: torch.Tensor  # f32[C, N]
    aff_term_cross: torch.Tensor  # bool[C, T1, C] term t of class c matches class j
    aff_cross_all: torch.Tensor  # bool[C, C] class j matches ALL req-aff terms of c
    anti_cross: torch.Tensor  # bool[C, T2, C]
    paff_cross: torch.Tensor  # bool[C, T3, C]
    panti_cross: torch.Tensor  # bool[C, T4, C]
    block_dyn: torch.Tensor  # bool[C, N] blocks from this cycle's commits
    score_dyn: torch.Tensor  # f32[C, N] score from this cycle's commits
    # what the kernels read from the batch and the plugin (the reference
    # reads them from its arguments)
    depth: int  # the batch's domain bucket D
    present: tuple  # the term groups with a valid term (PodBatch.group_present)
    req_aff_valid: torch.Tensor  # bool[C, T1]
    paff_weight: torch.Tensor  # f32[C, T3]
    panti_weight: torch.Tensor  # f32[C, T4]
    hard_weight: float  # hardPodAffinityWeight


# the count state and the dynamic planes: what the dedup engine updates
_MUTABLE = ("aff_cnt", "anti_cnt", "paff_cnt", "panti_cnt", "aff_total",
            "block_dyn", "score_dyn")


class InterPodAffinityPlugin(Plugin):
    name = "InterPodAffinity"
    dynamic = True

    def __init__(self, domain_cap: int = 256,
                 hard_pod_affinity_weight: int = DEFAULT_HARD_POD_AFFINITY_WEIGHT):
        self.domain_cap = domain_cap  # used when a batch carries no domain bucket
        self.hard_weight = float(hard_pod_affinity_weight)

    def events_to_register(self):
        return [
            ClusterEvent(EventResource.POD, ActionType.ALL),
            ClusterEvent(EventResource.NODE, ActionType.ADD | ActionType.UPDATE_NODE_LABEL),
        ]

    def _d(self, batch) -> int:
        """Batch-local domain axis (PodBatch.ipa_domain_bucket): the global
        domain_cap covers every registered topo key, so one hostname key
        would size a zone-affinity batch's tables (and flip it to planes)
        for 5k domains when its own keys have 3."""
        return getattr(batch, "ipa_domain_bucket", None) or self.domain_cap

    def _use_planes(self, batch, snap) -> bool:
        """Per-node planes when domains are dense (D ≈ N, hostname keys),
        per-domain tables when D ≪ N (zone keys) — the reference's static
        choice, so both packages carry the same form."""
        return self._d(batch) * 4 >= snap.num_nodes

    def _present(self, batch, name: str) -> bool:
        """Does the batch have ANY valid term in this group
        (PodBatch.group_present)?"""
        return name in getattr(batch, "group_present", AFFINITY_GROUPS)

    # --- host precompute ------------------------------------------------------

    def host_prepare(self, batch, snapshot, encoder, namespace_labels=None):
        """The existing pods' own terms: the ``[G, B]`` match matrix of the
        encoder's incremental affinity groups against the batch, or None
        when no live group matches (state/affinity_index.py match_batch)."""
        return encoder.aff.match_batch(batch.pods, batch.size, namespace_labels)

    def host_aux_take(self, aux, rows):
        """The identity-class rep view of the host aux: the match matrix's
        columns are functions of (namespace, labels) — class content — so
        gathering the rep columns is exact."""
        if aux is None:
            return None
        return {"match": np.asarray(aux["match"])[:, np.asarray(rows)]}

    # --- prepare (PreFilter + PreScore) ---------------------------------------

    def _group_arrays(self, group, snap, d):
        """dom [B, T, N]: each node's domain under each term's key; the trash
        slot d for nodes without the key and for invalid terms."""
        key = group.topo_key.long().clamp(0, snap.node_topo.shape[1] - 1)
        dom = snap.node_topo[:, key].permute(1, 2, 0)  # [N, B, T] → [B, T, N]
        has = (dom != MISSING) & group.valid[:, :, None]
        return torch.where(has, dom.clamp(0, d - 1), d).to(torch.int32).contiguous()

    def _match_vs(self, group, keys, vals, ns, numeric):
        """Term (b, t) matches target pods → bool[B, T, P] (validity +
        namespace + selector)."""
        b, t = group.valid.shape
        m = flat_selector_matrix(group.selectors, b, t, keys, vals, numeric)
        ns_ok = group.all_namespaces[:, :, None] | (
            group.ns_ids[:, :, :, None] == ns[None, None, None, :]).any(dim=2)
        return m & ns_ok & group.valid[:, :, None]

    def prepare(self, batch, snap, dyn, host_aux=None):
        """The class rows' count state, cross-match tensors and existing-pod
        planes, or None for a batch without affinity terms and without a
        live existing-pod group (the reference's static skip)."""
        if not getattr(batch, "has_affinity", True) and host_aux is None:
            return None
        d = self._d(batch)
        b = batch.valid.shape[0]
        n = snap.num_nodes
        dev = snap.device
        num = snap.numeric
        planes = self._use_planes(batch, snap)
        width = n if planes else d + 1
        # a count is at most every scheduled pod plus this cycle's commits
        check_count_bound(snap.num_pods + b)

        def absent(group):
            t = group.valid.shape[1]
            return (torch.full((b, t, n), d, dtype=torch.int32, device=dev),
                    torch.zeros((b, t, width), dtype=torch.int32, device=dev),
                    torch.zeros((b, t, b), dtype=torch.bool, device=dev))

        def sched_match(group):
            return self._match_vs(group, snap.pod_label_keys, snap.pod_label_vals,
                                  snap.pod_ns, num)

        def pending_match(group):
            return self._match_vs(group, batch.label_keys, batch.label_vals, batch.ns, num)

        def group_state(group, name):
            if not self._present(batch, name):
                return absent(group)
            dom = self._group_arrays(group, snap, d)
            cnt, _ = ipa_prepare_counts(sched_match(group), snap.pod_node, snap.pod_valid,
                                        dom, d, planes)
            return dom, cnt, pending_match(group)

        # required affinity: affinityCounts count pods matching ALL terms
        g_aff = batch.req_affinity
        if self._present(batch, "req_affinity"):
            valid = g_aff.valid[:, :, None]
            has_terms = g_aff.valid.any(dim=1)[:, None]
            dom_aff = self._group_arrays(g_aff, snap, d)
            all_match = (sched_match(g_aff) | ~valid).all(dim=1) & has_terms  # [B, P]
            aff_cnt, aff_total = ipa_prepare_counts(
                all_match[:, None, :] & valid, snap.pod_node, snap.pod_valid, dom_aff, d,
                planes)
            x_aff = pending_match(g_aff)
            x_aff_all = (x_aff | ~valid).all(dim=1) & has_terms & batch.valid[None, :]
        else:
            dom_aff, aff_cnt, x_aff = absent(g_aff)
            aff_total = torch.zeros((b,), dtype=torch.int32, device=dev)
            x_aff_all = torch.zeros((b, b), dtype=torch.bool, device=dev)

        dom_anti, anti_cnt, x_anti = group_state(batch.req_anti_affinity, "req_anti_affinity")
        dom_paff, paff_cnt, x_paff = group_state(batch.pref_affinity, "pref_affinity")
        dom_panti, panti_cnt, x_panti = group_state(batch.pref_anti_affinity,
                                                    "pref_anti_affinity")
        diag = torch.arange(b, device=dev)

        if host_aux is None:
            exist_anti_block = torch.zeros((b, n), dtype=torch.bool, device=dev)
            score_static = torch.zeros((b, n), dtype=torch.float32, device=dev)
        else:
            match_g = torch.as_tensor(np.asarray(host_aux["match"])).to(dev)
            exist_anti_block, score_static = ipa_existing_planes(
                match_g, snap.aff_counts, snap.aff_slot, snap.aff_valid, snap.aff_kind,
                snap.aff_weight, snap.node_topo, self.hard_weight)
        return IPAAux(
            dom_aff=dom_aff, dom_anti=dom_anti, dom_paff=dom_paff, dom_panti=dom_panti,
            aff_cnt=aff_cnt, anti_cnt=anti_cnt, paff_cnt=paff_cnt, panti_cnt=panti_cnt,
            aff_total=aff_total, self_match_all=x_aff_all[diag, diag],
            exist_anti_block=exist_anti_block, score_static=score_static,
            aff_term_cross=x_aff, aff_cross_all=x_aff_all, anti_cross=x_anti,
            paff_cross=x_paff, panti_cross=x_panti,
            block_dyn=torch.zeros((b, n), dtype=torch.bool, device=dev),
            score_dyn=torch.zeros((b, n), dtype=torch.float32, device=dev),
            depth=d, present=tuple(getattr(batch, "group_present", AFFINITY_GROUPS)),
            req_aff_valid=g_aff.valid, paff_weight=batch.pref_affinity.weight,
            panti_weight=batch.pref_anti_affinity.weight, hard_weight=self.hard_weight,
        )

    # --- filter / score / normalize (the reference's planes) -----------------

    def filter(self, batch, snap, dyn, aux: IPAAux = None):
        if aux is None:
            return torch.ones((batch.valid.shape[0], snap.num_nodes), dtype=torch.bool,
                              device=snap.device)
        return ipa_filter_plane(aux)

    def score(self, batch, snap, dyn, aux: IPAAux = None, mask=None):
        if aux is None:
            return torch.zeros((batch.valid.shape[0], snap.num_nodes),
                               dtype=torch.float32, device=snap.device)
        return ipa_raw_plane(aux)

    def normalize(self, scores, mask):
        return ipa_normalize(scores, mask)

    # --- the dedup engine's fused forms (K10, K11, K12) ------------------------

    def filter_bits(self, aux: IPAAux, bits, bit: int):
        """Clear this filter's ``bit`` of the pass-bit plane where it fails (K10)."""
        return ipa_filter_bits(aux, bits, bit)

    def score_into(self, aux: IPAAux, bits, full: int, total, weight: float):
        """Add weight · floor(normalize(score)) into ``total`` (K11)."""
        return ipa_score_combine(aux, bits, full, total, weight)

    def engine_copy(self, aux: IPAAux) -> IPAAux:
        """The aux with its own count state and dynamic planes, for an engine
        that updates them in place."""
        return aux._replace(**{f: getattr(aux, f).clone() for f in _MUTABLE})

    def update_batch_classes(self, aux: IPAAux, commit, choice, class_of):
        """The dedup engine's round update at class granularity (K12): ``aux``
        is the class-representative view, updated in place with the round's
        commits.  The reference takes the commits' class one-hot ``u_c``;
        the plain version builds it from the same (commit, choice,
        class_of) and is equal."""
        if aux is None:
            return None
        return ipa_update_classes(aux, commit, choice, class_of)

    # --- the deep pipeline (K15) -------------------------------------------------

    def chain_prev(self, aux: IPAAux, batch, snap, prev):
        """Fold a still-in-flight batch's placements (``prev``, a
        runtime.PrevBatch with its device-resident node rows) into the class
        view's state, as if those pods were already in the snapshot (the
        reference's chain_prev, interpodaffinity.py:533-670), in two halves:
        (i) this batch's term groups against the prev pods' labels bump the
        counts (and ``aff_total``) at the domain of each placed prev pod's
        node; (ii) the prev pods' own terms block (required anti-affinity)
        or score this batch's matching classes on every node that shares
        the term's raw topology value at the prev pod's node.  A carry
        without term groups (the dispatching batch has no affinity content,
        or the chain is off) leaves the aux as it is — the reference's
        static gate.  New tensors; the aux passed in is unchanged."""
        if aux is None:
            return None
        if prev.req_anti_affinity is None:
            return aux
        num = snap.numeric
        counts = {}
        if self._present(batch, "req_affinity"):
            g = batch.req_affinity
            m = self._match_vs(g, prev.label_keys, prev.label_vals, prev.ns, num)
            x_all = (m | ~g.valid[:, :, None]).all(dim=1) & g.valid.any(dim=1)[:, None]
            counts["req_affinity"] = x_all[:, None, :] & g.valid[:, :, None]
        for name in ("req_anti_affinity", "pref_affinity", "pref_anti_affinity"):
            if self._present(batch, name):
                counts[name] = self._match_vs(getattr(batch, name), prev.label_keys,
                                              prev.label_vals, prev.ns, num)
        own = []

        def terms(name, block, weight, w_scalar, sign):
            # a prev group without a valid term matches nothing: skip it
            if name not in prev.group_present:
                return
            pg = getattr(prev, name)
            mm = self._match_vs(pg, batch.label_keys, batch.label_vals, batch.ns, num)
            own.append(OwnTerms(block, mm, pg.topo_key, pg.valid, weight, w_scalar, sign))

        terms("req_anti_affinity", True, None, 0.0, 1.0)
        if self.hard_weight > 0:
            terms("req_affinity", False, None, self.hard_weight, 1.0)
        terms("pref_affinity", False, prev.pref_affinity.weight, 0.0, 1.0)
        terms("pref_anti_affinity", False, prev.pref_anti_affinity.weight, 0.0, -1.0)
        rows = torch.where(prev.valid, prev.rows, -1)
        return aux._replace(**ipa_chain_prev(aux, counts, own, rows, snap.node_topo,
                                             MISSING))

    # --- the exact scan: one pod's row (K10, K11) and its update (K19) ----------

    def row(self, aux: IPAAux, i: int) -> IPAAux:
        """Pod i's row of a full-batch aux: views, so the scan's updates to
        the counts and planes show through."""
        return aux._replace(**{f: v[i:i + 1] for f, v in aux._asdict().items()
                               if isinstance(v, torch.Tensor)})

    def update(self, aux: IPAAux, i: int, node_row, batch, snap):
        """Pod i placed at ``node_row`` (an i32[1] tensor on the aux's device,
        or an int; below 0: not placed) — the reference's update
        (:447-530), through K19.  The aux changes in place (the engine works
        on an ``engine_copy``)."""
        if aux is None:
            return None
        return ipa_update_row(aux, i, node_tensor(node_row, aux.block_dyn.device))
