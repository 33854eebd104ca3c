"""PodTopologySpread as batched tensor programs over per-domain count tables.

Reference: the JAX package's plugins/podtopologyspread.py, itself after
pkg/scheduler/framework/plugins/podtopologyspread/
  filtering.go:256-289 — PreFilter counts matching pods per (topologyKey, value)
      over nodes passing the pod's nodeSelector/affinity that carry ALL hard keys
  filtering.go:343-358 — Filter: matchNum + selfMatch − globalMin > maxSkew;
      node missing a key → UnschedulableAndUnresolvable
  scoring.go:108-175  — PreScore counts per pair over affinity-eligible nodes,
      restricted to pairs present among feasible nodes
  scoring.go:180-213  — Score: Σ_c cnt·log(topoSize+2) + (maxSkew−1)
  scoring.go:216+     — NormalizeScore: 100·(max+min−s)/max, ignored nodes → 0

Counts live in ``[B, C, D+1]`` tables (the last slot is the trash slot of
nodes without the key) over the batch's domain bucket
(``PodBatch.tsc_domain_bucket``).  The arithmetic lives beside its kernels
in kernels/spread.py: ``prepare`` builds its tables through K5, the
dedup engine folds ``filter`` into K1's bit plane through K6 and
``score`` + ``normalize`` into K2's total through K7, and
``update_batch_classes`` runs K8 once per auction round; the deep
pipeline's ``chain_prev`` folds a still-in-flight batch's placements in
through K14.  The full auction runs the same kernels at one class per pod (the
reference's ``update_batch`` is ``update_batch_classes`` at identity
classes); the exact scan runs K6 and K7 on one pod's ``row`` per step
(the reference's ``filter_row`` and ``score_row``) and ``update`` through
K18.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..framework.events import ActionType, ClusterEvent, EventResource
from ..framework.interface import Plugin
from ..framework.podbatch import WHEN_DO_NOT_SCHEDULE, WHEN_SCHEDULE_ANYWAY
from ..kernels.spread import (
    check_domain_bucket,
    spread_filter_bits,
    spread_filter_plane,
    spread_normalize,
    spread_prepare_counts,
    spread_raw_plane,
    spread_chain_prev,
    spread_score_combine,
    spread_update_classes,
    spread_update_row,
)
from ..ops.segment import check_count_bound
from ..state.dictionary import MISSING
from ..state.selectors import label_match_matrix
from .helpers import label_selector_matrix, node_selector_matrix, node_tensor


class TSAux(NamedTuple):
    hard_valid: torch.Tensor  # bool[B, C]
    soft_valid: torch.Tensor  # bool[B, C]
    max_skew: torch.Tensor  # i32[B, C]
    min_domains: torch.Tensor  # i32[B, C]
    self_match: torch.Tensor  # bool[B, C]
    dom_val: torch.Tensor  # i32[B, C, N] (domain index of node under c's key; D=trash)
    has_key: torch.Tensor  # bool[B, C, N]
    counted_hard: torch.Tensor  # bool[B, N] nodes counted for hard constraints
    counted_soft: torch.Tensor  # bool[B, N]
    hard_counts: torch.Tensor  # i32[B, C, D+1]
    soft_counts: torch.Tensor  # i32[B, C, D+1]
    hard_present: torch.Tensor  # bool[B, C, D+1] domains with ≥1 counted node
    match_pending: torch.Tensor  # bool[B, C, B] — selector (b,c) matches pending pod j


class PodTopologySpreadPlugin(Plugin):
    name = "PodTopologySpread"
    dynamic = True

    def __init__(self, domain_cap: int = 256, enable_min_domains: bool = True):
        self.domain_cap = domain_cap  # used when a batch carries no domain bucket
        self.enable_min_domains = enable_min_domains

    def events_to_register(self):
        return [
            ClusterEvent(EventResource.POD, ActionType.ALL),
            ClusterEvent(EventResource.NODE, ActionType.ADD | ActionType.UPDATE_NODE_LABEL),
        ]

    # --- prepare (PreFilter + the static part of PreScore) -------------------

    def prepare(self, batch, snap, dyn, host_aux=None):
        """The count tables of every (pod, constraint) row, or None for a
        batch without spread constraints (the reference's static skip).
        The plugin has no host half: ``host_aux`` is always None."""
        if not getattr(batch, "has_spread", True):
            return None
        d = getattr(batch, "tsc_domain_bucket", None) or self.domain_cap
        check_domain_bucket(d)
        b, c_cap = batch.tsc_valid.shape
        dev = snap.device

        hard_valid = batch.tsc_valid & (batch.tsc_when == WHEN_DO_NOT_SCHEDULE)
        soft_valid = batch.tsc_valid & (batch.tsc_when == WHEN_SCHEDULE_ANYWAY)

        key = batch.tsc_key.long().clamp(0, snap.node_topo.shape[1] - 1)  # [B, C]
        dom_val = snap.node_topo[:, key].permute(1, 2, 0)  # [N, B, C] → [B, C, N]
        has_key = (dom_val != MISSING).contiguous()
        dom_val = torch.where(has_key, dom_val.clamp(0, d - 1),
                              d).to(torch.int32).contiguous()

        # nodes eligible for counting: pass the pod's nodeSelector + required
        # node affinity
        sel_ok = label_selector_matrix(
            batch.node_selector, snap.node_label_keys, snap.node_label_vals,
            snap.numeric, vals_num=snap.node_label_num)
        aff_ok = node_selector_matrix(
            batch.node_affinity, snap.node_label_keys, snap.node_label_vals,
            snap.numeric, vals_num=snap.node_label_num)
        affinity_ok = sel_ok & aff_ok & snap.node_valid[None, :]  # [B, N]
        has_all_hard = (~hard_valid[:, :, None] | has_key).all(dim=1)
        has_all_soft = (~soft_valid[:, :, None] | has_key).all(dim=1)
        counted_hard = affinity_ok & has_all_hard
        counted_soft = affinity_ok & has_all_soft

        # selector (b, c) vs scheduled pods (same namespace only) → [B, C, P]
        match_sched = self._selector_vs_pods(
            batch, snap.pod_label_keys, snap.pod_label_vals, snap.pod_ns, snap.numeric)
        match_sched = match_sched & snap.pod_valid[None, None, :]
        # a table counts at most every scheduled pod and every batch pod
        check_count_bound(snap.num_pods + b)
        hard_counts, soft_counts, hard_present = spread_prepare_counts(
            match_sched, snap.pod_node, dom_val, counted_hard, counted_soft, d)

        # constraint selectors vs PENDING pods; the diagonal is selfMatch
        self_match = self._selector_vs_pods(
            batch, batch.label_keys, batch.label_vals, batch.ns, snap.numeric)
        match_pending = self_match & batch.valid[None, None, :]
        diag = torch.arange(b, device=dev)
        self_diag = match_pending[diag, :, diag]  # [B, C]

        return TSAux(
            hard_valid=hard_valid, soft_valid=soft_valid,
            max_skew=batch.tsc_max_skew, min_domains=batch.tsc_min_domains,
            self_match=self_diag, dom_val=dom_val, has_key=has_key,
            counted_hard=counted_hard, counted_soft=counted_soft,
            hard_counts=hard_counts, soft_counts=soft_counts,
            hard_present=hard_present, match_pending=match_pending,
        )

    def _selector_vs_pods(self, batch, pl_keys, pl_vals, p_ns, numeric):
        """Constraint selectors [B, C] vs pod label sets [P, L] → bool[B, C, P]
        (same namespace only)."""
        b, c_cap = batch.tsc_valid.shape
        m = label_match_matrix(batch.tsc_selectors, pl_keys, pl_vals,
                               numeric=numeric).reshape(b, c_cap, -1)
        return m & (batch.ns[:, None, None] == p_ns[None, None, :])

    # --- filter / score / normalize (the reference's planes) -----------------

    def filter(self, batch, snap, dyn, aux: TSAux = None):
        if aux is None:
            return torch.ones((batch.valid.shape[0], snap.num_nodes), dtype=torch.bool,
                              device=snap.device)
        return spread_filter_plane(aux, self.enable_min_domains)

    def score(self, batch, snap, dyn, aux: TSAux = None, mask=None):
        """Raw score; NaN marks ignored nodes (handled in normalize)."""
        if aux is None:
            return torch.zeros((batch.valid.shape[0], snap.num_nodes),
                               dtype=torch.float32, device=snap.device)
        return spread_raw_plane(aux, mask)

    def normalize(self, scores, mask):
        return spread_normalize(scores, mask)

    # --- the dedup engine's fused forms (K6, K7, K8) --------------------------

    def filter_bits(self, aux: TSAux, bits, bit: int):
        """Clear this filter's ``bit`` of the pass-bit plane where it fails (K6)."""
        return spread_filter_bits(aux, bits, bit, self.enable_min_domains)

    def score_into(self, aux: TSAux, bits, full: int, total, weight: float):
        """Add weight · floor(normalize(score)) into ``total`` (K7)."""
        return spread_score_combine(aux, bits, full, total, weight)

    def engine_copy(self, aux: TSAux) -> TSAux:
        """The aux with its own count tables, for an engine that updates
        them in place."""
        return aux._replace(hard_counts=aux.hard_counts.clone(),
                            soft_counts=aux.soft_counts.clone())

    def update_batch_classes(self, aux: TSAux, commit, choice, class_of):
        """The dedup engine's round update at class granularity (K8): ``aux``
        is the class-representative view ([C, ...] pending axis), updated in
        place with the round's commits.  The reference takes the commits'
        class one-hot ``u_c``; the plain version builds it from the same
        (commit, choice, class_of) and is equal."""
        if aux is None:
            return None
        spread_update_classes(aux, commit, choice, class_of)
        return aux

    # --- the deep pipeline (K14) ------------------------------------------------

    def chain_prev(self, aux: TSAux, batch, snap, prev):
        """Fold a still-in-flight batch's placements (``prev``, a
        runtime.PrevBatch with its device-resident node rows) into the count
        tables, as if those pods were already in the snapshot (the
        reference's chain_prev, podtopologyspread.py:306-339): this batch's
        constraint selectors against the prev pods' labels (same namespace)
        count where the prev pod's node counts.  New tables; the aux passed
        in is unchanged."""
        if aux is None:
            return None
        match = self._selector_vs_pods(batch, prev.label_keys, prev.label_vals, prev.ns,
                                       snap.numeric)
        hard, soft = spread_chain_prev(aux, match, prev.rows, prev.valid)
        return aux._replace(hard_counts=hard, soft_counts=soft)

    # --- the exact scan: one pod's row (K6, K7) and its update (K18) ------------

    def row(self, aux: TSAux, i: int) -> TSAux:
        """Pod i's row of a full-batch aux: views, so the scan's updates to
        the tables show through."""
        return aux._replace(**{f: getattr(aux, f)[i:i + 1] for f in aux._fields})

    def update(self, aux: TSAux, i: int, node_row, batch, snap):
        """Pod i placed at ``node_row`` (an i32[1] tensor on the aux's device,
        or an int; below 0: not placed) — the reference's update (:287-304),
        through K18.  The tables change in place (the engine works on an
        ``engine_copy``)."""
        if aux is None:
            return None
        spread_update_row(aux, i, node_tensor(node_row, aux.dom_val.device))
        return aux
