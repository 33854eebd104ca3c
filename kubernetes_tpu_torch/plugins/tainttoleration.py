"""TaintToleration as a batched tensor program (plain torch).

Reference: pkg/scheduler/framework/plugins/tainttoleration/taint_toleration.go
  Filter :64-82  — any untolerated NoSchedule/NoExecute taint →
                   UnschedulableAndUnresolvable
  Score  :133-162 — count of intolerable PreferNoSchedule taints (only tolerations
                   with effect "" or PreferNoSchedule participate)
  NormalizeScore :165-167 — DefaultNormalizeScore reversed
"""

from __future__ import annotations

from ..framework.events import ActionType, ClusterEvent, EventResource
from ..framework.interface import Plugin
from ..framework.podbatch import TOL_OP_EXISTS
from ..state.dictionary import MISSING
from .helpers import default_normalize

# taint effect codes (state/encoding.py EFFECT_CODE)
NO_SCHEDULE, PREFER_NO_SCHEDULE, NO_EXECUTE = 0, 1, 2


def _tolerated(batch, snap, tol_mask_extra=None):
    """bool[B, N, T]: is taint t on node n tolerated by any toleration of pod b.

    Toleration.ToleratesTaint semantics: effect filter (empty → all), key filter
    (empty key → all, valid only with Exists), Exists → true, Equal → value match.
    """
    tk = snap.taint_keys[None, :, :, None]  # [1, N, T, 1]
    tv = snap.taint_vals[None, :, :, None]
    te = snap.taint_effects[None, :, :, None]
    pk = batch.tol_key[:, None, None, :]  # [B, 1, 1, TT]
    pv = batch.tol_val[:, None, None, :]
    pe = batch.tol_effect[:, None, None, :]
    po = batch.tol_op[:, None, None, :]
    ok = batch.tol_valid[:, None, None, :]
    if tol_mask_extra is not None:
        ok = ok & tol_mask_extra[:, None, None, :]
    key_ok = (pk == MISSING) | (pk == tk)
    effect_ok = (pe == -1) | (pe == te)
    value_ok = (po == TOL_OP_EXISTS) | (pv == tv)
    return (ok & key_ok & effect_ok & value_ok).any(dim=-1)  # [B, N, T]


class TaintTolerationPlugin(Plugin):
    name = "TaintToleration"

    def events_to_register(self):
        return [ClusterEvent(EventResource.NODE, ActionType.ADD | ActionType.UPDATE_NODE_TAINT)]

    def filter(self, batch, snap, dyn, aux=None):
        hard = (snap.taint_effects == NO_SCHEDULE) | (snap.taint_effects == NO_EXECUTE)
        tolerated = _tolerated(batch, snap)  # [B, N, T]
        return (~hard[None, :, :] | tolerated).all(dim=-1)  # [B, N]

    def score(self, batch, snap, dyn, aux=None, mask=None):
        # only tolerations with effect "" or PreferNoSchedule count (:133-147)
        extra = (batch.tol_effect == -1) | (batch.tol_effect == PREFER_NO_SCHEDULE)
        tolerated = _tolerated(batch, snap, extra)
        prefer = snap.taint_effects[None, :, :] == PREFER_NO_SCHEDULE
        return (prefer & ~tolerated).sum(dim=-1).float()  # [B, N]

    def normalize(self, scores, mask):
        return default_normalize(scores, mask, reverse=True)
