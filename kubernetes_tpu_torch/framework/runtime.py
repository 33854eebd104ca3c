"""Batched framework runtime: plugin composition and the three assignment
engines, in torch.

Reference: the JAX package's framework/runtime.py — ``PrevBatch`` (:40-63),
``coupling_flags`` (:90), ``prepare`` (:172), ``chain_prev`` (:183-195),
``run_filters`` / ``run_scores`` / ``compute`` / ``diagnose_bits``
(:199-255), the exact serial scan ``greedy_assign`` (:327-432, with
``select_host`` :299 and ``_apply_dynamic`` :434), the full auction
``batch_assign`` (:450-745) and its identity-class dedup form
``_batch_assign_dedup`` (:747-977), the extender path's round programs
``compute_packed`` (:225), ``compute_static`` / ``compute_row`` (:259-297)
and ``apply_commits`` (:979-1020) — and the scheduler's
``reserve_nominated`` and ``apply_prev_delta`` (scheduler.py:889-916) over
K13.  All run through the kernels (kernels/): K1 filter bits + raw planes, then the live dynamic
plugins' filters folded into the bit plane (PodTopologySpread: K6,
InterPodAffinity: K10), K2 normalize + weighted total, then the dynamic
plugins' scores folded into the total (K7, K11, SelectorSpread's K32).  The auctions add K3
top-K candidates in (value desc, row asc) order, K4 the propose/resolve
auction with its scatter-add commit, and the dynamic plugins' round
updates (K8, K12); the full auction is the dedup engine at one class per
pod.  The scan runs K1, K2, K6, K7, K10 and K11 on one pod's row per step,
then K17 (select + assume) and the plugins' row updates (K18, K19).
Coscheduling's anchor-slice score, where a gang anchors, goes into the
total through K21; NodeAffinity's selector planes come from K23.  In a
batch with resource claims DynamicResources writes its bit through K24,
adds its score through K25 and takes each placed pod's chips through K26
(every auction round, every scan step).  The diagnosis and the packed
result are K22's (``pack_diag`` / ``diagnose_bits_from_plane`` are its
plain pieces).  On CPU tensors each kernel wrapper takes its plain torch
version.

Ties break by the lowest node row without a key.  With a key (the
scheduler's ``rng_key``, two uint32 words) the scan and the full auction
draw the reference's threefry tie noise through K33 (kernels/tie_noise.py,
plain version ops/prng.py): the scan splits the key into one key per step
and K17's keyed mode takes the largest noise among the tied maxima; the
full auction adds 0.5 · uniform(key, [B, N]) to the total where the mask
holds, before K3.  The dedup engine takes no key (the scheduler's gate
falls back to the full auction), as in the reference.  The extender
rounds' packed plane is K2's packed mode; ``apply_commits`` is one K13
bundle plus the dynamic plugins' class updates at identity classes.
"""

from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .interface import DynamicState, PluginWithWeight
from ..kernels.auction import auction_resolve_commit
from ..kernels.diag import MAX_FILTERS, diagnose_bits_plain, pack_diag_plain
from ..kernels.filter_score import (
    KERNEL_FILTERS,
    RAW_PLANES,
    FilterScorePlan,
    filter_score_planes,
    pod_row,
)
from ..kernels.normalize import (
    KIND_DEFAULT,
    KIND_DEFAULT_REVERSED,
    KIND_IDENTITY,
    CombinePlan,
    normalize_combine,
)
from ..kernels.prev_delta import prev_delta_apply
from ..kernels.scan import scan_select_assume
from ..kernels.tie_noise import key_rows, tie_plane, tie_row, tie_split
from ..kernels.topk import topk_rows
from ..plugins.nodeaffinity import NodeAffinityPlugin
from ..plugins.noderesources import BalancedAllocationPlugin, FitPlugin
from ..plugins.passthrough import _PassFilter
from ..plugins.trivial import image_scaled_by_id
from ..state.encoding import live_nodes

_RAW_KIND = {
    "TaintToleration": KIND_DEFAULT_REVERSED,
    "NodeAffinity": KIND_DEFAULT,
    "NodeResourcesFit": KIND_IDENTITY,
    "NodeResourcesBalancedAllocation": KIND_IDENTITY,
    "ImageLocality": KIND_IDENTITY,
}


class AssignResult(NamedTuple):
    node_row: torch.Tensor  # i32[B] assigned node row, -1 = unschedulable
    feasible_count: torch.Tensor  # i32[B] number of feasible nodes seen
    dyn: DynamicState  # final dynamic state after all assignments
    rounds: int = 0  # engine rounds executed (scan steps for greedy_assign)
    # the auctions' round-0 pass-bit plane i32[C, N] (the pre-assignment
    # state the diagnosis reads); None when no round ran, and for the scan
    diag_plane: Optional[torch.Tensor] = None
    # host wall spent in the auctions' per-round read of the loop condition
    # (seconds; it waits for the round's kernels); the scan reads nothing
    host_read_s: float = 0.0


class PrevBatch(NamedTuple):
    """The deep pipeline's carry: a still-in-flight batch's identity and its
    device-resident decisions, consumed by the next batch's cycle
    (``apply_prev_delta`` for resources, the plugins' ``chain_prev`` hooks
    for their tables) with no host round trip.  Every tensor lies on the
    device.  The four (anti)affinity term groups ride only when the
    dispatching batch has affinity content and the chain is on; with them
    InterPodAffinity chains the prev batch's own terms too.  The reference
    pads its carry slots with no-op bundles to keep XLA's shapes stable;
    the port passes only the real carries (a no-op bundle changes nothing)."""

    rows: torch.Tensor  # i32[B0] node row per prev pod (-1 = none)
    req: torch.Tensor  # i32[B0, R]
    nz: torch.Tensor  # i32[B0, 2]
    valid: torch.Tensor  # bool[B0]
    label_keys: torch.Tensor  # i32[B0, PL]
    label_vals: torch.Tensor  # i32[B0, PL]
    ns: torch.Tensor  # i32[B0]
    req_affinity: Any = None  # AffinityTermGroup | None (all four together)
    req_anti_affinity: Any = None
    pref_affinity: Any = None
    pref_anti_affinity: Any = None
    # the prev batch's term groups with a valid term (PodBatch.group_present)
    group_present: tuple = ()


def apply_prev_delta(dyn: DynamicState, prevs: Sequence[PrevBatch],
                     nominated=None) -> DynamicState:
    """The nominated pods' reservations and the in-flight batches' request
    rows added at their node rows (the reference's reserve_nominated,
    scheduler.py:889-895, then its apply_prev_delta, :897-916, for each
    bundle, oldest first) — K13 on the card, one launch for every bundle.
    ``nominated`` is (rows i32[K], req i32[K, R]) or None: it adds into
    ``requested`` only (a bundle with no ``nz`` rows).  A new state: the
    snapshot arrays ``dyn`` may alias stay untouched."""
    bundles = [(p.rows, p.req, p.nz) for p in prevs]
    if nominated is not None:
        rows, req = nominated
        bundles.insert(0, (rows, req, None))
    if not bundles:
        return dyn
    req, nz = prev_delta_apply(dyn.requested, dyn.non_zero, bundles)
    return DynamicState(requested=req, non_zero=nz)


class CouplingFlags(NamedTuple):
    """Host-computed batch coupling (see the reference's CouplingFlags):
    reads/solo/comp/multi per pod."""

    reads: torch.Tensor  # bool[B]
    solo: torch.Tensor  # bool[B]
    comp: Any = None  # i32[B] | None
    multi: Any = None  # bool[B] | None


def coupling_flags(batch, info) -> CouplingFlags:
    """CouplingFlags of a compiled (host numpy) PodBatch, as numpy arrays,
    from ``info``, the batch's ``conflict_components`` partition (the
    reference's coupling_flags, runtime.py:90)."""
    reads = np.asarray(
        batch.tsc_valid.any(axis=1)
        | batch.req_affinity.valid.any(axis=1)
        | batch.req_anti_affinity.valid.any(axis=1)
        | batch.pref_affinity.valid.any(axis=1)
        | batch.pref_anti_affinity.valid.any(axis=1), dtype=bool)
    solo = np.asarray(batch.req_anti_affinity.valid.any(axis=1), dtype=bool)
    return CouplingFlags(reads=reads, solo=solo, comp=info.comp, multi=info.multi)


def initial_dynamic_state(snap) -> DynamicState:
    return DynamicState(requested=snap.requested, non_zero=snap.non_zero_requested)


# the diagnosis (the reference's diagnose_bits, runtime.py:237) and the
# cycle's packed result (its pack_diag, scheduler.py:918) run as one kernel,
# K22 (kernels/diag.py ``diag_pack``); these are its plain pieces
diagnose_bits_from_plane = diagnose_bits_plain


def pack_diag(bits: torch.Tensor, node_row: torch.Tensor, rounds: int) -> torch.Tensor:
    """[3, B] i32: node_row; diagnosis bitmask (bit k = filter k leaves the
    pod a feasible node); engine rounds — the plain half of K22 (the
    reference's pack_diag, scheduler.py:918, for ≤ 31 filters)."""
    if bits.shape[1] > MAX_FILTERS:
        raise NotImplementedError("pack_diag: more than 31 filter plugins")
    return pack_diag_plain(bits, node_row, rounds)


class BatchedFramework:
    """Drives a fixed plugin list as tensor programs."""

    def __init__(self, plugins: Sequence[PluginWithWeight]):
        self.plugins = list(plugins)
        self.filter_plugins = [p for p in self.plugins if hasattr(p.plugin, "filter")]
        self.score_plugins = [p for p in self.plugins if hasattr(p.plugin, "score")]
        # the host binding cycle's hook lists, precomputed once (the
        # reference's runtime.py:153-156)
        self.reserve_plugins = [p for p in self.plugins if hasattr(p.plugin, "reserve")]
        self.permit_plugins = [p for p in self.plugins if hasattr(p.plugin, "permit")]
        self.pre_bind_plugins = [p for p in self.plugins if hasattr(p.plugin, "pre_bind")]
        self.post_bind_plugins = [p for p in self.plugins if hasattr(p.plugin, "post_bind")]
        self._plans: Dict[frozenset, tuple] = {}

    @property
    def filter_names(self):
        """Names of plugins with a Filter, in plugin order (Diagnosis keys)."""
        return [pw.plugin.name for pw in self.plugins if hasattr(pw.plugin, "filter")]

    # --- host-side precompute -------------------------------------------------

    def host_prepare(self, batch, snapshot, encoder, namespace_labels=None) -> Dict[str, Any]:
        """Each plugin's host half by plugin name (the reference's
        host_prepare, runtime.py:160): InterPodAffinity's existing-pod match
        matrix."""
        out: Dict[str, Any] = {}
        for pw in self.plugins:
            fn = getattr(pw.plugin, "host_prepare", None)
            if fn is not None:
                out[pw.plugin.name] = fn(batch, snapshot, encoder,
                                         namespace_labels=namespace_labels)
        return out

    # --- device-side prepare ---------------------------------------------------

    def prepare(self, batch, snap, dyn, host_auxes: Optional[Dict[str, Any]] = None):
        """One aux per plugin, in plugin order (the reference's prepare,
        runtime.py:172); None for plugins without a prepare or with nothing
        to carry for this batch.  ``host_auxes`` maps plugin names to their
        host halves."""
        host_auxes = host_auxes or {}
        auxes = []
        for pw in self.plugins:
            fn = getattr(pw.plugin, "prepare", None)
            auxes.append(None if fn is None else
                         fn(batch, snap, dyn, host_auxes.get(pw.plugin.name)))
        return tuple(auxes)

    def chain_prev(self, batch, snap, auxes, prev: PrevBatch):
        """Fold a still-in-flight batch's placements into this batch's plugin
        auxes (the reference's chain_prev, runtime.py:183-195): each
        plugin's ``chain_prev`` hook on its live aux."""
        out = []
        for pw, aux in zip(self.plugins, auxes):
            fn = getattr(pw.plugin, "chain_prev", None)
            out.append(aux if fn is None or aux is None else fn(aux, batch, snap, prev))
        return tuple(out)

    def _live(self, auxes):
        """[(PluginWithWeight, aux)] of the dynamic plugins whose aux is live
        (not None) — their planes fold into the kernels' outputs."""
        if auxes is None:
            return []
        return [(pw, aux) for pw, aux in zip(self.plugins, auxes) if aux is not None]

    # --- plugin compositions, through the kernels ----------------------------

    def static_inputs(self, rows, snap, dyn):
        """K1's per-cycle inputs for ``rows`` (a PodBatch): NodeAffinity's
        filter and preferred-weight planes (selector matching through K23)
        and ImageLocality's per-id spread-scaled sizes."""
        na = NodeAffinityPlugin()
        return (na.filter(rows, snap, dyn), na.score(rows, snap, dyn),
                image_scaled_by_id(snap))

    def _fold_filters(self, live, bits, fs_plan):
        """Each live dynamic filter writes its bit of the pass-bit plane.
        Every filter folds before any score: a score normalizes over the
        final mask (InterPodAffinity's min and max read the spread bit)."""
        for pw, aux in live:
            bit = fs_plan.dynamic_bits.get(pw.plugin.name)
            if bit is not None:
                pw.plugin.filter_bits(aux, bits, bit)
        return bits

    def _fold_scores(self, live, bits, full, total):
        """Each live dynamic score adds weight · floor(normalize) into the
        total.  Every term of the total is an integer-valued float32 below
        2^24, so the order in which the planes are added does not change
        the sum (the reference adds the dynamic planes last)."""
        for pw, aux in live:
            if hasattr(pw.plugin, "score_into"):
                pw.plugin.score_into(aux, bits, full, total, float(pw.weight))
        return total

    def planes(self, rows, snap, dyn, auxes=None):
        """K1 over every row of ``rows`` with the live dynamic filters folded
        in: (pass bits i32[B, N], raw f32[5, B, N])."""
        live = self._live(auxes)
        fs_plan, _ = self.kernel_plans(self._live_names(live))
        bits, raw = filter_score_planes(rows, snap, dyn, *self.static_inputs(rows, snap, dyn),
                                        fs_plan)
        return self._fold_filters(live, bits, fs_plan), raw

    def _full(self) -> int:
        return (1 << len(self.filter_names)) - 1

    @staticmethod
    def _live_names(live) -> frozenset:
        return frozenset(pw.plugin.name for pw, _ in live)

    def run_filters(self, batch, snap, dyn, auxes=None):
        """bool[B, N]: every filter passes on a live node (the reference's
        run_filters, runtime.py:199)."""
        bits, _ = self.planes(batch, snap, dyn, auxes)
        return bits == self._full()

    def run_scores(self, batch, snap, dyn, auxes, mask):
        """Σ weight · floor(normalize(raw)) over ``mask``, −inf off it (the
        reference's run_scores, runtime.py:206; runtime/framework.go:874-946)."""
        live = self._live(auxes)
        _, raw = self.planes(batch, snap, dyn, auxes)
        full = self._full()
        bits = torch.where(mask, full, 0).to(torch.int32)
        total = normalize_combine(bits, full, raw,
                                  self.kernel_plans(self._live_names(live))[1])[0]
        return self._fold_scores(live, bits, full, total)

    def compute(self, batch, snap, dyn, auxes=None):
        live = self._live(auxes)
        bits, raw = self.planes(batch, snap, dyn, auxes)
        full = self._full()
        total, _ = normalize_combine(bits, full, raw,
                                     self.kernel_plans(self._live_names(live))[1])
        return bits == full, self._fold_scores(live, bits, full, total)

    def diagnose_bits(self, batch, snap, dyn, auxes=None):
        """bool[B, K]: does filter plugin k leave pod b ANY feasible node."""
        bits, _ = self.planes(batch, snap, dyn, auxes)
        return diagnose_bits_from_plane(bits, len(self.filter_names))

    # --- the extender path's round programs ------------------------------------

    def compute_packed(self, batch, snap, dyn, auxes=None):
        """compute() as one f32[B, N], −inf where a node is infeasible (the
        reference's compute_packed, runtime.py:225): K1, the live dynamic
        filters, K2's packed mode (the plane alone, −inf where the bits
        miss ``full``), the live dynamic scores.  The extender walk fetches
        this one plane per round."""
        live = self._live(auxes)
        bits, raw = self.planes(batch, snap, dyn, auxes)
        full = self._full()
        total = normalize_combine(bits, full, raw,
                                  self.kernel_plans(self._live_names(live))[1], packed=True)
        return self._fold_scores(live, bits, full, total)

    def compute_static(self, batch, snap, dyn, auxes=None):
        """(static_mask bool[B, N], static_raw): the dynamic-state-free
        feasibility mask and the raw score planes of the non-dynamic scoring
        plugins, in plugin order (the reference's compute_static,
        runtime.py:259).  The mask is K1's bits of the non-dynamic filters
        on live nodes of valid rows; the raw planes are K1's
        (TaintToleration, NodeAffinity, ImageLocality) or, for a plugin K1
        does not score (Coscheduling), the plugin's own."""
        fs_plan, _ = self.kernel_plans(frozenset())
        bits, raw = filter_score_planes(batch, snap, dyn,
                                        *self.static_inputs(batch, snap, dyn), fs_plan)
        sbits = 0
        for k, pw in enumerate(self.filter_plugins):
            if not pw.plugin.dynamic:
                sbits |= 1 << k
        static_mask = (live_nodes(snap)[None, :] & batch.valid[:, None]
                       & ((bits & sbits) == sbits))
        static_raw = []
        for pw, aux in zip(self.plugins, auxes if auxes is not None
                           else [None] * len(self.plugins)):
            p = pw.plugin
            if not hasattr(p, "score") or p.dynamic:
                continue
            if p.name in RAW_PLANES:
                static_raw.append(raw[RAW_PLANES.index(p.name)])
            else:
                static_raw.append(p.score(batch, snap, dyn, aux))
        return static_mask, tuple(static_raw)

    def compute_row(self, batch, snap, dyn, auxes, static_mask, static_raw, i: int):
        """Pod i's feasibility row bool[N] and weighted total f32[N] (−inf
        off the row) against the current dynamic state (the reference's
        compute_row, runtime.py:274) — the scan's step row: K1 over the
        pod's one row (its static half equals ``static_mask[i]`` /
        ``static_raw``'s rows, recomputed in the same launch), the live
        dynamic plugins' row filters and scores, K2.  ``static_mask[i]`` is
        folded in, so a narrower caller mask narrows the row."""
        live = [(pw, pw.plugin.row(aux, i)) for pw, aux in self._live(auxes)]
        fs_plan, comb_plan = self.kernel_plans(self._live_names(live))
        full = self._full()
        bits, total = self._step_row(batch, i, snap, dyn, live, fs_plan, comb_plan, full,
                                     self.static_inputs(batch, snap, dyn))
        row_mask = (bits[0] == full) & static_mask[i]
        return row_mask, torch.where(row_mask, total[0], float("-inf"))

    def apply_commits(self, batch, snap, dyn, auxes, commit, choice):
        """One round's simultaneous placements (commit bool[B], choice
        i32[B]) added to the dynamic state and to every live dynamic
        plugin's aux (the reference's apply_commits, runtime.py:979) → new
        (dyn, auxes); the inputs are not modified.

        The resources are one K13 bundle: the rows ``where(commit, choice,
        −1)`` with the request and non-zero rows passed through float32, as
        the reference's one-hot einsum rounds them (a request above 2^24
        units rounds the same way; the extender walk commits at most one pod
        a node, so every einsum sum there has one term).  Each live dynamic
        plugin takes the commits through its ``update_batch_classes`` at
        identity classes (K8, K12, K26) — the reference's update_batch at
        pod granularity — on an engine copy of its aux; a plugin with only a
        per-pod ``update`` runs it for each committed pod in row order (the
        reference's fori_loop fallback, :1006-1019)."""
        dev = dyn.requested.device
        b = batch.valid.shape[0]
        commit = torch.as_tensor(commit).to(device=dev, dtype=torch.bool)
        choice = torch.as_tensor(choice).to(device=dev, dtype=torch.int32)
        rows = torch.where(commit, choice, -1).to(torch.int32)
        req, nz = prev_delta_apply(
            dyn.requested, dyn.non_zero,
            [(rows, batch.request.to(torch.float32).to(torch.int32),
              batch.non_zero.to(torch.float32).to(torch.int32))])
        new_dyn = DynamicState(requested=req, non_zero=nz)
        out = list(auxes) if auxes is not None else [None] * len(self.plugins)
        ident = None
        for k, pw in enumerate(self.plugins):
            p, aux = pw.plugin, out[k]
            if not p.dynamic or aux is None:
                continue
            if getattr(p, "update_batch_classes", None) is not None:
                if ident is None:
                    ident = torch.arange(b, device=dev)
                aux = p.engine_copy(aux)
                p.update_batch_classes(aux, commit, choice, ident)
                out[k] = aux
            elif getattr(p, "update", None) is not None:
                aux = p.engine_copy(aux)
                for i in torch.nonzero(commit).flatten().tolist():
                    p.update(aux, i, choice[i:i + 1], batch, snap)
                out[k] = aux
        return new_dyn, tuple(out)

    # --- the dedup engine's kernel plans -------------------------------------

    def kernel_plans(self, live: frozenset = frozenset()):
        """(FilterScorePlan, CombinePlan) for this plugin list, given the
        names of the dynamic plugins whose aux is live.  The kernels
        evaluate any subset of the default plugins, at any weights: a kernel
        filter the profile does not run has no bit (K1 sets nothing for
        it), and a raw plane whose plugin the profile does not score with
        takes weight 0 in K2's plan (its plane is finite, so it adds 0).  A
        pass-through half (the volume filters) contributes its filter as a
        bit K1 sets.  A live dynamic plugin (PodTopologySpread,
        InterPodAffinity, DynamicResources, SelectorSpread) has its bit
        seeded by K1 as passing — its filter with no aux — and written by
        its own kernel (K6, K10, K24), and its score added by its kernel
        (K7, K11, K25, K32); with no aux its score is the constant of its
        normalized all-zero plane (200 for PodTopologySpread, 0 for
        InterPodAffinity and DynamicResources), folded into ``const_add``.
        Coscheduling likewise: live (K21) when a row of the batch anchors a
        gang, else the constant 0 of its all-False plane.  A plugin with no
        kernel path raises, naming its ROADMAP item."""
        if live in self._plans:
            return self._plans[live]
        names = self.filter_names
        if len(names) > 31:
            raise NotImplementedError(
                f"{len(names)} filter plugins: the pass-bit plane holds 31")
        bit_of, dynamic_bits, pass_bits = {}, {}, 0
        for k, pw in enumerate(self.filter_plugins):
            p = pw.plugin
            if p.name in KERNEL_FILTERS:
                bit_of[p.name] = k
            elif isinstance(p, _PassFilter):
                pass_bits |= 1 << k
            elif hasattr(p, "filter_bits"):
                pass_bits |= 1 << k
                dynamic_bits[p.name] = k
            else:
                raise NotImplementedError(
                    f"filter plugin {p.name} has no kernel path in the dedup "
                    "engine yet (ROADMAP Queue B)")
        fit = balanced = None
        weights = {n: 0.0 for n in RAW_PLANES}
        const_add = 0.0
        for pw in self.score_plugins:
            p = pw.plugin
            if p.name in _RAW_KIND:
                weights[p.name] = float(pw.weight)
                if isinstance(p, FitPlugin):
                    fit = p
                elif isinstance(p, BalancedAllocationPlugin):
                    balanced = p
            elif hasattr(p, "score_into") and p.name not in live:
                one = torch.ones((1, 1), dtype=torch.bool)
                zero = torch.zeros((1, 1), dtype=torch.float32)
                const_add += float(pw.weight) * float(
                    torch.floor(p.normalize(zero, one))[0, 0])
            elif not hasattr(p, "score_into"):
                raise NotImplementedError(
                    f"score plugin {p.name} has no kernel path in the dedup "
                    "engine yet (ROADMAP Queue B)")
        self._plans[live] = (
            FilterScorePlan(fit=fit, balanced=balanced, bit_of=bit_of,
                            pass_bits=pass_bits, dynamic_bits=dynamic_bits),
            CombinePlan(kinds=tuple(_RAW_KIND[n] for n in RAW_PLANES),
                        weights=tuple(weights[n] for n in RAW_PLANES),
                        const_add=const_add),
        )
        return self._plans[live]

    # --- the exact serial scan (B9) ---------------------------------------------

    @staticmethod
    def select_host(row_scores, row_mask, key=None):
        """The argmax with tie handling (the reference's select_host,
        runtime.py:299): the first maximum without a key; with a key the
        argmax of where(masked == max, noise, −1) — a uniform draw among the
        tied maxima (noise: uniform(key, [N]), K33), the first row on equal
        noise; an all-−inf row is all ties."""
        masked = torch.where(row_mask, row_scores, float("-inf"))
        if key is None:
            return torch.argmax(masked)
        noise = tie_row(key_rows(key, masked.device), 0, masked.shape[0])
        return torch.argmax(torch.where(masked == masked.max(), noise, -1.0))

    def _step_row(self, batch, i: int, snap, dyn, rows, fs_plan, comb_plan, full, static):
        """Pod i's row against ``dyn``: K1 over its one row, the live
        dynamic plugins' row filters (``rows``: their row auxes), K2, their
        row scores → (bits i32[1, N], total f32[1, N])."""
        na_mask, na_pref, img_scaled = static
        bits, raw = filter_score_planes(pod_row(batch, i), snap, dyn, na_mask[i:i + 1],
                                        na_pref[i:i + 1], img_scaled, fs_plan)
        self._fold_filters(rows, bits, fs_plan)
        total, _ = normalize_combine(bits, full, raw, comb_plan)
        self._fold_scores(rows, bits, full, total)
        return bits, total

    def greedy_assign(self, batch, snap, dyn, auxes, order, key=None) -> AssignResult:
        """Schedule the batch pod by pod in ``order`` with exact
        greedy-sequential semantics (the reference's greedy_assign,
        runtime.py:327-432), bit for bit, with or without tie noise.

        Each step computes pod i's row against the carried state: K1 over
        the pod's single row (the static filters and scores as in the
        reference's precompute — they do not read the dynamic state — and
        Fit / BalancedAllocation as its filter_row / score_row), the live
        dynamic plugins' filter and score on their aux row (K6 / K10, K7 /
        K11), K2's normalized weighted total; then K17 selects the node
        (``select_host``: the first maximum, the nominated row when it is
        feasible; with ``key`` K17's keyed mode under the step's key
        ``split(key, B)[k]`` at scan position k, the keys K33's split made
        once a batch, the noise drawn inside K17) and assumes the
        pod's request into ``dyn``, writing
        ``node_row[i]`` on the device, and ``_apply_dynamic`` runs each live
        plugin's ``update`` (K18, K19), which reads that node there.  The
        host knows the trip count — the positions of ``order`` up to the
        last valid pod, from one read of ``batch.valid`` before the first
        step — so the steps queue back to back with no device→host read
        between the first and the last.  ``order`` is a host sequence of
        pod rows.  The inputs are not modified: the scan works on copies
        of ``dyn`` and of the live auxes' mutable state."""
        order = np.asarray(order, dtype=np.int64)
        valid = np.asarray(batch.valid.cpu(), dtype=bool)
        hits = np.nonzero(valid[order])[0]
        n_valid = int(hits[-1]) + 1 if hits.size else 0
        dev = snap.device
        b = batch.valid.shape[0]
        live = self._live(auxes)
        fs_plan, comb_plan = self.kernel_plans(self._live_names(live))
        full = self._full()
        static = self.static_inputs(batch, snap, dyn)
        live = [(pw, pw.plugin.engine_copy(aux)) for pw, aux in live]
        dyn = DynamicState(requested=dyn.requested.clone(), non_zero=dyn.non_zero.clone())
        node_row = torch.full((b,), -1, dtype=torch.int32, device=dev)
        feasible_count = torch.zeros((b,), dtype=torch.int32, device=dev)
        keys = tie_split(key, b, dev) if key is not None and n_valid else None
        for k in range(n_valid):
            i = int(order[k])
            rows = [(pw, pw.plugin.row(aux, i)) for pw, aux in live]
            bits, total = self._step_row(batch, i, snap, dyn, rows, fs_plan, comb_plan,
                                         full, static)
            scan_select_assume(bits, full, total, i, batch.nominated_row, batch.valid,
                               batch.request, batch.non_zero, dyn.requested, dyn.non_zero,
                               node_row, feasible_count, keys, k)
            self._apply_dynamic(live, i, node_row[i:i + 1], batch, snap)
        return AssignResult(node_row=node_row, feasible_count=feasible_count, dyn=dyn,
                            rounds=n_valid)

    @staticmethod
    def _apply_dynamic(live, i: int, node_at, batch, snap) -> None:
        """The plugins' half of the scan's assume (the reference's
        _apply_dynamic, runtime.py:434-448; K17 did the resources): each
        live dynamic plugin's ``update`` with pod i at ``node_at`` (i32[1]
        on the device; below 0: not placed), in place."""
        for pw, aux in live:
            fn = getattr(pw.plugin, "update", None)
            if fn is not None:
                fn(aux, i, node_at, batch, snap)

    # --- the full auction (B8) and its identity-class dedup form -----------------

    def batch_assign(self, batch, snap, dyn, auxes, order, coupling: CouplingFlags,
                     key=None, classes=None) -> AssignResult:
        """Whole-batch parallel assignment (the reference's batch_assign,
        runtime.py:450-745), bit for bit.  ``classes`` selects the
        identity-class dedup path (``_batch_assign_dedup``) when there is
        no ``key``, as in the reference (the per-pod noise cannot ride
        class-shared planes); without it
        the full path runs the dedup engine at one class per pod — the
        reference's update_batch is update_batch_classes at pod
        granularity (podtopologyspread.py:341-347), its per-pod planes are
        the class planes at identity classes, and its full argmax over
        unused nodes is the dedup engine's top-min(B, N) candidate walk
        (runtime.py:761-770) — over the full-batch ``auxes``.  The full
        path adds each round's commits to the dynamic state through a
        float32 one-hot contraction; a request above 2^24 units rounds
        there, and so it does here.  With ``key`` each round adds K33's
        noise plane, 0.5 · uniform(key, [B, N]) where the mask holds, to
        the total before K3 — the reference's ``eff`` (:588-589) — so K3's
        (value desc, row asc) order is its first argmax over ``eff``; N is
        the snapshot's padded node capacity, as there."""
        if classes is not None and key is None:
            return self._batch_assign_dedup(batch, snap, dyn, auxes, order, coupling,
                                            classes)
        ident = torch.arange(batch.valid.shape[0], device=snap.device)
        return self._auction(batch, snap, dyn, order, coupling, ident, batch, auxes,
                             batch.request.to(torch.float32).to(torch.int32),
                             batch.non_zero.to(torch.float32).to(torch.int32), key=key)

    def _batch_assign_dedup(self, batch, snap, dyn, auxes, order,
                            coupling: CouplingFlags, classes) -> AssignResult:
        """batch_assign with identity-class-deduplicated dense planes (the
        reference's _batch_assign_dedup, bit for bit).

        ``classes = (class_of i32[B], rep_batch PodBatch[C], rep_auxes)``:
        pods of one class have byte-identical compiled rows, so each round
        computes the planes once per class ([C, N]) and every pod proposes
        from its class's top-K candidate list (K = min(B, N)).  A live
        dynamic plugin's rep aux (PodTopologySpread's class count tables,
        InterPodAffinity's count state and block / score planes) folds its
        filter bit (K6, K10) and score (K7, K11) into each round's planes
        and takes the round's commits through its ``update_batch_classes``
        hook (K8, K12) — the full path's per-pod tables stay class-uniform, so
        the class rows reproduce them exactly."""
        class_of, rep_batch, rep_auxes = classes
        return self._auction(batch, snap, dyn, order, coupling, class_of, rep_batch,
                             rep_auxes, batch.request, batch.non_zero)

    def _auction(self, batch, snap, dyn, order, coupling: CouplingFlags, class_of,
                 rep_batch, rep_auxes, commit_request, commit_nz, key=None) -> AssignResult:
        """The auction rounds over class rows ``rep_batch`` (pod b's row is
        ``class_of[b]``) with the live rep auxes; K4 adds each winner's
        ``commit_request`` / ``commit_nz`` row at its node.  A coupled
        component commits only its head pod each round (``coupling``).

        The round loop is a Python loop.  Its condition
        (any pod active, rounds ≤ B) is read on the host once per round —
        one device→host sync per round; a device-side loop (or a CUDA
        graph) is queued in ROADMAP Queue B (B5).
        """
        live = self._live(rep_auxes)
        fs_plan, comb_plan = self.kernel_plans(self._live_names(live))
        full = self._full()
        dev = snap.device
        b = batch.valid.shape[0]
        n_cap = snap.num_nodes
        kcand = min(b, n_cap)
        class_of = class_of.to(device=dev, dtype=torch.long)
        reads = torch.as_tensor(coupling.reads).to(dev)
        solo = torch.as_tensor(coupling.solo).to(dev)
        if coupling.comp is None:
            comp = torch.zeros(b, dtype=torch.long, device=dev)
            multi = torch.ones(b, dtype=torch.bool, device=dev)
        else:
            comp = torch.as_tensor(coupling.comp).to(device=dev, dtype=torch.long)
            multi = torch.as_tensor(coupling.multi).to(dev)
        reader = reads & multi
        order = torch.as_tensor(order).to(device=dev, dtype=torch.long)
        arange_b = torch.arange(b, device=dev)

        na_mask, na_pref, img_scaled = self.static_inputs(rep_batch, snap, dyn)
        # the engine's working copies of the class tables (updated in place)
        live = [(pw, pw.plugin.engine_copy(aux)) for pw, aux in live]

        pos_of = torch.zeros(b, dtype=torch.long, device=dev).index_copy(
            0, order, arange_b)
        nom = batch.nominated_row.long().clamp(0, n_cap - 1)
        nom_set = batch.nominated_row >= 0
        # K4 reads its index inputs as int32: converted once, not every round
        class_i32, pos_i32, nom_i32 = (t.to(torch.int32) for t in (class_of, pos_of, nom))
        # the engine's working copies of the dynamic state (updated in place)
        dyn = DynamicState(requested=dyn.requested.clone(),
                           non_zero=dyn.non_zero.clone())

        assigned = torch.full((b,), -1, dtype=torch.int32, device=dev)
        active = batch.valid.clone()
        feas_n = torch.zeros(b, dtype=torch.int32, device=dev)
        comp_oh = comp[:, None] == arange_b[None, :]  # [B, C]
        rounds = 0
        diag_plane = None
        host_read_s = 0.0
        while True:
            # host read of the loop condition: one sync per round
            t_read = time.perf_counter()
            go = rounds <= b and bool(active.any())
            host_read_s += time.perf_counter() - t_read
            if not go:
                break
            bits, raw = filter_score_planes(rep_batch, snap, dyn, na_mask,
                                            na_pref, img_scaled, fs_plan)
            self._fold_filters(live, bits, fs_plan)
            if diag_plane is None:
                diag_plane = bits
            total, feas_cnt = normalize_combine(bits, full, raw, comb_plan)
            self._fold_scores(live, bits, full, total)
            if key is not None:  # the full auction only (one row per pod)
                tie_plane(key, bits, full, total)
            mask_r = bits == full
            feasible = (feas_cnt > 0)[class_of]
            cand_val, cand_idx = topk_rows(total, kcand)
            nom_ok = nom_set & mask_r[class_of, nom]

            # component heads — identical rules to the reference
            act_pos = torch.where(active & multi, pos_of, b)
            minpos_c = torch.where(comp_oh, act_pos[:, None], b).amin(dim=0)
            is_head = active & multi & (pos_of == minpos_c[comp])
            head_reader = is_head & reader
            head_unsched = head_reader & ~feasible
            closed_c = (comp_oh & (head_reader & feasible & solo)[:, None]).any(dim=0)
            comp_closed = multi & closed_c[comp] & ~is_head
            unresolved0 = active & feasible & (~reader | is_head) & ~comp_closed

            commit, choice = auction_resolve_commit(
                cand_val, cand_idx, class_i32, pos_i32, unresolved0, nom_i32, nom_ok,
                commit_request, commit_nz, dyn.requested, dyn.non_zero)
            for pw, aux in live:
                fn = getattr(pw.plugin, "update_batch_classes", None)
                if fn is not None:  # Coscheduling's anchors do not change
                    fn(aux, commit, choice, class_of)
            new_unsched = (active & ~reader & ~feasible) | head_unsched
            resolved = commit | new_unsched
            feas_n = torch.where(resolved & active, feas_cnt[class_of], feas_n)
            assigned = torch.where(commit, choice, assigned)
            active = active & ~resolved
            rounds += 1
        return AssignResult(node_row=assigned, feasible_count=feas_n, dyn=dyn,
                            rounds=rounds, diag_plane=diag_plane,
                            host_read_s=host_read_s)
