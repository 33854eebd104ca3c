"""The counterfactual engine: K candidate forks, each solved by the
scheduler's own engines.

Reference: the JAX package's whatif/engine.py (``Prediction`` :45,
``_QueueShim`` :63, ``WhatIfEngine`` :74-392), itself after
cluster-autoscaler's simulator (SchedulePod against a cluster snapshot
with template nodes) and the scheduler framework's DryRunPreemption.  One
evaluator for every fork-and-resolve consumer: the descheduler's
WhatIfPlanner and the cluster autoscaler's scale-up and scale-down
simulations.

Each fork (victim-mask / node-add / node-remove, whatif/fork.py) is applied
to the live DeviceSnapshot and the scheduler's assignment semantics re-run
on it: the same engine routing (``engine_choice``: the full auction, never
the dedup engine, or the exact scan), the nominated pods' reservations
(K13's nominated bundle), the same gang all-or-nothing mask (K20), the
same tie-breaks: the lowest row, or the scheduler's ``rng_key`` noise (K33)
in every fork's solve, as the reference passes ``sched.rng_key``
(engine.py:161, :170).  The reference's jitted body
(engine.py:370-380) becomes: the fork kernels (K30, and K31 when a fork
adds nodes), ``initial_dynamic_state`` + the nominated bundle,
``fw.prepare``, ``fw.batch_assign`` or ``fw.greedy_assign``, K20.  Its
vmap over K forks (:382-388) becomes one K30 / K31 launch that builds all
K forks (``vmapped=True``) or one launch a fork (``vmapped=False``); the K
solves then run one after another in fork order (the port's auction reads
a device flag per round, so no leading K axis goes through the engines:
ROADMAP Queue B, B5's round loop).  Both give the same predictions.

Quiescence precondition (as the reference's): an in-flight pipelined
batch holds placements the fork cannot see — ``evaluate`` refuses rather
than mispredict; the controllers flush the pipeline first.  A background
sync of the pipelined scheduler is joined and its payload folded back
into the encoder's dirty rows before the engine syncs and uploads.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api import objects as v1
from ..framework.podbatch import batch_to_device
from ..framework.runtime import apply_prev_delta, initial_dynamic_state
from ..gang import gang_all_or_nothing
from ..state.encoding import NODE_ARRAYS as _NODE_ARRAYS
from ..state.node_info import NodeInfo
from ..state.units import pow2_round_up as _pow2
from .fork import (
    ForkedEncoderView,
    ForkPayload,
    ForkSpec,
    apply_fork,
    apply_forks,
    stack_payloads,
)


@dataclass
class Prediction:
    """One counterfactual solve's outcome."""

    placements: Dict[str, Optional[str]]  # pod uid → node name (None = no fit)
    pods: List[v1.Pod] = field(default_factory=list)  # solve order (= queue order)
    masked_victims: int = 0
    fork: Optional[ForkSpec] = None

    @property
    def placed(self) -> int:
        return sum(1 for n in self.placements.values() if n is not None)

    @property
    def unplaced(self) -> int:
        return sum(1 for n in self.placements.values() if n is None)


class _QueueShim:
    """Just enough QueuedPodInfo surface for the gang less-fn."""

    __slots__ = ("pod", "initial_attempt_timestamp")

    def __init__(self, pod: v1.Pod):
        self.pod = pod
        self.initial_attempt_timestamp = pod.metadata.creation_timestamp or 0.0


class WhatIfEngine:
    """Counterfactual solver bound to a live TorchScheduler (shares its
    cache, encoder, compiler and framework).  ``forks`` counts the forks
    evaluated (the reference's ``whatif_forks`` counter)."""

    def __init__(self, scheduler):
        self.sched = scheduler
        self.forks = 0

    # --- queue-order staging --------------------------------------------------

    def order_pending(self, pods: Sequence[v1.Pod]) -> List[v1.Pod]:
        """The queue's pop order (gang-cohesive priority sort) so the
        counterfactual batch matches what the real scheduler will pop."""
        less = self.sched.gangs.less
        shims = [_QueueShim(p) for p in pods]
        shims.sort(key=functools.cmp_to_key(
            lambda a, b: -1 if less(a, b) else (1 if less(b, a) else 0)))
        return [s.pod for s in shims]

    # --- the solve ------------------------------------------------------------

    def evaluate_one(self, pending: Sequence[v1.Pod],
                     fork: ForkSpec) -> Optional[Prediction]:
        out = self.evaluate(pending, [fork], vmapped=False)
        return out[0] if out else None

    def evaluate(self, pending: Sequence[v1.Pod], forks: Sequence[ForkSpec],
                 vmapped: bool = True) -> Optional[List[Prediction]]:
        """Where would ``pending`` land under each of K candidate forks?

        Returns one Prediction per fork, or None when no solve can be
        trusted (empty / oversize batch, in-flight pipelined work) —
        callers must treat that as "no plan", never as "no fit".
        ``vmapped`` is kept for the reference's signature and changes no
        prediction: both settings run the same K solves in fork order, and
        differ only in the fork kernels' launches (``True``: one K30 / K31
        launch builds all K forks; ``False``: one launch a fork)."""
        sched = self.sched
        if not pending or not forks or len(pending) > sched.batch_size:
            return None
        if sched._inflight_q:
            return None
        sched.fold_sync_ahead()
        changed = sched.cache.update_snapshot(sched.snapshot)
        sched.encoder.sync(sched.snapshot, changed)
        enc = sched.encoder
        # compile BEFORE the template encodes and the upload (the dispatch's
        # order): first-seen topology keys register at compile time
        pods = self.order_pending(pending)
        batch = sched.compiler.compile(pods, pad_to=sched.batch_size)
        payloads, views, added_names = self._build_forks(forks)
        # the framework of the first pending pod's profile, after the fork
        # build: scratch template encodes may grow the topology domain, and
        # _framework rebuilds for it (the reference's whatif/engine.py:133-134)
        fw = sched._framework(sched._profile_of(pods[0]))
        dsnap = enc.to_device()
        sched.gangs.stage_batch(pods)
        gang_seg = sched.gangs.gang_segments(pods, batch.size)
        host_auxes = [fw.host_prepare(batch, sched.snapshot, view,
                                      namespace_labels=sched.namespace_labels)
                      for view in views]
        nom_rows, nom_req = sched._nominated_arrays({p.uid for p in pods})
        mode, coupling = self._route(batch, fw)
        dev = sched.device
        dbatch = batch_to_device(batch, dev)
        nom = None
        if bool((nom_rows >= 0).any()):
            nom = (torch.from_numpy(nom_rows).to(dev),
                   torch.from_numpy(nom_req).to(dev).to(torch.int32))
        seg = torch.from_numpy(gang_seg).to(dev)
        if vmapped and len(forks) > 1:
            fsnaps = apply_forks(dsnap, stack_payloads(payloads))
        else:
            fsnaps = [apply_fork(dsnap, p) for p in payloads]
        # every solve is queued before any result is read back
        rows_dev = [self._solve(fw, mode, dbatch, fsnap, aux, coupling, nom, seg,
                                sched.rng_key)
                    for fsnap, aux in zip(fsnaps, host_auxes)]
        rows_k = [r.cpu().numpy() for r in rows_dev]
        # the forked snapshots are NEVER committed back to the encoder
        self.forks += len(forks)
        name_of = enc.row_to_name()
        out: List[Prediction] = []
        for k, (fork, payload) in enumerate(zip(forks, payloads)):
            placements: Dict[str, Optional[str]] = {}
            for pod, row in zip(pods, rows_k[k][: len(pods)]):
                r = int(row)
                name = None
                if r >= 0:
                    name = added_names[k].get(r) or name_of.get(r)
                placements[pod.uid] = name
            out.append(Prediction(
                placements=placements, pods=pods,
                masked_victims=int((payload.vic_pod_rows >= 0).sum()), fork=fork))
        return out

    @staticmethod
    def _solve(fw, mode: str, dbatch, fsnap, host_aux, coupling, nom, seg,
               key=None) -> torch.Tensor:
        """One fork's solve (the reference's jitted ``body``) under the
        scheduler's tie-noise ``key`` → i32[B] node rows on the device."""
        dyn = apply_prev_delta(initial_dynamic_state(fsnap), (), nominated=nom)
        auxes = fw.prepare(dbatch, fsnap, dyn, host_aux)
        b = dbatch.valid.shape[0]
        if mode == "batch":
            order = torch.arange(b, dtype=torch.int32, device=fsnap.device)
            res = fw.batch_assign(dbatch, fsnap, dyn, auxes, order, coupling, key=key)
        else:
            res = fw.greedy_assign(dbatch, fsnap, dyn, auxes, np.arange(b), key=key)
        return gang_all_or_nothing(res.node_row, seg)

    # --- fork payload construction -------------------------------------------

    def _build_forks(self, forks: Sequence[ForkSpec]):
        """Resolve each ForkSpec against the (just-synced) encoder into
        fixed-shape payloads, host views and per-fork added-row → name maps.

        Template nodes are encoded into SCRATCH encoder rows (growing the
        tiers and the dictionary exactly as the real scale-up will), their
        rows captured, then rolled back: the uploaded mirrors carry the
        rows invalid, and each fork's payload activates only its own adds."""
        enc = self.sched.encoder
        any_adds = any(f.add_nodes for f in forks)
        scratch: Dict[int, List[Tuple[int, str]]] = {}
        captured_vals: Dict[int, list] = {}
        captured_view: Dict[int, dict] = {}
        if any_adds:
            scratch_names: set = set()
            encode_order: List[Tuple[int, str]] = []
            try:
                for fi, f in enumerate(forks):
                    rows = []
                    for node in f.add_nodes:
                        name = node.metadata.name
                        if name in enc.node_rows and name not in scratch_names:
                            raise ValueError(
                                f"whatif node-add: node {name!r} already exists")
                        if name not in scratch_names:
                            scratch_names.add(name)
                            row = enc.encode_node(NodeInfo.of(node))
                            encode_order.append((row, name))
                        else:
                            row = enc.node_rows[name]
                        rows.append((row, name))
                    scratch[fi] = rows
            except Exception:
                # a mid-build failure (name collision, encoding capacity):
                # the scratch rows leave the live encoder, or the next cycle
                # could place real pods on phantom nodes
                for row, name in reversed(encode_order):
                    enc.remove_node(name)
                raise
            # capture AFTER all encodes: a later encode may grow the node
            # tier, reallocating the mirrors the capture reads
            for rows in scratch.values():
                for row, _name in rows:
                    if row in captured_vals:
                        continue
                    captured_vals[row] = [np.copy(getattr(enc, name)[row])
                                          for name in _NODE_ARRAYS]
                    captured_view[row] = {
                        "allocatable": np.copy(enc.allocatable[row]),
                        "requested": np.copy(enc.requested[row]),
                        "non_zero_requested": np.copy(enc.non_zero_requested[row]),
                    }
            # roll back in REVERSE encode order: the free-row list is a LIFO,
            # so an identical rebuild hands the SAME rows back to the same
            # template names and two evaluates tie-break identically
            for row, name in reversed(encode_order):
                enc.remove_node(name)

        dra = self.sched.dra
        per_fork: List[dict] = []
        for fi, f in enumerate(forks):
            vic: List[Tuple[int, int]] = []
            aff: List[Tuple[int, int]] = []
            chips: List[int] = []
            for v in f.victims:
                pr = enc.pod_rows.get(v.uid)
                nr = enc.node_rows.get(v.spec.node_name)
                if pr is None or nr is None:
                    continue  # not encoded (already gone / never bound): no-op
                vic.append((pr, nr))
                aff.extend(enc.aff.contributions(v.uid))
                chips.append(dra.pod_chips(v))
            dels = [enc.node_rows[n] for n in f.remove_nodes if n in enc.node_rows]
            per_fork.append({"vic": vic, "aff": aff, "del": dels,
                             "add": scratch.get(fi, []), "chips": chips})

        vcap = _pow2(max((len(p["vic"]) for p in per_fork), default=1), 8)
        acap = _pow2(max((len(p["aff"]) for p in per_fork), default=1), 8)
        dcap = _pow2(max((len(p["del"]) for p in per_fork), default=1), 8)
        mcap = (_pow2(max((len(p["add"]) for p in per_fork), default=1), 4)
                if any_adds else 0)
        # the claim-chip release plane only when some victim holds chips
        any_chips = any(any(p["chips"]) for p in per_fork)

        payloads: List[ForkPayload] = []
        views: List[ForkedEncoderView] = []
        added_names: List[Dict[int, str]] = []
        for p in per_fork:
            vic_p = np.full(vcap, -1, dtype=np.int32)
            vic_n = np.zeros(vcap, dtype=np.int32)
            vic_c = np.zeros(vcap, dtype=np.int32) if any_chips else None
            for i, (pr, nr) in enumerate(p["vic"]):
                vic_p[i], vic_n[i] = pr, nr
                if vic_c is not None:
                    vic_c[i] = p["chips"][i]
            aff_r = np.full(acap, -1, dtype=np.int32)
            aff_v = np.zeros(acap, dtype=np.int32)
            for i, (gr, dv) in enumerate(p["aff"]):
                aff_r[i], aff_v[i] = gr, dv
            del_r = np.full(dcap, -1, dtype=np.int32)
            for i, r in enumerate(p["del"]):
                del_r[i] = r
            add_rows = add_ok = add_vals = None
            if any_adds:
                add_rows = np.zeros(mcap, dtype=np.int32)
                add_ok = np.zeros(mcap, dtype=bool)
                for i, (row, _name) in enumerate(p["add"]):
                    add_rows[i], add_ok[i] = row, True
                # pads point at row 0 with ok = False: K31 writes nothing
                # for them
                add_vals = tuple(
                    np.stack([(captured_vals[p["add"][i][0]][ai] if i < len(p["add"])
                               else np.asarray(getattr(enc, name)[0]))
                              for i in range(mcap)])
                    for ai, name in enumerate(_NODE_ARRAYS))
            payloads.append(ForkPayload(
                vic_pod_rows=vic_p, vic_node_rows=vic_n, aff_rows=aff_r, aff_vals=aff_v,
                del_rows=del_r, add_rows=add_rows, add_ok=add_ok, add_vals=add_vals,
                vic_claim_chips=vic_c))
            views.append(ForkedEncoderView(
                enc, p["vic"], p["del"], [row for row, _ in p["add"]], captured_view,
                vic_claim_chips=p["chips"] if any_chips else None))
            added_names.append({row: name for row, name in p["add"]})
        return payloads, views, added_names

    # --- engine routing ---------------------------------------------------------

    def _route(self, batch, fw):
        """The scheduler's OWN engine-choice predicate: a fork's solve
        routes exactly like the real dispatch will — "batch" (the full
        auction) or "scan"."""
        mode, coupling, _info = self.sched.engine_choice(batch, fw=fw)
        return ("batch", coupling) if mode == "batch" else ("scan", None)
