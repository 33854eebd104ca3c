"""Preemption (DefaultPreemption's PostFilter): the Evaluator.

Reference: the JAX package's preemption.py (``Candidate``, ``PlainTables``,
``pods_with_pdb_violation``, ``more_important``, the ``Evaluator`` :101 with
``plain_tables`` :120, ``preempt_plain`` :238, ``select_victims_on_node``
:321, ``select_victims_vectorized`` :420, ``pick_one_node`` :558,
``preempt`` :589), itself after pkg/scheduler/framework/preemption/
preemption.go (Evaluator.Preempt :138, findCandidates :198,
DryRunPreemption :546, SelectCandidate :301, pickOneNodeForPreemption
:397) and defaultpreemption/default_preemption.go (SelectVictimsOnNode
:139, candidate count = max(10%·n, 100) :110-127).

The split of labor is the reference's: the dry-run fit check over every
candidate node at once runs on the device (whatif/dryrun.py
``candidate_mask_device``: K27 + K28, or K29), and the exact victim
minimization + 6-criteria ranking run on the host over the surviving
candidates — for plain preemptors through the shared per-snapshot tables
and the reprieve sweep (``sweep_and_rank``: the C++ pass with
``native=True``, else its numpy version), for the others through the
oracle's reference-exact filters, node by node.

Extenders are not ported (ROADMAP Queue A item 6b): ``preempt`` refuses a
non-empty extender list.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .api import objects as v1
from .api.labels import match_label_selector
from .api.resource import compute_pod_resource_request
from .oracle import (
    Oracle,
    fits_resources,
    node_affinity_fits,
    node_name_fits,
    node_schedulable,
    tolerates_all_hard_taints,
)
from .state.cache import Snapshot
from .state.node_info import NodeInfo
from .state.node_info import _pod_host_ports as _node_info_host_ports
from .whatif.dryrun import sweep_and_rank as _sweep_and_rank


@dataclass
class Candidate:
    node_name: str
    victims: List[v1.Pod]
    num_pdb_violations: int


@dataclass
class PlainTables:
    """Per-snapshot victim tables for PLAIN preemptors at one priority
    threshold — the preemptor-independent 80% of select_victims_vectorized
    (potential-victim enumeration, ordering, resource vectors), built ONCE
    per (snapshot generation, priority, PDB state) and shared by every
    preemptor in a burst.  At 5k nodes the per-preemptor rebuild was ~35ms
    × a 256-pod batch ≈ 9s/cycle — the dominant PreemptionBasic cost."""

    names: List[str]
    index: Dict[str, int]
    infos: List[NodeInfo]
    victims: List[List[v1.Pod]]       # violating-first, importance-descending
    base: np.ndarray                   # [C,4] used minus all potential victims
    alloc: np.ndarray                  # [C,4]
    vr_mat: np.ndarray                 # [C,Vmax,4]
    v_valid: np.ndarray                # [C,Vmax] bool
    v_viol: np.ndarray                 # [C,Vmax] bool  (PDB-violating victim)
    v_prio: np.ndarray                 # [C,Vmax] int64
    v_ts: np.ndarray                   # [C,Vmax] float64 creation timestamps


def pods_with_pdb_violation(
    victims: Sequence[v1.Pod], pdbs: Sequence[v1.PodDisruptionBudget]
) -> Tuple[List[v1.Pod], List[v1.Pod]]:
    """filterPodsWithPDBViolation: a victim violates when any matching PDB has
    no disruption budget left."""
    violating, ok = [], []
    for pod in victims:
        bad = False
        for pdb in pdbs:
            if pdb.metadata.namespace != pod.namespace:
                continue
            if not match_label_selector(pdb.selector, pod.metadata.labels):
                continue
            if pdb.disruptions_allowed <= 0:
                bad = True
                break
        (violating if bad else ok).append(pod)
    return violating, ok


def more_important(a: v1.Pod, b: v1.Pod) -> bool:
    """util.MoreImportantPod: higher priority, then earlier start."""
    if a.spec.priority != b.spec.priority:
        return a.spec.priority > b.spec.priority
    return (a.metadata.creation_timestamp or 0) < (b.metadata.creation_timestamp or 0)


class Evaluator:
    """``native`` runs the reprieve sweep through the C++ pass (the
    scheduler sets it on the card; the plain numpy pass otherwise)."""

    def __init__(self, oracle: Optional[Oracle] = None, native: bool = False):
        self.oracle = oracle or Oracle()
        self.native = native
        # rotating start offset into the candidate list (the reference draws
        # rand.Intn(len(potentialNodes)) per attempt, preemption.go
        # findCandidates/GetOffsetAndNumCandidates): without it every
        # preemptor in a burst dry-runs the SAME first-cap nodes, later ones
        # find them all claimed by earlier nominations, return no candidate,
        # and burn a full retry cycle
        self._offset = 0
        # (snapshot id, snapshot generation, priority, pdb fingerprint) →
        # PlainTables; one entry per threshold survives a whole batch
        self._tables: Dict[tuple, PlainTables] = {}
        # (priority, pdb fingerprint) → node name → cached per-node row,
        # keyed by NodeInfo.generation: across cycles only nodes whose pods
        # changed (evictions, binds) rebuild their victim row — the full
        # rebuild was ~0.9s/cycle at 5k nodes / 25k pods
        self._rows: Dict[tuple, Dict[str, tuple]] = {}

    def plain_tables(
        self,
        snapshot: Snapshot,
        priority: int,
        pdbs: Sequence[v1.PodDisruptionBudget] = (),
    ) -> PlainTables:
        """Build (or fetch) the preemptor-independent victim tables for every
        node holding at least one pod below ``priority``.  Static node
        predicates are NOT applied here — they depend on the preemptor and
        are verified on the ranked winner only (see preempt_plain)."""
        pdb_fp = tuple(
            (p.metadata.namespace, p.metadata.name, p.disruptions_allowed)
            for p in pdbs
        )
        key = (id(snapshot), snapshot.generation, priority, pdb_fp)
        hit = self._tables.get(key)
        if hit is not None:
            return hit
        # evict only STALE generations: a batch mixing preemptor priorities
        # keeps one live entry per threshold (a full clear would rebuild the
        # tables once per pod, not once per threshold)
        for k in [k for k in self._tables if k[:2] != key[:2]]:
            del self._tables[k]
        if len(self._rows) > 8:  # many distinct thresholds: drop stale keys
            self._rows.clear()
        rows = self._rows.setdefault((priority, pdb_fp), {})

        names: List[str] = []
        infos: List[NodeInfo] = []
        victim_lists: List[List[v1.Pod]] = []
        row_data: List[tuple] = []
        seen = set()
        for info in snapshot.node_info_list:
            name = info.node_name
            seen.add(name)
            cached = rows.get(name)
            if cached is not None and cached[0] == info.generation:
                if cached[1] is None:  # no potential victims on this node
                    continue
                _, victims, vr, viol, prio, ts, base_u, alloc_u = cached
            else:
                potential = [
                    pi.pod for pi in info.pods
                    if pi.pod.spec.priority < priority
                ]
                if not potential:
                    rows[name] = (info.generation, None)
                    continue
                used = info.requested
                u = np.array(
                    [used.milli_cpu, used.memory, used.ephemeral_storage,
                     len(info.pods)], dtype=np.int64,
                )
                potential.sort(
                    key=lambda p: (-p.spec.priority,
                                   p.metadata.creation_timestamp or 0)
                )
                violating, non_violating = pods_with_pdb_violation(
                    potential, pdbs)
                victims = violating + non_violating
                nv = len(victims)
                vr = np.zeros((nv, 4), dtype=np.int64)
                prio = np.zeros(nv, dtype=np.int64)
                ts = np.zeros(nv, dtype=np.float64)
                for vi, victim in enumerate(victims):
                    r = compute_pod_resource_request(victim)
                    vr[vi] = (r.milli_cpu, r.memory, r.ephemeral_storage, 1)
                    prio[vi] = victim.spec.priority or 0
                    ts[vi] = victim.metadata.creation_timestamp or 0
                viol = np.zeros(nv, dtype=bool)
                viol[:len(violating)] = True
                base_u = u - vr.sum(axis=0)
                al = info.allocatable
                alloc_u = np.array(
                    [al.milli_cpu, al.memory, al.ephemeral_storage,
                     al.allowed_pod_number], dtype=np.int64,
                )
                rows[name] = (info.generation, victims, vr, viol, prio, ts,
                              base_u, alloc_u)
            names.append(name)
            infos.append(info)
            victim_lists.append(victims)
            row_data.append((vr, viol, prio, ts, base_u, alloc_u))
        if len(rows) > len(seen):  # nodes deleted since last cycle
            for name in list(rows):
                if name not in seen:
                    del rows[name]

        c = len(names)
        vmax = max((r[0].shape[0] for r in row_data), default=0)
        vr_mat = np.zeros((c, vmax, 4), dtype=np.int64)
        v_valid = np.zeros((c, vmax), dtype=bool)
        v_viol = np.zeros((c, vmax), dtype=bool)
        v_prio = np.zeros((c, vmax), dtype=np.int64)
        v_ts = np.zeros((c, vmax), dtype=np.float64)
        base = np.zeros((c, 4), dtype=np.int64)
        alloc = np.zeros((c, 4), dtype=np.int64)
        for ci, (vr, viol, prio, ts, base_u, alloc_u) in enumerate(row_data):
            nv = vr.shape[0]
            vr_mat[ci, :nv] = vr
            v_valid[ci, :nv] = True
            v_viol[ci, :nv] = viol
            v_prio[ci, :nv] = prio
            v_ts[ci, :nv] = ts
            base[ci] = base_u
            alloc[ci] = alloc_u
        tables = PlainTables(
            names=names, index={n: i for i, n in enumerate(names)},
            infos=infos, victims=victim_lists,
            base=base, alloc=alloc,
            vr_mat=vr_mat, v_valid=v_valid, v_viol=v_viol,
            v_prio=v_prio, v_ts=v_ts,
        )
        self._tables[key] = tables
        return tables

    def preempt_plain(
        self,
        pod: v1.Pod,
        tables: PlainTables,
        candidate_names: Sequence[str],
        nominated: Optional[Dict[str, List[v1.Pod]]] = None,
    ) -> Optional[Candidate]:
        """Fast preempt() body for plain preemptors: numpy reprieve sweep +
        vectorized 6-criteria ranking over the shared tables, materializing
        ONLY the winner's victim list.  Static node predicates are verified
        on the ranked winner (walking down on the rare failure) — the exact
        outcome the serial path reaches by pre-filtering every candidate."""
        req = compute_pod_resource_request(pod)
        if req.scalar_resources:
            raise ValueError(
                "preempt_plain does not support preemptors with scalar "
                "(extended) resource requests; use select_victims_on_node"
            )
        rows = np.array(
            [tables.index[n] for n in candidate_names if n in tables.index],
            dtype=np.int64,
        )
        if rows.size == 0:
            return None
        req_v = np.array(
            [req.milli_cpu, req.memory, req.ephemeral_storage, 1],
            dtype=np.int64,
        )
        base = tables.base[rows].copy()
        # fold nominated reservations (equal-or-higher-priority nominees on a
        # candidate add their request before the fit check, matching
        # select_victims_on_node's AddNominatedPods analog)
        if nominated:
            my_prio = pod.spec.priority or 0
            for ri, row in enumerate(rows):
                noms = nominated.get(tables.names[row])
                if not noms:
                    continue
                for nom in noms:
                    if nom.uid != pod.uid and (nom.spec.priority or 0) >= my_prio:
                        nr = compute_pod_resource_request(nom)
                        base[ri] += (nr.milli_cpu, nr.memory,
                                     nr.ephemeral_storage, 1)
        alloc = tables.alloc[rows]
        vr = tables.vr_mat[rows]
        v_valid = tables.v_valid[rows]

        victim_mask, nviol, order, valid = _sweep_and_rank(
            base, alloc, vr, v_valid, tables.v_viol[rows],
            tables.v_prio[rows], tables.v_ts[rows], req_v, native=self.native,
        )
        if valid is None or not valid.any():
            return None
        for oi in order:
            if not valid[oi]:
                return None
            row = int(rows[oi])
            info = tables.infos[row]
            node = info.node
            if (node is None or not node_name_fits(pod, node)
                    or not node_schedulable(pod, node)
                    or not node_affinity_fits(pod, node)
                    or not tolerates_all_hard_taints(pod, node)):
                continue  # statics fail: winner drops, next-ranked wins
            victims = [
                p for vi, p in enumerate(tables.victims[row])
                if victim_mask[oi, vi]
            ]
            victims.sort(
                key=lambda p: (-p.spec.priority,
                               p.metadata.creation_timestamp or 0)
            )
            return Candidate(info.node_name, victims, int(nviol[oi]))
        return None

    def select_victims_on_node(
        self,
        pod: v1.Pod,
        info: NodeInfo,
        node_infos: List[NodeInfo],
        pdbs: Sequence[v1.PodDisruptionBudget] = (),
        cluster_has_req_anti_affinity: bool = True,
        nominated: Optional[Dict[str, List[v1.Pod]]] = None,
    ) -> Optional[Candidate]:
        """SelectVictimsOnNode (default_preemption.go:139): remove all lower-
        priority pods, verify fit, then reprieve greedily (PDB-violating pods
        reprieved first, both groups by descending importance).

        ``nominated`` maps node name → pods already nominated there; equal-or-
        higher-priority nominees are added to the simulated node before the fit
        check (the reference's AddNominatedPods inside
        RunFilterPluginsWithNominatedPods, runtime/framework.go:822-836) so a
        burst of same-priority preemptors spreads across nodes instead of all
        claiming the first viable one."""
        sim = info.clone()
        potential = [
            pi.pod for pi in info.pods if pi.pod.spec.priority < pod.spec.priority
        ]
        if not potential:
            return None
        for victim in potential:
            sim.remove_pod(victim)
        for nom in (nominated or {}).get(info.node_name, []):
            if nom.uid != pod.uid and nom.spec.priority >= pod.spec.priority:
                sim.add_pod(nom)

        # Cross-node context is only needed when the preemptor carries
        # global constraints (topology-spread min counts, pod-affinity
        # domain counts); plain resource/taint/selector feasibility is
        # node-local, and evaluating just the simulated node keeps each
        # dry run O(1) in cluster size (the reference likewise filters one
        # node against preFilter state, default_preemption.go:139).
        aff = pod.spec.affinity
        needs_global = bool(
            pod.spec.topology_spread_constraints
            or (aff and (aff.pod_affinity or aff.pod_anti_affinity))
            # existing pods' required anti-affinity can block the preemptor
            # through a multi-node topology domain
            or cluster_has_req_anti_affinity
        )
        others = (
            [ni for ni in node_infos if ni.node_name != info.node_name]
            if needs_global
            else []
        )
        plain = _is_plain_preemptor(pod, cluster_has_req_anti_affinity)

        # Resource-only fast path for the REPRIEVE loop: for a PLAIN
        # preemptor (no global constraints, no host ports, no volumes) the
        # only node predicates that change as reprieved victims come back are
        # the resource/pod-count fits.  The INITIAL per-candidate check below
        # always runs the full oracle against the current snapshot — static
        # predicates (taints, cordon, selectors) may have changed since the
        # device candidate mask was computed (pipelined dispatch), and direct
        # Evaluator.preempt callers pass arbitrary candidates.  At 5k nodes
        # the full-oracle fits() per REPRIEVE step was the dominant
        # preemption cost (cap = n/10 = 500 dry-runs per pod).
        def full_fits() -> bool:
            feas = self.oracle.feasible_nodes(pod, others + [sim])
            return any(ni is sim for ni in feas)

        def fits() -> bool:
            if plain:
                return fits_resources(pod, sim)
            return full_fits()

        if not full_fits():
            return None
        victims: List[v1.Pod] = []
        num_violating = 0
        potential.sort(key=lambda p: (-p.spec.priority, p.metadata.creation_timestamp or 0))
        violating, non_violating = pods_with_pdb_violation(potential, pdbs)

        def reprieve(p: v1.Pod) -> bool:
            sim.add_pod(p)
            if fits():
                return True
            sim.remove_pod(p)
            return False

        for p in violating:
            if not reprieve(p):
                victims.append(p)
                num_violating += 1
        for p in non_violating:
            if not reprieve(p):
                victims.append(p)
        if not victims:
            return None
        victims.sort(key=lambda p: (-p.spec.priority, p.metadata.creation_timestamp or 0))
        return Candidate(info.node_name, victims, num_violating)

    def select_victims_vectorized(
        self,
        pod: v1.Pod,
        infos: List[NodeInfo],
        pdbs: Sequence[v1.PodDisruptionBudget] = (),
        nominated: Optional[Dict[str, List[v1.Pod]]] = None,
    ) -> List[Optional[Candidate]]:
        """select_victims_on_node over ALL candidates at once for PLAIN
        preemptors (no global constraints, host ports, volumes, or scalar
        resources): the reprieve loop is a ≤Vmax-step numpy sweep over
        [C, 4] resource vectors instead of per-candidate NodeInfo
        clone/remove/add churn (which profiled as ~80% of preempt()).

        Exactly the serial semantics: victims sorted violating-first then by
        descending importance; each reprieve re-checks the resource fit with
        that victim restored (test_preemption asserts equality vs the serial
        path).  Static node predicates are the caller's responsibility (the
        device candidate mask), matching the serial fast path's contract.
        """
        req = compute_pod_resource_request(pod)
        if req.scalar_resources:
            # an all-None return would alias "every candidate infeasible";
            # callers must route scalar-resource preemptors to the serial path
            raise ValueError(
                "select_victims_vectorized does not support preemptors with "
                "scalar (extended) resource requests; use select_victims_on_node"
            )

        def statics_ok(info) -> bool:
            # the serial path's full-oracle initial check re-verifies static
            # predicates against the CURRENT snapshot (they may have changed
            # since the device candidate mask was computed under pipelined
            # dispatch); reproduce exactly that portion here — ports/volumes
            # are excluded by the plain gate, resources are the vector pass
            node = info.node
            return (
                node is not None
                and node_name_fits(pod, node)
                and node_schedulable(pod, node)
                and node_affinity_fits(pod, node)
                and tolerates_all_hard_taints(pod, node)
            )
        req_v = np.array(
            [req.milli_cpu, req.memory, req.ephemeral_storage, 1], dtype=np.int64
        )
        c = len(infos)
        per_cand_victims: List[List[v1.Pod]] = []
        per_cand_viol: List[List[bool]] = []
        base = np.zeros((c, 4), dtype=np.int64)
        alloc = np.zeros((c, 4), dtype=np.int64)
        viable = np.zeros(c, dtype=bool)
        for ci, info in enumerate(infos):
            potential = [
                pi.pod for pi in info.pods if pi.pod.spec.priority < pod.spec.priority
            ]
            if not potential or not statics_ok(info):
                per_cand_victims.append([])
                per_cand_viol.append([])
                continue
            viable[ci] = True
            used = info.requested
            u = np.array(
                [used.milli_cpu, used.memory, used.ephemeral_storage, len(info.pods)],
                dtype=np.int64,
            )
            for victim in potential:
                vr = compute_pod_resource_request(victim)
                u -= (vr.milli_cpu, vr.memory, vr.ephemeral_storage, 1)
            for nom in (nominated or {}).get(info.node_name, []):
                if nom.uid != pod.uid and nom.spec.priority >= pod.spec.priority:
                    nr = compute_pod_resource_request(nom)
                    u += (nr.milli_cpu, nr.memory, nr.ephemeral_storage, 1)
            base[ci] = u
            al = info.allocatable
            alloc[ci] = (al.milli_cpu, al.memory, al.ephemeral_storage,
                         al.allowed_pod_number)
            potential.sort(
                key=lambda p: (-p.spec.priority, p.metadata.creation_timestamp or 0)
            )
            violating, non_violating = pods_with_pdb_violation(potential, pdbs)
            ordered = violating + non_violating
            per_cand_victims.append(ordered)
            per_cand_viol.append(
                [True] * len(violating) + [False] * len(non_violating)
            )

        vmax = max((len(v) for v in per_cand_victims), default=0)
        vr_mat = np.zeros((c, vmax, 4), dtype=np.int64)
        v_valid = np.zeros((c, vmax), dtype=bool)
        for ci, victims in enumerate(per_cand_victims):
            for vi, victim in enumerate(victims):
                vr = compute_pod_resource_request(victim)
                vr_mat[ci, vi] = (vr.milli_cpu, vr.memory, vr.ephemeral_storage, 1)
                v_valid[ci, vi] = True

        def fits(u):
            free = alloc - u
            return np.all((req_v == 0) | (req_v <= free), axis=1)

        feasible = viable & fits(base)
        used = base.copy()
        reprieved = np.zeros((c, vmax), dtype=bool)
        for vi in range(vmax):
            trial = used + vr_mat[:, vi]
            ok = fits(trial) & v_valid[:, vi] & feasible
            used = np.where(ok[:, None], trial, used)
            reprieved[:, vi] = ok

        out: List[Optional[Candidate]] = []
        for ci, info in enumerate(infos):
            if not feasible[ci]:
                out.append(None)
                continue
            victims = [
                p for vi, p in enumerate(per_cand_victims[ci])
                if not reprieved[ci, vi]
            ]
            if not victims:
                out.append(None)
                continue
            nviol = sum(
                1 for vi, p in enumerate(per_cand_victims[ci])
                if not reprieved[ci, vi] and per_cand_viol[ci][vi]
            )
            victims.sort(
                key=lambda p: (-p.spec.priority, p.metadata.creation_timestamp or 0)
            )
            out.append(Candidate(info.node_name, victims, nviol))
        return out

    def pick_one_node(self, candidates: List[Candidate]) -> Optional[Candidate]:
        """pickOneNodeForPreemption (:397): lexicographic 6-criteria."""
        if not candidates:
            return None
        pool = candidates
        pool = _argmin(pool, lambda c: c.num_pdb_violations)
        if len(pool) > 1:
            pool = _argmin(pool, lambda c: c.victims[0].spec.priority)
        if len(pool) > 1:
            pool = _argmin(
                pool, lambda c: sum(p.spec.priority + (1 << 31) for p in c.victims)
            )
        if len(pool) > 1:
            pool = _argmin(pool, lambda c: len(c.victims))
        if len(pool) > 1:
            # latest "earliest start time among the highest-priority victims"
            # wins (preemption.go:492-509 via util.GetEarliestPodStartTime):
            # prefer the node whose most-important victims are youngest.
            def earliest_high_priority_start(c: Candidate) -> int:
                # victims are sorted by descending priority (see sort above),
                # same invariant the criterion-2 tiebreak relies on
                top = c.victims[0].spec.priority
                return min(
                    (p.metadata.creation_timestamp or 0)
                    for p in c.victims
                    if p.spec.priority == top
                )

            pool = _argmin(pool, lambda c: -earliest_high_priority_start(c))
        return pool[0]

    def preempt(
        self,
        pod: v1.Pod,
        snapshot: Snapshot,
        candidate_nodes: Sequence[str],
        pdbs: Sequence[v1.PodDisruptionBudget] = (),
        max_candidates: Optional[int] = None,
        nominated: Optional[Dict[str, List[v1.Pod]]] = None,
        extenders: Sequence = (),
    ) -> Optional[Candidate]:
        """Evaluate candidates (already device-prefiltered) and pick one.

        Candidate cap mirrors default_preemption.go:110-127:
        max(100, 10%·n) unless overridden.  ``extenders`` must be empty:
        the preemption callout to extenders (preemption.go callExtenders)
        comes with them (ROADMAP Queue A item 6b).
        """
        if extenders:
            raise NotImplementedError(
                "preemption with scheduler extenders is not ported yet "
                "(ROADMAP Queue A item 6b)")
        n = len(snapshot.node_info_list)
        cap = max_candidates or max(100, n // 10)
        node_infos = snapshot.node_info_list
        has_anti = bool(snapshot.have_pods_with_required_anti_affinity_list)
        candidates: List[Candidate] = []
        pool = list(candidate_nodes)
        if len(pool) > cap:
            start = self._offset % len(pool)
            self._offset += cap
            pool = pool[start:] + pool[:start]
        pool = pool[:cap]
        vectorizable = (
            _is_plain_preemptor(pod, has_anti)
            and not compute_pod_resource_request(pod).scalar_resources
        )
        if vectorizable:
            # shared-tables fast path: ranking needs only the winner, so the
            # per-candidate Candidate materialization (and the per-preemptor
            # table rebuild) is skipped entirely
            tables = self.plain_tables(snapshot, pod.spec.priority or 0, pdbs)
            return self.preempt_plain(pod, tables, pool, nominated=nominated)
        # the serial dry run, node by node (the reference's vectorized
        # branch here serves only extender callouts, which the port refuses)
        by_name = snapshot.node_info_map
        for name in pool:
            info = by_name.get(name)
            if info is None:
                continue
            c = self.select_victims_on_node(
                pod, info, node_infos, pdbs,
                cluster_has_req_anti_affinity=has_anti,
                nominated=nominated,
            )
            if c is not None:
                candidates.append(c)
        return self.pick_one_node(candidates)


def _argmin(pool, key):
    best = min(key(c) for c in pool)
    return [c for c in pool if key(c) == best]


def _is_plain_preemptor(pod: v1.Pod, cluster_has_req_anti_affinity: bool) -> bool:
    """One predicate for both the per-node fast path and the vectorized
    batch path: no global constraints (own topology spread / pod (anti)
    affinity, or existing-pod required anti-affinity), no host ports, no
    volumes — the regimes where victim eviction only moves resources."""
    aff = pod.spec.affinity
    return not (
        pod.spec.topology_spread_constraints
        or (aff and (aff.pod_affinity or aff.pod_anti_affinity))
        or cluster_has_req_anti_affinity
        or _pod_host_ports(pod)
        or _pod_volumes(pod)
    )


def _pod_host_ports(pod: v1.Pod) -> bool:
    # single source of truth for host-port extraction (node_info's helper)
    return bool(_node_info_host_ports(pod))


def _pod_volumes(pod: v1.Pod) -> bool:
    return bool(getattr(pod.spec, "volumes", None))
