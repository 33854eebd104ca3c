"""PodBatch: a batch of pending pods compiled into padded device arrays.

The reference walks one pod's Go spec per cycle (scheduler.go:496 scheduleOne);
plugins re-parse it per node visit.  Here a whole batch of B pending pods is
compiled ONCE host-side into fixed-shape int32/float32 arrays, and every plugin's
Filter/Score reads only these arrays — so the full ``[B, N]`` feasibility/score
planes are pure tensor programs (``batch_to_device`` moves a compiled batch
onto the device).

Compiled per pod (MISSING = -1 pads everywhere):
  requests        — i32[B, R] scaled units (fit.go:162-178 semantics, incl. overhead)
  tolerations     — key/val/op/effect/valid [B, TT] (Toleration.ToleratesTaint)
  node selector   — pod.spec.nodeSelector as a matchLabels-only selector (AND)
  node affinity   — requiredDuringScheduling terms (OR of ANDed reqs) + weighted
                    preferred terms (nodeaffinity/node_affinity.go)
  topology spread — per-constraint key/maxSkew/whenUnsatisfiable/minDomains +
                    compiled label selector (podtopologyspread/common.go);
                    topology keys become encoder topo slots (compact domain ids)
  pod (anti)affinity — 4 term groups, each: topology key, compiled selector,
                    resolved namespace id list (namespaces ∪ namespaceSelector
                    resolved host-side, mirroring PreFilter's namespace resolution)
  ports, labels, namespace, priority, nodeName
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from ..api import objects as v1
from ..api.labels import match_label_selector
from ..state.dictionary import MISSING, Dictionary
from ..state.encoding import (
    EFFECT_CODE,
    _PROTO_CODE,
    ClusterEncoder,
    EncodingCapacityError,
)
from ..state import selectors as sel
from ..state.selectors import (
    CompiledLabelSelectors,
    CompiledNodeSelectors,
    compile_label_selectors,
    compile_node_selectors,
)

TOL_OP_EQUAL = 0
TOL_OP_EXISTS = 1

WHEN_DO_NOT_SCHEDULE = 0
WHEN_SCHEDULE_ANYWAY = 1


from ..state.units import pow2_round_up as _pow2


# the four pod-(anti)affinity term groups, in PodBatch field order — the ONE
# source for the compiler loop, the group_present default, and
# InterPodAffinityPlugin._present
AFFINITY_GROUPS = ("req_affinity", "req_anti_affinity",
                   "pref_affinity", "pref_anti_affinity")


@dataclass
class AffinityTermGroup:
    """One group of pod-affinity terms for the whole batch ([B, T] padded).

    selectors are flattened row-major: term (i, t) -> flat index i*T + t.
    """

    valid: np.ndarray  # bool[B, T]
    topo_key: np.ndarray  # i32[B, T]
    weight: np.ndarray  # f32[B, T]  (1.0 for required terms)
    ns_ids: np.ndarray  # i32[B, T, NS]
    all_namespaces: np.ndarray  # bool[B, T]  (empty-but-non-nil namespaceSelector)
    selectors: CompiledLabelSelectors  # batch size B*T

    @property
    def terms_per_pod(self) -> int:
        return self.valid.shape[1]


@dataclass
class PodBatch:
    pods: List[v1.Pod]
    valid: np.ndarray  # bool[B]
    request: np.ndarray  # i32[B, R]
    non_zero: np.ndarray  # i32[B, 2]
    ns: np.ndarray  # i32[B]
    label_keys: np.ndarray  # i32[B, PL]
    label_vals: np.ndarray  # i32[B, PL]
    priority: np.ndarray  # i32[B]
    node_name_id: np.ndarray  # i32[B] (MISSING when spec.nodeName unset)
    nominated_row: np.ndarray  # i32[B] node row from status.nominatedNodeName (-1 none)
    ports: np.ndarray  # i32[B, PP]
    ports_ip: np.ndarray  # i32[B, PP] (hostIP dictionary id; ID_WILDCARD_IP = any)
    image_ids: np.ndarray  # i32[B, CI] (container images, for ImageLocality)
    # tolerations
    tol_valid: np.ndarray  # bool[B, TT]
    tol_key: np.ndarray  # i32[B, TT] (MISSING = empty key → any)
    tol_val: np.ndarray  # i32[B, TT]
    tol_op: np.ndarray  # i32[B, TT]
    tol_effect: np.ndarray  # i32[B, TT] (-1 = all effects)
    # node selection
    node_selector: CompiledLabelSelectors  # B (pod.spec.nodeSelector)
    node_affinity: CompiledNodeSelectors  # B (required terms)
    pref_valid: np.ndarray  # bool[B, PT] preferred node-affinity terms
    pref_weight: np.ndarray  # f32[B, PT]
    pref_req_key: np.ndarray  # i32[B, PT, S]
    pref_req_op: np.ndarray
    pref_req_vals: np.ndarray  # i32[B, PT, S, V]
    pref_req_num: np.ndarray  # f32[B, PT, S]
    # topology spread
    tsc_valid: np.ndarray  # bool[B, C]
    tsc_key: np.ndarray  # i32[B, C]
    tsc_max_skew: np.ndarray  # i32[B, C]
    tsc_when: np.ndarray  # i32[B, C]
    tsc_min_domains: np.ndarray  # i32[B, C] (0 = unset)
    tsc_selectors: CompiledLabelSelectors  # B*C
    # pod (anti)affinity term groups
    req_affinity: AffinityTermGroup
    req_anti_affinity: AffinityTermGroup
    pref_affinity: AffinityTermGroup
    pref_anti_affinity: AffinityTermGroup
    # STATIC (pytree aux) batch-content flags: trace-time constants that let
    # the runtime compile constraint-free batches WITHOUT the topology-spread
    # / inter-pod-affinity programs at all — their per-step domain ops are
    # O(N·D) and dominate the greedy scan at 5k nodes even when every
    # constraint row is invalid padding
    has_spread: bool = False
    has_affinity: bool = False
    # pow-2 bound on compact domain indices across the batch's USED spread
    # keys.  The encoder's global domain_cap covers EVERY registered topology
    # key — one hostname-keyed pod anywhere (5k domains at 5k nodes) would
    # make every zone-spread batch contract [C, N, 8192] one-hots when its
    # own key has 3 domains.  Static (trace-time constant) → one compiled
    # program variant per bucket.  None (the default for any batch built
    # without the compiler's sizing pass) falls back to the global
    # domain_cap in the plugin — a too-small bucket would silently merge
    # domains past it.
    tsc_domain_bucket: Optional[int] = None
    # same bound over the batch's pod-(anti)affinity term keys — drives both
    # the InterPodAffinity table width AND its planes-vs-tables choice
    # (zone-affinity batches get [B,T,9] tables instead of [B,T,N] planes)
    ipa_domain_bucket: Optional[int] = None
    # which of the four (anti)affinity term groups have ANY valid term in
    # this batch (static): InterPodAffinity compiles out the per-scan-step
    # update work of empty groups — an anti-only batch skips the three
    # other groups' [B,T,N] plane rewrites on every step
    group_present: tuple = AFFINITY_GROUPS

    def __len__(self) -> int:
        return len(self.pods)

    @property
    def size(self) -> int:
        return self.valid.shape[0]

    def has_pod_affinity(self) -> bool:
        return bool(
            self.req_affinity.valid.any()
            or self.req_anti_affinity.valid.any()
            or self.pref_affinity.valid.any()
            or self.pref_anti_affinity.valid.any()
        )

    def has_topology_spread(self) -> bool:
        return bool(self.tsc_valid.any())

    def take(self, rows) -> "PodBatch":
        """Row-gather along the pod axis: a PodBatch whose pod i is this
        batch's pod ``rows[i]`` (static pytree aux copied unchanged).

        Works on host numpy and on device tensors (``rows`` may be an index
        tensor) — the identity-class dedup path gathers the class
        REPRESENTATIVES' rows this way, so the dense filter/score
        planes compute at ``[C, N]`` instead of ``[B, N]``.  The compiled
        selector structs hold content-deduplicated unique rows plus a
        per-pod ``index`` map, so gathering a selector batch is just
        gathering ``index``; per-pod-flattened selector batches (B*T
        row-major) gather whole T-blocks."""
        import dataclasses

        b = self.valid.shape[0]

        def g(a):  # plain pod-dim array
            return a[rows]

        def sel_take(cs, per_pod: int):
            idx = cs.index.reshape(b, per_pod)[rows].reshape(-1)
            return dataclasses.replace(cs, index=idx)

        def group_take(grp: "AffinityTermGroup"):
            t = grp.valid.shape[1]
            return AffinityTermGroup(
                valid=g(grp.valid), topo_key=g(grp.topo_key),
                weight=g(grp.weight), ns_ids=g(grp.ns_ids),
                all_namespaces=g(grp.all_namespaces),
                selectors=sel_take(grp.selectors, t),
            )

        return dataclasses.replace(
            self,
            pods=[],  # host pod objects are not gatherable by traced rows
            valid=g(self.valid), request=g(self.request),
            non_zero=g(self.non_zero), ns=g(self.ns),
            label_keys=g(self.label_keys), label_vals=g(self.label_vals),
            priority=g(self.priority), node_name_id=g(self.node_name_id),
            nominated_row=g(self.nominated_row),
            ports=g(self.ports), ports_ip=g(self.ports_ip),
            image_ids=g(self.image_ids),
            tol_valid=g(self.tol_valid), tol_key=g(self.tol_key),
            tol_val=g(self.tol_val), tol_op=g(self.tol_op),
            tol_effect=g(self.tol_effect),
            node_selector=sel_take(self.node_selector, 1),
            node_affinity=sel_take(self.node_affinity, 1),
            pref_valid=g(self.pref_valid), pref_weight=g(self.pref_weight),
            pref_req_key=g(self.pref_req_key), pref_req_op=g(self.pref_req_op),
            pref_req_vals=g(self.pref_req_vals),
            pref_req_num=g(self.pref_req_num),
            tsc_valid=g(self.tsc_valid), tsc_key=g(self.tsc_key),
            tsc_max_skew=g(self.tsc_max_skew), tsc_when=g(self.tsc_when),
            tsc_min_domains=g(self.tsc_min_domains),
            tsc_selectors=sel_take(self.tsc_selectors,
                                   self.tsc_valid.shape[1]),
            req_affinity=group_take(self.req_affinity),
            req_anti_affinity=group_take(self.req_anti_affinity),
            pref_affinity=group_take(self.pref_affinity),
            pref_anti_affinity=group_take(self.pref_anti_affinity),
        )


def _field_to_device(value, device):
    """numpy array → tensor on ``device``; compiled selector structs and
    term groups convert field by field; everything else passes through."""
    import torch

    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(value)).to(device)
    if torch.is_tensor(value):
        return value.to(device)
    if isinstance(value, (CompiledLabelSelectors, CompiledNodeSelectors,
                          AffinityTermGroup)):
        import dataclasses

        return dataclasses.replace(value, **{
            f.name: _field_to_device(getattr(value, f.name), device)
            for f in dataclasses.fields(value)
            if f.name != "has_numeric"})
    return value


def batch_to_device(batch: "PodBatch", device) -> "PodBatch":
    """The compiled (host numpy) PodBatch as tensors on ``device``; the host
    pod objects and the static content flags ride along unchanged."""
    import dataclasses

    return dataclasses.replace(batch, **{
        f.name: _field_to_device(getattr(batch, f.name), device)
        for f in dataclasses.fields(batch) if f.name != "pods"})


class PodBatchCompiler:
    """Compiles pods → PodBatch against a ClusterEncoder's dictionary/resource dims.

    namespace_labels: ns name → labels, used to resolve PodAffinityTerm
    namespaceSelector host-side (the reference resolves it in PreFilter via a
    namespace lister — interpodaffinity/plugin.go GetNamespaceLabelsSnapshot).
    """

    def __init__(
        self,
        encoder: ClusterEncoder,
        namespace_labels: Optional[Mapping[str, Mapping[str, str]]] = None,
    ):
        self.enc = encoder
        self.dic: Dictionary = encoder.dic
        self.namespace_labels = namespace_labels or {}
        # Sticky per-dimension caps: each inner dim (labels, tolerations,
        # spread constraints, affinity terms, …) is a pow-2 HIGH-WATER MARK
        # across all batches this compiler has seen, not the current batch's
        # max.  Otherwise batches alternating between pod kinds (e.g. plain ↔
        # anti-affinity in the mixed suites) flip shapes every cycle and each
        # flip recompiles the whole program suite.  Padding is semantically
        # inert (valid[] gates everything), so growing a cap never changes
        # results — test_podbatch_sticky_caps.
        self._caps: Dict[str, int] = {}

    def _cap(self, name: str, need: int, minimum: int) -> int:
        c = max(_pow2(need, minimum), self._caps.get(name, 0))
        self._caps[name] = c
        return c

    def _compile_ls(self, name: str, sel_list) -> CompiledLabelSelectors:
        """compile_label_selectors with sticky u/s/v caps (same rationale as _cap)."""
        cs = compile_label_selectors(
            sel_list, self.dic,
            min_s=self._caps.get(f"{name}_s", 4),
            min_v=self._caps.get(f"{name}_v", 4),
            min_u=self._caps.get(f"{name}_u", 4),
        )
        self._caps[f"{name}_s"] = cs.req_key.shape[-1]
        self._caps[f"{name}_v"] = cs.req_vals.shape[-1]
        self._caps[f"{name}_u"] = cs.req_key.shape[0]
        return cs

    def _compile_ns(self, name: str, sel_list) -> CompiledNodeSelectors:
        cs = compile_node_selectors(
            sel_list, self.dic,
            min_t=self._caps.get(f"{name}_t", 2),
            min_s=self._caps.get(f"{name}_s", 4),
            min_v=self._caps.get(f"{name}_v", 4),
            min_u=self._caps.get(f"{name}_u", 2),
        )
        self._caps[f"{name}_t"] = cs.req_key.shape[1]
        self._caps[f"{name}_s"] = cs.req_key.shape[2]
        self._caps[f"{name}_v"] = cs.req_vals.shape[-1]
        self._caps[f"{name}_u"] = cs.req_key.shape[0]
        return cs

    def compile(self, pods: Sequence[v1.Pod], pad_to: Optional[int] = None) -> PodBatch:
        b_real = len(pods)
        b = pad_to if pad_to is not None else _pow2(b_real, 1)
        if b < b_real:
            raise ValueError(f"pad_to {b} < batch size {b_real}")
        enc, dic = self.enc, self.dic
        cfg = enc.cfg
        r = cfg.num_resource_dims

        valid = np.zeros(b, dtype=bool)
        request = np.zeros((b, r), dtype=np.int32)
        non_zero = np.zeros((b, 2), dtype=np.int32)
        ns = np.full(b, MISSING, dtype=np.int32)
        priority = np.zeros(b, dtype=np.int32)
        node_name_id = np.full(b, MISSING, dtype=np.int32)
        nominated_row = np.full(b, -1, dtype=np.int32)

        pl_cap = self._cap("pl", max((len(p.metadata.labels) for p in pods), default=0), 4)
        label_keys = np.full((b, pl_cap), MISSING, dtype=np.int32)
        label_vals = np.full((b, pl_cap), MISSING, dtype=np.int32)

        port_lists = [sorted(
            {(_PROTO_CODE.get(proto, 0) * 65536 + port, dic.intern(ip))
             for (ip, proto, port) in _pod_host_ports(p)}
        ) for p in pods]
        pp_cap = self._cap("pp", max((len(pl) for pl in port_lists), default=0), 2)
        ports = np.full((b, pp_cap), MISSING, dtype=np.int32)
        ports_ip = np.full((b, pp_cap), MISSING, dtype=np.int32)

        ci_cap = self._cap("ci", max((len(p.spec.containers) for p in pods), default=0), 2)
        image_ids = np.full((b, ci_cap), MISSING, dtype=np.int32)

        tt_cap = self._cap("tt", max((len(p.spec.tolerations) for p in pods), default=0), 2)
        tol_valid = np.zeros((b, tt_cap), dtype=bool)
        tol_key = np.full((b, tt_cap), MISSING, dtype=np.int32)
        tol_val = np.full((b, tt_cap), MISSING, dtype=np.int32)
        tol_op = np.zeros((b, tt_cap), dtype=np.int32)
        tol_effect = np.full((b, tt_cap), -1, dtype=np.int32)

        node_selectors: List[Optional[v1.LabelSelector]] = []
        node_affinities: List[Optional[v1.NodeSelector]] = []
        pref_terms: List[List[v1.PreferredSchedulingTerm]] = []
        tsc_lists: List[List[v1.TopologySpreadConstraint]] = []

        for i, pod in enumerate(pods):
            valid[i] = True
            request[i] = enc.pod_request_units(pod)
            non_zero[i] = enc.pod_non_zero_units(pod)
            ns[i] = dic.intern(pod.namespace)
            priority[i] = pod.spec.priority
            if pod.spec.node_name:
                node_name_id[i] = dic.intern(pod.spec.node_name)
            if pod.status.nominated_node_name:
                nominated_row[i] = enc.node_rows.get(
                    pod.status.nominated_node_name, -1
                )
            for j, (k, val) in enumerate(pod.metadata.labels.items()):
                label_keys[i, j] = dic.intern(k)
                label_vals[i, j] = dic.intern(val)
            for j, (code, ip_id) in enumerate(port_lists[i]):
                ports[i, j] = code
                ports_ip[i, j] = ip_id
            for j, c in enumerate(pod.spec.containers):
                if c.image:
                    image_ids[i, j] = dic.intern(c.image)
            for j, t in enumerate(pod.spec.tolerations):
                tol_valid[i, j] = True
                tol_key[i, j] = dic.intern(t.key) if t.key else MISSING
                tol_val[i, j] = dic.intern(t.value)
                tol_op[i, j] = (
                    TOL_OP_EXISTS if t.operator == v1.TOLERATION_OP_EXISTS else TOL_OP_EQUAL
                )
                tol_effect[i, j] = EFFECT_CODE.get(t.effect, -1) if t.effect else -1

            # nodeSelector: empty selector matches everything (matchLabels AND)
            node_selectors.append(
                v1.LabelSelector(match_labels=dict(pod.spec.node_selector))
            )
            aff = pod.spec.affinity
            na = aff.node_affinity if aff else None
            node_affinities.append(na.required if na else None)
            pref_terms.append(list(na.preferred) if na else [])
            tsc_lists.append(list(pod.spec.topology_spread_constraints))

        # pad rows: invalid pods get empty node selector (matches everything) so
        # padded rows never constrain anything; valid[] gates all results anyway.
        node_selectors += [v1.LabelSelector()] * (b - b_real)
        node_affinities += [None] * (b - b_real)
        pref_terms += [[]] * (b - b_real)
        tsc_lists += [[]] * (b - b_real)

        compiled_ns = self._compile_ls("nodesel", node_selectors)
        compiled_na = self._compile_ns("nodeaff", node_affinities)

        # preferred node-affinity terms
        pt_cap = self._cap("pt", max((len(t) for t in pref_terms), default=0), 1)
        s_cap = self._cap(
            "pt_s",
            max(
                (len(t.preference.match_expressions) + len(t.preference.match_fields)
                 for terms in pref_terms for t in terms),
                default=0,
            ),
            2,
        )
        v_cap = self._cap(
            "pt_v",
            max(
                (len(e.values)
                 for terms in pref_terms for t in terms
                 for e in list(t.preference.match_expressions) + list(t.preference.match_fields)),
                default=0,
            ),
            2,
        )
        pref_valid = np.zeros((b, pt_cap), dtype=bool)
        pref_weight = np.zeros((b, pt_cap), dtype=np.float32)
        pref_req_key = np.full((b, pt_cap, s_cap), MISSING, dtype=np.int32)
        pref_req_op = np.full((b, pt_cap, s_cap), sel.OP_PAD, dtype=np.int32)
        pref_req_vals = np.full((b, pt_cap, s_cap, v_cap), MISSING, dtype=np.int32)
        pref_req_num = np.full((b, pt_cap, s_cap), np.nan, dtype=np.float32)
        for i, terms in enumerate(pref_terms):
            for ti, term in enumerate(terms):
                reqs = list(term.preference.match_expressions)
                fields = [
                    v1.NodeSelectorRequirement(
                        key="metadata.name" if e.key in ("metadata.name", "name") else e.key,
                        operator=e.operator,
                        values=list(e.values),
                    )
                    for e in term.preference.match_fields
                ]
                reqs = reqs + fields
                # a preferred term with no requirements matches nothing (reference:
                # empty NodeSelectorTerm matches no objects)
                pref_valid[i, ti] = len(reqs) > 0
                pref_weight[i, ti] = float(term.weight)
                for j, e in enumerate(reqs):
                    pref_req_key[i, ti, j] = dic.intern(e.key)
                    pref_req_op[i, ti, j] = sel._OP_CODE[e.operator]
                    for k, val in enumerate(e.values):
                        pref_req_vals[i, ti, j, k] = dic.intern(val)
                    if e.values:
                        try:
                            pref_req_num[i, ti, j] = float(int(e.values[0]))
                        except ValueError:
                            pass

        # topology spread constraints
        c_cap = self._cap("tsc", max((len(t) for t in tsc_lists), default=0), 1)
        tsc_valid = np.zeros((b, c_cap), dtype=bool)
        tsc_key = np.full((b, c_cap), MISSING, dtype=np.int32)
        tsc_max_skew = np.ones((b, c_cap), dtype=np.int32)
        tsc_when = np.full((b, c_cap), -1, dtype=np.int32)
        tsc_min_domains = np.zeros((b, c_cap), dtype=np.int32)
        tsc_sel_list: List[Optional[v1.LabelSelector]] = [None] * (b * c_cap)
        for i, constraints in enumerate(tsc_lists):
            for ci, c in enumerate(constraints):
                tsc_valid[i, ci] = True
                tsc_key[i, ci] = self.enc.topo_slot(c.topology_key)
                tsc_max_skew[i, ci] = c.max_skew
                tsc_when[i, ci] = (
                    WHEN_DO_NOT_SCHEDULE
                    if c.when_unsatisfiable == v1.DO_NOT_SCHEDULE
                    else WHEN_SCHEDULE_ANYWAY
                )
                tsc_min_domains[i, ci] = c.min_domains or 0
                tsc_sel_list[i * c_cap + ci] = c.label_selector
        tsc_selectors = self._compile_ls("tsc_sel", tsc_sel_list)

        groups = {}
        for gname in AFFINITY_GROUPS:
            groups[gname] = self._compile_affinity_group(pods, b, gname)
        has_spread = bool(tsc_valid.any())
        group_present = tuple(
            name for name in AFFINITY_GROUPS if bool(groups[name].valid.any())
        )
        has_affinity = bool(group_present)  # derived: one source of truth
        # effective domain axis for THIS batch's spread keys (see the field
        # comment): pow2 of the largest used key's live domain count, with
        # headroom floor 8 so zone-churn (a 4th zone appearing) doesn't
        # recompile.  MISSING-keyed rows (padding) contribute nothing.
        tsc_domain_bucket = self._domain_bucket(tsc_key[tsc_valid])
        ipa_domain_bucket = self._domain_bucket(
            *(g.topo_key[g.valid] for g in groups.values())
        )

        return PodBatch(
            pods=list(pods),
            valid=valid, request=request, non_zero=non_zero, ns=ns,
            label_keys=label_keys, label_vals=label_vals, priority=priority,
            node_name_id=node_name_id, nominated_row=nominated_row,
            ports=ports, ports_ip=ports_ip, image_ids=image_ids,
            tol_valid=tol_valid, tol_key=tol_key, tol_val=tol_val,
            tol_op=tol_op, tol_effect=tol_effect,
            node_selector=compiled_ns, node_affinity=compiled_na,
            pref_valid=pref_valid, pref_weight=pref_weight,
            pref_req_key=pref_req_key, pref_req_op=pref_req_op,
            pref_req_vals=pref_req_vals, pref_req_num=pref_req_num,
            tsc_valid=tsc_valid, tsc_key=tsc_key, tsc_max_skew=tsc_max_skew,
            tsc_when=tsc_when, tsc_min_domains=tsc_min_domains,
            tsc_selectors=tsc_selectors,
            has_spread=has_spread, has_affinity=has_affinity,
            tsc_domain_bucket=tsc_domain_bucket,
            ipa_domain_bucket=ipa_domain_bucket,
            group_present=group_present,
            **groups,
        )

    # --- pod affinity ---------------------------------------------------------

    def _terms_of(self, pod: v1.Pod, group: str):
        aff = pod.spec.affinity
        if aff is None:
            return []
        pa = aff.pod_affinity if "anti" not in group else aff.pod_anti_affinity
        if pa is None:
            return []
        if group.startswith("req"):
            return [(t, 1.0) for t in pa.required]
        return [(wt.pod_affinity_term, float(wt.weight)) for wt in pa.preferred]

    def _resolve_namespaces(self, pod: v1.Pod, term: v1.PodAffinityTerm):
        """→ (ns_names, all_namespaces). Mirrors PreFilter namespace resolution:
        namespaces ∪ namespaceSelector matches; neither set → pod's own namespace;
        empty-but-set namespaceSelector selects every namespace."""
        names = set(term.namespaces)
        all_ns = False
        if term.namespace_selector is not None:
            if not term.namespace_selector.match_labels and not term.namespace_selector.match_expressions:
                all_ns = True
            else:
                for ns_name, labels in self.namespace_labels.items():
                    if match_label_selector(term.namespace_selector, labels):
                        names.add(ns_name)
        if not names and not all_ns:
            names = {pod.namespace}
        return sorted(names), all_ns

    def _domain_bucket(self, *slot_arrays) -> int:
        """pow2 bound on the live domain counts of the topo-key slots named
        by the given arrays, floor 8 (headroom so small-domain churn — a 4th
        zone appearing — doesn't recompile).  See PodBatch.tsc_domain_bucket."""
        d = 1
        for arr in slot_arrays:
            for slot in np.unique(arr):
                if 0 <= slot < len(self.enc.topo_value_maps):
                    d = max(d, len(self.enc.topo_value_maps[slot]))
        return _pow2(d, 8)

    def _compile_affinity_group(
        self, pods: Sequence[v1.Pod], b: int, group: str
    ) -> AffinityTermGroup:
        dic = self.dic
        term_lists = [self._terms_of(p, group) for p in pods]
        t_cap = self._cap(
            f"{group}_t", max((len(t) for t in term_lists), default=0), 1
        )
        resolved = [
            [self._resolve_namespaces(p, term) for (term, _w) in terms]
            for p, terms in zip(pods, term_lists)
        ]
        ns_cap = self._cap(
            f"{group}_ns",
            max((len(names) for rl in resolved for (names, _a) in rl), default=0), 1
        )
        valid = np.zeros((b, t_cap), dtype=bool)
        topo_key = np.full((b, t_cap), MISSING, dtype=np.int32)
        weight = np.zeros((b, t_cap), dtype=np.float32)
        ns_ids = np.full((b, t_cap, ns_cap), MISSING, dtype=np.int32)
        all_namespaces = np.zeros((b, t_cap), dtype=bool)
        sel_list: List[Optional[v1.LabelSelector]] = [None] * (b * t_cap)
        for i, terms in enumerate(term_lists):
            for ti, (term, w) in enumerate(terms):
                valid[i, ti] = True
                topo_key[i, ti] = self.enc.topo_slot(term.topology_key)
                weight[i, ti] = w
                names, all_ns = resolved[i][ti]
                all_namespaces[i, ti] = all_ns
                for k, name in enumerate(names):
                    ns_ids[i, ti, k] = dic.intern(name)
                sel_list[i * t_cap + ti] = term.label_selector
        return AffinityTermGroup(
            valid=valid, topo_key=topo_key, weight=weight, ns_ids=ns_ids,
            all_namespaces=all_namespaces,
            selectors=self._compile_ls(f"{group}_sel", sel_list),
        )


def identity_classes(batch: PodBatch):
    """Host-side exact-content pod classes over a compiled batch.

    Two pods share a class iff every compiled pod-row that feeds the
    filter/score planes is byte-identical — so their ``[N]`` plane rows are
    provably equal and the dense compute can run once per class
    (``batch_assign``'s dedup path) instead of once per pod.  The compiled
    selector structs are content-deduplicated at compile time, so comparing
    their per-pod ``index`` rows compares selector CONTENT.
    ``nominated_row`` is excluded on purpose: it steers host selection, not
    the planes.  Returns ``(class_of i32[B], rep_rows i32[C])`` with
    ``rep_rows[class_of[b]]`` the first batch row of b's class.

    Templated scheduler_perf workloads collapse to a handful of classes
    (measured C=2 at B=256 on the basic suites: one pod template plus the
    padding rows), which turns the ``[B, N]`` dense planes — 18s/batch at
    131k nodes on the 1-core CI host — into a ``[C, N]`` compute (0.26s).

    The result is memoized on the batch object: the router precheck
    (the scheduler's engine choice), the dedup gate, and the extender callout
    dedup all consult it for the same compiled batch.
    """
    cached = getattr(batch, "_identity_classes_cache", None)
    if cached is not None:
        return cached
    b = batch.size

    def flat(a):
        return np.ascontiguousarray(np.asarray(a)).reshape(b, -1)

    cols = [
        flat(a) for a in (
            batch.valid, batch.request, batch.non_zero, batch.ns,
            batch.label_keys, batch.label_vals, batch.priority,
            batch.node_name_id, batch.ports, batch.ports_ip,
            batch.image_ids, batch.tol_valid, batch.tol_key, batch.tol_val,
            batch.tol_op, batch.tol_effect, batch.pref_valid,
            batch.pref_weight, batch.pref_req_key, batch.pref_req_op,
            batch.pref_req_vals, batch.pref_req_num, batch.tsc_valid,
            batch.tsc_key, batch.tsc_max_skew, batch.tsc_when,
            batch.tsc_min_domains,
            batch.node_selector.index, batch.node_affinity.index,
            batch.tsc_selectors.index,
        )
    ]
    for grp in (batch.req_affinity, batch.req_anti_affinity,
                batch.pref_affinity, batch.pref_anti_affinity):
        cols += [flat(grp.valid), flat(grp.topo_key), flat(grp.weight),
                 flat(grp.ns_ids), flat(grp.all_namespaces),
                 flat(grp.selectors.index)]
    blob = np.concatenate(cols, axis=1)
    seen: Dict[bytes, int] = {}
    class_of = np.zeros(b, dtype=np.int32)
    rep_rows: List[int] = []
    for i in range(b):
        key = blob[i].tobytes()
        c = seen.get(key)
        if c is None:
            c = seen[key] = len(rep_rows)
            rep_rows.append(i)
        class_of[i] = c
    out = (class_of, np.asarray(rep_rows, dtype=np.int32))
    try:
        batch._identity_classes_cache = out
    except (AttributeError, TypeError):
        pass  # frozen stand-ins just recompute
    return out


def _pod_host_ports(pod: v1.Pod):
    out = set()
    for c in pod.spec.containers:
        for p in c.ports:
            if p.host_port > 0:
                out.add((p.host_ip or "0.0.0.0", p.protocol or "TCP", p.host_port))
    return out
