"""Selector compilation: label/node selectors → int32 tensor programs.

The reference evaluates selectors per (pod, node/pod) pair in Go
(apimachinery labels.Selector; component-helpers nodeaffinity). Here a batch of
selectors is *compiled once* host-side into padded int32 arrays, and a whole
``[pods, nodes]`` or ``[terms, pods]`` match matrix is one call of K23
(kernels/selectors.py; its plain version broadcasts the compares along both the
selector batch and the node/pod axes on the CPU).

Encoding (MISSING = -1 is the universal pad):
  requirement ops: IN=0 NOT_IN=1 EXISTS=2 DOES_NOT_EXIST=3 GT=4 LT=5, PAD=-1
  a padded requirement row is the AND-identity (always true)
  a LabelSelector with match_none=True matches nothing (the None selector)
  a NodeSelector with match_all=True matches everything (the nil selector);
  otherwise OR over valid terms, AND over each term's requirements
  matchFields(metadata.name) is handled by interning the node name as a
  pseudo-label under the key "metadata.name" at node-encoding time.

Conservative-capacity note: S (requirements/term), V (values/requirement) and T
(terms) are sized to the max present in the compiled batch, rounded up to powers of
two (the reference's shape discipline); nothing is silently truncated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..api import objects as v1
from .dictionary import MISSING, Dictionary

from ..kernels.selectors import (  # noqa: F401  (the op codes live beside K23)
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_GT,
    OP_IN,
    OP_LT,
    OP_NOT_IN,
    OP_PAD,
    selector_match,
)

_OP_CODE = {
    v1.OP_IN: OP_IN,
    v1.OP_NOT_IN: OP_NOT_IN,
    v1.OP_EXISTS: OP_EXISTS,
    v1.OP_DOES_NOT_EXIST: OP_DOES_NOT_EXIST,
    v1.OP_GT: OP_GT,
    v1.OP_LT: OP_LT,
}


from .units import pow2_round_up as _round_up  # shared shape discipline


@dataclass
class CompiledLabelSelectors:
    """Batch of B compiled metav1.LabelSelectors, deduplicated to U unique rows.

    A scheduling batch's selectors repeat heavily (all pods of one deployment
    share one selector), so evaluation arrays hold only the U unique selectors
    and ``index`` i32[B] maps batch row → unique row.  Matrix evaluators run at
    U then expand — at 5k nodes this turned the dominant prepare cost into
    noise (the reference has no analog: it evaluates per (pod, node) pair in
    Go, labels.Selector.Matches).

    req_key  i32[U, S]; req_op i32[U, S]; req_vals i32[U, S, V]
    req_num  f32[U, S]  — numeric RHS for Gt/Lt (NaN when unparseable)
    match_none bool[U]  — True for the None selector (matches nothing)
    index    i32[B]
    has_numeric — any Gt/Lt op present (a plain Python flag that gates the
    numeric path).
    """

    req_key: np.ndarray
    req_op: np.ndarray
    req_vals: np.ndarray
    req_num: np.ndarray
    match_none: np.ndarray
    index: np.ndarray
    has_numeric: bool = False

    def __len__(self):
        return self.index.shape[0]


@dataclass
class CompiledNodeSelectors:
    """Batch of B compiled v1.NodeSelectors (terms OR, requirements AND),
    deduplicated like CompiledLabelSelectors.

    req_key i32[U, T, S]; req_op i32[U, T, S]; req_vals i32[U, T, S, V]
    req_num f32[U, T, S]; term_valid bool[U, T]; match_all bool[U]; index i32[B]
    """

    req_key: np.ndarray
    req_op: np.ndarray
    req_vals: np.ndarray
    req_num: np.ndarray
    term_valid: np.ndarray
    match_all: np.ndarray
    index: np.ndarray
    has_numeric: bool = False

    def __len__(self):
        return self.index.shape[0]


def _selector_requirements(sel: v1.LabelSelector):
    """Flatten matchLabels + matchExpressions into (key, op, values) triples."""
    reqs = []
    for k, val in sorted(sel.match_labels.items()):
        reqs.append((k, v1.OP_IN, [val]))
    for e in sel.match_expressions:
        reqs.append((e.key, e.operator, list(e.values)))
    return reqs


def compile_label_selectors(
    selectors: Sequence[Optional[v1.LabelSelector]],
    dic: Dictionary,
    min_s: int = 4,
    min_v: int = 4,
    min_u: int = 4,
) -> CompiledLabelSelectors:
    b = max(len(selectors), 1)
    req_lists = [
        _selector_requirements(s) if s is not None else None for s in selectors
    ]
    # dedup: canonical requirement tuple → unique row (order-insensitive AND)
    keys = [
        None if r is None
        else tuple(sorted((k, op, tuple(vals)) for (k, op, vals) in r))
        for r in req_lists
    ]
    uniq: dict = {}
    index = np.zeros(b, dtype=np.int32)
    for i, key in enumerate(keys):
        uid = uniq.get(key)
        if uid is None:
            uid = uniq[key] = len(uniq)
        index[i] = uid
    uniq_reqs = [None] * len(uniq)
    for i, key in enumerate(keys):
        uniq_reqs[uniq[key]] = req_lists[i] if key is not None else None
    u = _round_up(len(uniq), min_u)
    s_cap = _round_up(
        max((len(r) for r in uniq_reqs if r is not None), default=0), min_s
    )
    v_cap = _round_up(
        max((len(vals) for r in uniq_reqs if r is not None for (_, _, vals) in r),
            default=0),
        min_v,
    )
    req_key = np.full((u, s_cap), MISSING, dtype=np.int32)
    req_op = np.full((u, s_cap), OP_PAD, dtype=np.int32)
    req_vals = np.full((u, s_cap, v_cap), MISSING, dtype=np.int32)
    req_num = np.full((u, s_cap), np.nan, dtype=np.float32)
    match_none = np.zeros((u,), dtype=bool)
    match_none[len(uniq):] = True  # pad rows match nothing
    has_numeric = False
    for i, reqs in enumerate(uniq_reqs):
        if reqs is None:
            match_none[i] = True
            continue
        for j, (key, op, vals) in enumerate(reqs):
            req_key[i, j] = dic.intern(key)
            req_op[i, j] = _OP_CODE[op]
            has_numeric = has_numeric or op in (v1.OP_GT, v1.OP_LT)
            for k, val in enumerate(vals):
                req_vals[i, j, k] = dic.intern(val)
            if vals:
                try:
                    req_num[i, j] = float(int(vals[0]))
                except ValueError:
                    pass
    return CompiledLabelSelectors(
        req_key, req_op, req_vals, req_num, match_none, index, has_numeric
    )


def compile_node_selectors(
    selectors: Sequence[Optional[v1.NodeSelector]],
    dic: Dictionary,
    min_t: int = 2,
    min_s: int = 4,
    min_v: int = 4,
    min_u: int = 2,
) -> CompiledNodeSelectors:
    b = max(len(selectors), 1)
    all_terms: List[List[List]] = []
    for s in selectors:
        terms = []
        if s is not None:
            for t in s.node_selector_terms:
                reqs = [(e.key, e.operator, list(e.values)) for e in t.match_expressions]
                reqs += [
                    ("metadata.name" if e.key in ("metadata.name", "name") else e.key,
                     e.operator, list(e.values))
                    for e in t.match_fields
                ]
                terms.append(reqs)
        all_terms.append(terms)
    t_cap = _round_up(max((len(t) for t in all_terms), default=0), min_t)
    s_cap = _round_up(
        max((len(r) for terms in all_terms for r in terms), default=0), min_s
    )
    v_cap = _round_up(
        max(
            (len(vals) for terms in all_terms for reqs in terms for (_, _, vals) in reqs),
            default=0,
        ),
        min_v,
    )
    # dedup: canonical terms tuple → unique row (term order kept — OR of ANDs)
    keys = [
        None if selectors[i] is None
        else tuple(
            tuple(sorted((k, op, tuple(vals)) for (k, op, vals) in reqs))
            for reqs in all_terms[i]
        )
        for i in range(len(selectors))
    ]
    if not keys:
        keys = [None]
    uniq: dict = {}
    index = np.zeros(b, dtype=np.int32)
    for i, key in enumerate(keys):
        uid = uniq.get(key)
        if uid is None:
            uid = uniq[key] = len(uniq)
        index[i] = uid
    uniq_terms = [None] * len(uniq)
    for i, key in enumerate(keys):
        uniq_terms[uniq[key]] = all_terms[i] if key is not None else None
    u = _round_up(len(uniq), min_u)
    req_key = np.full((u, t_cap, s_cap), MISSING, dtype=np.int32)
    req_op = np.full((u, t_cap, s_cap), OP_PAD, dtype=np.int32)
    req_vals = np.full((u, t_cap, s_cap, v_cap), MISSING, dtype=np.int32)
    req_num = np.full((u, t_cap, s_cap), np.nan, dtype=np.float32)
    term_valid = np.zeros((u, t_cap), dtype=bool)
    match_all = np.zeros((u,), dtype=bool)
    has_numeric = False
    for i, terms in enumerate(uniq_terms):
        if terms is None:
            match_all[i] = True
            continue
        for ti, reqs in enumerate(terms):
            # Reference: an empty term matches nothing → leave term_valid False
            # only for terms with no requirements at all.
            term_valid[i, ti] = len(reqs) > 0
            for j, (key, op, vals) in enumerate(reqs):
                req_key[i, ti, j] = dic.intern(key)
                req_op[i, ti, j] = _OP_CODE[op]
                has_numeric = has_numeric or op in (v1.OP_GT, v1.OP_LT)
                for k, val in enumerate(vals):
                    req_vals[i, ti, j, k] = dic.intern(val)
                if vals:
                    try:
                        req_num[i, ti, j] = float(int(vals[0]))
                    except ValueError:
                        pass
    return CompiledNodeSelectors(
        req_key, req_op, req_vals, req_num, term_valid, match_all, index, has_numeric
    )


# --- device evaluation (K23; kernels/selectors.py) ----------------------------


def requirements_match_matrix(
    req_key, req_op, req_vals, req_num, keys, vals,
    vals_num=None, numeric=None, has_numeric: bool = True,
):
    """Batched requirement sets × batched label sets → bool match matrix.

    req_key/req_op [U, S]; req_vals [U, S, V]; req_num [U, S];
    keys/vals i32[O, L] (-1 padded); vals_num f32[O, L] — numeric parse of each
    label value (NaN unparseable), used for Gt/Lt.  When has_numeric is
    False the numeric path is skipped; when True and vals_num is None, the
    numbers come from the dictionary numeric side-table.  Returns
    bool[U, O].  Through K23 on the card, its plain version on the CPU."""
    u, s = req_key.shape
    return selector_match(
        req_key.reshape(u, 1, s), req_op.reshape(u, 1, s), req_vals.reshape(u, 1, s, -1),
        req_num.reshape(u, 1, s), None, None, None, keys, vals, vals_num=vals_num,
        numeric=numeric, has_numeric=has_numeric)


def label_match_matrix(
    cs: CompiledLabelSelectors, keys, vals, vals_num=None, numeric=None
):
    """Compiled selector batch (B rows, U unique) × label sets [O, L] → bool[B, O]."""
    u, s = cs.req_key.shape
    return selector_match(
        cs.req_key.reshape(u, 1, s), cs.req_op.reshape(u, 1, s),
        cs.req_vals.reshape(u, 1, s, -1), cs.req_num.reshape(u, 1, s), None, None,
        cs.match_none, keys, vals, vals_num=vals_num, numeric=numeric,
        has_numeric=cs.has_numeric, index=cs.index)


def node_match_matrix(
    cns: CompiledNodeSelectors, keys, vals, vals_num=None, numeric=None
):
    """Compiled NodeSelector batch (B rows, U unique) × label sets [O, L] →
    bool[B, O].  OR over valid terms, AND within a term; match_all rows → True."""
    return selector_match(
        cns.req_key, cns.req_op, cns.req_vals, cns.req_num, cns.term_valid,
        cns.match_all, None, keys, vals, vals_num=vals_num, numeric=numeric,
        has_numeric=cns.has_numeric, index=cns.index)
