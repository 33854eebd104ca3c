"""K5–K8, K14, K18: PodTopologySpread's domain count tables (CUDA:
csrc/spread.cu).

Replace the JAX package's plugins/podtopologyspread.py programs as the
identity-class dedup engine runs them, with the ops/segment.py domain
gathers and scatters they are built on (ROADMAP Queue B, B10 and B11):

  K5 spread_prepare_counts   ``prepare`` (:112-134): hard / soft counts per
                             domain of the scheduled pods the constraint
                             selectors match, and the present domains
  K6 spread_filter_bits      ``filter`` (:166-182) into K1's pass-bit plane
  K7 spread_score_combine    ``score`` (:186-215) + ``normalize`` (:217-232)
                             + the weighted floor into K2's total
  K8 spread_update_classes   ``update_batch_classes`` (:341-364), once per
                             auction round
  K14 spread_chain_prev      ``chain_prev`` (:306-339): a still-in-flight
                             batch's placements (deep pipeline), once per
                             chained batch before the rounds
  K18 spread_update_row      ``update`` (:287-304): one placed pod into the
                             full-batch tables, once per scan step

The full auction runs K6–K8 at one class row per pod (its ``update_batch``,
:366-388, is K8 at identity classes); the scan runs K6 and K7 on one row.

Tables are ``[C, Cc, D+1]`` int32 over the class rows C, the constraints
per pod Cc and the batch's domain bucket D plus the trash slot D of nodes
without the key.  Each wrapper takes its plain version for CPU tensors and
launches its kernel for CUDA tensors (raising if the launch fails).  The
plain versions here are the reference's arithmetic, with torch gathers and
scatter-adds in place of its one-hot einsums.

The score weight ``log(topo_size + 2)`` is read from ``TOPO_LOG``, never
computed: see ``topo_log_table``.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from ..ops.segment import domain_any, domain_gather, domain_scatter_add
from . import LAUNCHES, bind, ptr, require_cuda, require_dtype, stream_of
from .build import check, load

MAX_NODE_SCORE = 100.0
# the reference's "no present domain" minimum (podtopologyspread.py:38)
BIG = 2**30
# TOPO_LOG covers topo_size 0..TOPO_LOG_MAX; a batch's domain bucket (an
# upper bound on topo_size) beyond it is refused
TOPO_LOG_MAX = 8192
# the kernels keep one entry per constraint in registers / shared memory
MAX_CONSTRAINTS = 8

# (k + 2, ulps): where XLA:CPU's float32 log(k + 2) — the value the
# reference's score weight jnp.log(topo_size + 2.0) takes — differs from the
# correctly rounded float32 value, for k + 2 in 2..8194.  XLA:CPU's log is a
# polynomial approximation that is one ulp off at these 93 arguments (the
# first is 7: five spread domains), while torch.log and CUDA's logf round
# differently again.  One ulp of the weight moves round(cnt · w) at some
# counts (379 under five domains and maxSkew 1), so a naive log could give
# another score and another binding than the reference.  The table is
# therefore the correctly rounded value (float64 log, rounded once to
# float32) with these entries stepped by their ulps; tests/test_torch_spread.py
# regenerates it from jnp.log and requires every bit to match.
_XLA_LOG_ULPS = (
    (7, 1), (47, 1), (49, 1), (179, -1), (335, 1), (383, 1), (402, 1),
    (429, -1), (434, 1), (626, -1), (715, 1), (716, -1), (721, -1),
    (730, -1), (795, -1), (858, 1), (1166, 1), (1314, -1), (1333, 1),
    (1385, 1), (1423, 1), (1431, -1), (1433, 1), (1453, -1), (1469, 1),
    (1534, 1), (1562, 1), (1577, -1), (1579, -1), (1755, 1), (1781, -1),
    (1882, 1), (1917, -1), (1950, -1), (2315, -1), (2436, 1), (2481, -1),
    (2504, -1), (2526, 1), (2531, -1), (2777, 1), (2778, -1), (2845, 1),
    (2857, -1), (2860, 1), (2862, 1), (2864, -1), (2884, -1), (2891, -1),
    (2920, -1), (3100, 1), (3280, -1), (3399, 1), (3468, -1), (3625, 1),
    (3733, 1), (3771, 1), (3799, -1), (3828, -1), (4352, 1), (4471, -1),
    (4753, 1), (4935, 1), (5271, -1), (5305, -1), (5484, 1), (5658, -1),
    (5691, -1), (5739, 1), (5870, 1), (5904, 1), (5936, 1), (6077, 1),
    (6106, 1), (6184, 1), (6197, 1), (6256, 1), (6279, 1), (6344, -1),
    (6366, -1), (6406, -1), (6423, 1), (6521, 1), (6591, 1), (6749, 1),
    (6778, 1), (6781, 1), (6949, 1), (7112, 1), (7178, 1), (7241, -1),
    (7735, -1), (8075, 1),
)


@functools.lru_cache(maxsize=None)
def _topo_log_np() -> np.ndarray:
    table = np.array([math.log(k + 2) for k in range(TOPO_LOG_MAX + 1)],
                     dtype=np.float32)
    bits = table.view(np.int32)
    for arg, ulps in _XLA_LOG_ULPS:
        bits[arg - 2] += ulps
    return table


@functools.lru_cache(maxsize=None)
def _topo_log_on(device: str) -> torch.Tensor:
    return torch.from_numpy(_topo_log_np().copy()).to(device)


def topo_log_table(device="cpu") -> torch.Tensor:
    """f32[TOPO_LOG_MAX + 1]: entry k holds the bits XLA:CPU gives for
    float32 log(k + 2); uploaded once per device."""
    return _topo_log_on(str(torch.device(device)))


def check_domain_bucket(depth: int) -> None:
    """Refuse a domain axis whose topo_size could leave the TOPO_LOG table."""
    if depth > TOPO_LOG_MAX:
        raise NotImplementedError(
            f"a spread domain bucket of {depth} exceeds the {TOPO_LOG_MAX}-entry "
            "log table (hostname-keyed spread on more than ~8k nodes: ROADMAP "
            "Queue B B11)")


# --- K5 spread_prepare_counts ---------------------------------------------------


def spread_prepare_counts_plain(match_sched, pod_node, dom_val, counted_hard,
                                counted_soft, depth: int):
    """The plain torch version of the reference's per-node match count (its
    ``[C·Cc, P] × [P, N]`` one-hot matmul, here a scatter-add by pod node)
    and its domain scatters."""
    c, cc, p = match_sched.shape
    n = dom_val.shape[-1]
    node = pod_node.long().clamp(0, n - 1)
    hit = (match_sched & (pod_node >= 0)[None, None, :]).to(torch.int32)
    count_node = torch.zeros((c * cc, n), dtype=torch.int32, device=dom_val.device)
    count_node.scatter_add_(1, node[None, :].expand(c * cc, p), hit.reshape(c * cc, p))
    count_node = count_node.reshape(c, cc, n)

    def scatter(node_mask):
        vals = torch.where(node_mask[:, None, :], count_node, 0)
        return domain_scatter_add(vals, dom_val, depth + 1)

    hard_present = domain_any(counted_hard[:, None, :] & (dom_val < depth), dom_val,
                              depth + 1)
    return scatter(counted_hard), scatter(counted_soft), hard_present


def spread_prepare_counts(match_sched, pod_node, dom_val, counted_hard, counted_soft,
                          depth: int):
    """→ (hard_counts i32[C, Cc, D+1], soft_counts i32[C, Cc, D+1],
    hard_present bool[C, Cc, D+1]).  ``match_sched`` bool[C, Cc, P] already
    folds in the scheduled pods' validity.  CPU tensors take the plain
    version; CUDA tensors launch K5."""
    if not dom_val.is_cuda:
        return spread_prepare_counts_plain(match_sched, pod_node, dom_val,
                                           counted_hard, counted_soft, depth)
    c, cc, p = match_sched.shape
    n = dom_val.shape[-1]
    args = [t.contiguous() for t in (match_sched, pod_node, dom_val, counted_hard,
                                     counted_soft)]
    dev = require_cuda("spread_prepare_counts", *args)
    require_dtype("spread_prepare_counts", torch.bool, args[0], args[3], args[4])
    require_dtype("spread_prepare_counts", torch.int32, args[1], args[2])
    if args[1].shape != (p,) or args[2].shape != (c, cc, n) \
            or args[3].shape != (c, n) or args[4].shape != (c, n):
        raise ValueError("spread_prepare_counts: inconsistent shapes")
    hard = torch.zeros((c, cc, depth + 1), dtype=torch.int32, device=dev)
    soft = torch.zeros_like(hard)
    present = torch.zeros((c, cc, depth + 1), dtype=torch.bool, device=dev)
    err = _fn("launch_spread_prepare", "iiiii" + "p" * 8 + "p")(
        c, cc, p, n, depth + 1, *map(ptr, args), ptr(hard), ptr(soft), ptr(present),
        stream_of(dev))
    check(err, "spread_prepare_counts")
    LAUNCHES["spread_prepare_counts"] += 1
    return hard, soft, present


# --- K6 spread_filter_bits ------------------------------------------------------


def spread_filter_plane(aux, enable_min_domains: bool = True) -> torch.Tensor:
    """bool[C, N]: the reference's PodTopologySpread filter
    (podtopologyspread.py:166-182) — matchNum + selfMatch − globalMin ≤
    maxSkew for every hard constraint, and the node carries its key."""
    min_match = torch.where(aux.hard_present, aux.hard_counts,
                            BIG).amin(dim=-1)  # [C, Cc]
    if enable_min_domains:
        num_domains = aux.hard_present.sum(dim=-1)
        min_match = torch.where(
            (aux.min_domains > 0) & (num_domains < aux.min_domains), 0, min_match)
    match_num = domain_gather(aux.hard_counts, aux.dom_val)  # [C, Cc, N]
    skew = match_num + aux.self_match[:, :, None].to(torch.int32) \
        - min_match[:, :, None]
    ok_c = skew <= aux.max_skew[:, :, None]
    return (~aux.hard_valid[:, :, None] | (ok_c & aux.has_key)).all(dim=1)


def spread_filter_bits_plain(aux, bits, bit: int, enable_min_domains: bool = True):
    """The plain version: clear ``bit`` of ``bits`` (in place) where the
    filter fails."""
    fail = ~spread_filter_plane(aux, enable_min_domains)
    bits &= torch.where(fail, ~(1 << bit), -1).to(torch.int32)
    return bits


def spread_filter_bits(aux, bits, bit: int, enable_min_domains: bool = True):
    """Write PodTopologySpread's filter into the pass-bit plane ``bits``
    i32[C, N] in place: K1 seeds ``bit`` on every live node of a valid row
    (the filter's no-constraint plane); this clears it where a hard
    constraint fails or the node lacks its key.  CPU tensors take the plain
    version; CUDA tensors launch K6 once: the per-domain verdict in shared
    memory, a hostname-sized table (above 32 domains) split across a
    thread-block cluster of a row's blocks."""
    if not bits.is_cuda:
        return spread_filter_bits_plain(aux, bits, bit, enable_min_domains)
    c, cc, d1 = aux.hard_counts.shape
    n = bits.shape[1]
    if cc > MAX_CONSTRAINTS:
        raise ValueError(f"spread_filter_bits: more than {MAX_CONSTRAINTS} constraints")
    check_domain_bucket(d1 - 1)
    args = [t.contiguous() for t in (aux.hard_counts, aux.hard_present, aux.hard_valid,
                                     aux.max_skew, aux.min_domains, aux.self_match,
                                     aux.dom_val, aux.has_key)]
    if not bits.is_contiguous():
        raise ValueError("spread_filter_bits: bits must be contiguous (updated in place)")
    dev = require_cuda("spread_filter_bits", bits, *args)
    require_dtype("spread_filter_bits", torch.int32, bits, args[0], args[3], args[4],
                  args[6])
    require_dtype("spread_filter_bits", torch.bool, args[1], args[2], args[5], args[7])
    if bits.shape != (c, n) or args[6].shape != (c, cc, n):
        raise ValueError("spread_filter_bits: inconsistent shapes")
    err = _fn("launch_spread_filter", "iiii" + "p" * 8 + "iip" + "p")(
        c, cc, n, d1, *map(ptr, args), int(enable_min_domains), int(bit), ptr(bits),
        stream_of(dev))
    check(err, "spread_filter_bits")
    LAUNCHES["spread_filter_bits"] += 1
    return bits


# --- K7 spread_score_combine ----------------------------------------------------


def spread_raw_plane(aux, mask=None) -> torch.Tensor:
    """f32[C, N]: the reference's raw PodTopologySpread score
    (podtopologyspread.py:186-215), NaN on ignored nodes.  The constraint
    terms are summed in constraint order, as the kernel does."""
    d = aux.soft_counts.shape[-1] - 1
    if mask is None:
        mask = torch.ones(aux.counted_soft.shape, dtype=torch.bool,
                          device=aux.dom_val.device)
    ignored = ~(~aux.soft_valid[:, :, None] | aux.has_key).all(dim=1)  # [C, N]
    scored = mask & ~ignored
    soft_present = domain_any(scored[:, None, :] & (aux.dom_val < d), aux.dom_val, d + 1)
    topo_size = soft_present[..., :d].sum(dim=-1)  # [C, Cc]
    tp_weight = topo_log_table(aux.dom_val.device)[topo_size.long()]
    counts = domain_gather(aux.soft_counts, aux.dom_val)
    in_present = domain_gather(soft_present, aux.dom_val)
    per_c = counts.to(torch.float32) * tp_weight[:, :, None] \
        + (aux.max_skew[:, :, None].to(torch.float32) - 1.0)
    terms = torch.where(aux.soft_valid[:, :, None] & aux.has_key & in_present,
                        per_c, 0.0)
    acc = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    for cc in range(terms.shape[1]):
        acc = acc + terms[:, cc]
    raw = torch.round(acc)  # half to even, as jnp.round
    has_soft = aux.soft_valid.any(dim=1)[:, None]
    return torch.where(has_soft & ~scored, float("nan"),
                       torch.where(has_soft, raw, 0.0))


def spread_normalize(scores, mask) -> torch.Tensor:
    """100·(max+min−s)/max over scored nodes; NaN (ignored) → 0
    (podtopologyspread.py:217-232, scoring.go NormalizeScore)."""
    valid = mask & ~torch.isnan(scores)
    mx = torch.where(valid, scores, float("-inf")).amax(dim=-1, keepdim=True)
    mn = torch.where(valid, scores, float("inf")).amin(dim=-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    mn = torch.where(torch.isfinite(mn), mn, 0.0)
    out = torch.where(
        mx == 0, MAX_NODE_SCORE,
        MAX_NODE_SCORE * (mx + mn - scores) / torch.where(mx == 0, 1.0, mx))
    return torch.where(valid, out, 0.0)


def spread_score_combine_plain(aux, bits, full: int, total, weight: float):
    """The plain version: total += weight · floor(normalize(score)) (in
    place; off the mask the total is −inf and the term is 0)."""
    mask = bits == full
    norm = spread_normalize(spread_raw_plane(aux, mask), mask)
    total += float(weight) * torch.floor(norm)
    return total


def spread_score_combine(aux, bits, full: int, total, weight: float):
    """Add PodTopologySpread's weighted, floored, normalized score into K2's
    total f32[C, N] in place; the feasibility mask is "all bits of ``bits``
    set".  CPU tensors take the plain version; CUDA tensors launch K7 once
    (a row over a thread-block cluster at small C)."""
    if not bits.is_cuda:
        return spread_score_combine_plain(aux, bits, full, total, weight)
    c, cc, d1 = aux.soft_counts.shape
    n = bits.shape[1]
    if cc > MAX_CONSTRAINTS:
        raise ValueError(f"spread_score_combine: more than {MAX_CONSTRAINTS} constraints")
    check_domain_bucket(d1 - 1)
    table = topo_log_table(bits.device)
    args = [t.contiguous() for t in (bits, aux.soft_counts, aux.soft_valid,
                                     aux.max_skew, aux.dom_val, aux.has_key)]
    if not total.is_contiguous():
        raise ValueError("spread_score_combine: total must be contiguous (updated in place)")
    dev = require_cuda("spread_score_combine", total, table, *args)
    require_dtype("spread_score_combine", torch.int32, args[0], args[1], args[3], args[4])
    require_dtype("spread_score_combine", torch.bool, args[2], args[5])
    require_dtype("spread_score_combine", torch.float32, total)
    if total.shape != (c, n) or args[4].shape != (c, cc, n):
        raise ValueError("spread_score_combine: inconsistent shapes")
    err = _fn("launch_spread_score", "iiiipi" + "p" * 5 + "pif" + "p" + "p")(
        c, cc, n, d1, ptr(args[0]), int(full), *map(ptr, args[1:]), ptr(table),
        table.shape[0], float(weight), ptr(total), stream_of(dev))
    check(err, "spread_score_combine")
    LAUNCHES["spread_score_combine"] += 1
    return total


# --- K8 spread_update_classes ---------------------------------------------------


def spread_update_classes_plain(aux, commit, choice, class_of) -> Tuple:
    """The plain version, as the reference computes it: the commits' class
    one-hot ``u_c`` f32[Cp, N], ``einsum(match_pending, u_c)``, then the
    domain scatters; added into the tables in place."""
    c, cc, cp = aux.match_pending.shape
    n = aux.dom_val.shape[-1]
    d1 = aux.hard_counts.shape[-1]
    u_c = torch.zeros((cp, n), dtype=torch.float32, device=aux.dom_val.device)
    u_c.index_put_((class_of.long(), choice.long().clamp(0, n - 1)),
                   commit.to(torch.float32), accumulate=True)
    contrib = torch.einsum("bck,kn->bcn", aux.match_pending.to(torch.float32), u_c)
    hard_inc = domain_scatter_add(contrib * aux.counted_hard[:, None, :], aux.dom_val, d1)
    soft_inc = domain_scatter_add(contrib * aux.counted_soft[:, None, :], aux.dom_val, d1)
    aux.hard_counts.add_(hard_inc.to(torch.int32))
    aux.soft_counts.add_(soft_inc.to(torch.int32))
    return aux.hard_counts, aux.soft_counts


def spread_update_classes(aux, commit, choice, class_of) -> Tuple:
    """Add one auction round's commits (``commit`` bool[B], ``choice``
    i32[B] node rows, ``class_of`` [B] integer class rows) into the
    class tables ``aux.hard_counts`` / ``aux.soft_counts`` in place: each
    committed pod counts for every (class row, constraint) whose selector
    matches its class and whose counted nodes include its node.  CPU
    tensors take the plain version; CUDA tensors launch K8 once, with no
    copy of the path's inputs (int64 ``class_of``, as the engines pass it;
    another integer dtype is widened first): a thread a (pod, row), the
    pod's inputs, then the row's match byte and node bytes, then the adds
    (a warp's adds to one domain summed first) — O(B · C · Cc) instead of
    the reference's O(C · Cc · N)."""
    if not commit.is_cuda:
        return spread_update_classes_plain(aux, commit, choice, class_of)
    c, cc, cp = aux.match_pending.shape
    b = commit.shape[0]
    n = aux.dom_val.shape[-1]
    d1 = aux.hard_counts.shape[-1]
    args = [commit.contiguous(), choice.to(torch.int32).contiguous(),
            class_of.to(torch.int64).contiguous()]
    args += [t.contiguous() for t in (aux.match_pending, aux.counted_hard,
                                      aux.counted_soft, aux.dom_val)]
    for t in (aux.hard_counts, aux.soft_counts):
        if not t.is_contiguous():
            raise ValueError("spread_update_classes: tables must be contiguous "
                             "(updated in place)")
    dev = require_cuda("spread_update_classes", *args, aux.hard_counts, aux.soft_counts)
    require_dtype("spread_update_classes", torch.bool, args[0], args[3], args[4], args[5])
    require_dtype("spread_update_classes", torch.int32, args[6], aux.hard_counts,
                  aux.soft_counts)
    if args[1].shape != (b,) or args[2].shape != (b,) or args[6].shape != (c, cc, n) \
            or aux.soft_counts.shape != (c, cc, d1):
        raise ValueError("spread_update_classes: inconsistent shapes")
    err = _fn("launch_spread_update", "iiiiii" + "p" * 7 + "pp" + "p")(
        b, c, cc, cp, n, d1, *map(ptr, args), ptr(aux.hard_counts),
        ptr(aux.soft_counts), stream_of(dev))
    check(err, "spread_update_classes")
    LAUNCHES["spread_update_classes"] += 1
    return aux.hard_counts, aux.soft_counts


# --- K14 spread_chain_prev ------------------------------------------------------


def spread_chain_prev_plain(aux, match, rows, valid) -> Tuple:
    """The plain version, as the reference computes it: the placed prev
    pods' matches gated by their node's counted flags, scattered into the
    domains of their nodes (trash slot included), added to copies of the
    tables."""
    n = aux.dom_val.shape[-1]
    d1 = aux.hard_counts.shape[-1]
    placed = (rows >= 0) & valid
    at = rows.long().clamp(0, n - 1)
    m = match & placed[None, None, :]
    dom_at = aux.dom_val[:, :, at]  # [C, Cc, B0]
    inc_h = domain_scatter_add(m & aux.counted_hard[:, at][:, None, :], dom_at, d1)
    inc_s = domain_scatter_add(m & aux.counted_soft[:, at][:, None, :], dom_at, d1)
    return aux.hard_counts + inc_h, aux.soft_counts + inc_s


def spread_chain_prev(aux, match, rows, valid) -> Tuple:
    """→ (hard_counts, soft_counts) i32[C, Cc, D+1]: new tables with a
    still-in-flight batch's placed pods counted.  ``match`` bool[C, Cc, B0]:
    constraint (c, cc)'s selector matches prev pod j (same namespace);
    ``rows`` i32[B0] the prev pods' node rows (< 0 = not placed); ``valid``
    bool[B0].  CPU tensors take the plain version; CUDA tensors copy the
    tables and launch K14."""
    if not rows.is_cuda:
        return spread_chain_prev_plain(aux, match, rows, valid)
    c, cc, d1 = aux.hard_counts.shape
    b0 = rows.shape[0]
    n = aux.dom_val.shape[-1]
    args = [(match & valid[None, None, :]).contiguous(), rows.to(torch.int32).contiguous()]
    args += [t.contiguous() for t in (aux.counted_hard, aux.counted_soft, aux.dom_val)]
    hard = aux.hard_counts.clone(memory_format=torch.contiguous_format)
    soft = aux.soft_counts.clone(memory_format=torch.contiguous_format)
    dev = require_cuda("spread_chain_prev", *args, hard, soft)
    require_dtype("spread_chain_prev", torch.bool, args[0], args[2], args[3])
    require_dtype("spread_chain_prev", torch.int32, args[1], args[4], hard, soft)
    if args[0].shape != (c, cc, b0) or args[4].shape != (c, cc, n) \
            or args[2].shape != (c, n) or soft.shape != (c, cc, d1):
        raise ValueError("spread_chain_prev: inconsistent shapes")
    err = _fn("launch_spread_chain", "iiiii" + "p" * 5 + "pp" + "p")(
        b0, c, cc, n, d1, *map(ptr, args), ptr(hard), ptr(soft), stream_of(dev))
    check(err, "spread_chain_prev")
    LAUNCHES["spread_chain_prev"] += 1
    return hard, soft


# --- K18 spread_update_row -------------------------------------------------------


def spread_update_row_plain(aux, i: int, node_row):
    """The plain version of the reference's ``update`` (podtopologyspread.py
    :287-304) with no read on the host: pod i at node ``node_row`` (an
    i32[1] tensor; below 0 nothing changes) counts for every (pending pod,
    constraint) whose selector matches it, at the node's domain (the trash
    slot for a keyless node), where the node counts for that pod; added into
    the tables in place."""
    n = aux.dom_val.shape[-1]
    node = node_row.reshape(1).long()
    at = node.clamp(0, n - 1)
    dom_at = aux.dom_val.index_select(2, at)  # [B, Cc, 1]
    hit = aux.match_pending[:, :, i:i + 1] & (node >= 0)  # [B, Cc, 1]
    for table, counted in ((aux.hard_counts, aux.counted_hard),
                           (aux.soft_counts, aux.counted_soft)):
        inc = hit & counted.index_select(1, at)[:, None, :]
        table.scatter_add_(-1, dom_at.long(), inc.to(table.dtype))
    return aux.hard_counts, aux.soft_counts


def spread_update_row(aux, i: int, node_row):
    """Add pod i, placed at ``node_row`` (i32[1] on the device, written there
    by K17; below 0: not placed), into the full-batch tables
    ``aux.hard_counts`` / ``aux.soft_counts`` in place.  CPU tensors take
    the plain version; CUDA tensors launch K18, one thread per (pending
    pod, constraint): the node, then one round trip (the match byte, the
    node's domain and counted flags) and an add that waits on nothing."""
    if not node_row.is_cuda:
        return spread_update_row_plain(aux, i, node_row)
    b, cc, bp = aux.match_pending.shape
    n = aux.dom_val.shape[-1]
    d1 = aux.hard_counts.shape[-1]
    ins = [node_row, aux.match_pending, aux.counted_hard, aux.counted_soft, aux.dom_val]
    dev = require_cuda("spread_update_row", *ins, aux.hard_counts, aux.soft_counts)
    require_dtype("spread_update_row", torch.bool, *ins[1:4])
    require_dtype("spread_update_row", torch.int32, node_row, aux.dom_val,
                  aux.hard_counts, aux.soft_counts)
    if node_row.numel() != 1 or aux.dom_val.shape != (b, cc, n) \
            or aux.counted_hard.shape != (b, n) or aux.soft_counts.shape != (b, cc, d1) \
            or not 0 <= i < bp:
        raise ValueError("spread_update_row: inconsistent shapes")
    err = _fn("launch_spread_update_row", "iiiiii" + "p" * 5 + "pp" + "p")(
        b, cc, bp, n, d1, int(i), ptr(node_row), *map(ptr, ins[1:]), ptr(aux.hard_counts),
        ptr(aux.soft_counts), stream_of(dev))
    check(err, "spread_update_row")
    LAUNCHES["spread_update_row"] += 1
    return aux.hard_counts, aux.soft_counts


_FNS = {}


def _fn(name: str, spec: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = bind(load("spread"), name, spec)
    return fn
