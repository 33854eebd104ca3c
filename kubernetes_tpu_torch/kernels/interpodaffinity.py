"""K9–K12, K15, K19: InterPodAffinity's count planes and tables (CUDA:
csrc/interpodaffinity.cu).

Replace the JAX package's plugins/interpodaffinity.py programs as the
identity-class dedup engine runs them, with the ops/segment.py domain
gathers and scatters they are built on (ROADMAP Queue B, B10 and B12):

  K9  ipa_prepare_counts     ``prepare`` (:197-278) with ``_counts``
      ipa_existing_planes    (:166-195): per-domain counts of the scheduled
                             pods each term matches (pass 1), gathered per
                             node where the counts are planes (pass 2); and
                             the expansion of the existing-pod affinity
                             index into the block and static score planes
                             (:280-321, pass 3)
  K10 ipa_filter_bits        ``filter`` (:337-364) into K1's pass-bit plane:
                             a run of ``FILTER_RUN`` nodes a thread, every
                             load at entry (the bits only where a block
                             fails, without a required term), a store only
                             where a bit clears
  K11 ipa_score_combine      ``score`` (:368-385) + ``normalize`` (:387-398)
                             + the weighted floor into K2's total, one
                             pass: at most 16 rows a row over a cluster of
                             up to 8 blocks, one block a row above that
  K12 ipa_update_classes     ``update_batch_classes`` (:676-764), once per
                             auction round, every present term group in
                             one launch
  K15 ipa_chain_prev         ``chain_prev`` (:533-670): a still-in-flight
                             batch's placements (deep pipeline) — this
                             batch's terms against the prev pods' labels
                             into the counts, and the prev pods' own terms
                             into ``block_dyn`` / ``score_dyn``
  K19 ipa_update_row         ``update`` (:447-530): one placed pod into the
                             full-batch count state and dynamic planes,
                             once per scan step

The full auction runs K10–K12 at one class row per pod (its
``update_batch``, :766-864, is K12 at identity classes); the scan runs
K10 and K11 on one row.

The count state has the reference's two forms (the plugin's
``_use_planes``): per-node planes ``[C, T, N]`` when the batch's domain
bucket D is dense (hostname keys), per-domain tables ``[C, T, D+1]``
otherwise; the last table slot D is the trash slot of nodes without the
key.  A count tensor is a plane exactly when its last axis is the node
axis (D + 1 is odd, the node tier a power of two).  Each wrapper takes its
plain version for CPU tensors and launches its kernel for CUDA tensors
(raising if the launch fails).

Every score term is an integer-valued float32 below 2^24 (counts times
integer weights), so sums are exact in any order.  The one float step that
rounds is the normalization, which the kernel spells
``__fdiv_rn(__fmul_rn(100, s − min), max − min)`` in the reference's
order: a reciprocal ``(s − min) · (100 / diff)`` or ``((s − min) / diff) ·
100`` flips the floor at some diffs (97 and 100 among them).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..framework.podbatch import AFFINITY_GROUPS
from ..ops.segment import domain_gather, domain_scatter_add
from . import LAUNCHES, bind, ptr, require_cuda, require_dtype, stream_of
from .build import check, load

MAX_NODE_SCORE = 100.0
# the affinity index's group kinds (state/affinity_index.py)
KIND_BLOCK = 0
KIND_SCORE_REQ = 2
# K15 keeps one int per domain of a row in shared memory
MAX_SHARED_DOMAINS = (227 * 1024) // 4 - 64
# K19 stages pod i's same-domain bits (2 bytes a thread of 256) and each
# pending row's flags for every term of the four groups in shared memory
MAX_ROW_TERMS = 400

# each term group's (domain, count state) fields of the aux
GROUP_FIELDS = {
    "req_affinity": ("dom_aff", "aff_cnt"),
    "req_anti_affinity": ("dom_anti", "anti_cnt"),
    "pref_affinity": ("dom_paff", "paff_cnt"),
    "pref_anti_affinity": ("dom_panti", "panti_cnt"),
}


def read_counts(cnt: torch.Tensor, dom: torch.Tensor) -> torch.Tensor:
    """Per-node counts ``[..., N]`` from either count form (the reference's
    ``_read_cnt``)."""
    if cnt.shape[-1] == dom.shape[-1]:
        return cnt
    return domain_gather(cnt, dom)


def _is_planes(cnt: torch.Tensor, n: int) -> bool:
    return cnt.shape[-1] == n


# --- K9 ipa_prepare_counts / ipa_existing_planes -------------------------------------


def ipa_prepare_counts_plain(match, pod_node, pod_valid, dom, depth: int, planes: bool):
    """The plain version of the reference's ``_counts`` (its ``[C·T, P] ×
    [P, N]`` one-hot matmul, here a scatter-add by pod node) and the domain
    scatter / gather around it."""
    c, t, p = match.shape
    n = dom.shape[-1]
    ok = match & pod_valid[None, None, :] & (pod_node >= 0)[None, None, :]
    node = pod_node.long().clamp(0, n - 1)
    count_node = torch.zeros((c * t, n), dtype=torch.int32, device=dom.device)
    count_node.scatter_add_(1, node[None, :].expand(c * t, p),
                            ok.reshape(c * t, p).to(torch.int32))
    tbl = domain_scatter_add(count_node.reshape(c, t, n), dom, depth + 1)
    total = tbl[..., :depth].sum(dim=(1, 2), dtype=torch.int32)
    return (domain_gather(tbl, dom) if planes else tbl), total


def ipa_prepare_counts(match, pod_node, pod_valid, dom, depth: int, planes: bool):
    """→ (counts i32 — planes [C, T, N] or tables [C, T, D+1] —, the tables'
    mass without the trash slot i32[C]).  ``match`` bool[C, T, P]: term
    (c, t) matches scheduled pod p.  CPU tensors take the plain version;
    CUDA tensors launch K9's count pass and, for planes, its gather pass."""
    if not dom.is_cuda:
        return ipa_prepare_counts_plain(match, pod_node, pod_valid, dom, depth, planes)
    c, t, p = match.shape
    n = dom.shape[-1]
    args = [x.contiguous() for x in (match, pod_node, pod_valid, dom)]
    dev = require_cuda("ipa_prepare_counts", *args)
    require_dtype("ipa_prepare_counts", torch.bool, args[0], args[2])
    require_dtype("ipa_prepare_counts", torch.int32, args[1], args[3])
    if args[1].shape != (p,) or args[2].shape != (p,) or args[3].shape != (c, t, n):
        raise ValueError("ipa_prepare_counts: inconsistent shapes")
    tbl = torch.zeros((c, t, depth + 1), dtype=torch.int32, device=dev)
    total = torch.zeros((c,), dtype=torch.int32, device=dev)
    err = _fn("launch_ipa_count", "iiiii" + "p" * 6 + "p")(
        c, t, p, n, depth + 1, *map(ptr, args), ptr(tbl), ptr(total), stream_of(dev))
    check(err, "ipa_prepare_counts (count pass)")
    LAUNCHES["ipa_prepare"] += 1
    if not planes:
        return tbl, total
    plane = torch.empty((c, t, n), dtype=torch.int32, device=dev)
    err = _fn("launch_ipa_gather", "iii" + "ppp" + "p")(
        c * t, n, depth + 1, ptr(tbl), ptr(args[3]), ptr(plane), stream_of(dev))
    check(err, "ipa_prepare_counts (gather pass)")
    LAUNCHES["ipa_prepare"] += 1
    return plane, total


def ipa_existing_planes_plain(match_g, aff_counts, aff_slot, aff_valid, aff_kind,
                              aff_weight, node_topo, hard_weight: float):
    """The reference's expansion of the existing-pod group tables
    (interpodaffinity.py:292-321): per-group owner counts at each node's
    domain, then the block plane (a matched BLOCK group with an owner) and
    the static score plane (Σ_g match · weight · count)."""
    k_cap = node_topo.shape[1]
    dwidth = aff_counts.shape[1]
    slot = aff_slot.long().clamp(0, k_cap - 1)
    dom_g = node_topo[:, slot].t()  # [G, N]
    has = (dom_g != -1) & aff_valid[:, None] & (aff_slot >= 0)[:, None] & (dom_g < dwidth)
    cnt = domain_gather(aff_counts, torch.where(has, dom_g.clamp(0, dwidth - 1), 0))
    cnt = torch.where(has, cnt, 0.0)  # f32[G, N]
    mb = (match_g & (aff_kind == KIND_BLOCK)[:, None]).to(torch.float32)
    block = torch.einsum("gb,gn->bn", mb, (cnt > 0.5).to(torch.float32)) > 0.5
    w = torch.where(aff_kind == KIND_SCORE_REQ, float(hard_weight), aff_weight)
    ms = (match_g & (aff_kind != KIND_BLOCK)[:, None]).to(torch.float32) * w[:, None]
    return block, torch.einsum("gb,gn->bn", ms, cnt)


def ipa_existing_planes(match_g, aff_counts, aff_slot, aff_valid, aff_kind, aff_weight,
                        node_topo, hard_weight: float):
    """→ (exist_anti_block bool[C, N], score_static f32[C, N]) from the
    index's group tables (``aff_*``, G groups) and the batch's host match
    matrix ``match_g`` bool[G, C].  CPU tensors take the plain version;
    CUDA tensors launch K9's existing-pod pass."""
    if not node_topo.is_cuda:
        return ipa_existing_planes_plain(match_g, aff_counts, aff_slot, aff_valid,
                                         aff_kind, aff_weight, node_topo, hard_weight)
    g, c = match_g.shape
    n, k = node_topo.shape
    dw = aff_counts.shape[1]
    args = [x.contiguous() for x in (match_g, aff_counts, aff_slot, aff_valid, aff_kind,
                                     aff_weight, node_topo)]
    dev = require_cuda("ipa_existing_planes", *args)
    require_dtype("ipa_existing_planes", torch.bool, args[0], args[3])
    require_dtype("ipa_existing_planes", torch.float32, args[1], args[5])
    require_dtype("ipa_existing_planes", torch.int32, args[2], args[4], args[6])
    if args[1].shape[0] != g or args[2].shape != (g,) or args[3].shape != (g,) \
            or args[4].shape != (g,) or args[5].shape != (g,):
        raise ValueError("ipa_existing_planes: inconsistent shapes")
    block = torch.empty((c, n), dtype=torch.bool, device=dev)
    score = torch.empty((c, n), dtype=torch.float32, device=dev)
    err = _fn("launch_ipa_existing", "iiiii" + "p" * 7 + "f" + "pp" + "p")(
        g, c, n, k, dw, *map(ptr, args), float(hard_weight), ptr(block), ptr(score),
        stream_of(dev))
    check(err, "ipa_existing_planes")
    LAUNCHES["ipa_prepare"] += 1
    return block, score


# --- K10 ipa_filter_bits ------------------------------------------------------------


def ipa_filter_plane(aux) -> torch.Tensor:
    """bool[C, N]: the reference's InterPodAffinity filter
    (interpodaffinity.py:337-364) — every required-affinity term keyed and
    matched in the node's domain (or the first pod of a series), no
    required-anti-affinity match in the node's domain, no existing pod's
    anti-affinity block, no block from this cycle's commits."""
    d = aux.depth
    ok = torch.ones(aux.exist_anti_block.shape, dtype=torch.bool,
                    device=aux.exist_anti_block.device)
    if "req_affinity" in aux.present:
        v = aux.req_aff_valid[:, :, None]
        cnt = read_counts(aux.aff_cnt, aux.dom_aff)
        keys_all = (~v | (aux.dom_aff < d)).all(dim=1)
        pods_exist = (~v | (cnt > 0)).all(dim=1)
        first_pod = (aux.aff_total == 0) & aux.self_match_all
        ok = keys_all & (pods_exist | first_pod[:, None])
    if "req_anti_affinity" in aux.present:
        # an invalid term's domain is the trash slot D (the plugin's
        # _group_arrays), so ``dom < d`` carries the term's validity
        acnt = read_counts(aux.anti_cnt, aux.dom_anti)
        ok = ok & ~((aux.dom_anti < d) & (acnt > 0)).any(dim=1)
    return ok & ~aux.exist_anti_block & ~aux.block_dyn


def ipa_filter_bits_plain(aux, bits, bit: int):
    """The plain version: clear ``bit`` of ``bits`` (in place) where the
    filter fails."""
    fail = ~ipa_filter_plane(aux)
    bits &= torch.where(fail, ~(1 << bit), -1).to(torch.int32)
    return bits


# K10's run: the nodes of a row one thread owns (csrc/interpodaffinity.cu)
FILTER_RUN = 4


def ipa_filter_bits(aux, bits, bit: int):
    """Write InterPodAffinity's filter into the pass-bit plane ``bits``
    i32[C, N] in place: K1 seeds ``bit`` on every live node of a valid row
    (the filter's plane with no aux); this clears it where the filter fails.
    CPU tensors take the plain version; CUDA tensors launch K10 — one
    launch, and no other device work where the aux's arrays are contiguous
    (as the plugin builds them)."""
    if not bits.is_cuda:
        return ipa_filter_bits_plain(aux, bits, bit)
    c, n = bits.shape
    d = aux.depth
    aff = "req_affinity" in aux.present
    anti = "req_anti_affinity" in aux.present
    if not bits.is_contiguous():
        raise ValueError("ipa_filter_bits: bits must be contiguous (updated in place)")
    fixed = [x.contiguous() for x in (aux.exist_anti_block, aux.block_dyn)]
    t1 = aux.dom_aff.shape[1]
    t2 = aux.dom_anti.shape[1]
    aff_args = [x.contiguous() for x in (aux.req_aff_valid, aux.dom_aff, aux.aff_cnt,
                                         aux.aff_total, aux.self_match_all)] if aff else []
    anti_args = [x.contiguous() for x in (aux.dom_anti, aux.anti_cnt)] if anti else []
    dev = require_cuda("ipa_filter_bits", bits, *fixed, *aff_args, *anti_args)
    require_dtype("ipa_filter_bits", torch.int32, bits)
    require_dtype("ipa_filter_bits", torch.bool, *fixed)
    if fixed[0].shape != (c, n) or fixed[1].shape != (c, n):
        raise ValueError("ipa_filter_bits: inconsistent shapes")
    if aff:
        require_dtype("ipa_filter_bits", torch.bool, aff_args[0], aff_args[4])
        require_dtype("ipa_filter_bits", torch.int32, *aff_args[1:4])
        if aff_args[1].shape != (c, t1, n) or aff_args[0].shape != (c, t1):
            raise ValueError("ipa_filter_bits: inconsistent affinity shapes")
    if anti:
        require_dtype("ipa_filter_bits", torch.int32, *anti_args)
        if anti_args[0].shape != (c, t2, n):
            raise ValueError("ipa_filter_bits: inconsistent anti-affinity shapes")
    w1 = aux.aff_cnt.shape[-1]
    w2 = aux.anti_cnt.shape[-1]
    a = [ptr(x) for x in aff_args] if aff else [0] * 5
    b = [ptr(x) for x in anti_args] if anti else [0] * 2
    err = _fn("launch_ipa_filter", "iiii" + "ii" + "ppppp" + "ii" + "pp" + "pp" + "p" + "p")(
        c, n, d, int(bit), t1, w1, *a, t2, w2, *b, ptr(fixed[0]), ptr(fixed[1]),
        ptr(bits), stream_of(dev))
    check(err, "ipa_filter_bits")
    LAUNCHES["ipa_filter_bits"] += 1
    return bits


# --- K11 ipa_score_combine ----------------------------------------------------------


def ipa_raw_plane(aux) -> torch.Tensor:
    """f32[C, N]: the reference's raw InterPodAffinity score
    (interpodaffinity.py:368-385): ±weight · count over the pod's preferred
    terms in the node's domain, plus the existing pods' static score and
    this cycle's commits' score."""
    d = aux.depth
    own = 0.0
    if "pref_affinity" in aux.present:
        c_paff = read_counts(aux.paff_cnt, aux.dom_paff)
        own = own + torch.where(aux.dom_paff < d, c_paff * aux.paff_weight[:, :, None],
                                0.0).sum(dim=1)
    if "pref_anti_affinity" in aux.present:
        c_panti = read_counts(aux.panti_cnt, aux.dom_panti)
        own = own - torch.where(aux.dom_panti < d, c_panti * aux.panti_weight[:, :, None],
                                0.0).sum(dim=1)
    return own + aux.score_static + aux.score_dyn


def ipa_normalize(scores, mask) -> torch.Tensor:
    """100·(s−min)/(max−min) over feasible nodes, 0 where max = min or no
    node is feasible (interpodaffinity.py:387-398, scoring.go NormalizeScore)."""
    mx = torch.where(mask, scores, float("-inf")).amax(dim=-1, keepdim=True)
    mn = torch.where(mask, scores, float("inf")).amin(dim=-1, keepdim=True)
    diff = mx - mn
    ok = torch.isfinite(diff) & (diff > 0)
    return torch.where(
        ok & mask, MAX_NODE_SCORE * (scores - torch.where(ok, mn, 0.0))
        / torch.where(ok, diff, 1.0), 0.0)


def ipa_score_combine_plain(aux, bits, full: int, total, weight: float):
    """The plain version: total += weight · floor(normalize(score)) (in
    place; off the mask the total is −inf and the term is 0)."""
    mask = bits == full
    total += float(weight) * torch.floor(ipa_normalize(ipa_raw_plane(aux), mask))
    return total


def ipa_score_combine(aux, bits, full: int, total, weight: float):
    """Add InterPodAffinity's weighted, floored, normalized score into K2's
    total f32[C, N] in place; the feasibility mask is "all bits of ``bits``
    set".  CPU tensors take the plain version; CUDA tensors launch K11
    once: each thread computes its nodes' raw scores once and keeps them in
    registers, the row's max and min reduce as a pair (at most 16 rows
    across a thread-block cluster of up to 8 blocks a row), and the total
    is written from the registers."""
    if not bits.is_cuda:
        return ipa_score_combine_plain(aux, bits, full, total, weight)
    c, n = bits.shape
    paff = "pref_affinity" in aux.present
    panti = "pref_anti_affinity" in aux.present
    if not total.is_contiguous():
        raise ValueError("ipa_score_combine: total must be contiguous (updated in place)")
    fixed = [x.contiguous() for x in (bits, aux.score_static, aux.score_dyn)]
    pa = [x.contiguous() for x in (aux.dom_paff, aux.paff_cnt, aux.paff_weight)] if paff else []
    pn = [x.contiguous() for x in (aux.dom_panti, aux.panti_cnt, aux.panti_weight)] \
        if panti else []
    dev = require_cuda("ipa_score_combine", total, *fixed, *pa, *pn)
    require_dtype("ipa_score_combine", torch.int32, fixed[0])
    require_dtype("ipa_score_combine", torch.float32, total, fixed[1], fixed[2])
    for grp in (pa, pn):
        if grp:
            require_dtype("ipa_score_combine", torch.int32, grp[0], grp[1])
            require_dtype("ipa_score_combine", torch.float32, grp[2])
            if grp[0].shape[0] != c or grp[0].shape[2] != n:
                raise ValueError("ipa_score_combine: inconsistent term shapes")
    if total.shape != (c, n) or fixed[1].shape != (c, n) or fixed[2].shape != (c, n):
        raise ValueError("ipa_score_combine: inconsistent shapes")
    t3, w3 = aux.dom_paff.shape[1], aux.paff_cnt.shape[-1]
    t4, w4 = aux.dom_panti.shape[1], aux.panti_cnt.shape[-1]
    a = [ptr(x) for x in pa] if paff else [0] * 3
    b = [ptr(x) for x in pn] if panti else [0] * 3
    err = _fn("launch_ipa_score", "iiii" + "p" + "ii" + "ppp" + "ii" + "ppp" + "pp" + "f"
              + "p" + "p")(
        c, n, aux.depth, int(full), ptr(fixed[0]), t3, w3, *a, t4, w4, *b,
        ptr(fixed[1]), ptr(fixed[2]), float(weight), ptr(total), stream_of(dev))
    check(err, "ipa_score_combine")
    LAUNCHES["ipa_score_combine"] += 1
    return total


def _term_group_args(aux, fn: str, rows: int, n: int) -> tuple:
    """The four term groups of ``aux`` (``rows`` pending rows on ``n``
    nodes) as K12's and K19's launch functions take them, in the
    reference's group order: each group's terms a row T, count width W, dom,
    counts and own cross ``[rows, T, rows]`` (term (k, t) matches row j),
    then the all-terms cross and the row validity (required affinity) or
    the weights (the preferred groups); zeros for an absent group.  →
    (args, the tensors the pointers name): the caller holds the second
    until the launch is queued, so that a contiguous copy of a view is not
    freed, and its memory handed to the next copy, before the kernel reads
    it."""
    args, held = [], []
    for name in AFFINITY_GROUPS:
        dom_f, cnt_f = GROUP_FIELDS[name]
        dom, cnt = getattr(aux, dom_f), getattr(aux, cnt_f)
        own = {"req_affinity": aux.aff_term_cross, "req_anti_affinity": aux.anti_cross,
               "pref_affinity": aux.paff_cross, "pref_anti_affinity": aux.panti_cross}[name]
        extra = []
        if name == "req_affinity":
            extra = [aux.aff_cross_all, aux.req_aff_valid]
        elif name != "req_anti_affinity":
            extra = [aux.paff_weight if name == "pref_affinity" else aux.panti_weight]
        if name not in aux.present:
            args += [0, 0, 0, 0, 0] + [0] * len(extra)
            continue
        t = dom.shape[1]
        dom, own = dom.contiguous(), own.contiguous()
        extra = [x.contiguous() for x in extra]
        if not cnt.is_contiguous():
            raise ValueError(f"{fn}: counts must be contiguous (updated in place)")
        require_cuda(fn, dom, cnt, own, *extra)
        require_dtype(fn, torch.int32, dom, cnt)
        require_dtype(fn, torch.bool, own)
        if dom.shape != (rows, t, n) or own.shape != (rows, t, rows) or cnt.shape[:2] != (rows, t):
            raise ValueError(f"{fn}: inconsistent {name} shapes")
        args += [t, cnt.shape[-1], ptr(dom), ptr(cnt), ptr(own)] + [ptr(x) for x in extra]
        held += [dom, own, *extra]
    return args, held


# --- K12 ipa_update_classes ---------------------------------------------------------


def ipa_update_classes_plain(aux, commit, choice, class_of):
    """The plain version, as the reference computes it: the commits' class
    one-hot ``u_c`` f32[Cp, N], then per present group the count bump
    (``einsum`` + domain scatter, the trash slot zeroed, gathered back for
    planes) and the committers' own block / score planes over their terms'
    domains; added into the aux in place."""
    d = aux.depth
    cp, n = aux.exist_anti_block.shape
    dev = aux.exist_anti_block.device
    u_c = torch.zeros((cp, n), dtype=torch.float32, device=dev)
    u_c.index_put_((class_of.long(), choice.long().clamp(0, n - 1)),
                   commit.to(torch.float32), accumulate=True)
    keep = (torch.arange(d + 1, device=dev) < d).to(torch.float32)

    def count_inc(cross, dom, cnt):
        contrib = torch.einsum("ctk,kn->ctn", cross.to(torch.float32), u_c)
        tbl = domain_scatter_add(contrib, dom, d + 1) * keep
        inc = domain_gather(tbl, dom) if _is_planes(cnt, n) else tbl
        cnt.add_(inc.to(torch.int32))
        return tbl.sum(dim=(1, 2))

    def same_mass(dom):
        w = domain_scatter_add(u_c[:, None, :].expand(dom.shape), dom, d + 1) * keep
        return domain_gather(w, dom)

    def plane(cross, dom, w):
        return torch.einsum("ktj,ktn->jn", cross.to(torch.float32) * w, same_mass(dom))

    score = aux.score_dyn.clone()
    if "req_affinity" in aux.present:
        cross = aux.aff_cross_all[:, None, :] & aux.req_aff_valid[:, :, None]
        aux.aff_total.add_(count_inc(cross, aux.dom_aff, aux.aff_cnt).to(torch.int32))
    if "req_anti_affinity" in aux.present:
        count_inc(aux.anti_cross, aux.dom_anti, aux.anti_cnt)
        add = torch.einsum("ktj,ktn->jn", aux.anti_cross.to(torch.float32),
                           same_mass(aux.dom_anti)) > 0.5
        aux.block_dyn.logical_or_(add)
    if "pref_affinity" in aux.present:
        count_inc(aux.paff_cross, aux.dom_paff, aux.paff_cnt)
    if "pref_anti_affinity" in aux.present:
        count_inc(aux.panti_cross, aux.dom_panti, aux.panti_cnt)
    if "req_affinity" in aux.present:
        w1 = torch.full(aux.dom_aff.shape[:2], float(aux.hard_weight),
                        dtype=torch.float32, device=dev)[:, :, None]
        score = score + plane(aux.aff_term_cross, aux.dom_aff, w1)
    if "pref_affinity" in aux.present:
        score = score + plane(aux.paff_cross, aux.dom_paff, aux.paff_weight[:, :, None])
    if "pref_anti_affinity" in aux.present:
        score = score - plane(aux.panti_cross, aux.dom_panti, aux.panti_weight[:, :, None])
    aux.score_dyn.copy_(score)
    return aux


def ipa_update_classes(aux, commit, choice, class_of):
    """Add one auction round's commits (``commit`` bool[B], ``choice`` i32[B]
    node rows and ``class_of`` i64[B] class rows, as the auction passes
    them) into the class view's count state, ``aff_total``, ``block_dyn``
    and ``score_dyn``, in place.  CPU tensors take the plain version; CUDA tensors launch K12
    once, every present term group in the one launch: each block compacts
    the round's commits, keys its row's committed domains in a small table
    (no domain-sized array), and a row no commit reaches exits there; a
    reached row adds at the committed domains of its table, or walks its
    tile of nodes for the planes and for the classes its term matches."""
    if not commit.is_cuda:
        return ipa_update_classes_plain(aux, commit, choice, class_of)
    b = commit.shape[0]
    c, n = aux.exist_anti_block.shape
    fixed = [commit, choice, class_of, aux.block_dyn, aux.score_dyn, aux.aff_total]
    dev = require_cuda("ipa_update_classes", *fixed)
    require_dtype("ipa_update_classes", torch.bool, commit, aux.block_dyn)
    require_dtype("ipa_update_classes", torch.int32, aux.aff_total)
    require_dtype("ipa_update_classes", torch.float32, aux.score_dyn)
    require_dtype("ipa_update_classes", torch.int32, choice)
    require_dtype("ipa_update_classes", torch.int64, class_of)
    if choice.shape != (b,) or class_of.shape != (b,) or aux.score_dyn.shape != (c, n):
        raise ValueError("ipa_update_classes: inconsistent shapes")
    args, _held = _term_group_args(aux, "ipa_update_classes", c, n)
    # launch_ipa_update's order: aff (T1, W1, dom, cnt, own cross, all-terms
    # cross, row validity), aff_total and the hard weight, then anti, paff, panti
    aff, rest = args[:7], args[7:]
    err = _fn("launch_ipa_update", "iiii" + "ppp" + "iipppppp" + "f" + "iippp"
              + "iipppp" + "iipppp" + "pp" + "p")(
        b, c, n, aux.depth, ptr(commit), ptr(choice), ptr(class_of), *aff,
        ptr(aux.aff_total), float(aux.hard_weight), *rest, ptr(aux.block_dyn),
        ptr(aux.score_dyn), stream_of(dev))
    check(err, "ipa_update_classes")
    LAUNCHES["ipa_update_classes"] += 1
    return aux


# --- K15 ipa_chain_prev -------------------------------------------------------------


class OwnTerms(NamedTuple):
    """One term group of the prev batch, for the chain's second half."""

    block: bool  # required anti-affinity: block; the others: score
    mm: torch.Tensor  # bool[B0, T0, C]: prev term (j, t) matches class row c
    topo_key: torch.Tensor  # i32[B0, T0] topology slot of each prev term
    term_valid: torch.Tensor  # bool[B0, T0]
    weight: Optional[torch.Tensor]  # f32[B0, T0], or None for ``w_scalar``
    w_scalar: float
    sign: float  # +1 or −1 (preferred anti-affinity subtracts)


def ipa_chain_prev_plain(aux, counts, own, rows, node_topo, missing: int) -> dict:
    """The plain version, as the reference computes it, with the placement
    one-hot replaced by a gather at each prev pod's node row: (i) per term
    group of ``counts`` (name → cross bool[C, T, B0]) the placed matches
    scattered into the domains of their nodes, the trash slot zeroed,
    gathered back for planes, and (required affinity) the tables' mass
    into ``aff_total``; (ii) per ``OwnTerms`` the nodes sharing the prev
    term's raw topology value at its pod's node, blocked or scored for the
    class rows the term matches.  → the updated fields, new tensors."""
    d = aux.depth
    n = aux.exist_anti_block.shape[1]
    placed = rows >= 0
    at = rows.long().clamp(0, n - 1)
    keep = (torch.arange(d + 1, device=rows.device) < d).to(torch.int32)
    out = {}
    for name, cross in counts.items():
        dom_f, cnt_f = GROUP_FIELDS[name]
        dom, cnt = getattr(aux, dom_f), getattr(aux, cnt_f)
        tbl = domain_scatter_add(cross & placed[None, None, :], dom[:, :, at], d + 1) * keep
        inc = domain_gather(tbl, dom) if _is_planes(cnt, n) else tbl
        out[cnt_f] = cnt + inc
        if name == "req_affinity":
            out["aff_total"] = aux.aff_total + tbl.sum(dim=(1, 2), dtype=torch.int32)
    block = aux.block_dyn
    score = aux.score_dyn
    k_cap = node_topo.shape[1]
    for g in own:
        key = g.topo_key.long().clamp(0, k_cap - 1)
        domp = node_topo[:, key].permute(1, 2, 0)  # [B0, T0, N] raw values
        hasp = (domp != missing) & g.term_valid[:, :, None]
        idx = at[:, None, None].expand(domp.shape[0], domp.shape[1], 1)
        dom_at = domp.gather(2, idx)[..., 0]
        has_at = hasp.gather(2, idx)[..., 0] & placed[:, None]
        same = (hasp & has_at[:, :, None] & (domp == dom_at[:, :, None])).to(torch.float32)
        mm = g.mm.to(torch.float32)
        if g.block:
            block = block | (torch.einsum("jtb,jtn->bn", mm, same) > 0.5)
        else:
            w = g.weight if g.weight is not None else torch.full(
                g.term_valid.shape, g.w_scalar, dtype=torch.float32, device=rows.device)
            score = score + g.sign * torch.einsum("jtb,jtn->bn", mm * w[:, :, None], same)
    if own:
        out["block_dyn"] = block
        out["score_dyn"] = score
    return out


def ipa_chain_prev(aux, counts, own, rows, node_topo, missing: int) -> dict:
    """Fold a still-in-flight batch's placements into the class view's
    state (see ``ipa_chain_prev_plain`` for the arguments; ``rows`` i32[B0]
    already folds in the prev pods' validity).  → the updated fields, new
    tensors (the inputs stay untouched).  CPU tensors take the plain
    version; CUDA tensors launch K15 once per group of ``counts`` and once
    per ``OwnTerms``."""
    if not rows.is_cuda:
        return ipa_chain_prev_plain(aux, counts, own, rows, node_topo, missing)
    d = aux.depth
    if d > MAX_SHARED_DOMAINS:
        raise NotImplementedError(
            f"ipa_chain_prev: a domain bucket of {d} exceeds the {MAX_SHARED_DOMAINS} "
            "domains one block keeps in shared memory (hostname affinity on more than "
            "~57k nodes: ROADMAP Queue B B12)")
    b0 = rows.shape[0]
    c, n = aux.exist_anti_block.shape
    rows = rows.to(torch.int32).contiguous()
    dev = require_cuda("ipa_chain_prev", rows)
    out = {}
    for name, cross in counts.items():
        dom_f, cnt_f = GROUP_FIELDS[name]
        dom = getattr(aux, dom_f).contiguous()
        cnt = getattr(aux, cnt_f).clone(memory_format=torch.contiguous_format)
        cross = cross.contiguous()
        t = dom.shape[1]
        total = None
        if name == "req_affinity":
            total = aux.aff_total.clone(memory_format=torch.contiguous_format)
        require_cuda("ipa_chain_prev", cross, dom, cnt, *([total] if total is not None else []))
        require_dtype("ipa_chain_prev", torch.bool, cross)
        require_dtype("ipa_chain_prev", torch.int32, dom, cnt)
        if cross.shape != (c, t, b0) or dom.shape != (c, t, n):
            raise ValueError(f"ipa_chain_prev: inconsistent {name} shapes")
        err = _fn("launch_ipa_chain_count", "iiiiii" + "ppp" + "pp" + "p")(
            b0, c, t, n, d, int(_is_planes(cnt, n)), ptr(cross), ptr(rows), ptr(dom),
            ptr(cnt), ptr(total) if total is not None else 0, stream_of(dev))
        check(err, f"ipa_chain_prev ({name} counts)")
        LAUNCHES["ipa_chain_prev"] += 1
        out[cnt_f] = cnt
        if total is not None:
            out["aff_total"] = total
    if own:
        block = aux.block_dyn.clone(memory_format=torch.contiguous_format)
        score = aux.score_dyn.clone(memory_format=torch.contiguous_format)
        topo = node_topo.contiguous()
        require_dtype("ipa_chain_prev", torch.int32, topo)
        for g in own:
            parts = [g.mm.contiguous(), g.topo_key.to(torch.int32).contiguous(),
                     g.term_valid.contiguous()]
            wt = None if g.weight is None else g.weight.to(torch.float32).contiguous()
            require_cuda("ipa_chain_prev", *parts, topo, block, score,
                         *([wt] if wt is not None else []))
            t0 = parts[1].shape[1]
            if parts[0].shape != (b0, t0, c) or parts[2].shape != (b0, t0):
                raise ValueError("ipa_chain_prev: inconsistent prev term shapes")
            err = _fn("launch_ipa_chain_own", "iiiiiii" + "ppppp" + "pff" + "pp" + "p")(
                b0, t0, c, n, topo.shape[1], int(missing), int(g.block), *map(ptr, parts),
                ptr(rows), ptr(topo), ptr(wt) if wt is not None else 0, float(g.w_scalar),
                float(g.sign), ptr(block), ptr(score), stream_of(dev))
            check(err, "ipa_chain_prev (prev terms)")
            LAUNCHES["ipa_chain_prev"] += 1
        out["block_dyn"] = block
        out["score_dyn"] = score
    return out


# --- K19 ipa_update_row -------------------------------------------------------------


def ipa_update_row_plain(aux, i: int, node_row):
    """The plain version of the reference's ``update`` (interpodaffinity.py
    :447-530) at full-batch rows, with no read on the host: pod i at node
    ``node_row`` (an i32[1] tensor; below 0 nothing changes).  (1, 2, 4) the
    pending pods' terms pod i matches gain it at the domain of its node
    (where the node has the key), through a same-domain compare-add on
    planes or a point add on tables, and ``aff_total`` the keyed required
    terms; (3) pod i's own required anti-affinity terms block the pods they
    match on the nodes of their domain; (5) pod i's own terms score them
    there: + hardPodAffinityWeight, + the preferred weights, − the preferred
    anti-affinity weights, in that order.  In place."""
    d = aux.depth
    n = aux.exist_anti_block.shape[1]
    node = node_row.reshape(1).long()
    placed = node >= 0
    at = node.clamp(0, n - 1)

    def count(cnt, dom, cross_col):
        # cross_col [B, T]: term (b, t) matches pod i
        dom_at = dom.index_select(2, at)[..., 0]  # [B, T]
        inc = (cross_col & (dom_at < d) & placed).to(torch.int32)
        if _is_planes(cnt, n):
            cnt.add_(inc[:, :, None] * (dom == dom_at[:, :, None]).to(torch.int32))
        else:
            cnt.scatter_add_(-1, dom_at.long()[:, :, None], inc[:, :, None])
        return inc

    def same(dom_i):
        # [T, N]: node n shares pod i's node's domain under pod i's term t
        return (dom_i == dom_i.index_select(1, at)) & (dom_i < d) & placed

    def plane(cross_i, dom_i, w):
        # cross_i [T, B], dom_i [T, N], w [T] → f32[B, N]
        return torch.einsum("tj,tn->jn", cross_i.to(torch.float32) * w[:, None],
                            same(dom_i).to(torch.float32))

    if "req_affinity" in aux.present:
        inc = count(aux.aff_cnt, aux.dom_aff,
                    aux.aff_cross_all[:, i:i + 1] & aux.req_aff_valid)
        aux.aff_total.add_(inc.sum(dim=1, dtype=torch.int32))
    if "req_anti_affinity" in aux.present:
        count(aux.anti_cnt, aux.dom_anti, aux.anti_cross[:, :, i])
        hit = (aux.anti_cross[i][:, :, None] & same(aux.dom_anti[i])[:, None, :]).any(dim=0)
        aux.block_dyn.logical_or_(hit)
    if "pref_affinity" in aux.present:
        count(aux.paff_cnt, aux.dom_paff, aux.paff_cross[:, :, i])
    if "pref_anti_affinity" in aux.present:
        count(aux.panti_cnt, aux.dom_panti, aux.panti_cross[:, :, i])
    score = aux.score_dyn
    if "req_affinity" in aux.present:
        w1 = torch.full((aux.dom_aff.shape[1],), float(aux.hard_weight),
                        dtype=torch.float32, device=score.device)
        score = score + plane(aux.aff_term_cross[i], aux.dom_aff[i], w1)
    if "pref_affinity" in aux.present:
        score = score + plane(aux.paff_cross[i], aux.dom_paff[i], aux.paff_weight[i])
    if "pref_anti_affinity" in aux.present:
        score = score - plane(aux.panti_cross[i], aux.dom_panti[i], aux.panti_weight[i])
    if score is not aux.score_dyn:
        aux.score_dyn.copy_(score)
    return aux


def ipa_update_row(aux, i: int, node_row):
    """Add pod i, placed at ``node_row`` (i32[1] on the device, written there
    by K17; below 0: not placed), into the full-batch aux's count state,
    ``aff_total``, ``block_dyn`` and ``score_dyn``, in place.  CPU tensors
    take the plain version; CUDA tensors launch K19 once, every present
    term group in the one launch: blocks of node tiles over runs of pending
    rows, touching only the rows and nodes the step changes."""
    if not node_row.is_cuda:
        return ipa_update_row_plain(aux, i, node_row)
    b, n = aux.exist_anti_block.shape
    fixed = [node_row, aux.block_dyn, aux.score_dyn, aux.aff_total]
    dev = require_cuda("ipa_update_row", *fixed)
    require_dtype("ipa_update_row", torch.int32, node_row, aux.aff_total)
    require_dtype("ipa_update_row", torch.bool, aux.block_dyn)
    require_dtype("ipa_update_row", torch.float32, aux.score_dyn)
    if node_row.numel() != 1 or aux.score_dyn.shape != (b, n) or not 0 <= i < b:
        raise ValueError("ipa_update_row: inconsistent shapes")
    args, _held = _term_group_args(aux, "ipa_update_row", b, n)
    terms = sum(args[k] for k in (0, 7, 12, 18))
    if terms > MAX_ROW_TERMS:
        raise ValueError(f"ipa_update_row: {terms} terms a pod over the four groups, more "
                         f"than the {MAX_ROW_TERMS} K19 stages in shared memory")
    # launch_ipa_update_row's order: aff (T1, W1, dom, cnt, own cross, all-terms
    # cross, row validity), aff_total and the hard weight, then anti, paff, panti
    aff, rest = args[:7], args[7:]
    err = _fn("launch_ipa_update_row", "iiiip" + "iipppppp" + "f" + "iippp" + "iipppp"
              + "iipppp" + "pp" + "p")(
        b, n, aux.depth, int(i), ptr(node_row), *aff, ptr(aux.aff_total),
        float(aux.hard_weight), *rest, ptr(aux.block_dyn), ptr(aux.score_dyn),
        stream_of(dev))
    check(err, "ipa_update_row")
    LAUNCHES["ipa_update_row"] += 1
    return aux


_FNS = {}


def _fn(name: str, spec: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = bind(load("interpodaffinity"), name, spec)
    return fn
