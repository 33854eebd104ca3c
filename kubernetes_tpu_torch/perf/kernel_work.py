"""The bytes and operations each kernel must move and do on given inputs
(``*_work``, the basis of ``bound_ms``), the synthetic inputs that
``chip_smoke.py`` and ``kernel_ab.py`` both build for K10, K11, K12, K23,
K25, K27 and K28, and the launch plans of K6, K16, K17, K25, K27, K28 and
K32 and K30's tiles, whose splits both scripts' cases and the CPU mirrors
take from here (``k6_plan``, ``k16_plan``, ``k17_plan``, ``k17_tie_rows``,
``k17_equal_noise``, ``k25_plan``, ``k27_plan``, ``k28_plan``,
``k32_plan``, ``K30_*``).

A bound counts what the function needs on this data: each input read
once, each output written once, and only the cells the data reaches.  The
rates are the H100 SXM's from NVIDIA's data sheet.  Imports nothing of JAX.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (same sheet)


def nbytes(*tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def bound_ms(n_bytes: int, n_ops: int):
    """(the least time in ms, what bounds it): the larger of the bytes over
    the memory rate and the scalar operations over the float32 peak."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def k1_work(rep, snap, dyn, na_mask, na_pref, img, bits, raw):
    """(bytes, operations) K1 needs on these inputs: every input read once
    and both outputs written once; per (class, node) the taint × toleration
    matches, port × port and image × image compares and ~12 arithmetic
    steps per resource dimension."""
    c, n = bits.shape
    k1_in = [rep.valid, rep.request, rep.non_zero, rep.node_name_id, rep.tol_valid,
             rep.tol_key, rep.tol_val, rep.tol_op, rep.tol_effect, rep.ports,
             rep.ports_ip, rep.image_ids, snap.node_valid, snap.node_ready,
             snap.node_name_ids, snap.unschedulable, snap.allocatable, dyn.requested,
             dyn.non_zero, snap.taint_keys, snap.taint_vals, snap.taint_effects,
             snap.ports, snap.ports_ip, snap.image_ids, na_mask, na_pref]
    # of ImageLocality's per-id table K1 needs only the entries at the class
    # rows' image ids, one f32 each
    img_gathered = int((rep.image_ids >= 0).sum()) * img.element_size()
    pod_t, pod_p, pod_i = (rep.tol_key.shape[1], rep.ports.shape[1],
                           rep.image_ids.shape[1])
    node_t, node_p, node_i = (snap.taint_keys.shape[1], snap.ports.shape[1],
                              snap.image_ids.shape[1])
    r = dyn.requested.shape[1]
    ops = c * n * (node_t * pod_t + pod_p * node_p + pod_i * node_i + 12 * r)
    return nbytes(*k1_in, bits, raw) + img_gathered, ops


# threefry2x32 and the uniform: 20 rounds of an add, a rotate (two shifts and
# an or) and an xor, 5 key injections of three adds; the bits to a float, 3
THREEFRY_OPS = 20 * 5 + 5 * 3 + 3


def k17_work(bits, full: int, total, i: int, nominated, valid, request,
             keys=None) -> tuple:
    """(bytes, operations) one K17 step must move and do on these inputs:
    the bit row read once; the total only on feasible nodes; keyed, the
    step's 8-byte key, and a threefry and a noise compare at each tied
    maximum of the masked total where the answer depends on the draws: a
    placed pod that the nominated path does not take, on a row with two or
    more tied maxima (one maximum wins whatever its draw; an infeasible,
    padding or nominated pod's node is not the draw's); pod i's nominated
    row and valid flag, the nominated node's bits when it names one; both
    outputs at i written; and when the pod is placed its request and
    non-zero rows read and the node's requested / non_zero rows read and
    written.  Per node a compare, a count and the value compare."""
    n = bits.shape[-1]
    r = request.shape[1]
    mask = bits.reshape(n) == full
    n_feas = int(mask.sum())
    placed = n_feas > 0 and bool(valid[i])
    n_bytes = 4 * n + 4 * n_feas + 4 + 1 + 8
    ops = 3 * n
    if keys is not None:
        n_bytes += 8
        nom = int(nominated[i])
        if placed and not (nom >= 0 and bool(mask[min(nom, n - 1)])):
            feas_total = total.reshape(n)[mask]
            ties = int((feas_total == feas_total.max()).sum())
            ops += ties * (THREEFRY_OPS + 1) if ties > 1 else 0
    n_bytes += 4 if int(nominated[i]) >= 0 else 0
    n_bytes += 4 * (r + 2) * 3 if placed else 0
    return n_bytes, ops


def k17_plan(n: int, vec: int = 4, cl: int = None) -> tuple:
    """(CL, S, threads): K17's launch plan for a row of ``n`` nodes, a copy
    of ``select_plan`` in csrc/scan.cu (``chip_smoke.py`` holds the two
    together on the card) — the fewest blocks, a power of two up to 8, of
    at most 1024 nodes (or ``cl`` blocks); S, a block's slice, a multiple
    of 4; threads a whole number of warps covering the slice's vectors of
    ``vec`` nodes, 32 to 1024."""
    if cl is None:
        cl = 1
        while cl < 8 and cl * 1024 < n:
            cl *= 2
    s = ((n + cl - 1) // cl + 3) // 4 * 4
    return cl, s, min(max(((s + vec - 1) // vec + 31) // 32 * 32, 32), 1024)


def k17_tie_rows(n: int) -> list:
    """The rows either side of each of K17's slice boundaries and of the
    last slice's vector tail, and the last row."""
    cl, s, _t = k17_plan(n)
    at = [q * s + d for q in range(1, cl) for d in (-1, 0)]
    at += [n - n % 4 - 1, n - n % 4] if n % 4 and n > 4 else []
    return sorted({a for a in at + [n - 1] if 0 <= a < n})


def k23_work(req_key, req_op, req_vals, req_num, term_valid, match_all, match_none, keys,
             vals, vals_num=None, numeric=None, has_numeric: bool = True,
             index=None) -> tuple:
    """(bytes, operations) K23 must move and do on ``selector_match``'s
    arguments: the label sets (keys, values and, with the numeric side on,
    ``vals_num`` or else the side table) read once, the requirement arrays
    once, the index once and the bool ``[B, O]`` result written once; one
    key compare per (unique row, term, requirement, object, label
    column)."""
    u, t, s = req_key.shape
    o, lab = keys.shape
    reqs = [a for a in (req_key, req_op, req_vals, req_num, term_valid, match_all,
                        match_none) if a is not None]
    nums = [vals_num if vals_num is not None else numeric] if has_numeric else []
    b = u if index is None else index.shape[0]
    n_bytes = nbytes(*reqs, keys, vals, *[x for x in nums if x is not None]) + b * o
    n_bytes += nbytes(index) if index is not None else 0
    return n_bytes, u * t * s * o * lab


def k17_equal_noise(keys, n: int, live: int = None) -> tuple:
    """(k, a, b): the first row k of the key table ``keys`` (int32 [b, 2])
    whose uniform row of ``n`` draws holds an equal pair a < b below
    ``live`` in different slices of ``k17_plan(n)`` (any pair in one
    block) — a tie on the noise that only the row order breaks, found under
    real keys."""
    import torch

    from kubernetes_tpu_torch.ops import prng

    live = n if live is None else live
    cl, s, _t = k17_plan(n)
    words = keys.cpu().to(torch.int64) & prng.MASK32
    for k in range(words.shape[0]):
        z = prng.uniform(words[k], (n,))[:live]
        order = torch.argsort(z, stable=True)
        zs = z[order]
        for j in torch.nonzero(zs[1:] == zs[:-1]).flatten().tolist():
            a, b = sorted((int(order[j]), int(order[j + 1])))
            if cl == 1 or a // s != b // s:
                return k, a, b
    raise ValueError(f"no key row with equal noise across slices at N = {n}")


# K23's shapes: label → (mode, U, T, S, O, L, B, index, numeric) — mode
# "node" (term_valid, match_all) or "label" (T = 1, match_none); index
# "repeats" (B rows over the U unique rows), "permuted" (B = U, each row
# once) or None (B = U); numeric "off", "table" (the side table) or
# "vals_num".  The first is GangBasic's node-affinity call.
K23_CASES = {
    "path: node selectors, U = 2": ("node", 2, 2, 4, 8192, 16, 512, "repeats", "off"),
    "label selectors, side table": ("label", 12, 1, 4, 8192, 8, 512, "repeats", "table"),
    "label selectors, vals_num": ("label", 12, 1, 4, 8192, 8, 512, "repeats", "vals_num"),
    "label selectors, numeric off": ("label", 12, 1, 4, 8192, 8, 512, "repeats", "off"),
    "requirement rows, no index": ("label", 64, 1, 4, 8192, 8, 64, None, "table"),
    "U = 512 distinct rows": ("node", 512, 2, 4, 8192, 16, 512, "permuted", "vals_num"),
    "O = 8190": ("node", 2, 2, 4, 8190, 16, 512, "repeats", "off"),
    "L = 20, labels in shared memory": ("label", 12, 1, 4, 4096, 20, 512, "repeats",
                                        "vals_num"),
}


def k23_inputs(label, dev, seed: int = 23) -> tuple:
    """``selector_match``'s arguments at ``K23_CASES[label]`` (or at a
    shape tuple of the same form) → (args, kw):
    objects with up to L distinct keys of a pool of 24 (−1 padded), value
    ids 0–63 (the side table's numbers integers, every ninth NaN);
    requirements of every op code, the pad op and an unknown one, absent
    and negative keys, value lists with −1 pads, NaN right-hand sides;
    node mode with a few invalid terms and match_all rows, label mode with
    match_none rows (none on requirement rows with no index)."""
    import numpy as np
    import torch

    mode, u, t, s_, o, lab, b, index, numeric = K23_CASES.get(label, label)
    rng = np.random.default_rng(seed + u + o + lab)
    pool, n_vals, v = 24, 64, 4
    keys = np.full((o, lab), -1, np.int32)
    vals = np.full((o, lab), -1, np.int32)
    for j in range(o):
        ks = rng.permutation(pool)[: int(rng.integers(0, lab + 1))]
        keys[j, : ks.size] = ks
        vals[j, : ks.size] = rng.integers(0, n_vals, ks.size)
    table = np.arange(n_vals, dtype=np.float32) - 20.0
    table[::9] = np.nan
    vals_num = np.where(vals >= 0, table[np.clip(vals, 0, n_vals - 1)], np.nan)
    op = rng.choice([-1, 0, 1, 2, 3, 4, 5, 9], size=(u, t, s_),
                    p=[0.1, 0.25, 0.2, 0.15, 0.1, 0.09, 0.09, 0.02]).astype(np.int32)
    req_key = rng.integers(-1, pool + 2, (u, t, s_)).astype(np.int32)
    req_vals = rng.integers(-1, n_vals, (u, t, s_, v)).astype(np.int32)
    req_num = rng.integers(-20, 40, (u, t, s_)).astype(np.float32)
    req_num[rng.random((u, t, s_)) < 0.1] = np.nan
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    opt = [None, None, None]
    if mode == "node":
        opt[0] = i32(rng.random((u, t)) < 0.85)
        opt[1] = i32(rng.random(u) < 0.1)
    elif index is not None:
        opt[2] = i32(rng.random(u) < 0.1)
    idx = None
    if index == "repeats":
        idx = i32(rng.integers(0, u, b).astype(np.int32))
    elif index == "permuted":
        idx = i32(rng.permutation(u).astype(np.int32))
    args = (i32(req_key), i32(op), i32(req_vals), i32(req_num), *opt, i32(keys), i32(vals))
    kw = {"vals_num": i32(vals_num.astype(np.float32)) if numeric == "vals_num" else None,
          "numeric": i32(table) if numeric == "table" else None,
          "has_numeric": numeric != "off", "index": idx}
    return args, kw


def k32_plan(n: int, vec: int = 4) -> tuple:
    """(CL, S, threads): K32's launch plan for a lone row (at most 16 rows)
    of ``n`` nodes, a copy of ``split_plan`` in csrc/selectorspread.cu
    (``chip_smoke.py`` holds the two together on the card).  It splits a
    row as K17's plan does: the fewest blocks, a power of two up to 8, of
    at most 1024 nodes; S a multiple of 4; threads a whole number of warps
    covering the slice's vectors of ``vec`` nodes, 32 to 1024."""
    return k17_plan(n, vec)


def k32_work(bits, full: int, has_zone) -> tuple:
    """(bytes, operations) K32 must move and do on these inputs: the bit
    plane read over every entry and has_zone once; on the masked entries
    only both count planes and the total read and the total written (16
    bytes an entry: an unmasked entry, node-tier padding included, is
    skipped after its bit test).  One bit test an entry; on a masked entry
    the two max steps and ~10 float steps."""
    c, n = bits.shape
    masked = int((bits == full).sum())
    return nbytes(bits, has_zone) + 16 * masked, c * n + 12 * masked


# K30's tiles and staging slots, a copy of csrc/fork.cu's NODE_TILE,
# POD_TILE, AFF_TILE, THREADS and SEG: a block owns NODE_TILE nodes' rows,
# POD_TILE pods or AFF_TILE affinity cells of one fork, and each of its
# THREADS / 32 warps stages at most SEG of a group's entries for its tile
K30_NODE_TILE, K30_POD_TILE, K30_AFF_TILE = 128, 4096, 1024
K30_THREADS, K30_SEG = 256, 32


def k30_work(args, kw) -> tuple:
    """(bytes, operations) K30 must move and do on ``fork_masks``' arguments
    ``args`` / ``kw``: the bases read once (the node group once a fork
    when K31 gave it per fork), the K copies written once, the payload read
    once and each live victim's pod_request / pod_non_zero rows read once.
    Per live victim a subtract per resource, non-zero and claim column, per
    live affinity contribution one."""
    (nv, req, nz, claim, pv, preq, pnz, aff, vp, vn, ar, av, dr) = args
    chips = kw.get("vic_claim_chips") is not None
    k = vp.shape[0]
    n, r = req.shape[-2:]
    p = pv.shape[0]
    g, d = aff.shape
    per_fork = req.dim() == 3
    node_one = n * (1 + 4 * r + 8 + (4 if chips else 0))
    live_v = int((vp >= 0).sum())
    n_bytes = (node_one * (k if per_fork else 1) + p + 4 * g * d
               + k * (node_one + p + 4 * g * d)
               + vp.numel() * (8 + (4 if chips else 0)) + ar.numel() * 8
               + dr.numel() * 4 + live_v * (4 * r + 8))
    return n_bytes, live_v * (r + 2 + (1 if chips else 0)) + int((ar >= 0).sum())


def k6_plan(n: int, d1: int, vec: int = 4) -> tuple:
    """(threads, NB, CL, WS): K6's launch plan for rows of ``n`` nodes and
    ``d1`` domains, a copy of ``filter_plan`` in csrc/spread.cu
    (``chip_smoke.py`` holds the two together on the card) — one vector of
    ``vec`` nodes a thread, threads a whole number of warps from 32 to 256
    covering the row, NB blocks a row; above 32 domains a
    row's blocks in clusters of CL, a power of two up to 8 and the fewest
    that cover the row's blocks (NB rounded up to a multiple of it), block
    q of a cluster building the verdict words [q WS, (q + 1) WS)."""
    t = min(max(((n + vec - 1) // vec + 31) // 32 * 32, 32), 256)
    nb = (n + t * vec - 1) // (t * vec)
    cl = 1
    if d1 > 32:
        while cl < 8 and cl < nb:
            cl *= 2
    w = (d1 + 31) // 32
    return t, (nb + cl - 1) // cl * cl, cl, (w + cl - 1) // cl


def k6_work(aux, bits, bit: int) -> tuple:
    """(bytes, operations) K6 must move and do on these inputs: the hard
    tables and the per-constraint scalars read once; dom_val and has_key on
    the hard constraints' rows only; the bit plane read where the filter
    fails and written where it fails on a set ``bit`` (where the word
    changes).  Per (hard row, node) a gather, an add and two compares, per
    table entry a compare."""
    from kubernetes_tpu_torch.kernels.spread import spread_filter_plane

    c, cc, d1 = aux.hard_counts.shape
    n = bits.shape[1]
    n_hard = int(aux.hard_valid.sum())
    fail = ~spread_filter_plane(aux)
    n_clear = int((fail & (((bits >> bit) & 1) == 1)).sum())
    return (nbytes(aux.hard_counts, aux.hard_present, aux.hard_valid, aux.max_skew,
                   aux.min_domains, aux.self_match) + 5 * n_hard * n
            + 4 * int(fail.sum()) + 4 * n_clear, 4 * n_hard * n + c * cc * d1)


def k18_work(aux, i: int, node_row) -> tuple:
    """(bytes, operations) one K18 step must move and do: pod i's node
    (nothing more when it is below 0: not placed); then pod i's match
    column (a byte a (pending pod, constraint) row), each matching row's
    domain at the node, each pending pod with a matching row its two
    counted flags there, and a read and a write per table add.  Per row a
    compare, per add an add."""
    node = int(node_row.reshape(-1)[0])
    if node < 0:
        return 4, 0
    b, cc, _bp = aux.match_pending.shape
    at = min(node, aux.dom_val.shape[-1] - 1)
    hit = aux.match_pending[:, :, i]  # [B, Cc]
    adds = int((hit & aux.counted_hard[:, at][:, None]).sum()
               + (hit & aux.counted_soft[:, at][:, None]).sum())
    return (4 + b * cc + 4 * int(hit.sum()) + 2 * int(hit.any(dim=1).sum()) + 8 * adds,
            b * cc + adds)


def k8_work(aux, commit, choice, class_of) -> tuple:
    """(bytes, operations) one K8 round must move and do: every pod's
    commit flag; per committed pod its node and class at their widths
    (int64 ``class_of`` at 8 bytes), the match byte of every (class,
    constraint) row at its class, at its node the domain of each matching
    row and the two counted flags of each class row with a matching row; a
    read and a write per table add.  Per committed pod a test a row, per
    add an add."""
    c, cc, _cp = aux.match_pending.shape
    n = aux.dom_val.shape[-1]
    committed = commit.nonzero(as_tuple=True)[0]
    ks = class_of[committed].long()
    ns = choice[committed].long().clamp(0, n - 1)
    mp = aux.match_pending[:, :, ks]  # [C, Cc, commits]
    adds = int((aux.counted_hard[:, ns][:, None, :] & mp).sum()
               + (aux.counted_soft[:, ns][:, None, :] & mp).sum())
    nc = int(committed.numel())
    per_commit = choice.element_size() + class_of.element_size() + c * cc
    return (nbytes(commit) + nc * per_commit + 4 * int(mp.sum())
            + 2 * int(mp.any(dim=1).sum()) + 8 * adds, nc * c * cc + adds)


# K16's block and tiles, a copy of csrc/scatter_rows.cu's THREADS, UNROLL and
# MAX_TILE_ROWS: a block of THREADS threads owns a tile of THREADS · UNROLL
# vectors of one array (at most MAX_TILE_ROWS rows, at least one)
K16_THREADS, K16_UNROLL, K16_MAX_TILE_ROWS = 256, 2, 1024


def k16_plan(row_bytes: int, n_rows: int, aligned16: bool = True, aligned4: bool = True,
             *, tile_vectors: int = K16_THREADS * K16_UNROLL,
             max_tile_rows: int = K16_MAX_TILE_ROWS) -> tuple:
    """(vector bytes, tile rows, blocks): K16's plan for one array of
    ``n_rows`` rows of ``row_bytes`` bytes, a copy of ``array_plan`` in
    csrc/scatter_rows.cu (``chip_smoke.py`` holds the two together on the
    card) — 16-byte vectors where the three pointers are 16-byte aligned and
    a row is whole vectors or divides one, else 4-byte words where they are
    4-byte aligned and a row is whole words, else bytes; a tile of ``tile_vectors`` vectors, at least one row
    and at most ``max_tile_rows``; no block for a zero-width array."""
    rb = row_bytes
    v = 1
    if rb > 0 and aligned16 and (rb % 16 == 0 or 16 % rb == 0):
        v = 16
    elif rb > 0 and aligned4 and rb % 4 == 0:
        v = 4
    tile_bytes = tile_vectors * v
    tr = min(1 if rb >= tile_bytes else tile_bytes // max(rb, 1), max_tile_rows)
    return v, tr, (n_rows + tr - 1) // tr if rb > 0 else 0


def k16_work(arrays, rows, vals) -> tuple:
    """(bytes, operations) K16 must move on one array group: every output
    array written once, each old array read on its clean rows only (a
    dirty row comes from the payload), the payload's row list read once and
    its values once at each distinct dirty row (a pad repeats a row with
    equal values).  No arithmetic."""
    n = arrays[0].shape[0]
    per_row = sum(a.numel() * a.element_size() for a in arrays) // n if n else 0
    dirty = int(rows.unique().numel()) if rows.numel() else 0
    return n * per_row + (n - dirty) * per_row + nbytes(rows) + dirty * per_row, 0


def k7_work(aux, bits, full: int) -> tuple:
    """K7's bytes and operations on these inputs: the bit plane (the
    feasibility mask) and soft_valid read once; the total read and written
    on feasible nodes; for the soft constraints only: has_key on feasible
    nodes, dom_val on scored ones, their table row, maxSkew and log-table
    entry; per feasible (row, node) the normalization, floor, scale and add,
    per scored soft term six more."""
    feas_mask = bits == full
    soft_feas = feas_mask[:, None, :] & aux.soft_valid[:, :, None]  # [C, Cc, N]
    n_soft = int(aux.soft_valid.sum())
    n_scored_soft = int((soft_feas & aux.has_key).sum())
    n_feas = int(feas_mask.sum())
    d1 = aux.soft_counts.shape[-1]
    return (nbytes(bits, aux.soft_valid) + 8 * n_feas + int(soft_feas.sum())
            + 4 * n_scored_soft + n_soft * (4 * d1 + 4 + 4), 8 * n_feas + 6 * n_scored_soft)


# --- K11 and K12: InterPodAffinity's class views ---------------------------------


def ipa_view(c: int, form: str, present, dev, *, t: int = 1, seed: int = 11,
             cross_p: float = 1.0, n: int = 8192, live: int = 5000, d: int = None):
    """An InterPodAffinity class view (IPAAux) of ``c`` class rows on N
    nodes (``live`` of them live, the rest without the key) with ``t``
    terms a row in each group of ``present``: "planes" — hostname keys,
    each live node its own domain (D = 8192), counts per node; "tables" —
    zone keys, three zones (D = 8), counts per domain; ``d`` another domain
    bucket for the tables form, the live nodes spread over it at random.
    A term matches a class with probability ``cross_p`` (the suites'
    pods all match); weights 1–100, counts 0–3, static and dynamic scores
    integers."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.plugins.interpodaffinity import IPAAux

    rng = np.random.default_rng(seed + c)
    planes = form == "planes"
    d = d or (8192 if planes else 8)
    width = n if planes else d + 1
    node_dom = np.full(n, d, np.int32)
    node_dom[:live] = np.arange(live) if planes and d >= live else \
        (np.arange(live) % 3 if d == 8 else rng.integers(0, d, live))
    groups = {}
    for g in ("req_affinity", "req_anti_affinity", "pref_affinity", "pref_anti_affinity"):
        on = g in present
        dom = np.broadcast_to(node_dom, (c, t, n)).copy() if on else np.full((c, t, n), d, np.int32)
        tbl = rng.integers(0, 4, (c, t, d + 1)).astype(np.int32)
        cnt = np.take_along_axis(tbl, dom, axis=2) if planes else tbl
        cross = (rng.random((c, t, c)) < cross_p) if on else np.zeros((c, t, c), bool)
        groups[g] = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                     for x in (dom, cnt if on else np.zeros_like(cnt), cross)]
    ra, an, pa, pn = (groups[g] for g in ("req_affinity", "req_anti_affinity",
                                          "pref_affinity", "pref_anti_affinity"))

    def f32(x):
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    return IPAAux(
        dom_aff=ra[0], dom_anti=an[0], dom_paff=pa[0], dom_panti=pn[0],
        aff_cnt=ra[1], anti_cnt=an[1], paff_cnt=pa[1], panti_cnt=pn[1],
        aff_total=torch.from_numpy(rng.integers(0, 100, c).astype(np.int32)).to(dev),
        self_match_all=torch.ones(c, dtype=torch.bool, device=dev),
        exist_anti_block=torch.zeros((c, n), dtype=torch.bool, device=dev),
        score_static=f32(rng.integers(0, 100, (c, n))),
        aff_term_cross=ra[2], aff_cross_all=ra[2][:, 0, :].clone(), anti_cross=an[2],
        paff_cross=pa[2], panti_cross=pn[2],
        block_dyn=torch.zeros((c, n), dtype=torch.bool, device=dev),
        score_dyn=f32(rng.integers(-50, 50, (c, n))), depth=d, present=tuple(present),
        req_aff_valid=torch.full((c, t), "req_affinity" in present, dtype=torch.bool,
                                 device=dev),
        paff_weight=f32(rng.integers(1, 101, (c, t))),
        panti_weight=f32(rng.integers(1, 101, (c, t))), hard_weight=1.0)


# K11's shapes: label → (C, form, present groups)
K11_CASES = {
    "C = 4, planes": (4, "planes", ("pref_affinity",)),
    "C = 1, planes": (1, "planes", ("pref_affinity",)),
    "C = 512, anti-affinity classes": (512, "planes", ("req_anti_affinity",)),
    "C = 4, tables, both preferred groups": (4, "tables", ("pref_affinity",
                                                            "pref_anti_affinity")),
}


def k11_inputs(label: str, dev, seed: int = 11):
    """(aux, bits, full, total) at K11's shape ``label``: SchedulingPreferred
    PodAffinity's dedup round (C = 4, one preferred-affinity term on the
    hostname, D = 8192) and the scan's step (C = 1); the full auction's
    anti-affinity classes (C = 512: no preferred term, only the static and
    dynamic scores); C = 4 on zone tables with both preferred groups.  A
    bit plane of 7 filter bits with ~70% of the 5000 live nodes feasible,
    and K2's total (finite where feasible, −inf elsewhere)."""
    import numpy as np
    import torch

    c, form, present = K11_CASES[label]
    aux = ipa_view(c, form, present, dev, seed=seed)
    rng = np.random.default_rng(seed + 7 * c)
    n, live, full = 8192, 5000, 0b1111111
    feasible = (rng.random((c, n)) < 0.7) & (np.arange(n) < live)
    bits = np.where(feasible, full, full & ~(1 << rng.integers(0, 7, (c, n)))).astype(np.int32)
    total = np.where(feasible, rng.integers(0, 400, (c, n)), -np.inf).astype(np.float32)
    return aux, torch.from_numpy(bits).to(dev), full, torch.from_numpy(total).to(dev)


# K12's shapes: label → (C, form, present groups, commits, term cross probability)
K12_CASES = {
    "C = 4, planes, one commit": (4, "planes", ("pref_affinity",), 1, 1.0),
    "C = 4, tables": (4, "tables", ("req_affinity",), 1, 1.0),
    "C = 512, anti-affinity round": (512, "planes", ("req_anti_affinity",), 384, 1.0),
    "C = 4, four groups": (4, "planes", ("req_affinity", "req_anti_affinity",
                                         "pref_affinity", "pref_anti_affinity"), 4, 0.5),
}


def k12_inputs(label: str, dev, seed: int = 12, d: int = None, b: int = 512):
    """(aux, commit, choice, class_of) at K12's shape ``label``, B = 512:
    the coupled round (C = 4, one commit, SchedulingPreferredPodAffinity's
    hostname planes); the tables form (C = 4, required affinity on three
    zones, D = 8 — or ``d`` domains); the full auction's anti-affinity
    round (C = 512 identity classes, 384 commits on distinct live nodes,
    every pod matching every term: each commit blocks its node for every
    class); all four groups present (C = 4, one commit a class).  ``choice``
    i32 and ``class_of`` i64, as the engines pass them; ``b`` another batch
    size."""
    import numpy as np
    import torch

    c, form, present, commits, cross_p = K12_CASES[label]
    aux = ipa_view(c, form, present, dev, seed=seed, cross_p=cross_p, d=d)
    rng = np.random.default_rng(seed + c)
    live = 5000
    commit = np.zeros(b, bool)
    at = rng.permutation(b)[:commits]
    commit[at] = True
    choice = rng.integers(0, live, b).astype(np.int32)
    choice[at] = rng.permutation(live)[:commits]
    class_of = (np.arange(b) if c == b else rng.integers(0, c, b)).astype(np.int64)
    if commits <= c:
        class_of[at] = np.arange(commits)
    return (aux,) + tuple(torch.from_numpy(x).to(dev) for x in (commit, choice, class_of))


def k11_work(aux, bits, full: int) -> tuple:
    """(bytes, operations) K11 must move and do on these inputs: the bit
    plane and the term weights read once; on feasible nodes the static and
    dynamic scores read, the total read and written, and each preferred
    term's domain read; a term's count read per feasible node with the key
    where the counts are planes, once per domain of the row's feasible
    nodes where they are tables; per feasible node the raw sum (2 per term
    + 3), the max / min and the normalization, floor, scale and add (5)."""
    import torch

    feas = bits == full
    n_feas = int(feas.sum())
    n_bytes = nbytes(bits) + n_feas * (4 + 4 + 8)
    terms = 0
    for g, name in (("paff", "pref_affinity"), ("panti", "pref_anti_affinity")):
        if name not in aux.present:
            continue
        dom, cnt = getattr(aux, f"dom_{g}"), getattr(aux, f"{g}_cnt")
        t, n = dom.shape[1], dom.shape[2]
        terms += t
        keyed = feas[:, None, :] & (dom < aux.depth)
        if cnt.shape[-1] == n:
            counts = int(keyed.sum())
        else:
            seen = torch.zeros(cnt.shape, dtype=torch.bool, device=dom.device)
            seen.scatter_(2, torch.where(keyed, dom, aux.depth).long(), True)
            counts = int(seen[:, :, :aux.depth].sum())
        n_bytes += nbytes(getattr(aux, f"{g}_weight")) + 4 * t * n_feas + 4 * counts
    return n_bytes, n_feas * (2 * terms + 3 + 2 + 5)


def k12_work(aux, commit, choice, class_of) -> tuple:
    """(bytes, operations) K12 must move and do on this round, each cell
    counted once: the commit flags, each commit's node and class; per
    group the cross bytes at the committed classes (required affinity: the
    all-terms cross there and the row validity); a (class, term) domain row
    read whole where the row walks its nodes — a reached plane row, or a
    committer row (a term of a committed class, at a node with the key,
    matching some class) —, else its words at the committed nodes its cross
    takes; the counts read and written on the nodes of a plane row's
    committed domains or at a table row's, aff_total on the rows reached;
    the cross row of each term of a committed class whose node has the key,
    a committer row's weight; then each block_dyn cell the round sets
    written, and each score_dyn cell it moves read and written, once."""
    import torch

    c, n = aux.score_dyn.shape
    d = aux.depth
    dev = aux.score_dyn.device
    committed = torch.nonzero(commit, as_tuple=True)[0]
    ks = class_of[committed].long()
    ns = choice[committed].long().clamp(0, n - 1)
    nc = int(committed.numel())
    n_bytes = commit.numel() + nc * (choice.element_size() + class_of.element_size())
    ops = commit.numel()
    if not nc:
        return n_bytes, ops
    n_k = int(torch.unique(ks).numel())
    nodes, node_at = torch.unique(ns, return_inverse=True)
    block = torch.zeros((c, n), dtype=torch.bool, device=dev)
    score = torch.zeros((c, n), dtype=torch.bool, device=dev)
    for name, g, own in (("req_affinity", "aff", aux.aff_term_cross),
                         ("req_anti_affinity", "anti", aux.anti_cross),
                         ("pref_affinity", "paff", aux.paff_cross),
                         ("pref_anti_affinity", "panti", aux.panti_cross)):
        if name not in aux.present:
            continue
        dom, cnt = getattr(aux, f"dom_{g}"), getattr(aux, f"{g}_cnt")
        t = dom.shape[1]
        planes = cnt.shape[-1] == n
        if name == "req_affinity":
            take = aux.aff_cross_all[:, None, ks] & aux.req_aff_valid[:, :, None]
            n_bytes += c * n_k + nbytes(aux.req_aff_valid)
        else:
            take = own[:, :, ks]
            n_bytes += c * t * n_k
        ops += c * t * nc
        dom_at = dom[:, :, ns]  # [C, T, commits]
        hit = take & (dom_at < d)
        # each count row's committed domains
        mark = torch.zeros((c, t, d + 1), dtype=torch.bool, device=dev)
        mark.scatter_(2, torch.where(hit, dom_at, d).long(), True)
        mark[:, :, d] = False
        # each committer row's: class k's commits at their node's domain
        dom_k = dom[ks, :, ns]  # [commits, T]
        kk = ks[:, None].expand(nc, t)
        tt = torch.arange(t, device=dev)[None].expand(nc, t)
        keyed = dom_k < d
        asked = torch.zeros((c, t), dtype=torch.bool, device=dev)
        asked[kk[keyed], tt[keyed]] = True
        live = keyed & own.any(dim=-1)[kk, tt]
        mine = torch.zeros((c, t, d + 1), dtype=torch.bool, device=dev)
        mine[kk[live], tt[live], dom_k[live].long()] = True
        gain = mark.gather(2, dom.long())
        same = mine.gather(2, dom.long())
        reached, rows = mark.any(dim=-1), same.any(dim=-1)
        whole = (reached | rows) if planes else rows
        took = torch.zeros((c, t, nodes.numel()), dtype=torch.float32, device=dev)
        took.index_add_(2, node_at, take.to(torch.float32))
        n_bytes += 4 * n * int(whole.sum()) + 4 * int(((took > 0) & ~whole[:, :, None]).sum())
        n_bytes += 8 * int(gain.sum() if planes else mark.sum())
        ops += n * int(whole.sum())
        if name == "req_affinity":
            n_bytes += 8 * int(reached.any(dim=1).sum())
        # a term's cross row (the committed classes' bytes are counted above)
        n_bytes += int(asked.sum()) * (c if name == "req_affinity" else c - n_k)
        if name in ("pref_affinity", "pref_anti_affinity"):
            n_bytes += 4 * int(rows.sum())
        cells = torch.einsum("ktj,ktn->jn", (own & rows[:, :, None]).to(torch.float32),
                             same.to(torch.float32)) > 0
        ops += int(cells.sum())
        (block if name == "req_anti_affinity" else score).logical_or_(cells)
    return n_bytes + int(block.sum()) + 8 * int(score.sum()), ops


# --- K10: InterPodAffinity's filter into the bit plane ---------------------------


def k10_work(aux, bits, bit: int) -> tuple:
    """(bytes, operations) K10 must move and do on these inputs: the
    existing-pod and dynamic block planes read once; with required
    affinity the row flags (term validity, aff_total, self_match) and, per
    valid term row, its domain row and its counts — a plane's at every
    keyed node, a table's once per keyed domain; with required
    anti-affinity the same for every term row with a keyed node; the bit
    plane read where the filter fails and written where it fails on a set
    ``bit``.  Per (row, node) two tests, per (term row, node) two more."""
    import torch

    from kubernetes_tpu_torch.kernels.interpodaffinity import ipa_filter_plane

    c, n = bits.shape
    d = aux.depth
    n_bytes = nbytes(aux.exist_anti_block, aux.block_dyn)
    term_rows = 0
    for name, g in (("req_affinity", "aff"), ("req_anti_affinity", "anti")):
        if name not in aux.present:
            continue
        dom, cnt = getattr(aux, f"dom_{g}"), getattr(aux, f"{g}_cnt")
        keyed = dom < d  # [C, T, N]
        if name == "req_affinity":
            rows = aux.req_aff_valid
            n_bytes += nbytes(aux.req_aff_valid, aux.aff_total, aux.self_match_all)
        else:
            rows = keyed.any(dim=-1)
        keyed = keyed & rows[:, :, None]
        n_rows = int(rows.sum())
        term_rows += n_rows
        n_bytes += 4 * n * n_rows
        if cnt.shape[-1] == n:
            n_bytes += 4 * int(keyed.sum())
        else:
            seen = torch.zeros(cnt.shape, dtype=torch.bool, device=dom.device)
            seen.scatter_(2, torch.where(keyed, dom, d).long(), True)
            n_bytes += 4 * int(seen[:, :, :d].sum())
    fail = ~ipa_filter_plane(aux)
    n_clear = int((fail & (((bits >> bit) & 1) == 1)).sum())
    return n_bytes + 4 * int(fail.sum()) + 4 * n_clear, 2 * c * n + 2 * term_rows * n


# K10's shapes: label → (C, form, present groups, N); the path's batch has no
# required term (SchedulingPreferredPodAffinity), SchedulingPodAffinity's
# required affinity on zone tables, SchedulingPodAntiAffinity's required
# anti-affinity on hostname planes; C = 4 a dedup round, 1 the scan's row,
# 512 the full auction
K10_CASES = {
    "C = 4, planes, no required term": (4, "planes", ("pref_affinity",), 8192),
    "C = 4, tables, required affinity": (4, "tables", ("req_affinity",), 8192),
    "C = 1, tables, required affinity": (1, "tables", ("req_affinity",), 8192),
    "C = 512, tables, required affinity": (512, "tables", ("req_affinity",), 8192),
    "C = 4, planes, required anti-affinity": (4, "planes", ("req_anti_affinity",), 8192),
    "C = 1, planes, required anti-affinity": (1, "planes", ("req_anti_affinity",), 8192),
    "C = 512, planes, required anti-affinity": (512, "planes", ("req_anti_affinity",), 8192),
    "C = 4, tables, required affinity, N = 8190": (4, "tables", ("req_affinity",), 8190),
}


def k10_inputs(label: str, dev, seed: int = 10):
    """(aux, bits, bit) at K10's shape ``label``: ``ipa_view``'s class view
    (5000 live nodes, the rest without the key; counts 0–3, so some nodes
    match and some do not; aff_total 0–99 with a self-match, so a row of 0
    takes the first-pod escape) and K1's bit plane (7 filter bits, ~70% of
    the live nodes with every bit, dead nodes 0); bit 3 is the filter's.
    With a required term, a block on 1% of the nodes in each of the
    existing-pod and dynamic planes; without one (the path's batch) no
    block, so the filter clears nothing, as on the path."""
    import numpy as np
    import torch

    c, form, present, n = K10_CASES[label]
    aux = ipa_view(c, form, present, dev, seed=seed, n=n)
    rng = np.random.default_rng(seed + c)
    live, full = 5000, 0b1111111
    bits = np.where(rng.random((c, n)) < 0.7, full,
                    full & ~(1 << rng.integers(0, 7, (c, n)))).astype(np.int32)
    bits[:, live:] = 0
    frac = 0.01 if {"req_affinity", "req_anti_affinity"} & set(present) else 0.0
    aux = aux._replace(
        exist_anti_block=torch.from_numpy(rng.random((c, n)) < frac).to(dev),
        block_dyn=torch.from_numpy(rng.random((c, n)) < frac).to(dev))
    return aux, torch.from_numpy(bits).to(dev), 3


# --- K27: the priority-level prefix -------------------------------------------------

# K27's block, a copy of csrc/preempt.cu's PREFIX_* and BLOCK_BASE: a tile
# of K27_TILE nodes, a list of K27_CAP gathered pods a round, at most
# K27_MAX_SMEM dynamic bytes (one block an SM)
K27_TILE, K27_CAP, K27_MAX_SMEM, K27_BASE = 64, 1024, 200 * 1024, 16


def k27_plan(r: int, k: int) -> tuple:
    """(window, dynamic shared bytes): K27's plan for ``r`` requests and
    ``k`` levels, a copy of ``prefix_plan`` in csrc/preempt.cu
    (``chip_smoke.py`` holds the two together on the card): the list's
    K27_CAP entries (4·r + 7 bytes each), then the largest window of w
    levels (a multiple of 16, at most k rounded up to 16) whose totals and
    w / 16 + 1 carry rows (r + 1 floats a node each) fit beside it."""
    per_level = K27_TILE * (r + 1) * 4
    lst = K27_CAP * (4 * r + 7)
    k16 = max(K27_BASE, -(-k // K27_BASE) * K27_BASE)
    fits = [c for c in range(K27_BASE, k16 + 1, K27_BASE)
            if lst + (c + c // K27_BASE + 1) * per_level <= K27_MAX_SMEM]
    if not fits:
        raise ValueError(f"k27_plan: no window fits R = {r}")
    w = fits[-1]
    return w, lst + (w + w // K27_BASE + 1) * per_level


def k27_work(pod_valid, pod_node, pod_priority, pod_request, levels, n: int) -> tuple:
    """(bytes, operations) K27 must move and do on these inputs: the valid
    flags of the tier; each valid pod's node; each valid bound pod's
    priority, and its requests where its bucket is below K (the reference
    drops the rest); the levels; the [K+1, N, R] and [K+1, N] outputs
    written once.  An add a (kept pod, channel) and a (level, node,
    channel) of the prefix."""
    import torch

    p, r = pod_request.shape
    k = levels.shape[0]
    bound = pod_valid & (pod_node >= 0)
    kept = bound & (torch.searchsorted(levels, pod_priority) < k)
    n_kept = int(kept.sum())
    n_bytes = (nbytes(pod_valid) + 4 * int(pod_valid.sum()) + 4 * int(bound.sum())
               + 4 * r * n_kept + 4 * k + 4 * (k + 1) * n * (r + 1))
    return n_bytes, n_kept * (r + 1) + k * n * (r + 1)


# K27's shapes: label → (N, live nodes, P, R, priorities, hot-node pods); the
# path's (PreemptionBasic/5000Nodes: two live levels, ~10.8k bound pods of a
# 32768-row tier), the check case's 128 levels on odd-KiB requests, a node
# holding more pods than a round, and R = 16 over 128 levels (windows); the
# path with a quarter of the tier (one chunk), with one request (a fifth of
# the output) and a node holding 1500 pods split where the time goes
K27_CASES = {
    "path": (8192, 5000, 32768, 8, 2, 0),
    "check case, 128 levels": (8192, 8192, 32768, 4, 128, 0),
    "hot node": (8192, 5000, 32768, 8, 2, 6000),
    "R = 16, 128 levels": (8192, 8192, 32768, 16, 128, 0),
    "path, P = 8192": (8192, 5000, 8192, 8, 2, 0),
    "path, R = 1": (8192, 5000, 32768, 1, 2, 0),
    "hot node, 1500 pods": (8192, 5000, 32768, 8, 2, 1500),
}


def _pod_tier(n: int, live: int, p: int, r: int, n_prio: int, hot: int, rng):
    """A pod tier as numpy arrays (valid, node, priority, request, levels):
    pods bound to the ``live`` nodes at random (a third of the tier with
    two levels, else 90%, valid; a twentieth unbound), odd-KiB memory
    requests near 1.6M so the float32 sums round, priorities ``10 · k``
    over ``n_prio`` levels; ``hot`` pods on node 7; the levels padded with
    i32-max to 128."""
    import numpy as np

    node = rng.integers(0, live, p).astype(np.int32)
    valid = rng.random(p) < (0.33 if n_prio <= 2 else 0.9)
    node[rng.random(p) < 0.05] = -1
    if hot:
        node[:hot] = 7
        valid[:hot] = True
    prios = (np.arange(n_prio) * 10).astype(np.int32)
    prio = prios[rng.integers(0, n_prio, p)]
    req = np.zeros((p, r), np.int32)
    req[:, 0] = rng.integers(100, 1000, p)
    if r > 1:
        req[:, 1] = rng.integers(700_000, 900_000, p) * 2 + 1
    if r > 2:
        req[:, 2:] = rng.integers(0, 8, (p, r - 2))
        req[:, r - 1] = 1
    levels = np.full(128, np.iinfo(np.int32).max, np.int32)
    levels[:n_prio] = prios
    return valid, node, prio, req, levels


def k27_inputs(label: str, dev, seed: int = 27):
    """(pod_valid, pod_node, pod_priority, pod_request, levels, n) at K27's
    shape ``label``: ``_pod_tier``'s tier."""
    import numpy as np
    import torch

    n, live, p, r, n_prio, hot = K27_CASES[label]
    rng = np.random.default_rng(seed)
    t = [torch.from_numpy(x).to(dev) for x in _pod_tier(n, live, p, r, n_prio, hot, rng)]
    return (*t, n)


# K28 candidate_fit: the threshold gather and the fit over K27's table --
# the [B, N] static bits read and the mask written, each distinct threshold
# row of prefix and prefix_cnt, the node rows, the batch rows and the
# levels read once; a compare a (row, node, channel)


# K28's layout (csrc/preempt.cu FIT_*): nodes a block, batch rows a block,
# nodes a thread, dynamic shared bytes a block
K28_TILE, K28_GROUP, K28_NPT, K28_SMEM = 128, 128, 16, 40 * 1024


def k28_plan(r: int) -> tuple:
    """(slots, dynamic shared bytes): K28's plan for ``r`` channels, a copy
    of ``fit_plan`` in csrc/preempt.cu (``chip_smoke.py`` holds the two
    together on the card): base and requested [r][K28_TILE + 4] floats,
    then as many slots as fit K28_SMEM (at most the K28_GROUP rows of a
    group), each a free row [r][K28_TILE + 4], the counts [K28_TILE] and
    their 16-node masks."""
    ntp = K28_TILE + 4
    fixed = 8 * r * ntp
    per = 4 * r * ntp + 4 * K28_TILE + 4 * (K28_TILE // K28_NPT)
    slots = 0 if fixed >= K28_SMEM else min(K28_GROUP, (K28_SMEM - fixed) // per)
    return slots, fixed + slots * per


def k28_work(prefix, prefix_cnt, levels, priority, request, allocatable, requested,
             static_bits, static_mask: int) -> tuple:
    """(bytes, operations) K28 must move and do on these inputs: the static
    bits read and the mask written (5 bytes a pair), each distinct
    threshold row of prefix and prefix_cnt, alloc and requested, the batch
    rows' priority and requests and the levels, once each; a compare a
    (row, node, channel)."""
    import torch

    b, n = static_bits.shape
    r = allocatable.shape[1]
    tbs = int(torch.unique(torch.searchsorted(levels, priority)).numel())
    n_bytes = (5 * b * n + tbs * n * (r + 1) * 4 + 8 * n * r + b * (r + 1) * 4
               + 4 * levels.numel())
    return n_bytes, 4 * b * n * r


# K28's shapes: label → (B, N, live nodes, R, priorities, kind); the path
# (PreemptionBasic/5000Nodes: two live levels, one request shape, batch rows
# at the top level), the check case's 128 levels with batch rows across them
# (many distinct thresholds a row group), the ulp-boundary rows (the fit
# value and one ulp above), R = 4 and 16, N = 8190 (no 16-byte rows) and
# static bits that mostly fail
K28_CASES = {
    "path": (512, 8192, 5000, 8, 2, "path"),
    "check case, 128 levels": (512, 8192, 8192, 4, 128, "spread"),
    "boundary rows": (512, 8192, 8192, 4, 128, "boundary"),
    "R = 4": (512, 8192, 5000, 4, 2, "path"),
    "R = 16": (512, 8192, 5000, 16, 2, "path"),
    "N = 8190": (512, 8190, 5000, 8, 2, "path"),
    "static bits mostly fail": (512, 8192, 5000, 8, 2, "fail"),
}


def k28_inputs(label: str, dev, seed: int = 28) -> tuple:
    """``candidate_fit``'s arguments at ``K28_CASES[label]``: ``_pod_tier``'s
    tier over 32768 rows, its prefix by the plain K27 on the CPU; nodes of
    4000m cpu, 32Gi (2^25 KiB) and 110 pods, requested up to 98% of each;
    batch rows of 3000m / 500Mi / 1 pod at the top level ("path", a
    sixteenth at level 0), random requests across the levels ("spread"),
    or pairs asking exactly a node's float32 fit value at a threshold and
    one ulp more ("boundary"); static bits (mask 0b1111) set on the live
    nodes but for 2% of them (95% with "fail")."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.kernels.preempt import priority_prefix_plain

    b, n, live, r, n_prio, kind = K28_CASES[label]
    rng = np.random.default_rng(seed)
    tier = [torch.from_numpy(x) for x in _pod_tier(n, live, 32768, r, n_prio, 0, rng)]
    lv = tier[4]
    prefix, cnt = priority_prefix_plain(*tier, n)
    alloc = np.zeros((n, r), np.int32)
    alloc[:, 0] = 4000
    if r > 1:
        alloc[:, 1] = 1 << 25
    if r > 2:
        alloc[:, r - 1] = 110
    requested = (alloc * rng.uniform(0.5, 0.98, (n, r))).astype(np.int32)
    req = np.zeros((b, r), np.int32)
    prios = lv.numpy()[:n_prio]
    if kind == "spread":
        prio = prios[rng.integers(0, n_prio, b)] + 1
        req[:, 0] = rng.integers(0, 3000, b)
        if r > 1:
            req[:, 1] = rng.integers(0, 1 << 25, b)
    else:
        prio = np.full(b, prios[-1], np.int32)
        prio[: b // 16] = prios[0]
        req[:, 0] = 3000
        if r > 1:
            req[:, 1] = 512_000
    if r > 2:
        req[:, r - 1] = 1
    if kind == "boundary":
        free = alloc.astype(np.float32) - requested.astype(np.float32)
        pf = prefix.numpy()
        req[:] = 0
        for j in range(b // 2):
            node = int(rng.integers(0, live))
            th = int(rng.integers(1, n_prio + 1))
            v = float(np.float32(free[node, 1] + pf[th, node, 1]))
            ulp = max(1, int(np.spacing(np.float32(v))))
            prio[2 * j: 2 * j + 2] = lv[th] if th < n_prio else prios[-1] + 1
            req[2 * j, 1], req[2 * j + 1, 1] = int(v), int(v) + ulp
    fail_p = 0.95 if kind == "fail" else 0.02
    bits = np.where(rng.random((b, n)) < fail_p, 0b1011, 0b1111).astype(np.int32)
    bits[:, live:] = 0
    t = [x.to(dev) for x in (prefix, cnt, lv)]
    t += [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
          for x in (prio.astype(np.int32), req, alloc, requested, bits)]
    return (*t, 0b1111)


# K25 dra_score_into: DynamicResources' score added into K2's total


def k25_plan(c: int, n: int) -> tuple:
    """(rows a thread, nodes a thread): K25's plan, a copy of ``score_plan``
    in csrc/dra.cu (``chip_smoke.py`` holds the two together on the card):
    4 nodes of the fewest of 1, 2, 4, 8 rows that keep ceil(C / rows) ·
    ceil(N / 4) threads to one wave of the card (132 SMs × 2048); one node
    of one row a thread where C · ceil(N / 4) is under 132 × 256."""
    vecs = -(-n // 4)
    if c * vecs < 132 * 256:
        return 1, 1
    rows = 1
    while rows < 8 and -(-c // rows) * vecs > 132 * 2048:
        rows *= 2
    return rows, 4


def k25_work(bits, full: int, total, cap, free, demand, weight) -> tuple:
    """(bytes, operations) K25 must move and do on these inputs: the bit
    plane read; the feasible entries' totals read and written; cap / free
    and demand once; six float32 operations a scored entry (feasible, with
    demand, on a node with inventory)."""
    c, n = bits.shape
    feas = bits == full
    n_feas = int(feas.sum())
    n_scored = int((feas & (demand[:, None] > 0) & (cap[None, :] > 0)).sum())
    return 4 * c * n + 8 * n_feas + 8 * n + 4 * c, 6 * n_scored


# K25's shapes: label → (C, N, kind); the DeviceClaimGang path's claim
# rounds (B = 64; a 4-chip claim a pod, one 4-chip slice a live host, half
# of them taken), the harness's C = 512 and the scan's C = 1; N = 8190 (no
# 16-byte rows); no feasible entry; random claims (demand 0–8, capacities
# 0–16, some over-allocated); the floor grid (capacity 1–256 × used)
K25_CASES = {
    "C = 64, path": (64, 8192, "path"),
    "C = 512": (512, 8192, "path"),
    "C = 1": (1, 8192, "path"),
    "N = 8190": (64, 8190, "path"),
    "no feasible entry": (64, 8192, "none"),
    "C = 64, random claims": (64, 8192, "random"),
    "floor grid": (1, None, "grid"),
}


def k25_inputs(label: str, dev, seed: int = 25) -> tuple:
    """``dra_score_into``'s arguments (bits, full, total, cap, free, demand,
    weight) at ``K25_CASES[label]``; the totals hold K2's scores (integers
    0–400) on feasible entries and −inf elsewhere."""
    import numpy as np
    import torch

    c, n, kind = K25_CASES[label]
    rng = np.random.default_rng(seed)
    full = (1 << 16) - 1
    weight = 1.0
    if kind == "grid":
        pairs = [(u, cp) for cp in range(1, 257) for u in range(cp + 1)]
        n = len(pairs)
        used = np.array([u for u, _ in pairs], np.int32)
        cap = np.array([cp for _, cp in pairs], np.int32)
        free = cap - used + 1
        demand = np.ones(1, np.int32)
        feas = np.ones((1, n), bool)
    elif kind == "random":
        demand = rng.integers(0, 9, c).astype(np.int32)
        demand[rng.random(c) < 0.2] = 0
        cap = np.array([0, 2, 4, 8, 16], np.int32)[rng.integers(0, 5, n)]
        cap[5000:] = 0
        free = cap - np.minimum(rng.integers(0, 18, n), cap + 3).astype(np.int32)
        feas = rng.random((c, n)) < 0.7
        weight = 2.0
    else:
        live = 5000
        demand = np.full(c, 4, np.int32)
        cap = np.zeros(n, np.int32)
        cap[:live] = 4
        free = np.where(rng.random(n) < 0.5, cap, 0).astype(np.int32)
        feas = np.zeros((c, n), bool) if kind == "none" else \
            np.broadcast_to((free >= 4)[None, :], (c, n))
    bits = np.where(feas, full, full & ~(1 << rng.integers(0, 16, (c, n)))).astype(np.int32)
    total = np.where(feas, rng.integers(0, 401, (c, n)).astype(np.float32),
                     np.float32(-np.inf)).astype(np.float32)
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
         for x in (bits, total, cap.astype(np.int32), free.astype(np.int32), demand)]
    return t[0], full, t[1], t[2], t[3], t[4], weight
