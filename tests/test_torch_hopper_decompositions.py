"""K1's and K13's Hopper decompositions, mirrored in numpy, against the JAX
package (exact).

The CUDA kernels run only on the card; these mirrors walk the inputs in the
kernels' own order and with their own skips, so that the decomposition —
not only the function — is held against the reference on the CPU:

* K1 ``filter_score_planes`` (the dedup round's static planes,
  framework/runtime.py:852-867, from plugins/trivial.py,
  plugins/tainttoleration.py and plugins/noderesources.py): blocks of node
  tiles × class groups, each group walked in chunks of staged classes.
  Each node is read once a block — its resource rows, and skip flags from
  its first taints, host ports and (a valid node's) images: a flagged node,
  or one wider than that, walks its rows whole; each class once a chunk — its
  request rows, the tolerates-unschedulable flag, Fit's and
  BalancedAllocation's per-dimension include masks, its valid tolerations,
  host ports and image ids compacted (past a staged count, read whole), its
  image threshold and its image score on a node holding none of its images.
  A node with no acting taint, no host port or no image skips that walk;
  dimensions
  past the staged count take the unstaged walk; BalancedAllocation's
  fractions are computed once and reused for the variance.  On the
  reference's encoded clusters (``tests/test_torch_plugins.py``'s: taints
  of all three effects, tolerations by key, by value and of every key,
  host ports with a concrete and a wildcard IP, images present and absent,
  unschedulable and NotReady nodes, padding rows, floor-boundary
  capacities), with nodes given many taints (the unschedulable key among
  them), host ports and images, and an extended
  resource that half the pods request (weighted in Fit, selected by
  BalancedAllocation), under Fit's three strategies, at tile, group and
  chunk sizes that cut N and C unevenly, with the kernel's staged counts
  and with counts of one; every cell is written once, and its filter bits
  and five raw planes equal the JAX plugins' planes.
* K13 ``prev_delta_apply`` (``reserve_nominated`` + ``apply_prev_delta``,
  scheduler.py:889-916): blocks own node tiles, stage the bundles' rows in
  chunks, add the pods that land in their tile (rows −1 add nothing, rows
  ≥ N land on N − 1) in any order, a bundle with no ``nz`` rows leaving
  ``non_zero`` alone; equal to the reference's ``.at[clip(rows)].add`` for
  three bundles, two pods on one node among them.

Tolerance: exact (float32 operations in the reference's order, integer
adds).
"""

from __future__ import annotations

from types import SimpleNamespace as NS

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.plugins.noderesources import BalancedAllocationPlugin as JBalanced
from kubernetes_tpu.plugins.noderesources import FitPlugin as JFit
from kubernetes_tpu.plugins.noderesources import fit_filter as j_fit_filter
from kubernetes_tpu.plugins.tainttoleration import TaintTolerationPlugin as JTaint
from kubernetes_tpu.plugins.trivial import (
    ImageLocalityPlugin as JImage,
    NodeNamePlugin as JName,
    NodePortsPlugin as JPorts,
    NodeUnschedulablePlugin as JUnsched,
)
from kubernetes_tpu_torch.kernels.prev_delta import prev_delta_apply_plain
from kubernetes_tpu_torch.ops.fma import fma32
from kubernetes_tpu_torch.plugins.trivial import image_scaled_by_id
from kubernetes_tpu_torch.state.dictionary import ID_UNSCHEDULABLE_TAINT, ID_WILDCARD_IP

from tests.test_torch_plugins import build_problem

F32 = np.float32
MISSING = -1
TOL_OP_EXISTS = 1
MIN_THRESHOLD = F32(23 * 1024 * 1024)
MAX_CONTAINER_THRESHOLD = 1000 * 1024 * 1024
DX_EPS = F32(2.0 ** -46)
STRATEGY = {"LeastAllocated": 0, "MostAllocated": 1, "RequestedToCapacityRatio": 2}
# the framework's filter order for the six kernel filters, and a pass-through bit
BITS = {"unsched": 0, "name": 1, "taint": 2, "affinity": 3, "ports": 4, "fit": 5}
PASS_BITS = 1 << 6
EXT = {"example.com/gpu": 4}

# csrc/filter_score.cu's counts, and counts of one (every overflow path):
# resource dimensions in registers, a node's entries read for its skip flags
# (NODE_CAP), a class's tolerations / ports / image ids staged
KERNEL_CAPS = dict(rs=8, node=8, ct=8, cp=8, ci=8)
ONE_CAPS = dict(rs=4, node=1, ct=1, cp=1, ci=1)


# --- K1: node tiles × class chunks ---------------------------------------------------------


def _k1_problem(seed: int):
    """The reference's encoded cluster (64 node rows, 64 pod rows as the
    class rows, padding included) as numpy arrays, widened: a few nodes
    with many taints (the unschedulable key's NoSchedule taint among them),
    host ports (the pods' 8080 / 9090 on the wildcard, the same and another
    IP) and images, and an extended resource on half the nodes that half
    the pods request."""
    p = build_problem(seed, boundary=seed == 2)
    rng = np.random.default_rng(100 + seed)
    b, s = p["batch"], p["dsnap"]
    cls = {f: np.asarray(getattr(b, f)).copy() for f in (
        "valid", "request", "non_zero", "node_name_id", "tol_valid", "tol_key", "tol_val",
        "tol_op", "tol_effect", "ports", "ports_ip", "image_ids")}
    nodes = {f: np.asarray(getattr(s, f)).copy() for f in (
        "node_valid", "node_ready", "node_name_ids", "unschedulable", "allocatable",
        "taint_keys", "taint_vals", "taint_effects", "ports", "ports_ip", "image_ids",
        "image_sizes", "numeric")}
    nodes["requested"] = np.asarray(p["dyn"].requested).copy()
    nodes["non_zero"] = np.asarray(p["dyn"].non_zero).copy()
    n = nodes["node_valid"].shape[0]
    live = np.flatnonzero(nodes["node_valid"])
    keys = np.unique(nodes["taint_keys"][nodes["taint_keys"] >= 0])
    vals = np.unique(nodes["taint_vals"][nodes["taint_vals"] >= 0])
    # more acting taints than staged on six nodes, the unschedulable key on two
    for i, node in enumerate(live[:6]):
        nodes["taint_keys"][node, 2:8] = rng.choice(keys, 6)
        nodes["taint_vals"][node, 2:8] = rng.choice(vals, 6)
        nodes["taint_effects"][node, 2:8] = rng.choice([0, 1, 2, -1], 6)
        if i < 2:
            nodes["taint_keys"][node, 7] = ID_UNSCHEDULABLE_TAINT
            nodes["taint_effects"][node, 7] = 0
    # host ports: the pods' codes on the wildcard IP, on the pods' own IP
    # and on another IP; five on two nodes
    codes = cls["ports"][cls["ports"] >= 0]
    ips = cls["ports_ip"][cls["ports"] >= 0]
    for node in live[6:20]:
        j = int(rng.integers(len(codes)))
        nodes["ports"][node, 0] = codes[j]
        nodes["ports_ip"][node, 0] = rng.choice([ID_WILDCARD_IP, ips[j], 99999])
    for node in live[20:22]:
        nodes["ports"][node, :5] = rng.choice(codes, 5)
        nodes["ports_ip"][node, :5] = rng.choice([ID_WILDCARD_IP, 99999], 5)
    # images: every id on two nodes (more than one staged)
    img_ids = np.unique(nodes["image_ids"][nodes["image_ids"] >= 0])
    for node in live[22:24]:
        nodes["image_ids"][node, :len(img_ids)] = img_ids
        nodes["image_sizes"][node, :len(img_ids)] = 5e8
    # an extended resource: on half the nodes, requested by half the valid pods
    has = rng.random(n) < 0.5
    nodes["allocatable"][:, 4] = np.where(has, rng.integers(1, 9, n), 0)
    nodes["requested"][:, 4] = np.where(has, rng.integers(0, 3, n), 0)
    cls["request"][:, 4] = np.where(rng.random(64) < 0.5, rng.integers(1, 3, 64), 0)
    return cls, nodes


def _plugins(strategy: str, shape=None):
    res = {"cpu": 1, "memory": 1, "example.com/gpu": 2}
    fit = JFit(strategy, resources=res, num_resource_dims=8, extended_index=EXT, shape=shape)
    ba = JBalanced(resources={"cpu": 1, "memory": 1, "example.com/gpu": 1},
                   num_resource_dims=8, extended_index=EXT)
    return fit, ba


def _extra(cls, nodes, fit, ba, seed: int) -> dict:
    rng = np.random.default_rng(200 + seed)
    c, n = cls["valid"].shape[0], nodes["node_valid"].shape[0]
    snap = NS(**{k: torch.from_numpy(nodes[k]) for k in (
        "image_ids", "node_valid", "numeric", "image_sizes")})
    return dict(
        na_mask=rng.random((c, n)) < 0.85,
        na_pref=rng.integers(0, 4, (c, n)).astype(F32) * F32(5),
        img_scaled=image_scaled_by_id(snap).numpy(),
        fit_w=fit.weights.astype(F32), ba_sel=ba.sel.copy(),
        strategy=STRATEGY[fit.strategy], shape_x=fit.shape_x, shape_y=fit.shape_y)


def _jax_planes(cls, nodes, ex, fit, ba) -> dict:
    """Every plane K1 folds, from the JAX plugins (under jax.jit, as the
    reference scheduler runs them)."""
    j = {k: jnp.asarray(v) for k, v in cls.items()}
    s = {k: jnp.asarray(v) for k, v in nodes.items()}

    def planes(j, s):
        batch = NS(**j)
        snap = NS(**s)
        dyn = NS(requested=s["requested"], non_zero=s["non_zero"])
        return {
            "unsched": JUnsched().filter(batch, snap, dyn),
            "name": JName().filter(batch, snap, dyn),
            "taint": JTaint().filter(batch, snap, dyn),
            "ports": JPorts().filter(batch, snap, dyn),
            "fit": j_fit_filter(batch, snap, dyn),
            "taint_score": JTaint().score(batch, snap, dyn),
            "fit_score": fit.score(batch, snap, dyn),
            "ba_score": ba.score(batch, snap, dyn),
            "img_score": JImage().score(batch, snap, dyn),
        }

    out = {k: np.asarray(v) for k, v in jax.jit(planes)(j, s).items()}
    live = (nodes["node_valid"] & nodes["node_ready"])[None, :] & cls["valid"][:, None]
    want_bits = np.where(live, PASS_BITS, 0)
    for name, bit in BITS.items():
        plane = ex["na_mask"] if name == "affinity" else out[name]
        want_bits |= np.where(live & plane, 1 << bit, 0)
    want_raw = np.stack([out["taint_score"], ex["na_pref"], out["fit_score"], out["ba_score"],
                         out["img_score"]]).astype(F32)
    return {"bits": want_bits.astype(np.int32), "raw": want_raw}


def _interp(x, xp, fp):
    """csrc/filter_score.cu's rtcr_interp: jnp.interp's binary search and
    its fused multiply-add."""
    s = xp.shape[0]
    levels = 0
    while (1 << levels) < s + 1:
        levels += 1
    low, high = 0, s
    for _ in range(levels):
        mid = (low + high) // 2
        if x < xp[min(mid, s - 1)]:
            high = mid
        else:
            low = mid
    i = min(max(high, 1), s - 1)
    df, dx, delta = fp[i] - fp[i - 1], xp[i] - xp[i - 1], x - xp[i - 1]
    if abs(dx) <= DX_EPS:
        f = fp[i - 1]
    else:
        f = F32(fma32(*(torch.tensor([v], dtype=torch.float32)
                        for v in (delta / dx, df, fp[i - 1])))[0])
    if x < xp[0]:
        f = fp[0]
    if x > xp[s - 1]:
        f = fp[s - 1]
    return f


def _per_dim(strategy: int, total, alloc, ex):
    if strategy == 2:
        util = F32(100) if alloc == 0 else \
            F32(min(total / max(alloc, F32(1)), F32(1)) * F32(100))
        return _interp(util, ex["shape_x"], ex["shape_y"])
    if alloc == 0 or total > alloc:
        return F32(0)
    num = total * F32(100) if strategy == 1 else (alloc - total) * F32(100)
    return F32(np.floor(num / max(alloc, F32(1))))


def _image_score(img_sum, max_t):
    clamped = min(max(img_sum, MIN_THRESHOLD), max_t)
    return F32(F32(100) * (clamped - MIN_THRESHOLD)) / (max_t - MIN_THRESHOLD)


def _compact(row, keep, cap: int):
    """A staged list: the kept entries in order, or None past ``cap`` (the
    kernel then reads the whole row)."""
    got = [i for i, v in enumerate(row) if keep(v)]
    return got if len(got) <= cap else None


def _stage_node(n: int, nodes, caps, r: int) -> dict:
    """The node's registers: its resource rows, and its skip flags from the
    first ``caps["node"]`` entries of its taint, port and image rows (a row
    wider than that is flagged: it is walked)."""
    rs, w = min(caps["rs"], r), caps["node"]
    nvalid = bool(nodes["node_valid"][n])
    te, pp, im = nodes["taint_effects"][n], nodes["ports"][n], nodes["image_ids"][n]
    return dict(
        al=nodes["allocatable"][n, :rs].copy(), rq=nodes["requested"][n, :rs].copy(),
        nz=nodes["non_zero"][n].copy(), name=int(nodes["node_name_ids"][n]),
        live=bool(nodes["node_valid"][n] & nodes["node_ready"][n]),
        unsched=bool(nodes["unschedulable"][n]),
        any_t=len(te) > w or any(e in (0, 1, 2) for e in te[:w]),
        any_p=len(pp) > w or any(v != MISSING for v in pp[:w]),
        any_i=nvalid and (len(im) > w or any(v != MISSING for v in im[:w])))


def _stage_class(c: int, cls, ex, caps, r: int, unsched_id: int) -> dict:
    rs = min(caps["rs"], r)
    req = cls["request"][c, :rs]
    ext_ok = [(d < 4) or (req[d] > 0) for d in range(rs)]
    tv = cls["tol_valid"][c]
    tol_unsched = any(tv[j] and cls["tol_key"][c, j] in (MISSING, unsched_id)
                      and cls["tol_effect"][c, j] in (-1, 0)
                      and cls["tol_op"][c, j] == TOL_OP_EXISTS for j in range(tv.shape[0]))
    ids = cls["image_ids"][c]
    count = int((ids != MISSING).sum())
    max_t = F32(np.int32(np.int64(max(count, 1) * MAX_CONTAINER_THRESHOLD)
                         .astype(np.uint32).view(np.int32)))
    img_sum = F32(0)
    for q in np.flatnonzero(ids != MISSING):  # a node with none: +0.0 terms
        img_sum = F32(img_sum + ex["img_scaled"][min(max(ids[q], 0),
                                                     ex["img_scaled"].shape[0] - 1)] * F32(0))
    return dict(
        valid=bool(cls["valid"][c]), nid=int(cls["node_name_id"][c]), req=req.copy(),
        nz=cls["non_zero"][c].copy(), tol_unsched=tol_unsched,
        fit=[ext_ok[d] and ex["fit_w"][d] > 0 for d in range(rs)],
        ba=[ext_ok[d] and bool(ex["ba_sel"][d]) for d in range(rs)],
        tols=_compact(tv, bool, caps["ct"]),
        ports=_compact(cls["ports"][c], lambda v: v != MISSING, caps["cp"]),
        images=_compact(ids, lambda v: v != MISSING, caps["ci"]),
        max_t=max_t, img_score0=_image_score(img_sum, max_t))


def _tolerates(cls, c, j, tk, tv, te) -> bool:
    pk, pe = cls["tol_key"][c, j], cls["tol_effect"][c, j]
    return ((pk == MISSING or pk == tk) and (pe == -1 or pe == te)
            and (cls["tol_op"][c, j] == TOL_OP_EXISTS or cls["tol_val"][c, j] == tv))


def _cell(c, n, k_c, k_n, cls, nodes, ex, caps, r, skips) -> tuple:
    """One (class, node) cell as the kernel computes it from the staged rows."""
    rs = min(caps["rs"], r)
    f_unsched = (not k_n["unsched"]) or k_c["tol_unsched"]
    f_name = k_c["nid"] == MISSING or k_c["nid"] == k_n["name"]
    # TaintToleration: the node's acting taints against the valid tolerations
    f_taint, prefer = True, 0
    if not k_n["any_t"]:
        skips["taint"] += 1
    else:
        taints = range(nodes["taint_effects"].shape[1])  # the row in global memory
        tols = k_c["tols"] if k_c["tols"] is not None \
            else [j for j in range(cls["tol_valid"].shape[1]) if cls["tol_valid"][c, j]]
        for t in taints:
            tk, tv, te = (nodes["taint_keys"][n, t], nodes["taint_vals"][n, t],
                          nodes["taint_effects"][n, t])
            if te not in (0, 1, 2):
                continue
            tol = any(_tolerates(cls, c, j, tk, tv, te) for j in tols
                      if te != 1 or cls["tol_effect"][c, j] in (-1, 1))
            if not tol:
                if te == 1:
                    prefer += 1
                else:
                    f_taint = False
    # NodePorts
    f_ports = True
    if not k_n["any_p"] or k_c["ports"] == []:
        skips["ports"] += 1
    else:
        nps = range(nodes["ports"].shape[1])
        cps = k_c["ports"] if k_c["ports"] is not None else range(cls["ports"].shape[1])
        for i in cps:
            pp, pip = cls["ports"][c, i], cls["ports_ip"][c, i]
            if pp == MISSING:
                continue
            for j in nps:
                nip = nodes["ports_ip"][n, j]
                if nodes["ports"][n, j] == pp and (
                        pip == nip or pip == ID_WILDCARD_IP or nip == ID_WILDCARD_IP):
                    f_ports = False
    # Fit + BalancedAllocation: the staged dimensions, then the rest
    f_fit, wsum, wscore, ba_sum, ba_n = True, F32(0), F32(0), F32(0), 0
    frac = {}
    for d in range(r):
        staged = d < rs
        req = k_c["req"][d] if staged else cls["request"][c, d]
        al = k_n["al"][d] if staged else nodes["allocatable"][n, d]
        rq = k_n["rq"][d] if staged else nodes["requested"][n, d]
        if not (req == 0 or req <= al - rq):
            f_fit = False
        if al <= 0:
            continue
        fit_in = k_c["fit"][d] if staged else (req > 0 and ex["fit_w"][d] > 0)
        ba_in = k_c["ba"][d] if staged else (req > 0 and bool(ex["ba_sel"][d]))
        if fit_in:
            nz_node = F32(k_n["nz"][d] if d < 2 else rq)
            nz_pod = F32(k_c["nz"][d] if d < 2 else req)
            w = F32(ex["fit_w"][d])
            per = _per_dim(ex["strategy"], F32(nz_node + nz_pod), F32(al), ex)
            wsum, wscore = F32(wsum + w), F32(wscore + F32(per * w))
        if ba_in:
            frac[d] = F32(min(F32(rq + req) / max(F32(al), F32(1)), F32(1)))
            ba_sum, ba_n = F32(ba_sum + frac[d]), ba_n + 1
    fit_score = F32(0) if wsum == 0 else F32(np.floor(wscore / max(wsum, F32(1))))
    ba_score = F32(0)
    if ba_n:
        denom = F32(ba_n)
        mean = F32(ba_sum / denom)
        var = F32(0)
        for d in sorted(frac):  # the fractions kept, in dimension order
            dd = F32(frac[d] - mean)
            var = F32(var + F32(dd * dd))
        ba_score = F32(F32(F32(1) - F32(np.sqrt(F32(var / denom)))) * F32(100))
    # ImageLocality
    img_score = k_c["img_score0"]
    if not k_n["any_i"] or k_c["images"] == []:
        skips["images"] += 1
    else:
        n_imgs = range(nodes["image_ids"].shape[1])
        c_imgs = k_c["images"] if k_c["images"] is not None \
            else range(cls["image_ids"].shape[1])
        img_sum = F32(0)
        for q in c_imgs:
            idv = cls["image_ids"][c, q]
            if idv == MISSING:
                continue
            scaled = ex["img_scaled"][min(max(idv, 0), ex["img_scaled"].shape[0] - 1)]
            present = any(nodes["image_ids"][n, j] == idv for j in n_imgs)
            img_sum = F32(img_sum + F32(scaled * F32(1.0 if present else 0.0)))
        img_score = _image_score(img_sum, k_c["max_t"])
    bits = 0
    if k_n["live"] and k_c["valid"]:
        bits = PASS_BITS
        for name, ok in (("unsched", f_unsched), ("name", f_name), ("taint", f_taint),
                         ("affinity", bool(ex["na_mask"][c, n])), ("ports", f_ports),
                         ("fit", f_fit)):
            bits |= (1 << BITS[name]) if ok else 0
    return bits, (F32(prefer), ex["na_pref"][c, n], fit_score, ba_score, img_score)


def k1_mirror(cls, nodes, ex, tile: int, per_group: int, chunk: int, caps: dict):
    """K1's walk: blocks of ``tile`` nodes × groups of ``per_group``
    classes, the group in chunks of ``chunk`` staged classes → (bits,
    raw, how many cells skipped each walk, class lists read whole)."""
    c_all, n_all = ex["na_mask"].shape
    r = nodes["allocatable"].shape[1]
    bits = np.full((c_all, n_all), -1, np.int64)
    raw = np.full((5, c_all, n_all), np.nan, F32)
    visits = np.zeros((c_all, n_all), np.int64)
    skips = {"taint": 0, "ports": 0, "images": 0}
    staged_nodes = [_stage_node(n, nodes, caps, r) for n in range(n_all)]
    over = 0
    for n0 in range(0, n_all, tile):
        tile_nodes = range(n0, min(n_all, n0 + tile))
        for c_begin in range(0, c_all, per_group):
            c_end = min(c_all, c_begin + per_group)
            for c0 in range(c_begin, c_end, chunk):
                staged = {c: _stage_class(c, cls, ex, caps, r, ID_UNSCHEDULABLE_TAINT)
                          for c in range(c0, min(c_end, c0 + chunk))}
                over += sum(v is None for k_c in staged.values()
                            for v in (k_c["tols"], k_c["ports"], k_c["images"]))
                for n in tile_nodes:
                    for c, k_c in staged.items():
                        bits[c, n], raw[:, c, n] = _cell(c, n, k_c, staged_nodes[n], cls,
                                                         nodes, ex, caps, r, skips)
                        visits[c, n] += 1
    assert (visits == 1).all(), "a cell written other than once"
    return bits.astype(np.int32), raw, skips, over


FIT_STRATEGIES = [("LeastAllocated", None), ("MostAllocated", None),
                  ("RequestedToCapacityRatio", None),
                  ("RequestedToCapacityRatio", [(0, 0), (30, 7), (30, 2), (70, 9), (100, 3)])]

_K1_CACHE = {}


def _k1_case(seed: int, strategy: str, shape):
    key = (seed, strategy, None if shape is None else tuple(shape))
    if key not in _K1_CACHE:
        cls, nodes = _k1_problem(seed)
        fit, ba = _plugins(strategy, shape)
        ex = _extra(cls, nodes, fit, ba, seed)
        _K1_CACHE[key] = (cls, nodes, ex, _jax_planes(cls, nodes, ex, fit, ba))
    return _K1_CACHE[key]


def _check_k1(seed, strategy, shape, tile, per_group, chunk, caps):
    cls, nodes, ex, want = _k1_case(seed, strategy, shape)
    bits, raw, skips, over = k1_mirror(cls, nodes, ex, tile, per_group, chunk, caps)
    assert np.array_equal(bits, want["bits"]), np.argwhere(bits != want["bits"])[:5]
    for i, name in enumerate(("TaintToleration", "NodeAffinity", "Fit",
                              "BalancedAllocation", "ImageLocality")):
        assert np.array_equal(raw[i], want["raw"][i]), \
            (name, np.argwhere(raw[i] != want["raw"][i])[:5])
    # the per-node flags skipped walks (with a window of one every node is
    # wider than it and walks its taints), and the problem reaches every
    # kind of cell
    assert all(v > 0 for k, v in skips.items() if caps["node"] > 1 or k != "taint"), skips
    live = (nodes["node_valid"] & nodes["node_ready"])[None, :] & cls["valid"][:, None]
    feasible = want["bits"] == (PASS_BITS | sum(1 << b for b in BITS.values()))
    assert feasible.any() and (live & ~feasible).any()
    return over


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("strategy,shape", FIT_STRATEGIES)
def test_k1_tile_walk_equals_reference(seed, strategy, shape):
    """The kernel's staged counts, 16-node tiles, groups of 13 classes in
    chunks of 4 (N = 64 and C = 64 cut unevenly)."""
    _check_k1(seed, strategy, shape, 16, 13, 4, KERNEL_CAPS)


@pytest.mark.parametrize("caps", ["kernel", "one"])
@pytest.mark.parametrize("tile,per_group,chunk", [(64, 64, 16), (7, 5, 3), (48, 30, 16)])
def test_k1_tilings_and_overflow_equal_reference(tile, per_group, chunk, caps):
    """Other tile, group and chunk sizes, and staged counts of one (every
    list past its count, resource dimensions 4–7 unstaged)."""
    over = _check_k1(0, "RequestedToCapacityRatio", None, tile, per_group, chunk,
                     KERNEL_CAPS if caps == "kernel" else ONE_CAPS)
    assert over > 0 or caps == "kernel"  # counts of one: lists read whole


# --- K13: node tiles, staged bundles ---------------------------------------------------------


def _k13_problem(seed: int):
    rng = np.random.default_rng(seed)
    n, r = 37, 8
    requested = rng.integers(0, 50, (n, r)).astype(np.int32)
    non_zero = rng.integers(0, 50, (n, 2)).astype(np.int32)
    bundles = []
    for k, m in enumerate((23, 9, 14)):
        rows = rng.integers(-1, n + 3, m).astype(np.int32)  # rows ≥ N among them
        rows[:4] = [5, 5, -1, n + 1]  # two pods on one node, one unplaced, one clipped
        req = rng.integers(0, 9, (m, r)).astype(np.int32)
        nz = None if k == 0 else rng.integers(0, 9, (m, 2)).astype(np.int32)
        bundles.append((rows, req, nz))
    return requested, non_zero, bundles


def k13_mirror(requested, non_zero, bundles, tile: int, chunk: int, order: str, seed=0):
    """K13's walk: each block owns ``tile`` node rows, stages the bundles
    laid end to end in chunks of ``chunk`` pods, and adds those that land in
    its tile (in ``order``) into its staged rows, then writes them out."""
    rng = np.random.default_rng(seed)
    n = requested.shape[0]
    rows = np.concatenate([b[0] for b in bundles])
    req = np.concatenate([b[1] for b in bundles])
    has_nz = np.concatenate([np.full(len(b[0]), b[2] is not None) for b in bundles])
    nz = np.concatenate([b[2] if b[2] is not None else np.zeros((len(b[0]), 2), np.int32)
                         for b in bundles])
    out_r, out_n = np.empty_like(requested), np.empty_like(non_zero)
    for n0 in range(0, n, tile):
        nt = min(tile, n - n0)
        s_r, s_n = requested[n0:n0 + nt].copy(), non_zero[n0:n0 + nt].copy()
        for base in range(0, len(rows), chunk):
            idx = np.arange(base, min(len(rows), base + chunk))
            if order == "reverse":
                idx = idx[::-1]
            elif order == "shuffled":
                idx = rng.permutation(idx)
            for i in idx:
                if rows[i] < 0:
                    continue
                t = min(rows[i], n - 1) - n0
                if not 0 <= t < nt:
                    continue
                s_r[t] += req[i]
                if has_nz[i]:
                    s_n[t] += nz[i]
        out_r[n0:n0 + nt], out_n[n0:n0 + nt] = s_r, s_n
    return out_r, out_n


def _k13_reference(requested, non_zero, bundles):
    """The reference's reserve_nominated / apply_prev_delta: per bundle
    ``.at[clip(rows)].add(where(rows >= 0, x, 0))``; the nominated bundle
    (no nz rows) adds into requested only."""
    n = requested.shape[0]
    req, nz = jnp.asarray(requested), jnp.asarray(non_zero)
    for rows, b_req, b_nz in bundles:
        at = jnp.clip(jnp.asarray(rows), 0, n - 1)
        ok = jnp.asarray(rows)[:, None] >= 0
        req = req.at[at].add(jnp.where(ok, jnp.asarray(b_req), 0))
        if b_nz is not None:
            nz = nz.at[at].add(jnp.where(ok, jnp.asarray(b_nz), 0))
    return np.asarray(req), np.asarray(nz)


@pytest.mark.parametrize("order", ["forward", "reverse", "shuffled"])
@pytest.mark.parametrize("tile,chunk", [(256, 2000), (5, 3), (8, 16), (37, 4)])
def test_k13_tile_adds_equal_reference(tile, chunk, order):
    requested, non_zero, bundles = _k13_problem(13)
    want_r, want_n = _k13_reference(requested, non_zero, bundles)
    got_r, got_n = k13_mirror(requested, non_zero, bundles, tile, chunk, order)
    assert np.array_equal(got_r, want_r)
    assert np.array_equal(got_n, want_n)
    assert not np.array_equal(want_r, requested) and not np.array_equal(want_n, non_zero)


def test_k13_plain_version_takes_a_bundle_with_no_nz_rows():
    """The wrapper's plain version (CPU tensors) on the same bundles, the
    nominated one with ``nz`` None, equals the reference; the snapshot it
    read is untouched."""
    requested, non_zero, bundles = _k13_problem(14)
    want_r, want_n = _k13_reference(requested, non_zero, bundles)
    t = torch.from_numpy
    tr, tn = t(requested.copy()), t(non_zero.copy())
    got_r, got_n = prev_delta_apply_plain(
        tr, tn, [(t(a), t(b), None if c is None else t(c)) for a, b, c in bundles])
    assert np.array_equal(got_r.numpy(), want_r) and np.array_equal(got_n.numpy(), want_n)
    assert np.array_equal(tr.numpy(), requested) and np.array_equal(tn.numpy(), non_zero)
    # the nominated bundle alone leaves non_zero as it was
    only_r, only_n = prev_delta_apply_plain(tr, tn, [tuple(
        None if x is None else t(x) for x in bundles[0])])
    assert np.array_equal(only_n.numpy(), non_zero)
    assert not np.array_equal(only_r.numpy(), requested)

