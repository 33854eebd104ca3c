"""K2 (normalize_combine), K29 (candidate_dense), K19 (ipa_update_row), K11
(ipa_score_combine), K12 (ipa_update_classes), K7 (spread_score_combine),
K1 (filter_score_planes), K13 (prev_delta_apply), K17
(scan_select_assume, keyless and keyed), K6 (spread_filter_bits), K18
(spread_update_row), K32 (selector_spread_score), K30 (fork_masks), K8
(spread_update_classes), K16 (scatter_rows), K27 (priority_prefix), K10
(ipa_filter_bits), K23 (selector_match), K28 (candidate_fit) and K25
(dra_score_into) timed on synthetic inputs at the shapes their paths give
them, for the copy of ``kubernetes_tpu_torch`` under ``--root``, so that
two trees (a parent and a change, unpacked side by side) are timed by the
same methods on one card:

    python3 kubernetes_tpu_torch/perf/kernel_ab.py --root build/parent --out chiprun_out/ab_1.json
    python3 kubernetes_tpu_torch/perf/kernel_ab.py --root . --out chiprun_out/ab_2.json

Each row is checked against the plain version on the same inputs, then
timed two ways with the timers of ``chip_smoke.py`` (of the same tree):
``ms`` from torch.profiler (every device activity of the call; ``ms_source``
names the queued-events fallback where the profiler kept no whole record)
and ``queued_ms`` from CUDA events around calls queued behind a spin
kernel.  Shapes: K2 at C = 1 (the exact scan's step), 4 (a NorthStar round)
and 512 (the full auction) on N = 8192 with the framework's five planes,
and in its packed mode at C = 512 over 5000 live nodes; K29 at the dense
preemption path's shape (B = 128, 200 live nodes of a 256-row tier, 800
pods at 800 priorities in a 1024-row tier, R = 8) and at the check case's
(``chip_smoke.preempt_case``: N = 8192, P = 32768, R = 4, 300 priorities)
with B = 64 and B = 512; K19 at B = 512, N = 8192 (5000 live nodes) in
the planes form (SchedulingPreferredPodAffinity's hostname preferred
affinity, D = 8192) and the tables form (SchedulingPodAffinity's required
affinity on one zone, D = 8), and a step whose ``node_row`` is -1; K11
and K12 at ``kernel_work.K11_CASES`` / ``K12_CASES`` (``ipa_view``'s class
views: the dedup round and the scan's step on hostname planes, the full
auction's C = 512, zone tables; one commit, the anti-affinity round's 384
commits at C = 512, all four groups), with their bounds; K7 on
N = 8192 at C = 4 with no soft constraint (TopologySpreading), C = 4 with a
ScheduleAnyway constraint on three zones, C = 1 (the scan's step) and
C = 512 (the full auction); K1 on N = 8192 (5000 live ``node_default``
nodes, no taint, port or image, as the NorthStar and heterogeneous-backlog
clusters) at C = 1 (the scan's step), 4 (a NorthStar round) and 512 (the
heterogeneous backlog's classes, cpu 100m + (i mod 400)m), Fit under
MostAllocated and RequestedToCapacityRatio at C = 128 (the profiles path's
dedup rounds), and at C = 512 on ``chip_smoke.synthetic_snapshot``'s
adversarial nodes (taints, ports, images on most of them); K13 with the
pipelined path's two in-flight bundles (2 × 512 pods, N = 8192, R = 8) and
with the nominated bundle alone (512 of 1024 rows live, no ``nz`` rows —
a zero tensor for a tree whose wrapper needs one), each beside
``index_add_`` into the same arrays timed by the same method; K17 at
``K17_CASES`` (the TopologySpreading scan's step — N = 8192, 5000 live
nodes, R = 8, a cluster of 8 — and the 500-node what-if forks' — N = 512,
500 live, one block; ties across the plan's slice boundaries, keyed two
rows whose draws under the step's key are equal (``kernel_work.
k17_equal_noise``), all-tied rows), the K17 kernel's own time; keyed, the
step keys of PRNGKey(7) — a tree whose K17 takes the key gets it, one
whose K17 takes a noise row gets K33's ``tie_row`` under it — and a
", the step" row beside each, the step as the scan issues it (the
parent's ``tie_row`` + K17, the change's one launch); K6 at ``K6_CASES`` (``spread_aux``: N = 8192,
5000 live nodes, one hard constraint — C = 1 (the scan's step), 4 (a
TopologySpreading round) and 512 (the full auction) on the zone tables,
D + 1 = 9; C = 512 on a hostname table, D + 1 = 8193, split across a
cluster; minDomains above the present domains at C = 4 and on the
hostname table).  K6 filters in place, so each of its timed calls first
copies the plane as K1 seeded it into the plane it filters, as the path
hands it over: ``ms`` is the K6 kernel's own device time on that plane,
``queued_ms`` has the copy's own queued time taken off, and
``ms_filtered`` is K6 on a plane it already filtered (no word changes,
no store).  K18 at ``K18_CASES`` (B = 512 on the zone tables, every
pod matching: Cc = 1 and 2, pod i on a dead keyless node, ``node_row``
−1).  K32 at ``K32_CASES`` (N = 8192, 5000 live nodes: the profiles
path's scan row at C = 1 and its default-scheduler wave at C = 512; at
C = 1 a row with every entry masked, one whose counts are all 0 — max 0,
every score 100 —, one whose zone counts are all 0, and N = 8190, a row
with a scalar tail).  K30 at ``K30_CASES`` (Defrag's K = 4 forks: N =
8192, P = 16384, R = 8, G = D = 8, 8 victims, 8 affinity contributions and
up to 4 removes a fork, −1 pads in each; with the claim plane; on per-fork
node arrays as K31 hands them over on AutoscaleGang; K = 1; a duplicate
victim and a duplicate affinity cell in every fork).  K8 at ``K8_CASES``
(B = 512 on ``spread_aux``'s tables: TopologySpreading's C = 4 round with
one commit, ``class_of`` int64 as the engines pass it and int32, which
the wrapper widens first; the full
auction's identity classes, C = 512, with the path's one commit and with
384 commits on the zone tables and on a hostname table, D + 1 = 8193; a
round with no commit; every pod committed to one node): ``ms`` is every
device activity of the call (a tree that casts ``class_of`` launches its
cast there too), ``ms_kernel`` the K8 kernel's own.  K16 at ``K16_CASES``
(the encoder's node group, 20 arrays at N = 8192 with the NorthStar
path's payload, 400 dirty rows padded to 512; its pod group at P = 16384;
its affinity group, G = 1024 with 256-domain count rows; the node group
with k = 0 and with 100 rows padded to 512; bool, 12-byte and 3-byte rows
at N = 8190), each beside ``index_copy`` per array timed by the same
method.  K23 at ``kernel_work.K23_CASES`` (GangBasic's node-affinity call
— U = 2 node selectors of T = 2 terms of S = 4 requirements over O = 8192
nodes of L = 16 labels, B = 512 —, label selectors with the side table,
``vals_num`` and the numeric side off, requirement rows with no index, U =
512 distinct rows, O = 8190, 20 label columns), and on a tree with
``selectors.plan_for`` its path, label selectors, requirement rows and U =
512 rows again under other tiles (64, 128 objects) and chunks (16 to 512
rows).  K27 at
``kernel_work.K27_CASES`` (PreemptionBasic's path: P =
32768, N = 8192, R = 8, two live levels; the check case's 128 levels at
R = 4; a node holding 6000 pods; R = 16 over 128 levels), ``ms`` the whole
call's device time (a tree that sorts before its kernel is timed with its
sort), held against the plain version on CPU copies.  K10 at
``kernel_work.K10_CASES`` (C = 4 hostname planes with no required term, the
path's; zone tables with required affinity and hostname planes with
required anti-affinity at C = 1, 4 and 512; N = 8190), on the plane as K1
seeded it as K6 is, ``ms_filtered`` on a plane already filtered.  K28 at
``kernel_work.K28_CASES`` (PreemptionBasic's path: B = 512, N = 8192, R =
8, two live levels; the check case's 128 levels with batch rows across
them; ulp-boundary rows; R = 4 and 16; N = 8190; static bits that mostly
fail), the whole call.  K25 at ``kernel_work.K25_CASES`` (the
DeviceClaimGang path's C = 64, the harness's C = 512, the scan's C = 1, N
= 8190, no feasible entry, random claims, the floor grid), each timed call
adding into a copy of the totals.  ``--only name,...`` times only the rows
of those kernels (the others are still checked).  The K6, K17, K18, K32,
K30, K8, K16, K27, K10, K28 and K25 rows carry ``host_us``, the host's
issue time of one wrapper call over 1000 queued calls
(``host_timer.py``).  K1's, K6's, K13's, K17's, K18's, K32's, K30's, K8's,
K16's, K27's, K10's, K23's, K28's and K25's rows carry their bound
(``kernel_work.k1_work`` / ``k6_work`` / the bytes the adds need /
``k17_work`` / ``k18_work`` / ``k32_work`` / ``k30_work`` / ``k8_work`` /
``k16_work`` / ``k27_work`` / ``k10_work`` / ``k23_work`` / ``k28_work`` /
``k25_work``, over the card's rates). The bound formulas,
K11 / K12's inputs, K17's plan and the host timer are ``kernel_work.py``
and ``host_timer.py`` beside this file, whichever tree ``--root`` names:
both trees are held to the same bound and timed by the same method. Needs a
CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import subprocess
import sys
import types
from pathlib import Path


def _sibling(name: str):
    """This file's sibling ``name``.py, loaded by its path (the
    ``kubernetes_tpu_torch`` on the import path is the one under ``--root``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k2_inputs(c: int, n: int, seed: int, dev, feasible: float = 0.7):
    """A bit plane (7 filter bits, ``feasible`` of the nodes feasible) and
    the framework's five raw planes of integers 0–100 (identity ×3,
    default, reversed)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    full = 0b1111111
    drop = rng.integers(0, 7, (c, n))
    bits = np.where(rng.random((c, n)) < feasible, full, full & ~(1 << drop)).astype(np.int32)
    raw = rng.integers(0, 101, (5, c, n)).astype(np.float32)
    return full, torch.from_numpy(bits).to(dev), torch.from_numpy(raw).to(dev)


def k29_path_inputs(dev):
    """The dense preemption path's shape: 200 nodes of 4 cpu / 32Gi in a
    256-row tier, four 900m / 500Mi pods a node at priorities (i · 37) mod
    800, a 1024-row pod tier, 128 preemptors of 3000m / 500Mi at 1000."""
    import numpy as np
    import torch

    n, live, p, b, r = 256, 200, 1024, 128, 8
    alloc = np.zeros((n, r), np.int32)
    alloc[:live, 0], alloc[:live, 1], alloc[:live, 2] = 4000, 32 << 20, 110
    valid = np.zeros(p, bool)
    node = np.full(p, -1, np.int32)
    prio = np.zeros(p, np.int32)
    req = np.zeros((p, r), np.int32)
    i = np.arange(800)
    valid[:800], node[:800], prio[:800] = True, i % live, (i * 37) % 800
    req[:800, 0], req[:800, 1], req[:800, 2] = 900, 512000, 1
    requested = np.zeros((n, r), np.int32)
    np.add.at(requested, node[:800], req[:800])
    bprio = np.full(b, 1000, np.int32)
    breq = np.zeros((b, r), np.int32)
    breq[:, 0], breq[:, 1], breq[:, 2] = 3000, 512000, 1
    bits = np.zeros((b, n), np.int32)
    bits[:100, :live] = 0b1111
    arrays = (valid, node, prio, req, bprio, breq, alloc, requested, bits)
    return [torch.from_numpy(a).to(dev) for a in arrays] + [0b1111]


def k19_inputs(form: str, dev, seed: int = 19):
    """A full-batch InterPodAffinity aux (B = 512, N = 8192, 5000 live
    nodes) with one present term group of one term a pod, every pending pod
    matching every term: "planes" — preferred affinity on the hostname
    (each live node its own domain, D = 8192, weight 1–100), "tables" —
    required affinity on one zone holding every live node (D = 8)."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.plugins.interpodaffinity import IPAAux

    rng = np.random.default_rng(seed)
    b, n, live = 512, 8192, 5000
    planes = form == "planes"
    d = 8192 if planes else 8
    width = n if planes else d + 1
    present = "pref_affinity" if planes else "req_affinity"
    node_dom = np.full(n, d, np.int32)
    node_dom[:live] = np.arange(live) if planes else 0
    groups = {}
    for g in ("req_affinity", "req_anti_affinity", "pref_affinity", "pref_anti_affinity"):
        if g == present:
            dom = np.broadcast_to(node_dom, (b, 1, n)).copy()
            cnt = rng.integers(0, 4, (b, 1, width)).astype(np.int32)
            cross = np.ones((b, 1, b), bool)
        else:
            dom = np.full((b, 1, n), d, np.int32)
            cnt = np.zeros((b, 1, width), np.int32)
            cross = np.zeros((b, 1, b), bool)
        groups[g] = [torch.from_numpy(x).to(dev) for x in (dom, cnt, cross)]
    t = {k: torch.from_numpy(v).to(dev) for k, v in {
        "aff_total": rng.integers(0, 100, b).astype(np.int32),
        "score_dyn": rng.integers(-50, 50, (b, n)).astype(np.float32),
        "paff_weight": rng.integers(1, 101, (b, 1)).astype(np.float32),
    }.items()}
    ra, an, pa, pn = (groups[g] for g in ("req_affinity", "req_anti_affinity",
                                          "pref_affinity", "pref_anti_affinity"))
    return IPAAux(
        dom_aff=ra[0], dom_anti=an[0], dom_paff=pa[0], dom_panti=pn[0],
        aff_cnt=ra[1], anti_cnt=an[1], paff_cnt=pa[1], panti_cnt=pn[1],
        aff_total=t["aff_total"], self_match_all=torch.ones(b, dtype=torch.bool, device=dev),
        exist_anti_block=torch.zeros((b, n), dtype=torch.bool, device=dev),
        score_static=torch.zeros((b, n), dtype=torch.float32, device=dev),
        aff_term_cross=ra[2], aff_cross_all=ra[2][:, 0, :].clone(), anti_cross=an[2],
        paff_cross=pa[2], panti_cross=pn[2],
        block_dyn=torch.zeros((b, n), dtype=torch.bool, device=dev), score_dyn=t["score_dyn"],
        depth=d, present=(present,),
        req_aff_valid=torch.full((b, 1), not planes, dtype=torch.bool, device=dev),
        paff_weight=t["paff_weight"],
        panti_weight=torch.zeros((b, 1), dtype=torch.float32, device=dev), hard_weight=1.0)


def k7_inputs(c: int, soft: bool, dev, seed: int = 7):
    """A PodTopologySpread aux of ``c`` class rows on N = 8192 (5000 live
    nodes in three zones, D = 4) with one constraint on the zone —
    DoNotSchedule (no soft row) or ScheduleAnyway (maxSkew 1, counts
    0–400) —, a bit plane of 7 filter bits with ~70% of the live nodes
    feasible, and K2's total (finite where feasible, −inf elsewhere)."""
    import types

    import numpy as np
    import torch

    rng = np.random.default_rng(seed + c)
    n, live, d = 8192, 5000, 4
    full = 0b1111111
    zone = np.full(n, d, np.int32)
    zone[:live] = np.arange(live) % 3
    dom_val = np.broadcast_to(zone, (c, 1, n)).copy()
    has_key = dom_val < d
    drop = rng.integers(0, 7, (c, n))
    feasible = (rng.random((c, n)) < 0.7) & (np.arange(n) < live)
    bits = np.where(feasible, full, full & ~(1 << drop)).astype(np.int32)
    total = np.where(feasible, rng.integers(0, 400, (c, n)), -np.inf).astype(np.float32)
    aux = types.SimpleNamespace(
        soft_counts=torch.from_numpy(rng.integers(0, 400, (c, 1, d + 1)).astype(np.int32)),
        soft_valid=torch.full((c, 1), soft), max_skew=torch.ones((c, 1), dtype=torch.int32),
        dom_val=torch.from_numpy(dom_val), has_key=torch.from_numpy(has_key))
    for k, v in vars(aux).items():
        setattr(aux, k, v.to(dev))
    return aux, torch.from_numpy(bits).to(dev), full, torch.from_numpy(total).to(dev)


def spread_aux(c: int, cc: int, d: int, dev, *, seed: int = 6, b: int = 1,
               min_domains: bool = False):
    """A PodTopologySpread aux (TSAux) of ``c`` rows and ``cc`` hard
    constraints on N = 8192 nodes, 5000 of them live: a zone key (``d`` =
    8: live node i in zone i mod 3, counts 100–105 a zone and 112 in zone
    0, so that zone 0 fails under maxSkew 5, the TopologySpreading suite's)
    or a hostname key (``d`` = 8192: live node i
    its own domain, counts 0–3, maxSkew 1); the 3192 dead rows without the
    key and not counted; every pod self-matching; ``min_domains`` asks for
    one domain more than are present (the minimum becomes 0).  ``b``
    pending pods a row in ``match_pending`` (every pod matching every
    selector: the suite's)."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.plugins.podtopologyspread import TSAux

    rng = np.random.default_rng(seed + c + 10 * cc + d)
    n, live = 8192, 5000
    node_dom = np.full(n, d, np.int32)
    node_dom[:live] = np.arange(live) % 3 if d == 8 else np.arange(live)
    n_dom = 3 if d == 8 else live
    dom_val = np.broadcast_to(node_dom, (c, cc, n)).copy()
    counts = (rng.integers(100, 106, (c, cc, d + 1)) if d == 8
              else rng.integers(0, 4, (c, cc, d + 1))).astype(np.int32)
    if d == 8:
        counts[:, :, 0] = 112
    present = np.zeros((c, cc, d + 1), bool)
    present[:, :, :n_dom] = True
    counted = np.broadcast_to(np.arange(n) < live, (c, n)).copy()

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return TSAux(
        hard_valid=t(np.ones((c, cc), bool)), soft_valid=t(np.zeros((c, cc), bool)),
        max_skew=t(np.full((c, cc), 5 if d == 8 else 1, np.int32)),
        min_domains=t(np.full((c, cc), n_dom + 1 if min_domains else 0, np.int32)),
        self_match=t(np.ones((c, cc), bool)), dom_val=t(dom_val), has_key=t(dom_val < d),
        counted_hard=t(counted), counted_soft=t(counted), hard_counts=t(counts),
        soft_counts=t(counts.copy()), hard_present=t(present),
        match_pending=t(np.ones((c, cc, b), bool)))


# K6's shapes: label → (C, D, minDomains)
K6_CASES = {
    "C = 1, zones": (1, 8, False),
    "C = 4, zones": (4, 8, False),
    "C = 512, zones": (512, 8, False),
    "C = 4, zones, minDomains": (4, 8, True),
    "C = 512, hostname": (512, 8192, False),
    "C = 512, hostname, minDomains": (512, 8192, True),
}

# K18's shapes: label → (Cc, node): B = 512 on the zone tables, pod i on a
# live node, on a dead keyless one, or not placed
K18_CASES = {
    "Cc = 1": (1, 1234),
    "Cc = 2": (2, 1234),
    "keyless node": (1, 6000),
    "node_row -1": (1, -1),
}


# K32's shapes: label → (C, N, kind)
K32_CASES = {
    "C = 1, scan row": (1, 8192, None),
    "C = 512, default-scheduler wave": (512, 8192, None),
    "C = 1, every entry masked": (1, 8192, "all"),
    "C = 1, counts 0 (max 0: every score 100)": (1, 8192, "zero counts"),
    "C = 1, zone counts 0": (1, 8192, "zero zones"),
    "C = 1, N = 8190 (unaligned tail)": (1, 8190, None),
}


def k32_inputs(label: str, dev, seed: int = 32):
    """K32's arguments at ``label``: a bit plane of 7 filter bits with ~70%
    of the 5000 live nodes in the mask (kind "all": every entry), counts
    0–max and zone counts 0–3·max with a row maximum 1–399 (kind "zero
    counts" / "zero zones": all 0), has_zone on ~80% of the live nodes, and
    a total of integers 0–600 on the mask, −inf off it → (bits, full,
    total, counts, zone_counts, has_zone)."""
    import numpy as np
    import torch

    c, n, kind = K32_CASES[label]
    rng = np.random.default_rng(seed + c + n + 7 * len(kind or ""))
    full, live = 0b1111111, min(5000, n)
    mask = (rng.random((c, n)) < 0.7) & (np.arange(n) < live)
    if kind == "all":
        mask[:] = True
    bits = np.where(mask, full, full & ~(1 << rng.integers(0, 7, (c, n)))).astype(np.int32)
    mx = rng.integers(1, 400, (c, 1))
    counts = np.floor(rng.random((c, n)) * (mx + 1)).astype(np.float32)
    zone = np.floor(rng.random((c, n)) * (3 * mx + 1)).astype(np.float32)
    if kind == "zero counts":
        counts[:] = 0.0
    if kind == "zero zones":
        zone[:] = 0.0
    has_zone = (rng.random(n) < 0.8) & (np.arange(n) < live)
    total = np.where(mask, rng.integers(0, 600, (c, n)), -np.inf).astype(np.float32)
    t = [torch.from_numpy(x).to(dev) for x in (bits, total, counts, zone, has_zone)]
    return t[0], full, t[1], t[2], t[3], t[4]


# K8's shapes: label → (C, D, commits, class_of dtype, kind): B = 512 on
# ``spread_aux``'s tables (one constraint, every pod matching every
# selector), C = 4 the TopologySpreading round's class rows, C = 512 the
# full auction's identity classes; kind "one node": every pod committed
# to one node
K8_CASES = {
    "C = 4, one commit, int64 class_of": (4, 8, 1, "int64", None),
    "C = 4, one commit, int32 class_of": (4, 8, 1, "int32", None),
    "C = 512, identity classes, one commit": (512, 8, 1, "int64", None),
    "C = 512, identity classes, 384 commits, zones": (512, 8, 384, "int64", None),
    "C = 512, identity classes, 384 commits, hostname (D + 1 = 8193)":
        (512, 8192, 384, "int64", None),
    "C = 4, no commit": (4, 8, 0, "int64", None),
    "C = 4, every pod committed to one node": (4, 8, 512, "int64", "one node"),
}


def k8_inputs(label: str, dev, seed: int = 8):
    """(aux, commit, choice, class_of) at K8's shape ``label``: the commits
    on distinct live nodes (kind "one node": all on node 1234), ``choice``
    i32 and ``class_of`` as the engines pass them (int64; or int32)."""
    import numpy as np
    import torch

    c, d, commits, dtype, kind = K8_CASES[label]
    b = 512
    aux = spread_aux(c, 1, d, dev, b=c)
    rng = np.random.default_rng(seed + c + d + commits)
    commit = np.zeros(b, bool)
    commit[rng.permutation(b)[:commits]] = True
    choice = rng.integers(0, 5000, b).astype(np.int32)
    choice[commit] = 1234 if kind == "one node" else rng.permutation(5000)[:commits]
    class_of = (np.arange(b) if c == b else rng.integers(0, c, b)).astype(dtype)
    return (aux,) + tuple(torch.from_numpy(x).to(dev) for x in (commit, choice, class_of))


# K16's array groups: (row shape, dtype) per array — the encoder's node
# group (20 arrays, 535 bytes a node), its pod group (8 arrays) and its
# affinity group (5 arrays, the counts 256 domains wide)
K16_GROUPS = {
    "node": [((), "bool"), ((), "int32"), ((8,), "int32"), ((8,), "int32"), ((2,), "int32"),
             ((16,), "int32"), ((16,), "int32"), ((16,), "float32"), ((8,), "int32"),
             ((8,), "int32"), ((8,), "int32"), ((8,), "int32"), ((8,), "int32"),
             ((8,), "int32"), ((8,), "int32"), ((8,), "float32"), ((), "bool"), ((), "bool"),
             ((), "int32"), ((), "int32")],
    "pod": [((), "bool"), ((), "int32"), ((), "int32"), ((8,), "int32"), ((8,), "int32"),
            ((), "int32"), ((8,), "int32"), ((2,), "int32")],
    "affinity": [((), "bool"), ((), "int32"), ((), "float32"), ((), "int32"),
                 ((256,), "float32")],
    "bool, 12-byte and 3-byte rows": [((), "bool"), ((3,), "int32"), ((3,), "bool")],
}
# K16's shapes: label → (group, rows, dirty rows, payload rows)
K16_CASES = {
    "node group, N = 8192 (NorthStar path)": ("node", 8192, 400, 512),
    "pod group, P = 16384": ("pod", 16384, 512, 512),
    "affinity group, G = 1024": ("affinity", 1024, 5, 8),
    "node group, k = 0": ("node", 8192, 0, 0),
    "node group, 100 rows padded to 512": ("node", 8192, 100, 512),
    "bool, 12-byte and 3-byte rows, N = 8190": ("bool, 12-byte and 3-byte rows", 8190, 300, 512),
}


def k16_inputs(label: str, dev, seed: int = 16):
    """(arrays, rows, vals) at K16's shape ``label``: random arrays of the
    group's widths; ``dirty`` distinct rows padded to ``k`` by repeating the
    first (rows int64, as the encoder's payload), new values on the dirty
    rows and a pad carrying its row's value."""
    import numpy as np
    import torch

    group, n, dirty, k = K16_CASES[label]
    rng = np.random.default_rng(seed + n + dirty)
    arrays, vals = [], []
    rows = np.sort(rng.permutation(n)[:dirty]).astype(np.int64)
    rows = np.concatenate([rows, np.full(k - dirty, rows[0] if dirty else 0, np.int64)])
    for shape, dtype in K16_GROUPS[group]:
        a = rng.integers(-99, 99, (n,) + shape).astype(dtype)
        v = rng.integers(-99, 99, (k,) + shape).astype(dtype)
        v[dirty:] = v[0] if dirty else v[dirty:]
        arrays.append(torch.from_numpy(a).to(dev))
        vals.append(torch.from_numpy(v).to(dev))
    return arrays, torch.from_numpy(rows).to(dev), vals


# K30's shapes: label → (K, claim plane, per-fork node arrays, duplicates)
K30_CASES = {
    "Defrag, K = 4": (4, False, False, False),
    "Defrag, K = 4, claim plane": (4, True, False, False),
    "AutoscaleGang, per-fork node arrays": (4, False, True, False),
    "K = 1": (1, False, False, False),
    "duplicate victims and affinity cells": (4, True, False, True),
}


def k30_inputs(label: str, dev, seed: int = 30):
    """``fork_masks``' arguments at ``label`` → (args, kw): N = 8192 nodes
    (victims on the 5000 live ones), P = 16384 pods, R = 8, G = D = 8; fork
    f holds 7 − f mod 4 victims, as many affinity contributions and
    f mod 4 + 1 removes, −1 pads behind them; the node arrays live, or one
    per fork (K31's output); ``duplicates`` lists each fork's first victim
    and first affinity cell twice."""
    import numpy as np
    import torch

    k, chips, per_fork, dups = K30_CASES[label]
    rng = np.random.default_rng(seed + k + 2 * chips + 4 * per_fork + 8 * dups)
    n, p, r, g, d, v, a, dd = 8192, 16384, 8, 8, 8, 8, 8, 8
    lead = (k,) if per_fork else ()

    def i32(lo, hi, shape):
        return rng.integers(lo, hi, shape).astype(np.int32)

    node = [rng.random(lead + (n,)) < 0.97, i32(0, 1 << 20, lead + (n, r)),
            i32(0, 1 << 20, lead + (n, 2)), i32(0, 5, lead + (n,))]
    live = [rng.random(p) < 0.9, i32(0, 5000, (p, r)), i32(0, 5000, (p, 2)),
            rng.integers(0, 50, (g, d)).astype(np.float32)]
    vp, vn, vc = np.full((k, v), -1, np.int32), np.zeros((k, v), np.int32), np.zeros((k, v), np.int32)
    ar, av, dr = np.full((k, a), -1, np.int32), np.zeros((k, a), np.int32), np.full((k, dd), -1, np.int32)
    for f in range(k):
        m = 7 - f % 4
        vp[f, :m], vn[f, :m], vc[f, :m] = i32(0, p, m), i32(0, 5000, m), i32(0, 5, m)
        ar[f, :m], av[f, :m] = i32(0, g, m), i32(0, d, m)
        dr[f, :f % 4 + 1] = i32(0, 5000, f % 4 + 1)
        if dups:
            vp[f, 1], vn[f, 1], vc[f, 1] = vp[f, 0], vn[f, 0], vc[f, 0]
            ar[f, 1], av[f, 1] = ar[f, 0], av[f, 0]
    t = [torch.from_numpy(x).to(dev) for x in node + live + [vp, vn, ar, av, dr]]
    args = [t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], *t[8:]]
    return args, {"vic_claim_chips": torch.from_numpy(vc).to(dev) if chips else None}


def k1_inputs(c: int, base, dev, seed: int = 1):
    """K1's arguments at the dedup / scan paths' shape, on ``base`` (a
    DeviceSnapshot of N = 8192 rows) rewritten to 5000 live
    ``node_default`` nodes (4 cpu, 32Gi, 110 pods; requests 0–75% used), no
    taint, port or image; ``c`` class rows of cpu 100m + (i mod 400)m, 500Mi
    and one pod each, no toleration, port or image; NodeAffinity's planes
    all-pass and zero."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + c)
    n, live, r = 8192, 5000, 8
    alloc = np.zeros((n, r), np.int32)
    alloc[:live, 0], alloc[:live, 1], alloc[:live, 3] = 4000, 32 << 20, 110
    req = np.zeros((n, r), np.int32)
    req[:live, 0] = rng.integers(0, 3000, live)
    req[:live, 1] = rng.integers(0, 24 << 20, live)
    req[:live, 3] = rng.integers(0, 80, live)
    valid = np.arange(n) < live

    def i32(*shape, v=-1):
        return torch.full(shape, v, dtype=torch.int32, device=dev)

    snap = dataclasses.replace(base, **{k: torch.from_numpy(v).to(dev) for k, v in {
        "allocatable": alloc, "requested": req, "non_zero_requested": req[:, :2].copy(),
        "node_valid": valid, "node_ready": valid.copy(),
        "unschedulable": np.zeros(n, bool)}.items()},
        taint_keys=i32(n, 8), taint_vals=i32(n, 8), taint_effects=i32(n, 8),
        ports=i32(n, 8), ports_ip=i32(n, 8), image_ids=i32(n, 8))
    creq = np.zeros((c, r), np.int32)
    creq[:, 0] = 100 + np.arange(c) % 400
    creq[:, 1], creq[:, 3] = 512000, 1
    rep = types.SimpleNamespace(
        valid=torch.ones(c, dtype=torch.bool, device=dev),
        request=torch.from_numpy(creq).to(dev),
        non_zero=torch.from_numpy(creq[:, :2].copy()).to(dev), node_name_id=i32(c),
        tol_valid=torch.zeros((c, 2), dtype=torch.bool, device=dev), tol_key=i32(c, 2),
        tol_val=i32(c, 2), tol_op=i32(c, 2), tol_effect=i32(c, 2), ports=i32(c, 2),
        ports_ip=i32(c, 2), image_ids=i32(c, 2))
    dyn = types.SimpleNamespace(requested=snap.requested, non_zero=snap.non_zero_requested)
    na_mask = torch.ones((c, n), dtype=torch.bool, device=dev)
    na_pref = torch.zeros((c, n), dtype=torch.float32, device=dev)
    return rep, snap, dyn, na_mask, na_pref


def k13_inputs(kind: str, dev, seed: int = 13):
    """(requested, non_zero, bundles): "path" — two in-flight bundles of 512
    pod_default pods (100m / 500Mi, one pod) on N = 8192, R = 8, their rows
    on the 5000 live nodes (pods sharing a node) with 16 unplaced (−1) each;
    "nominated" — one bundle of 1024 rows, 512 live at distinct nodes
    (3000m / 500Mi), no ``nz`` rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n, r = 8192, 8
    requested = torch.from_numpy(rng.integers(0, 1 << 20, (n, r)).astype(np.int32)).to(dev)
    non_zero = torch.from_numpy(rng.integers(0, 1 << 20, (n, 2)).astype(np.int32)).to(dev)
    bundles = []
    if kind == "path":
        for _ in range(2):
            rows = rng.integers(0, 5000, 512).astype(np.int32)
            rows[rng.permutation(512)[:16]] = -1
            req = np.zeros((512, r), np.int32)
            req[:, 0], req[:, 1], req[:, 3] = 100, 512000, 1
            bundles.append(tuple(torch.from_numpy(a).to(dev)
                                 for a in (rows, req, req[:, :2].copy())))
    else:
        rows = np.full(1024, -1, np.int32)
        rows[:512] = rng.permutation(n)[:512]
        req = np.zeros((1024, r), np.int32)
        req[:512, 0], req[:512, 1], req[:512, 3] = 3000, 512000, 1
        bundles.append((torch.from_numpy(rows).to(dev), torch.from_numpy(req).to(dev), None))
    return requested, non_zero, bundles


# K17's shapes: label → (keyed, ties, N, live) — the TopologySpreading
# scan's step (a cluster of 8) and the 500-node what-if forks' (one block)
K17_CASES = {
    "keyless, ties across slices": (False, "slices", 8192, 5000),
    "keyless, all tied": (False, "all", 8192, 5000),
    "keyed, equal noise across slices": (True, "slices", 8192, 5000),
    "keyed, all tied": (True, "all", 8192, 5000),
    "keyless, N = 512, ties": (False, "slices", 512, 500),
    "keyed, N = 512, equal noise": (True, "slices", 512, 500),
}


def k17_inputs(label: str, dev, kw, seed: int = 17):
    """K17's arguments at ``label``: a bit row of 7 filter bits with ~70%
    of the live nodes feasible and K2's total (integers 0–400, −inf off the
    mask); "slices" puts the row's maximum on feasible rows across the
    plan's slices — keyless ``kw.k17_tie_rows``'s (either side of each slice
    boundary) or, in one block, either side of the live nodes' middle;
    keyed the pair ``kw.k17_equal_noise`` finds, two rows whose draws under
    the step's key are equal — and the lowest of them must win; "all" gives
    every feasible node the same total (the spread cell's rows).  Keyed,
    the step keys are ``split(PRNGKey(7), 512)`` and the step is the
    found pair's key row (pod 137's otherwise).  Pod 137 of B = 512 (R = 8,
    not nominated, valid) on random requested / non_zero rows → ((bits,
    full, total, i, nominated, valid, request, pod_nz, requested, node_nz,
    node_row, feasible_count), keys or None, k, the tied rows)."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.kernels.tie_noise import tie_split_plain

    keyed, ties, n, live = K17_CASES[label]
    rng = np.random.default_rng(seed + keyed + 2 * (ties == "all") + 4 * (n != 8192))
    b, r, full, i = 512, 8, 0b1111111, 137
    feasible = (rng.random(n) < 0.7) & (np.arange(n) < live)
    bits = np.where(feasible, full, full & ~(1 << rng.integers(0, 7, n))).astype(np.int32)
    total = rng.integers(0, 400, n).astype(np.float32)
    keys = tie_split_plain((0, 7), b, device=dev) if keyed else None
    k, at = i, []
    if ties == "all":
        total[:] = 250.0
    elif keyed:
        k, lo, hi = kw.k17_equal_noise(keys, n, live)
        at = [lo, hi]
    else:
        at = [a for a in kw.k17_tie_rows(n) if a < live] or [live // 2 - 1, live // 2]
    bits[at], total[at] = full, 500.0
    total = np.where(bits == full, total, -np.inf).astype(np.float32)
    arrays = [bits[None], total[None], np.full(b, -1, np.int32), np.ones(b, bool),
              rng.integers(0, 3000, (b, r)).astype(np.int32),
              rng.integers(0, 3000, (b, 2)).astype(np.int32),
              rng.integers(0, 1 << 20, (n, r)).astype(np.int32),
              rng.integers(0, 1 << 20, (n, 2)).astype(np.int32),
              np.full(b, -1, np.int32), np.zeros(b, np.int32)]
    t = [torch.from_numpy(a).to(dev) for a in arrays]
    return (t[0], full, t[1], i, *t[2:]), keys, k, at


def k17_expected(a17, keys, k) -> int:
    """The step's node by ``select_host``'s rule on the host: the first
    maximum keyless, keyed the largest draw among the tied maxima (the
    first row on equal draws)."""
    import torch

    from kubernetes_tpu_torch.ops import prng

    n = a17[0].shape[-1]
    masked = torch.where(a17[0].reshape(n).cpu() == a17[1], a17[2].reshape(n).cpu(),
                         float("-inf"))
    if keys is None:
        return int(torch.argmax(masked))
    noise = prng.uniform(keys[k].cpu().to(torch.int64) & prng.MASK32, (n,))
    return int(torch.argmax(torch.where(masked == masked.max(), noise, -1.0)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the tree whose kubernetes_tpu_torch to time")
    ap.add_argument("--out", required=True, help="where to write the rows (JSON)")
    ap.add_argument("--only", default="", help="comma-separated kernel names: time only "
                    "their rows (the others are still checked)")
    args = ap.parse_args()
    only = {x for x in args.only.split(",") if x}
    root = Path(args.root).resolve()
    sys.path[0] = str(root)  # the tree under --root, not this file's
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA card")
    import chip_smoke as cs

    kw = _sibling("kernel_work")
    host_issue_us = _sibling("host_timer").host_issue_us
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.kernels.normalize import (
        CombinePlan,
        normalize_combine,
        normalize_combine_plain,
    )
    from kubernetes_tpu_torch.kernels.interpodaffinity import ipa_update_row, ipa_update_row_plain
    from kubernetes_tpu_torch.kernels.preempt import candidate_dense, candidate_dense_plain
    from kubernetes_tpu_torch.kernels.spread import spread_score_combine, spread_score_combine_plain
    from kubernetes_tpu_torch.kernels.filter_score import (
        filter_score_planes,
        filter_score_planes_plain,
    )
    from kubernetes_tpu_torch.kernels.prev_delta import prev_delta_apply, prev_delta_apply_plain
    from kubernetes_tpu_torch.kernels.scan import scan_select_assume, scan_select_assume_plain
    from kubernetes_tpu_torch.plugins.interpodaffinity import InterPodAffinityPlugin
    from kubernetes_tpu_torch.plugins.noderesources import FitPlugin
    from kubernetes_tpu_torch.plugins.trivial import image_scaled_by_id

    for mod in (cs, kernels):
        if not str(Path(mod.__file__).resolve()).startswith(str(root)):
            sys.exit(f"kernel_ab: imported {mod.__file__}, not the tree under {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    dev = torch.device("cuda", 0)
    build.load("normalize_combine")
    build.load("preempt")
    build.load("interpodaffinity")
    build.load("spread")
    build.load("filter_score")
    build.load("prev_delta")
    build.load("scan")
    build.load("selectorspread")
    build.load("fork")
    build.load("scatter_rows")
    plan = CombinePlan(kinds=(0, 0, 0, 1, 2), weights=(1.0, 1.0, 1.0, 1.0, 1.0), const_add=0.0)
    rows = []

    def add(name, fn, equal, kernel=None, less=None, **shape):
        # ``kernel``: only its device activities count; ``less``: a call
        # that each call of ``fn`` begins with, its queued time taken off
        if only and name.split(" (")[0] not in only:
            if not equal:
                rows.append({"name": name, "equal": False})
            return
        ms = cs.device_ms(fn, kernel)
        queued = cs.queued_device_ms(fn) - (cs.queued_device_ms(less) if less else 0.0)
        row = {"name": name, "ms": ms, "ms_source": cs.MS_SOURCE[0],
               "queued_ms": queued, "equal": equal, **shape}
        rows.append(row)
        print(f"{root.name}: {name} {ms:.5f} ms ({row['ms_source']}), {row['queued_ms']:.5f} "
              f"ms queued ({'equal' if equal else 'DIFFERS'}) {shape}", flush=True)

    for c, packed, live in ((1, False, 8192), (4, False, 8192), (512, False, 8192),
                            (512, True, 5000)):
        full, bits, raw = k2_inputs(c, 8192, 13 + c, dev)
        bits[:, live:] = 0  # a node tier's dead rows
        got = normalize_combine(bits, full, raw, plan, packed=packed)
        pt, pf = normalize_combine_plain(bits, full, raw, plan)
        kt = got if packed else got[0]
        equal = torch.equal(kt.view(torch.int32), pt.view(torch.int32)) \
            and (packed or torch.equal(got[1], pf))
        add("normalize_combine" + (" (packed)" if packed else ""),
            lambda b_=bits, r_=raw, f_=full, p_=packed: normalize_combine(b_, f_, r_, plan,
                                                                          packed=p_),
            bool(equal), C=c, N=8192, P=5, live=live)

    cases = [("path", k29_path_inputs(dev))]
    for b in (64, 512):
        gen = torch.Generator().manual_seed(cs.SEED + 29)
        d = cs.preempt_case(gen, b=b, n_prio=300)
        cases.append((f"check case, B = {b}", [
            d[k].to(dev) for k in ("pod_valid", "pod_node", "pod_priority", "pod_request",
                                   "priority", "request", "allocatable", "requested",
                                   "static_bits")] + [0b1111]))
    for label, a in cases:
        got = candidate_dense(*a)
        want = candidate_dense_plain(*a)  # the plain version on the card
        add(f"candidate_dense ({label})", lambda a_=a: candidate_dense(*a_),
            bool(torch.equal(got, want)), B=a[4].shape[0], N=a[6].shape[0],
            P=a[0].shape[0], R=a[3].shape[1])

    iplug = InterPodAffinityPlugin()
    for form, placed in (("planes", True), ("tables", True), ("planes", False)):
        aux = k19_inputs(form, dev)
        i = 137
        at = torch.tensor([1234 if placed else -1], dtype=torch.int32, device=dev)
        ka, pa = iplug.engine_copy(aux), iplug.engine_copy(aux)
        ipa_update_row(ka, i, at)
        ipa_update_row_plain(pa, i, at)
        fields = ("aff_cnt", "anti_cnt", "paff_cnt", "panti_cnt", "aff_total", "block_dyn",
                  "score_dyn")
        equal = all(torch.equal(getattr(ka, f), getattr(pa, f)) for f in fields)
        if placed:
            equal = equal and not torch.equal(ka.score_dyn, aux.score_dyn)
        work = iplug.engine_copy(aux)
        add(f"ipa_update_row ({form}{'' if placed else ', node_row -1'})",
            lambda w_=work, a_=at: ipa_update_row(w_, i, a_), bool(equal),
            B=512, N=8192, D=aux.depth, present=list(aux.present))

    from kubernetes_tpu_torch.kernels.interpodaffinity import (
        ipa_score_combine,
        ipa_score_combine_plain,
        ipa_update_classes,
        ipa_update_classes_plain,
    )

    for label in kw.K11_CASES:
        aux, bits, full, total = kw.k11_inputs(label, dev)
        kt, pt = total.clone(), total.clone()
        ipa_score_combine(aux, bits, full, kt, 2.0)
        ipa_score_combine_plain(aux, bits, full, pt, 2.0)
        equal = torch.equal(kt.view(torch.int32), pt.view(torch.int32)) \
            and not torch.equal(kt, total)
        least, by = kw.bound_ms(*kw.k11_work(aux, bits, full))
        work = total.clone()
        add(f"ipa_score_combine ({label})",
            lambda a_=aux, b_=bits, f_=full, w_=work: ipa_score_combine(a_, b_, f_, w_, 2.0),
            bool(equal), C=bits.shape[0], N=8192, D=aux.depth, present=list(aux.present),
            bound_ms=least, bound_by=by)

    fields = ("aff_cnt", "anti_cnt", "paff_cnt", "panti_cnt", "aff_total", "block_dyn",
              "score_dyn")
    for label in kw.K12_CASES:
        aux, commit, choice, class_of = kw.k12_inputs(label, dev)
        ka, pa = iplug.engine_copy(aux), iplug.engine_copy(aux)
        ipa_update_classes(ka, commit, choice, class_of)
        ipa_update_classes_plain(pa, commit, choice, class_of)
        equal = all(torch.equal(getattr(ka, f), getattr(pa, f)) for f in fields) \
            and not all(torch.equal(getattr(ka, f), getattr(aux, f)) for f in fields)
        least, by = kw.bound_ms(*kw.k12_work(aux, commit, choice, class_of))
        work = iplug.engine_copy(aux)
        add(f"ipa_update_classes ({label})",
            lambda w_=work, a_=commit, b_=choice, c_=class_of: ipa_update_classes(w_, a_, b_, c_),
            bool(equal), C=aux.score_dyn.shape[0], N=8192, D=aux.depth,
            present=list(aux.present), commits=int(commit.sum()), bound_ms=least, bound_by=by)

    for c, soft in ((4, False), (4, True), (1, False), (512, False)):
        aux, bits, full, total = k7_inputs(c, soft, dev)
        kt, pt = total.clone(), total.clone()
        spread_score_combine(aux, bits, full, kt, 2.0)
        spread_score_combine_plain(aux, bits, full, pt, 2.0)
        equal = torch.equal(kt.view(torch.int32), pt.view(torch.int32)) \
            and not torch.equal(kt, total)
        work = total.clone()
        add("spread_score_combine" + (" (ScheduleAnyway)" if soft else ""),
            lambda a_=aux, b_=bits, f_=full, w_=work: spread_score_combine(a_, b_, f_, w_, 2.0),
            bool(equal), C=c, N=8192, Cc=1, soft=soft)

    fw, (fs_plan, _comb) = cs.framework_plans()
    gen = torch.Generator().manual_seed(cs.SEED + 1)
    k1_cases = [(c, "LeastAllocated", "path") for c in (1, 4, 512)]
    k1_cases += [(128, s_, "path") for s_ in ("MostAllocated", "RequestedToCapacityRatio")]
    k1_cases.append((512, "LeastAllocated", "synthetic"))
    base = cs.synthetic_snapshot(8192, gen, dev)
    for c, strategy, nodes in k1_cases:
        if nodes == "path":
            rep, snap, dyn, na_mask, na_pref = k1_inputs(c, base, dev)
        else:
            snap = cs.synthetic_snapshot(8192, gen, dev)
            dyn = types.SimpleNamespace(requested=snap.requested,
                                        non_zero=snap.non_zero_requested)
            rep, na_mask, na_pref = cs.synthetic_classes(c, 8192, gen, dev)
        img = image_scaled_by_id(snap)
        plan = fs_plan if strategy == "LeastAllocated" else \
            dataclasses.replace(fs_plan, fit=FitPlugin(strategy))
        a1 = (rep, snap, dyn, na_mask, na_pref, img, plan)
        kb, kr = filter_score_planes(*a1)
        pb, pr = filter_score_planes_plain(*a1)
        equal = torch.equal(kb, pb) and torch.equal(kr.view(torch.int32), pr.view(torch.int32))
        least, by = kw.bound_ms(*kw.k1_work(rep, snap, dyn, na_mask, na_pref, img, kb, kr))
        add("filter_score_planes" + ("" if strategy == "LeastAllocated" else f" ({strategy})")
            + ("" if nodes == "path" else " (synthetic nodes)"),
            lambda a_=a1: filter_score_planes(*a_), bool(equal), C=c, N=8192,
            strategy=strategy, nodes=nodes, bound_ms=least, bound_by=by)

    for kind in ("path", "nominated"):
        requested, non_zero, bundles = k13_inputs(kind, dev)
        try:  # a tree whose wrapper takes no null nz gets the zero rows
            prev_delta_apply(requested, non_zero, bundles)
        except (TypeError, AttributeError, RuntimeError):
            bundles = [(rw, rq, torch.zeros((rw.shape[0], 2), dtype=torch.int32, device=dev))
                       for rw, rq, _nz in bundles]
        kr_, kn_ = prev_delta_apply(requested, non_zero, bundles)
        pr_, pn_ = prev_delta_apply_plain(requested, non_zero, bundles)
        equal = torch.equal(kr_, pr_) and torch.equal(kn_, pn_) \
            and not torch.equal(kr_, requested)
        n, r = requested.shape
        rows_all = torch.cat([b[0] for b in bundles])
        live = rows_all >= 0
        at = rows_all.long().clamp(0, n - 1)
        add_req = torch.where(live[:, None], torch.cat([b[1] for b in bundles]), 0)
        with_nz = [b for b in bundles if b[2] is not None and bool(b[2].any())]
        add_nz = torch.where(live[:, None], torch.cat([b[2] for b in bundles]), 0) \
            if with_nz else None
        lib_r, lib_n = requested.clone(), non_zero.clone()

        def library(at_=at, ar=add_req, an=add_nz, lr=lib_r, ln=lib_n):
            lr.index_add_(0, at_, ar)
            if an is not None:
                ln.index_add_(0, at_, an)
        # what the adds need: each bundle row's node row and request rows read
        # once, the touched node rows read and written
        placed = int(live.sum())
        touched = int(at[live].unique().numel())
        width = r + (2 if add_nz is not None else 0)
        n_bytes = 4 * rows_all.numel() * (1 + width) + touched * width * 4 * 2
        least, by = kw.bound_ms(n_bytes, placed * width)
        fn = (lambda q=requested, z=non_zero, b_=bundles: prev_delta_apply(q, z, b_))
        add(f"prev_delta_apply ({kind})", fn, bool(equal), N=n, R=r, bundles=len(bundles),
            rows=int(rows_all.numel()), placed=placed, bound_ms=least, bound_by=by,
            library_ms=cs.device_ms(library), library_ms_source=cs.MS_SOURCE[0],
            library_queued_ms=cs.queued_device_ms(library))

    # K17: a tree whose keyed mode takes the step's key (one launch a step)
    # or its noise row (K33's tie_row first: the step is two launches)
    from kubernetes_tpu_torch.kernels.tie_noise import tie_row

    by_key = "keys" in inspect.signature(scan_select_assume).parameters
    build.load("tie_noise")
    for label in K17_CASES:
        keyed, ties, n, live = K17_CASES[label]
        a17, keys, k, tied = k17_inputs(label, dev, kw)
        i = a17[3]
        if keys is None:
            tail = ()
        elif by_key:
            tail = (keys, k)
        else:
            tail = (tie_row(keys, k, n),)
        ko, po = [t.clone() for t in a17[8:12]], [t.clone() for t in a17[8:12]]
        scan_select_assume(*a17[:8], *ko, *tail)
        scan_select_assume_plain(*a17[:8], *po, *tail)
        node = int(ko[2][i])
        want = k17_expected(a17, keys, k)
        equal = all(torch.equal(x, y) for x, y in zip(ko, po)) and node == want \
            and (ties == "all" or node == min(tied))  # the lowest tied row
        least, by = kw.bound_ms(*kw.k17_work(a17[0], a17[1], a17[2], i, a17[4], a17[5],
                                             a17[6], keys))
        work = [t.clone() for t in a17[8:12]]
        fn = (lambda a_=a17, w_=work, t_=tail: scan_select_assume(*a_[:8], *w_, *t_))
        add(f"scan_select_assume ({label})", fn, bool(equal), kernel="scan_select_kernel",
            N=n, R=8, live=live, node=node, bound_ms=least, bound_by=by,
            host_us=host_issue_us(fn))
        if keys is None:
            continue
        # the keyed step as the scan issues it: the parent's tie_row + K17,
        # the change's one launch
        if by_key:
            step = fn
        else:
            def step(a_=a17, w_=work, ks=keys, k_=k, n_=n):
                scan_select_assume(*a_[:8], *w_, tie_row(ks, k_, n_))
        add(f"scan_select_assume ({label}, the step)", step, bool(equal), N=n, R=8,
            live=live, launches=1 if by_key else 2, bound_ms=least, bound_by=by,
            host_us=host_issue_us(step))

    # K23 at K23_CASES, and some under other launch plans where the tree
    # chooses one (``selectors.plan_for``: objects a block, rows a block)
    from kubernetes_tpu_torch.kernels import selectors as KSEL

    build.load("selector_match")
    plans = [None]
    if hasattr(KSEL, "plan_for"):
        plans += [(64, 32), (64, 512), (128, 16), (128, 32), (128, 128), (128, 256)]
    for label in kw.K23_CASES:
        a23, kw23 = kw.k23_inputs(label, dev)
        want = KSEL.selector_match_plain(*a23, **kw23)
        least, by = kw.bound_ms(*kw.k23_work(*a23, **kw23))
        mode, u, t, s_, o, lab, b, index, numeric = kw.K23_CASES[label]
        for plan_ in plans if label.startswith(("path", "U = 512", "label selectors, side",
                                                "requirement rows")) else [None]:
            def fn(a_=a23, k_=kw23, p_=plan_):
                if p_ is None:
                    return KSEL.selector_match(*a_, **k_)
                keep, KSEL.plan_for = KSEL.plan_for, lambda _u, _t: p_
                try:
                    return KSEL.selector_match(*a_, **k_)
                finally:
                    KSEL.plan_for = keep
            got = fn()
            equal = bool(torch.equal(got, want)) and 0 < int(want.sum()) < want.numel()
            add(f"selector_match ({label}" + ("" if plan_ is None else f", plan {plan_}") + ")",
                fn, equal, U=u, T=t, S=s_, O=o, L=lab, B=b, mode=mode, index=index,
                numeric=numeric,
                plan=list(plan_ or (KSEL.plan_for(u, t) if hasattr(KSEL, "plan_for") else ())),
                bound_ms=least, bound_by=by)

    from kubernetes_tpu_torch.kernels.spread import (
        spread_filter_bits,
        spread_filter_bits_plain,
        spread_update_row,
        spread_update_row_plain,
    )
    from kubernetes_tpu_torch.plugins.podtopologyspread import PodTopologySpreadPlugin

    for label, (c, d, md) in K6_CASES.items():
        aux = spread_aux(c, 1, d, dev, min_domains=md)
        rng = np.random.default_rng(c + d)
        full, bit = 0b1111111, 3
        seeded = np.where(rng.random((c, 8192)) < 0.7, full, full & ~(1 << rng.integers(
            0, 7, (c, 8192)))).astype(np.int32)
        seeded[:, 5000:] = 0
        seeded = torch.from_numpy(seeded).to(dev)
        kb, pb = seeded.clone(), seeded.clone()
        spread_filter_bits(aux, kb, bit, True)
        spread_filter_bits_plain(aux, pb, bit, True)
        equal = torch.equal(kb, pb) and not torch.equal(kb, seeded)
        work = seeded.clone()

        def reseed(w_=work, s_=seeded):
            w_.copy_(s_)

        def fn(a_=aux, w_=work, r_=reseed):  # the path's state: the plane as seeded
            r_()
            spread_filter_bits(a_, w_, bit, True)

        done = kb.clone()  # already filtered: no word changes
        call = (lambda a_=aux, w_=done: spread_filter_bits(a_, w_, bit, True))
        least, by = kw.bound_ms(*kw.k6_work(aux, seeded, bit))
        add(f"spread_filter_bits ({label})", fn, bool(equal), kernel="spread_filter_kernel",
            less=reseed, C=c, N=8192, live=5000, D1=d + 1, min_domains=md, bound_ms=least,
            bound_by=by, ms_filtered=cs.device_ms(call, "spread_filter_kernel"),
            host_us=host_issue_us(call))

    splug = PodTopologySpreadPlugin()
    for label, (cc, node) in K18_CASES.items():
        aux = spread_aux(512, cc, 8, dev, b=512)
        i = 137
        at = torch.tensor([node], dtype=torch.int32, device=dev)
        ka, pa = splug.engine_copy(aux), splug.engine_copy(aux)
        spread_update_row(ka, i, at)
        spread_update_row_plain(pa, i, at)
        equal = torch.equal(ka.hard_counts, pa.hard_counts) \
            and torch.equal(ka.soft_counts, pa.soft_counts)
        moved = not torch.equal(ka.hard_counts, aux.hard_counts)
        equal = equal and moved == (node == 1234)  # a dead node is not counted
        work = splug.engine_copy(aux)
        fn = (lambda w_=work, a_=at: spread_update_row(w_, i, a_))
        least, by = kw.bound_ms(*kw.k18_work(aux, i, at))
        add(f"spread_update_row ({label})", fn, bool(equal), B=512, Cc=cc, N=8192, D1=9,
            node=node, bound_ms=least, bound_by=by, host_us=host_issue_us(fn))

    from kubernetes_tpu_torch.kernels.fork import fork_masks, fork_masks_plain
    from kubernetes_tpu_torch.kernels.selectorspread import (
        selector_spread_score,
        selector_spread_score_into_plain,
    )

    for label, (c, n, kind) in K32_CASES.items():
        bits, full, total, counts, zone, has_zone = k32_inputs(label, dev)
        kt, pt = total.clone(), total.clone()
        selector_spread_score(bits, full, kt, counts, zone, has_zone, 1.0)
        selector_spread_score_into_plain(bits, full, pt, counts, zone, has_zone, 1.0)
        equal = torch.equal(kt.view(torch.int32), pt.view(torch.int32)) \
            and not torch.equal(kt, total)
        work = total.clone()
        fn = (lambda a_=(bits, full, work, counts, zone, has_zone):
              selector_spread_score(*a_, 1.0))
        least, by = kw.bound_ms(*kw.k32_work(bits, full, has_zone))
        add(f"selector_spread_score ({label})", fn, bool(equal), C=c, N=n,
            masked=int((bits == full).sum()), bound_ms=least, bound_by=by,
            host_us=host_issue_us(fn))

    for label, (k, chips, per_fork, dups) in K30_CASES.items():
        a30, kw30 = k30_inputs(label, dev)
        got = fork_masks(*a30, **kw30)
        want = fork_masks_plain(*a30, **kw30)  # the plain version on the card
        equal = all((x is None and y is None) or torch.equal(x, y) for x, y in zip(got, want))
        fn = (lambda a_=a30, k_=kw30: fork_masks(*a_, **k_))
        least, by = kw.bound_ms(*kw.k30_work(a30, kw30))
        add(f"fork_masks ({label})", fn, bool(equal), K=k, N=8192, P=16384, R=8,
            claim_plane=chips, node_arrays_per_fork=per_fork, bound_ms=least, bound_by=by,
            host_us=host_issue_us(fn))

    from kubernetes_tpu_torch.kernels.scatter import scatter_rows, scatter_rows_plain
    from kubernetes_tpu_torch.kernels.spread import (
        spread_update_classes,
        spread_update_classes_plain,
    )

    for label, (c, d, commits, dtype, kind) in K8_CASES.items():
        aux, commit, choice, class_of = k8_inputs(label, dev)
        ka, pa = splug.engine_copy(aux), splug.engine_copy(aux)
        spread_update_classes(ka, commit, choice, class_of)
        spread_update_classes_plain(pa, commit, choice, class_of)
        equal = torch.equal(ka.hard_counts, pa.hard_counts) \
            and torch.equal(ka.soft_counts, pa.soft_counts) \
            and torch.equal(ka.hard_counts, aux.hard_counts) == (commits == 0)
        work = splug.engine_copy(aux)
        fn = (lambda w_=work, a_=commit, b_=choice, c_=class_of:
              spread_update_classes(w_, a_, b_, c_))
        least, by = kw.bound_ms(*kw.k8_work(aux, commit, choice, class_of))
        # ms: every device activity of the call (a tree that casts class_of
        # launches its cast there too); ms_kernel: the K8 kernel's own
        add(f"spread_update_classes ({label})", fn, bool(equal), C=c, Cc=1, B=512, N=8192,
            D1=d + 1, commits=commits, class_of=dtype, bound_ms=least, bound_by=by,
            ms_kernel=cs.device_ms(fn, "spread_update_kernel"), host_us=host_issue_us(fn))

    for label, (group, n, dirty, k) in K16_CASES.items():
        arrays, rows16, vals = k16_inputs(label, dev)
        before = [a.clone() for a in arrays]
        got = scatter_rows(arrays, rows16, vals)
        want = scatter_rows_plain(arrays, rows16, vals)
        equal = all(torch.equal(g, w_) for g, w_ in zip(got, want)) \
            and all(torch.equal(a, b_) for a, b_ in zip(arrays, before)) \
            and any(not torch.equal(g, a) for g, a in zip(got, arrays)) == (dirty > 0)
        fn = (lambda a_=arrays, r_=rows16, v_=vals: scatter_rows(a_, r_, v_))

        def library(a_=arrays, r_=rows16, v_=vals):
            return [a.index_copy(0, r_, v) for a, v in zip(a_, v_)]

        least, by = kw.bound_ms(*kw.k16_work(arrays, rows16, vals))
        add(f"scatter_rows ({label})", fn, bool(equal), arrays=len(arrays), rows=n,
            dirty=dirty, payload_rows=k, bytes=kw.nbytes(*arrays), bound_ms=least, bound_by=by,
            library_ms=cs.device_ms(library), library_ms_source=cs.MS_SOURCE[0],
            host_us=host_issue_us(fn))

    from kubernetes_tpu_torch.kernels import interpodaffinity as KI
    from kubernetes_tpu_torch.kernels import preempt as KP

    # K27: the whole call (a tree that sorts before its kernel is timed with
    # its sort), held against the plain version on CPU copies (the card's
    # index_add_ adds in no fixed order)
    build.load("preempt")
    for label, (n, live, p, r, n_prio, hot) in kw.K27_CASES.items():
        a27 = kw.k27_inputs(label, dev)
        want = KP.priority_prefix_plain(*[x.cpu() if torch.is_tensor(x) else x for x in a27])
        got = KP.priority_prefix(*a27)
        equal = torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        least, by = kw.bound_ms(*kw.k27_work(*a27))
        fn = (lambda a_=a27: KP.priority_prefix(*a_))
        add(f"priority_prefix ({label})", fn, bool(equal), N=n, live=live, P=p, R=r,
            live_levels=n_prio, hot_node_pods=hot, bound_ms=least, bound_by=by,
            host_us=host_issue_us(fn))

    # K10 on the plane as K1 seeded it: each timed call first copies it in
    # (``ms`` the K10 kernel's own device time, ``queued_ms`` with the copy's
    # taken off); ``ms_filtered`` on a plane it already filtered (no store)
    for label, (c, form, present, n) in kw.K10_CASES.items():
        aux, seeded, bit = kw.k10_inputs(label, dev)
        kb, pb = seeded.clone(), seeded.clone()
        KI.ipa_filter_bits(aux, kb, bit)
        KI.ipa_filter_bits_plain(aux, pb, bit)
        equal = torch.equal(kb, pb) \
            and torch.equal(kb, seeded) == (present == ("pref_affinity",))
        work = seeded.clone()

        def reseed(w_=work, s_=seeded):
            w_.copy_(s_)

        def fn(a_=aux, w_=work, r_=reseed):
            r_()
            KI.ipa_filter_bits(a_, w_, bit)

        done = kb.clone()
        call = (lambda a_=aux, w_=done: KI.ipa_filter_bits(a_, w_, bit))
        least, by = kw.bound_ms(*kw.k10_work(aux, seeded, bit))
        add(f"ipa_filter_bits ({label})", fn, bool(equal), kernel="ipa_filter_kernel",
            less=reseed, C=c, N=n, form=form, present=list(present), bound_ms=least,
            bound_by=by, ms_filtered=cs.device_ms(call, "ipa_filter_kernel"),
            host_us=host_issue_us(call))

    # K28 at K28_CASES, the whole call, held against the plain version on
    # CPU copies
    def cpu_args(a):
        return [x.cpu() if torch.is_tensor(x) else x for x in a]

    for label in kw.K28_CASES:
        b, n, live, r, n_prio, kind = kw.K28_CASES[label]
        a28 = kw.k28_inputs(label, dev)
        want = KP.candidate_fit_plain(*cpu_args(a28))
        equal = torch.equal(KP.candidate_fit(*a28).cpu(), want)
        least, by = kw.bound_ms(*kw.k28_work(*a28))
        fn = (lambda a_=a28: KP.candidate_fit(*a_))
        add(f"candidate_fit ({label})", fn, bool(equal), B=b, N=n, live=live, R=r,
            levels=n_prio, kind=kind, bound_ms=least, bound_by=by, host_us=host_issue_us(fn))

    # K25 at K25_CASES on a copy of the totals (each timed call adds into
    # it again), held against the plain version on CPU copies
    from kubernetes_tpu_torch.kernels import dra as KR

    build.load("dra")
    for label in kw.K25_CASES:
        a25 = kw.k25_inputs(label, dev)
        bits, full, total, cap, free, demand, weight = a25
        want = KR.dra_score_into_plain(*[x.clone() if torch.is_tensor(x) else x
                                         for x in cpu_args(a25)])
        equal = torch.equal(KR.dra_score_into(bits, full, total.clone(), cap, free, demand,
                                              weight).cpu(), want)
        least, by = kw.bound_ms(*kw.k25_work(*a25))
        work = total.clone()
        fn = (lambda w_=work, a_=a25: KR.dra_score_into(a_[0], a_[1], w_, *a_[3:]))
        add(f"dra_score_into ({label})", fn, bool(equal), C=bits.shape[0], N=bits.shape[1],
            feasible=int((bits == full).sum()), bound_ms=least, bound_by=by,
            host_us=host_issue_us(fn))

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"root": str(root), "card": card.strip(),
                                          "rows": rows}, indent=1))
    print(f"{root.name} rows: " + "; ".join(f"{r['name']} {r['ms']:.5f} / {r['queued_ms']:.5f}"
                                           for r in rows), flush=True)
    if not all(r["equal"] for r in rows):
        sys.exit("kernel_ab: a kernel differs from its plain version")


if __name__ == "__main__":
    main()
