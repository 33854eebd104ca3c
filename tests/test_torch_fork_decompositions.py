"""K30's Hopper decomposition, mirrored in numpy, against the JAX package
(exact).

The CUDA kernel runs only on the card; this mirror walks the inputs as
K30 ``fork_masks`` (csrc/fork.cu) does, so that the decomposition — not
only the function — is held against the reference's ``apply_fork`` with
no node-add (``kubernetes_tpu/whatif/fork.py:92-129``) on the CPU:

* one block a (fork, output tile): a node tile of ``K30_NODE_TILE`` nodes
  owns their node_valid, requested, non_zero_requested and
  claim_allocated rows, a pod tile ``K30_POD_TILE`` pods of pod_valid, an
  affinity tile ``K30_AFF_TILE`` cells of aff_counts (``kernel_work``'s
  copy of the kernel's constants); the tiles' elements walked in 16-byte
  vectors where the arrays allow it, single elements otherwise;
* the block reads its fork's payload once and stages the entries that land
  in its tile: warp w of ``K30_THREADS / 32`` takes entries w·32 + lane +
  j·K30_THREADS and keeps the first ``K30_SEG`` that land (ballot order);
  where a warp has more, the tile walks the whole payload instead;
* each element is written once, from its base with the staged entries
  applied: a removed node or masked victim cleared, each victim's request,
  non-zero and claim rows subtracted (duplicates twice), 1.0 subtracted per
  affinity contribution, in staging order.

The cases: duplicate victims and affinity cells, −1 pads in every group,
rows past N − 1 / P − 1 / G − 1 / D − 1 (clipped) and below 0, victims,
removes and cells on either side of a tile boundary with N, P and G × D
not whole numbers of tiles, the claim plane on and off, G or D of 0, K = 1
and K = 4, warps with exactly ``K30_SEG`` entries in a tile and with more
(the walk), and per-fork node arrays from K31 (the port's
``fork_add_rows``).  Each case also runs through the port's plain version
at ``device="cpu"``, and ``kernel_work.k30_work`` is held to a hand count.

Tolerance: exact (integer and boolean arrays; integer-valued float32
counts).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.whatif import fork as jfork
from kubernetes_tpu_torch.kernels.fork import fork_add_rows, fork_masks
from kubernetes_tpu_torch.perf.kernel_work import (
    K30_AFF_TILE,
    K30_NODE_TILE,
    K30_POD_TILE,
    K30_SEG,
    K30_THREADS,
    k30_work,
)

WARPS = K30_THREADS // 32


@dataclasses.dataclass
class Snap:
    """The DeviceSnapshot fields the reference's apply_fork reads without a
    node-add (``dataclasses.replace`` takes any dataclass)."""

    node_valid: object
    requested: object
    non_zero_requested: object
    pod_valid: object
    pod_request: object
    pod_non_zero: object
    aff_counts: object
    claim_allocated: object


# --- the mirror ----------------------------------------------------------------------------


def stage(lands: np.ndarray):
    """The entries a block stages for its tile, in staging order, and
    whether a warp ran past its slots: warp w takes entries w·32 + lane +
    j·THREADS (ballot order: by j, then lane) and keeps the first SEG that
    land.  Past an overflow the tile walks every landing entry in row
    order."""
    e = lands.shape[0]
    staged, over = [], False
    for w in range(WARPS):
        mine = [i for j in range(0, e, K30_THREADS) for lane in range(32)
                if (i := w * 32 + lane + j) < e and lands[i]]
        over |= len(mine) > K30_SEG
        staged += mine[:K30_SEG]
    return (list(np.nonzero(lands)[0]) if over else staged), over


def units(count: int, itemsize: int, vec: bool):
    """A tile piece's units: 16-byte vectors (where ``vec``), then single
    elements → [(first element, elements)]."""
    pv = 16 // itemsize
    full = count // pv if vec else 0
    return [(u * pv, pv) for u in range(full)] + [(i, 1) for i in range(full * pv, count)]


def k30_mirror(node: dict, pods: dict, aff: np.ndarray, pay: dict, chips: bool):
    """K30's decomposition → (node_valid, pod_valid, requested, non_zero,
    aff_counts, claim_allocated or None), each ``[K, ...]``, and the number
    of overflowed tiles.  ``node``'s arrays are ``[N, ...]`` (shared) or
    ``[K, N, ...]`` (per fork)."""
    vp, vn, vc = pay["vic_pod_rows"], pay["vic_node_rows"], pay["vic_claim_chips"]
    ar, av, dr = pay["aff_rows"], pay["aff_vals"], pay["del_rows"]
    k = vp.shape[0]
    per_fork = node["requested"].ndim == 3
    n, r = node["requested"].shape[-2:]
    p = pods["pod_valid"].shape[0]
    g, d = aff.shape
    out = {"node_valid": np.zeros((k, n), bool), "pod_valid": np.zeros((k, p), bool),
           "requested": np.zeros((k, n, r), np.int32), "non_zero": np.zeros((k, n, 2), np.int32),
           "aff_counts": np.zeros((k, g, d), np.float32),
           "claim_allocated": np.zeros((k, n), np.int32) if chips else None}
    written = {name: np.zeros(a.shape, np.int32) for name, a in out.items() if a is not None}
    vec = {"node_valid": n % 16 == 0, "requested": n * r * 4 % 16 == 0,
           "non_zero": n * 8 % 16 == 0, "claim_allocated": n * 4 % 16 == 0,
           "pod_valid": p % 16 == 0, "aff_counts": g * d * 4 % 16 == 0}
    overflowed = 0

    def write(name, flat_out, base, lo, count, width, apply):
        """Elements [lo·width, (lo + count)·width) of one fork's flat array,
        unit by unit, each written once."""
        src = base.reshape(-1)
        for first, m in units(count * width, src.itemsize, vec[name]):
            for i in range(lo * width + first, lo * width + first + m):
                flat_out[i] = apply(i - lo * width, src[i])
                written_flat = written[name][fork].reshape(-1)
                written_flat[i] += 1

    for fork in range(k):
        nodes = {nm: (a[fork] if per_fork else a) for nm, a in node.items()}
        v_node = np.clip(vn[fork], 0, n - 1)
        v_pod = np.minimum(vp[fork], p - 1)
        live_v = vp[fork] >= 0
        # --- node tiles
        for n0 in range(0, n, K30_NODE_TILE):
            tn = min(K30_NODE_TILE, n - n0)
            vs, o1 = stage(live_v & (v_node >= n0) & (v_node < n0 + tn))
            dd = np.clip(dr[fork], 0, n - 1)
            ds, o2 = stage((dr[fork] >= 0) & (dd >= n0) & (dd < n0 + tn))
            overflowed += o1 + o2
            dead = {int(dd[i]) - n0 for i in ds}
            at = [(int(v_node[i]) - n0, i) for i in vs]

            def victims(ln):
                return [i for a, i in at if a == ln]

            write("node_valid", out["node_valid"][fork], nodes["node_valid"], n0, tn, 1,
                  lambda e, v: False if e in dead else v)

            def req(e, v):
                for i in victims(e // r):
                    v = np.int32(v - pods["pod_request"][v_pod[i], e % r])
                return v

            write("requested", out["requested"][fork].reshape(-1), nodes["requested"], n0, tn,
                  r, req)

            def nzr(e, v):
                for i in victims(e // 2):
                    v = np.int32(v - pods["pod_non_zero"][v_pod[i], e % 2])
                return v

            write("non_zero", out["non_zero"][fork].reshape(-1), nodes["non_zero"], n0, tn, 2,
                  nzr)
            if chips:
                def claim(e, v):
                    for i in victims(e):
                        v = np.int32(v - vc[fork, i])
                    return v

                write("claim_allocated", out["claim_allocated"][fork],
                      nodes["claim_allocated"], n0, tn, 1, claim)
        # --- pod tiles
        for p0 in range(0, p, K30_POD_TILE):
            tp = min(K30_POD_TILE, p - p0)
            ps, o = stage(live_v & (v_pod >= p0) & (v_pod < p0 + tp))
            overflowed += o
            hit = {int(v_pod[i]) - p0 for i in ps}
            write("pod_valid", out["pod_valid"][fork], pods["pod_valid"], p0, tp, 1,
                  lambda e, v: False if e in hit else v)
        # --- affinity tiles
        if g * d:
            cell = np.clip(ar[fork], 0, g - 1) * d + np.clip(av[fork], 0, d - 1)
            for c0 in range(0, g * d, K30_AFF_TILE):
                tc = min(K30_AFF_TILE, g * d - c0)
                cs_, o = stage((ar[fork] >= 0) & (cell >= c0) & (cell < c0 + tc))
                overflowed += o
                at_c = [int(cell[i]) - c0 for i in cs_]

                def minus(e, v):
                    for c in at_c:
                        if c == e:
                            v = np.float32(v - np.float32(1.0))
                    return v

                write("aff_counts", out["aff_counts"][fork].reshape(-1), aff, c0, tc, 1, minus)
    for name, w in written.items():
        assert (w == 1).all(), f"{name}: an element written {w.min()}–{w.max()} times"
    return (out["node_valid"], out["pod_valid"], out["requested"], out["non_zero"],
            out["aff_counts"], out["claim_allocated"]), overflowed


# --- the cases -----------------------------------------------------------------------------


def make_case(seed, *, k=4, n=300, p=5000, r=3, g=7, d=150, v=16, a=16, dd=8, chips=True,
              per_fork=False, crowd=None):
    """Random live arrays and K payloads built as the engine builds them
    (−1 pads behind each group's entries), then edge entries: victims,
    removes and cells either side of the tile boundaries and on the last
    row, rows past the end and below 0, a duplicate victim and a duplicate
    cell; ``crowd`` = (fork, count) puts ``count`` victims on node 5 (pods
    0..count−1), ``count`` removes on node 1 and ``count`` contributions on
    one cell in that fork."""
    rng = np.random.default_rng(seed)
    lead = (k,) if per_fork else ()
    node = {"node_valid": rng.random(lead + (n,)) < 0.9,
            "requested": rng.integers(0, 1 << 20, lead + (n, r)).astype(np.int32),
            "non_zero": rng.integers(0, 1 << 20, lead + (n, 2)).astype(np.int32),
            "claim_allocated": rng.integers(0, 9, lead + (n,)).astype(np.int32)}
    pods = {"pod_valid": rng.random(p) < 0.9,
            "pod_request": rng.integers(0, 5000, (p, r)).astype(np.int32),
            "pod_non_zero": rng.integers(0, 5000, (p, 2)).astype(np.int32)}
    aff = rng.integers(0, 50, (g, d)).astype(np.float32)
    pay = {"vic_pod_rows": np.full((k, v), -1, np.int32),
           "vic_node_rows": np.zeros((k, v), np.int32),
           "vic_claim_chips": np.zeros((k, v), np.int32),
           "aff_rows": np.full((k, a), -1, np.int32), "aff_vals": np.zeros((k, a), np.int32),
           "del_rows": np.full((k, dd), -1, np.int32)}
    edge_n = [K30_NODE_TILE - 1, K30_NODE_TILE, n - 1, n + 40, -3]
    edge_p = [K30_POD_TILE - 1, K30_POD_TILE, p - 1, p + 9, 0]
    for f in range(k):
        m = max(v - 6 - f, 0)
        pay["vic_pod_rows"][f, :m] = rng.integers(0, p, m)
        pay["vic_node_rows"][f, :m] = rng.integers(0, n, m)
        pay["vic_claim_chips"][f, :m] = rng.integers(0, 5, m)
        if m >= 7:
            pay["vic_pod_rows"][f, :5] = edge_p
            pay["vic_node_rows"][f, :5] = edge_n
            pay["vic_pod_rows"][f, 5], pay["vic_node_rows"][f, 5] = \
                pay["vic_pod_rows"][f, 0], pay["vic_node_rows"][f, 0]  # a duplicate
            pay["vic_claim_chips"][f, 5] = pay["vic_claim_chips"][f, 0]
        ma = max(a - 4 - f, 0)
        if g * d:
            pay["aff_rows"][f, :ma] = rng.integers(0, g, ma)
            pay["aff_vals"][f, :ma] = rng.integers(0, d, ma)
        if ma >= 6 and g * d:
            edge_c = K30_AFF_TILE if g * d > K30_AFF_TILE else g * d - 1
            pay["aff_rows"][f, :4] = [edge_c // d, (edge_c - 1) // d, g + 3, 0]
            pay["aff_vals"][f, :4] = [edge_c % d, (edge_c - 1) % d, d + 5, -2]
            pay["aff_rows"][f, 4], pay["aff_vals"][f, 4] = \
                pay["aff_rows"][f, 0], pay["aff_vals"][f, 0]  # a duplicate cell
        md = min(f + 1, dd)
        pay["del_rows"][f, :md] = rng.integers(0, n, md)
        if dd >= 4:
            pay["del_rows"][f, :4] = [K30_NODE_TILE - 1, K30_NODE_TILE, n - 1, n + 7]
    if crowd is not None:
        f, count = crowd
        pay["vic_pod_rows"][f, :count] = np.arange(count)
        pay["vic_node_rows"][f, :count] = 5
        pay["vic_claim_chips"][f, :count] = 1
        pay["del_rows"][f, :count] = 1
        if g * d:
            pay["aff_rows"][f, :count], pay["aff_vals"][f, :count] = 0, 0
    if not chips:
        pay["vic_claim_chips"] = None
    return node, pods, aff, pay


CASES = {
    "K = 4, claims, tile edges": dict(seed=1),
    "K = 4, no claim plane": dict(seed=2, chips=False),
    "K = 1": dict(seed=3, k=1),
    "one node tile, one pod tile, one affinity tile": dict(seed=4, n=64, p=256, g=8, d=8),
    "G = 0": dict(seed=5, g=0, d=5),
    "D = 0": dict(seed=6, g=4, d=0),
    "a warp's slots exactly full": dict(seed=7, v=256, a=256, dd=256, crowd=(2, 256)),
    "past a warp's slots": dict(seed=8, v=512, a=512, dd=512, crowd=(3, 512)),
    "per-fork node arrays": dict(seed=9, per_fork=True),
}


def reference(node, pods, aff, pay, chips):
    """The reference's apply_fork (no node-add) on each fork → [K, ...]
    arrays in the kernel's output order."""
    k = pay["vic_pod_rows"].shape[0]
    per_fork = node["requested"].ndim == 3
    outs = []
    for f in range(k):
        nd = {nm: (a[f] if per_fork else a) for nm, a in node.items()}
        snap = Snap(node_valid=jnp.asarray(nd["node_valid"]),
                    requested=jnp.asarray(nd["requested"]),
                    non_zero_requested=jnp.asarray(nd["non_zero"]),
                    pod_valid=jnp.asarray(pods["pod_valid"]),
                    pod_request=jnp.asarray(pods["pod_request"]),
                    pod_non_zero=jnp.asarray(pods["pod_non_zero"]),
                    aff_counts=jnp.asarray(aff),
                    claim_allocated=jnp.asarray(nd["claim_allocated"]))
        payload = jfork.ForkPayload(
            *(pay[x][f] for x in ("vic_pod_rows", "vic_node_rows", "aff_rows", "aff_vals",
                                  "del_rows")),
            vic_claim_chips=pay["vic_claim_chips"][f] if chips else None)
        got = jfork.apply_fork(snap, payload)
        outs.append([np.asarray(got.node_valid), np.asarray(got.pod_valid),
                     np.asarray(got.requested), np.asarray(got.non_zero_requested),
                     np.asarray(got.aff_counts),
                     np.asarray(got.claim_allocated) if chips else None])
    return tuple(None if outs[0][j] is None else np.stack([o[j] for o in outs])
                 for j in range(6))


def port_plain(node, pods, aff, pay):
    t = {nm: torch.from_numpy(np.ascontiguousarray(a)) for nm, a in {**node, **pods}.items()}
    py = {nm: None if a is None else torch.from_numpy(a) for nm, a in pay.items()}
    got = fork_masks(t["node_valid"], t["requested"], t["non_zero"], t["claim_allocated"],
                     t["pod_valid"], t["pod_request"], t["pod_non_zero"], torch.from_numpy(aff),
                     py["vic_pod_rows"], py["vic_node_rows"], py["aff_rows"], py["aff_vals"],
                     py["del_rows"], vic_claim_chips=py["vic_claim_chips"])
    return tuple(None if x is None else x.numpy() for x in got)


NAMES = ("node_valid", "pod_valid", "requested", "non_zero", "aff_counts", "claim_allocated")


def assert_same(got, want, what):
    for nm, x, y in zip(NAMES, got, want):
        if y is None:
            assert x is None, f"{what}: {nm}"
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what}: {nm} {x.shape} {y.shape}"
        assert np.array_equal(x.view(np.int32) if x.dtype == np.float32 else x,
                              y.view(np.int32) if y.dtype == np.float32 else y), f"{what}: {nm}"


@pytest.mark.parametrize("label", list(CASES))
def test_k30_tile_owner_mirror_equals_reference(label):
    kw = dict(CASES[label])
    chips = kw.get("chips", True)
    node, pods, aff, pay = make_case(**kw)
    want = reference(node, pods, aff, pay, chips)
    got, overflowed = k30_mirror(node, pods, aff, pay, chips)
    assert_same(got, want, f"mirror, {label}")
    assert_same(port_plain(node, pods, aff, pay), want, f"port plain, {label}")
    # the cases hold what they are named for
    assert (overflowed > 0) == (label == "past a warp's slots")
    if "K = 4" in label:
        # a duplicate victim subtracts twice, masks once
        f = 0
        row = int(np.clip(pay["vic_node_rows"][f, 0], 0, node["requested"].shape[-2] - 1))
        pod = int(min(pay["vic_pod_rows"][f, 0], pods["pod_valid"].shape[0] - 1))
        same = (np.clip(pay["vic_node_rows"][f], 0, node["requested"].shape[-2] - 1) == row) \
            & (pay["vic_pod_rows"][f] >= 0)
        taken = sum(pods["pod_request"][min(int(q), pods["pod_valid"].shape[0] - 1)]
                    for q in pay["vic_pod_rows"][f][same])
        assert np.array_equal(want[2][f, row], (node["requested"][row] - taken).astype(np.int32))
        assert not want[1][f, pod]


def test_k30_per_fork_node_arrays_from_k31():
    """K31's per-fork node arrays (the port's fork_add_rows on CPU tensors,
    adds on rows either side of a node-tile boundary) handed to K30: the
    mirror, the port and the reference applied to each fork's arrays
    agree."""
    node, pods, aff, pay = make_case(11, k=4, n=300)
    k = 4
    rows = np.array([[K30_NODE_TILE - 1, K30_NODE_TILE, 299, 0]] * k, np.int32)
    ok = np.array([[True, True, True, False]] * k)
    rng = np.random.default_rng(12)
    vals = [rng.random((k, 4)) < 0.5, rng.integers(0, 9000, (k, 4, 3)).astype(np.int32),
            rng.integers(0, 9000, (k, 4, 2)).astype(np.int32),
            rng.integers(0, 9, (k, 4)).astype(np.int32)]
    names = ("node_valid", "requested", "non_zero", "claim_allocated")
    outs = fork_add_rows([torch.from_numpy(node[nm]) for nm in names], torch.from_numpy(rows),
                         torch.from_numpy(ok), [torch.from_numpy(x) for x in vals])
    per = {nm: o.numpy() for nm, o in zip(names, outs)}
    assert per["requested"].shape == (k, 300, 3)
    want = reference(per, pods, aff, pay, True)
    got, _ = k30_mirror(per, pods, aff, pay, True)
    assert_same(got, want, "mirror on K31's arrays")
    assert_same(port_plain(per, pods, aff, pay), want, "port plain on K31's arrays")


def test_k30_stage_orders_and_slots():
    """The staging model: ballot order inside a warp, warps in turn, SEG
    slots a warp, the walk past them."""
    e = 3 * K30_THREADS
    lands = np.zeros(e, bool)
    lands[[5, 40, 33, K30_THREADS + 1, 2 * K30_THREADS + 5]] = True
    order, over = stage(lands)
    assert not over and order == [5, K30_THREADS + 1, 2 * K30_THREADS + 5, 33, 40]
    lands[:] = False
    lands[[j * K30_THREADS + lane for j in range(2) for lane in range(32)]] = True
    order, over = stage(lands)  # warp 0 holds 64 landing entries: past its 32 slots
    assert over and order == sorted(order)


def test_k30_work_counts_bases_copies_and_payload():
    k, n, r, p, g, d, v, a, dd = 2, 10, 3, 20, 4, 5, 3, 2, 1
    node_valid = torch.ones(n, dtype=torch.bool)
    req, nz = torch.zeros((n, r), dtype=torch.int32), torch.zeros((n, 2), dtype=torch.int32)
    claim = torch.zeros(n, dtype=torch.int32)
    pv, preq = torch.ones(p, dtype=torch.bool), torch.zeros((p, r), dtype=torch.int32)
    pnz, aff = torch.zeros((p, 2), dtype=torch.int32), torch.zeros((g, d))
    vp = torch.tensor([[1, 2, -1], [3, -1, -1]], dtype=torch.int32)
    vn = torch.zeros((k, v), dtype=torch.int32)
    ar = torch.tensor([[0, -1], [1, 2]], dtype=torch.int32)
    av = torch.zeros((k, a), dtype=torch.int32)
    dr = torch.full((k, dd), -1, dtype=torch.int32)
    args = [node_valid, req, nz, claim, pv, preq, pnz, aff, vp, vn, ar, av, dr]
    node_one = n * (1 + 4 * r + 8)  # valid, requested, non-zero: no claim plane
    base = node_one + p + 4 * g * d
    payload = k * v * 8 + k * a * 8 + k * dd * 4
    assert k30_work(args, {"vic_claim_chips": None}) == (
        base + k * base + payload + 3 * (4 * r + 8), 3 * (r + 2) + 3)
    chips = torch.ones((k, v), dtype=torch.int32)
    node_one_c = n * (1 + 4 * r + 8 + 4)
    base_c = node_one_c + p + 4 * g * d
    assert k30_work(args, {"vic_claim_chips": chips}) == (
        base_c + k * base_c + payload + k * v * 4 + 3 * (4 * r + 8), 3 * (r + 3) + 3)
    # per-fork node arrays: the node group read once a fork
    per = [x.unsqueeze(0).expand(k, *x.shape).contiguous() for x in (node_valid, req, nz, claim)]
    got = k30_work(per + args[4:], {"vic_claim_chips": None})
    assert got[0] == k * node_one + p + 4 * g * d + k * base + payload + 3 * (4 * r + 8)
