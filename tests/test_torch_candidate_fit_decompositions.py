"""K28's Hopper decomposition, mirrored in numpy, against the port's plain
version and the JAX package (exact).

The CUDA kernel runs only on the card; this mirror walks the [B, N] mask
in the kernel's own split, so that the decomposition -- not only the
function -- is held against the reference on the CPU.  K28
``candidate_fit`` (the reference's threshold gather and fit,
whatif/dryrun.py:70-73, 95-96): a block owns a tile of ``FIT_TILE`` nodes
and a group of ``FIT_GROUP`` batch rows; each row's threshold tb =
lower_bound(levels, priority) is found once and flagged, and the group's
distinct thresholds get slots in ascending order, as many as
``kernel_work.k28_plan`` holds; for each slot the block stages the tile's
free[r][n] = (float(alloc) - float(requested)) + prefix[tb][n][r] and its
has-victims bits, a 16-bit word per 16-node chunk.  Thread (p, t) takes
rows p, p + 32, ... and the chunk's nodes [16t, 16t + 16): its static bits,
then -- where any bit passes -- the row's requests, channels whose request
is 0 skipped, the chunk's four 4-node vectors in an order rotated by t / 2,
or, for a row whose threshold found no slot, the threshold row from global
memory against the staged base.  The 16 answers go out as one 16-byte
store where the row's offset allows, four 4-byte stores where it is a
multiple of 4, single bytes else (and on a chunk that N cuts).

Problems: the path's two live levels (one or two thresholds a group); 128
levels with more distinct thresholds in a group than slots (the overflow
path), at R = 4, 5 and 16; N not a multiple of 16 or of the tile; part
groups; static bits that mostly fail; the odd-KiB cluster of
``tests/test_torch_preemption.py``, whose batch rows ask exactly for a
node's float32 fit value at a threshold and one ulp more, with every
threshold staged and with none (every row on the overflow path).  Each
against ``candidate_fit_plain`` and the JAX package's
``candidate_mask_device``.

Tolerance: exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.kernels import preempt as KP
from kubernetes_tpu_torch.kernels.preempt import (
    candidate_fit,
    candidate_fit_plain,
    priority_prefix_plain,
)
from kubernetes_tpu_torch.perf import kernel_work as KW

from tests.test_torch_preemption import (
    I32_MAX,
    _jax_candidate_mask,
    _levels_of,
    _odd_kib_cluster,
)

F32 = np.float32
NPT = KP.FIT_NPT
TPR = KP.FIT_TILE // NPT  # threads a row
RP = 256 // TPR           # rows a pass (csrc/preempt.cu FIT_THREADS = 256)


# --- the mirror ---------------------------------------------------------------------------


def k28_mirror(prefix, cnt, levels, priority, request, alloc, requested, bits, mask: int, *,
               tile: int = KP.FIT_TILE, group: int = KP.FIT_GROUP, slots: int = None,
               vec_bits: bool = True, stats: dict = None):
    """K28's walk over its grid → bool[B, N]; every output element written
    exactly once (asserted).  ``slots`` defaults to the kernel's plan;
    ``vec_bits``: the bits and mask pointers on 16-byte boundaries."""
    b_all, n_all = bits.shape
    r = alloc.shape[1]
    k = levels.size
    s_max = KW.k28_plan(r)[0] if slots is None else slots
    rb = 4 if r <= 4 else (8 if r <= 8 else 16)
    out = np.zeros((b_all, n_all), bool)
    writes = np.zeros((b_all, n_all), np.int64)
    st = stats if stats is not None else {}
    st.update(staged=0, overflow=0, vec16=0, vec4=0, bytes=0, skipped=0)
    for n0 in range(0, n_all, tile):
        # the tile's base, transposed [R][tile] (nodes past N never read)
        h_in = min(tile, n_all - n0)
        base = np.zeros((r, tile), F32)
        base[:, :h_in] = (alloc[n0:n0 + h_in].astype(F32)
                          - requested[n0:n0 + h_in].astype(F32)).T
        for b0 in range(0, b_all, group):
            rows = np.arange(b0, min(b0 + group, b_all))
            tb = np.searchsorted(levels[:k], priority[rows], side="left")
            flags = np.zeros(k + 1, bool)
            flags[tb] = True
            ranked = np.flatnonzero(flags)  # ascending: the warp's ballot scan
            slot_of = {int(t): (i if i < s_max else -1) for i, t in enumerate(ranked)}
            free, cm = {}, {}
            for t_, s in slot_of.items():
                if s < 0:
                    continue
                fr = np.zeros((r, tile), F32)
                fr[:, :h_in] = base[:, :h_in] + prefix[t_, n0:n0 + h_in].T
                free[s] = fr
                c = np.zeros(tile, bool)
                c[:h_in] = cnt[t_, n0:n0 + h_in] > 0
                cm[s] = [sum(1 << e for e in range(NPT) if c[ch * NPT + e])
                         for ch in range(TPR)]
            for tid in range(256):
                t, p = tid % TPR, tid // TPR
                n = n0 + t * NPT
                left = n_all - n
                rot = (t >> 1) & 3
                for kk in range(group // RP):
                    row = p + kk * RP
                    b = b0 + row
                    if b >= b_all:
                        continue
                    ok = 0
                    for e in range(NPT):
                        if e < left and (int(bits[b, n + e]) & mask) == mask:
                            ok |= 1 << e
                    if ok:
                        q = np.zeros(rb, F32)
                        q[:r] = request[b].astype(F32)
                        slot = slot_of[int(tb[row])]
                        fail = 0
                        if slot >= 0:
                            st["staged"] += 1
                            c_m = cm[slot][t]
                            for ch in range(rb):
                                if q[ch] == 0:
                                    continue
                                for qq in range(4):
                                    c4 = (qq + rot) & 3
                                    for j in range(4):
                                        h = t * NPT + 4 * c4 + j
                                        if not q[ch] <= free[slot][ch, h]:
                                            fail |= 1 << (4 * c4 + j)
                        else:
                            st["overflow"] += 1
                            tbr = int(tb[row])
                            c_m = sum(1 << e for e in range(NPT)
                                      if e < left and cnt[tbr, n + e] > 0)
                            for e in range(NPT):
                                if e >= left:
                                    continue
                                for ch in range(rb):
                                    if q[ch] != 0 and not q[ch] <= F32(
                                            base[ch, t * NPT + e] + prefix[tbr, n + e, ch]):
                                        fail |= 1 << e
                        ok &= c_m & ~fail
                    else:
                        st["skipped"] += 1
                    g = b * n_all + n
                    if vec_bits and left >= NPT and g % 16 == 0:
                        st["vec16"] += 1
                        span = range(NPT)
                    elif vec_bits and left >= NPT and g % 4 == 0:
                        st["vec4"] += 1
                        span = range(NPT)
                    else:
                        st["bytes"] += 1
                        span = range(max(0, min(NPT, left)))
                    for e in span:
                        assert n + e < n_all, (b, n, e)  # never past the row
                        out[b, n + e] = bool((ok >> e) & 1)
                        writes[b, n + e] += 1
    assert (writes == 1).all(), np.argwhere(writes != 1)[:5]
    return out


# --- the problems ---------------------------------------------------------------------------


def _tier(seed: int, n: int, p: int, r: int, n_prio: int):
    """A pod tier on ``n`` nodes as the scheduler holds it: requests small
    integers and odd-KiB memory near 1.6M (float32 rounds), a tenth of the
    pods invalid, a twentieth unbound; the levels (sorted unique
    priorities of valid pods, padded with i32-max to 128)."""
    rng = np.random.default_rng(seed)
    node = rng.integers(0, n, p).astype(np.int32)
    node[rng.random(p) < 0.05] = -1
    valid = rng.random(p) >= 0.1
    prios = (np.arange(n_prio) * 7 - 20).astype(np.int32)
    prio = prios[rng.integers(0, n_prio, p)]
    req = np.zeros((p, r), np.int32)
    req[:, 0] = rng.integers(100, 1000, p)
    if r > 1:
        req[:, 1] = rng.integers(700_000, 900_000, p) * 2 + 1
    if r > 2:
        req[:, 2:] = rng.integers(0, 9, (p, r - 2))
    levels = np.full(128, I32_MAX, np.int32)
    u = np.unique(prio[valid])
    levels[: min(u.size, 128)] = u[:128]
    return {"pod_valid": valid, "pod_node": node, "pod_priority": prio,
            "pod_request": req}, levels, prios


def _batch(seed: int, n: int, b: int, r: int, prios, *, fail: float = 0.1, top: bool = False):
    """Nodes of 4000m / 32Gi / 110 pods, requested 30–98%; batch rows at a
    level + 1 (``top``: all at the top level but a sixteenth at the lowest,
    as PreemptionBasic's), requests up to 3000m and 32Gi with zero channels,
    static bits (mask 0b1111) failing on a ``fail`` share."""
    rng = np.random.default_rng(seed)
    alloc = np.zeros((n, r), np.int32)
    alloc[:, 0] = 4000
    if r > 1:
        alloc[:, 1] = 1 << 25
    if r > 2:
        alloc[:, r - 1] = 110
    requested = (alloc * rng.uniform(0.3, 0.98, (n, r))).astype(np.int32)
    if top:
        priority = np.full(b, prios.max() + 1, np.int32)
        priority[: max(1, b // 16)] = prios.min()
    else:
        priority = (prios[rng.integers(0, prios.size, b)] + 1).astype(np.int32)
    req = np.zeros((b, r), np.int32)
    req[:, 0] = rng.integers(0, 3000, b)
    if r > 1:
        req[:, 1] = rng.integers(0, 1 << 25, b)
    req[rng.random((b, r)) < 0.15] = 0
    bits = np.where(rng.random((b, n)) < fail, 0b1011, 0b1111).astype(np.int32)
    return {"alloc": alloc, "requested": requested, "priority": priority, "request": req,
            "bits": bits}


def _case(seed, n, p, b, r, n_prio, **kw):
    tier, levels, prios = _tier(seed, n, p, r, n_prio)
    side = _batch(seed + 100, n, b, r, prios, **kw)
    t = {k_: torch.from_numpy(v) for k_, v in tier.items()}
    prefix, cnt = priority_prefix_plain(t["pod_valid"], t["pod_node"], t["pod_priority"],
                                        t["pod_request"], torch.from_numpy(levels), n)
    return tier, levels, side, prefix.numpy(), cnt.numpy()


def _plain(levels, side, prefix, cnt):
    return candidate_fit_plain(
        torch.from_numpy(prefix), torch.from_numpy(cnt), torch.from_numpy(levels),
        *(torch.from_numpy(side[k_]) for k_ in ("priority", "request", "alloc", "requested",
                                                 "bits")), 0b1111).numpy()


def _jax(tier, levels, side):
    a = dict(tier, alloc=side["alloc"], requested=side["requested"], request=side["request"],
             priority=side["priority"], static_ok=side["bits"] == 0b1111)
    return _jax_candidate_mask(a, levels)


CASES = {
    # name: (seed, N, P, B, R, priorities, batch kwargs, mirror kwargs)
    "two live levels (the path's)": (1, 300, 1200, 150, 8, 2, dict(top=True), {}),
    "many thresholds, R = 4": (2, 100, 2000, 160, 4, 60, {}, {}),
    "many thresholds, R = 16": (3, 70, 1500, 140, 16, 40, {}, {}),
    "R = 5, N = 1000": (4, 1000, 4000, 37, 5, 20, {}, {}),
    "N = 8190-like tail, N = 270": (5, 270, 1500, 90, 8, 5, {}, {}),
    "mostly failing bits": (6, 200, 1500, 130, 8, 3, dict(fail=0.95), {}),
    "misaligned bits": (7, 160, 1500, 70, 8, 4, {}, dict(vec_bits=False)),
    "N = 200, 4-byte stores on odd rows": (8, 200, 1500, 50, 8, 4, {}, {}),
    "one slot": (9, 130, 1500, 140, 8, 30, {}, dict(slots=1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_k28_tile_walk_equals_plain_and_jax(case):
    """The mirror equals ``candidate_fit_plain`` and the reference's
    candidate mask bit for bit, writes every element once, and takes the
    paths the case is named for."""
    seed, n, p, b, r, n_prio, bkw, mkw = CASES[case]
    tier, levels, side, prefix, cnt = _case(seed, n, p, b, r, n_prio, **bkw)
    st = {}
    got = k28_mirror(prefix, cnt, levels, side["priority"], side["request"], side["alloc"],
                     side["requested"], side["bits"], 0b1111, stats=st, **mkw)
    want = _plain(levels, side, prefix, cnt)
    assert np.array_equal(got, want)
    assert np.array_equal(got, _jax(tier, levels, side))
    # the wrapper on CPU tensors is the plain version
    w = candidate_fit(*(torch.from_numpy(x) for x in (prefix, cnt, levels, side["priority"],
                                                      side["request"], side["alloc"],
                                                      side["requested"], side["bits"])),
                      0b1111).numpy()
    assert np.array_equal(w, want)
    # not vacuous: some pairs pass, some fail, and the named paths ran
    assert 0 < got.sum() < (side["bits"] == 0b1111).sum()
    assert st["staged"] > 0 or mkw.get("slots") == 0
    if "many thresholds" in case or case == "one slot":
        assert st["overflow"] > 0
    if "two live" in case:
        assert st["overflow"] == 0
    if n % 16 or case == "misaligned bits":
        assert st["bytes"] > 0
    if case.startswith("N = 200") or case.startswith("R = 5"):
        assert st["vec4"] > 0
    if "failing" in case:
        assert st["skipped"] > st["staged"]


def test_k28_distinct_thresholds_exceed_slots():
    """The many-threshold cases hold more distinct thresholds in a row
    group than the plan has slots, so rows take the overflow path."""
    for case in ("many thresholds, R = 4", "many thresholds, R = 16"):
        seed, n, p, b, r, n_prio, bkw, _ = CASES[case]
        tier, levels, side, _p, _c = _case(seed, n, p, b, r, n_prio, **bkw)
        tb = np.searchsorted(levels, side["priority"][: KP.FIT_GROUP], side="left")
        assert np.unique(tb).size > KW.k28_plan(r)[0]


@pytest.mark.parametrize("slots", [None, 0])
def test_k28_mirror_pins_reference_on_ulp_boundaries(slots):
    """The odd-KiB cluster: batch rows asking exactly for free + prefix[t]
    of a node, and one ulp more; the mirror (every threshold staged, or
    none: every row through the overflow path), the plain version and the
    JAX package agree on every pair, and each pair splits."""
    c = _odd_kib_cluster(7)
    n = c["alloc"].shape[0]
    lv = _levels_of(dict(c, static_ok=None))
    t = {k_: torch.from_numpy(v) for k_, v in c.items()}
    prefix, cnt = (x.numpy() for x in priority_prefix_plain(
        t["pod_valid"], t["pod_node"], t["pod_priority"], t["pod_request"],
        torch.from_numpy(lv), n))
    base = (c["alloc"].astype(F32) - c["requested"].astype(F32))[:, 1]
    rows, prios, targets = [], [], []
    n_lv = int((lv != I32_MAX).sum())
    for node in range(n):
        for th in (2, 5, 17, 18, 33, n_lv):
            if cnt[th, node] == 0:
                continue
            targets.append(node)
            v = float(F32(base[node] + prefix[th, node, 1]))
            ulp = max(1, int(np.spacing(F32(v))))
            rows += [int(v), int(v) + ulp]
            prios += [int(lv[th]) if th < n_lv else 1000] * 2
    b = len(rows)
    req = np.zeros((b, 4), np.int32)
    req[:, 1] = rows
    bits = np.full((b, n), 0b1111, np.int32)
    st = {}
    got = k28_mirror(prefix, cnt, lv, np.asarray(prios, np.int32), req, c["alloc"],
                     c["requested"], bits, 0b1111, slots=slots, stats=st)
    a = dict(c, request=req, priority=np.asarray(prios, np.int32),
             static_ok=np.ones((b, n), bool))
    assert np.array_equal(got, _jax_candidate_mask(a, lv))
    side = {"priority": a["priority"], "request": req, "alloc": c["alloc"],
            "requested": c["requested"], "bits": bits}
    assert np.array_equal(got, _plain(lv, side, prefix, cnt))
    for k_, node in enumerate(targets):
        assert got[2 * k_, node] and not got[2 * k_ + 1, node]
    assert (st["overflow"] > 0) == (slots == 0) and (st["staged"] > 0) == (slots is None)


def test_k28_plan_and_layout():
    """kernel_work.k28_plan (the copy of fit_plan) and its constants equal
    the wrapper's: base and requested rows, then as many slots as fit 40
    KiB; more slots on fewer channels; every plan within the budget, at
    least one slot up to R = 16."""
    assert (KW.K28_TILE, KW.K28_GROUP, KW.K28_NPT, KW.K28_SMEM) == (
        KP.FIT_TILE, KP.FIT_GROUP, KP.FIT_NPT, KP.FIT_SMEM)
    ntp = KP.FIT_TILE + 4
    assert KW.k28_plan(8) == (6, 8 * 8 * ntp + 6 * (4 * 8 * ntp + 4 * 128 + 4 * 8))
    slots = [KW.k28_plan(r)[0] for r in range(17)]
    assert slots == sorted(slots, reverse=True) and min(slots) >= 1
    assert all(KW.k28_plan(r)[1] <= KP.FIT_SMEM for r in range(17))
    assert KW.k28_plan(4)[0] == 13 and KW.k28_plan(16)[0] == 2


def test_k28_work_counts_bits_mask_and_threshold_rows():
    """K28's bound: 5 bytes a (row, node) for the bits read and the mask
    written, each distinct threshold row of prefix and prefix_cnt, alloc
    and requested, the batch rows' priority and requests and the levels;
    a compare a (row, node, channel)."""
    b, n, r, k = 3, 5, 2, 4
    levels = torch.tensor([1, 5, 9, I32_MAX], dtype=torch.int32)
    priority = torch.tensor([5, 5, 20], dtype=torch.int32)  # thresholds 1 and 3
    args = (torch.zeros((k + 1, n, r)), torch.zeros((k + 1, n)), levels, priority,
            torch.zeros((b, r), dtype=torch.int32), torch.zeros((n, r), dtype=torch.int32),
            torch.zeros((n, r), dtype=torch.int32), torch.zeros((b, n), dtype=torch.int32),
            1)
    want = 5 * b * n + 2 * n * (r + 1) * 4 + 8 * n * r + b * (r + 1) * 4 + 4 * k
    assert KW.k28_work(*args) == (want, 4 * b * n * r)
