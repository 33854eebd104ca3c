"""K27's Hopper decomposition, mirrored in numpy, against the port's plain
version and the JAX package (exact).

The CUDA kernel runs only on the card; this mirror walks the pod tier in
the kernel's own split and order, so that the decomposition — not only the
function — is held against the reference on the CPU.  K27
``priority_prefix`` (the reference's level table and exclusive prefix,
whatif/dryrun.py:56-69): a block owns a tile of ``PREFIX_TILE`` nodes; it
streams the tier in chunks of ``PREFIX_CHUNK`` rows, 16 consecutive rows a
thread, and gathers the valid bound pods of its tile (a node past N at
N − 1) into a list placed by a warp scan and a scan of the warps' totals;
the list is flushed when it holds ``PREFIX_CAP`` entries and at the end:
each entry's bucket by lower_bound over the live levels, its requests as
float32, then per group of 32 entries each node's entries as a mask, each
lane taking its node's entries low bit first (by shuffle from the lanes
that loaded them), added into the window's level totals.
The live levels are those below i32-max and the first pad; where they do
not fit (``kernel_work.k27_plan``'s window), each window re-walks the list,
or re-streams the tier where a round overflowed, and the scan's carry
passes between windows.  A window of at most 4 levels sums in registers,
a wider one in shared memory — the same adds in the same order.  Then
each element's carry into each live 16-level block is computed once, and
each (output vector, block) pair — a node's 4 channels, or 4 nodes'
counts, or one element where R or N is not a multiple of 4 — runs
XLA:CPU's blocked recurrence from registers and writes its rows once.

Problems: the odd-KiB cluster of ``tests/test_torch_preemption.py`` (sums
past 2^24, so float32 rounds), whose ulp-boundary batch rows hold the
mirror's prefix against the JAX package's ``candidate_mask_device``; one
node holding more pods than a round, at the kernel's constants and at
small ones that take many chunks and rounds; 128 live levels with R = 16
(several windows, the list kept and the list overflowing); two live levels
as on the PreemptionBasic path; invalid and unbound pods, a node past N,
pods at i32-max and above every level; N not a multiple of the tile or of
4; R not a multiple of 4.  Each also through the port's plain version.

Tolerance: exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.kernels.preempt import (
    CUMSUM_BASE,
    PREFIX_CAP,
    PREFIX_CHUNK,
    PREFIX_TILE,
    candidate_fit_plain,
    priority_prefix,
    priority_prefix_plain,
)
from kubernetes_tpu_torch.perf.kernel_work import k27_plan, k27_work

from tests.test_torch_preemption import (
    I32_MAX,
    _jax_candidate_mask,
    _levels_of,
    _odd_kib_cluster,
)

F32 = np.float32
THREADS = 512  # csrc/preempt.cu PREFIX_THREADS
PPT = 16       # DENSE_PPT: consecutive tier rows a thread
WARP = 32


# --- the mirror ---------------------------------------------------------------------------


def _gather(valid, node, n: int, n0: int, tile: int, c0: int, chunk: int):
    """One chunk's pods of the tile [n0, n0 + tile) in list order: each
    thread's flagged rows, placed at its warp's exclusive scan plus the
    scan of the warps' totals → (rows, local nodes)."""
    p = node.size
    threads = chunk // PPT
    rows = c0 + np.arange(threads)[:, None] * PPT + np.arange(PPT)[None, :]
    inb = rows < p
    rr = np.where(inb, rows, 0)
    nd = node[rr]
    loc = np.minimum(nd, n - 1) - n0
    flag = inb & valid[rr] & (nd >= 0) & (loc >= 0) & (loc < tile)
    mine = flag.sum(axis=1)
    incl = np.concatenate([np.cumsum(w) for w in mine.reshape(-1, WARP)])
    wsum = incl.reshape(-1, WARP)[:, -1]
    first = incl - mine + np.concatenate([[0], np.cumsum(wsum)[:-1]])[
        np.arange(threads) // WARP]
    out_rows = np.full(int(wsum.sum()), -1)
    out_loc = np.full(int(wsum.sum()), -1)
    for t in range(threads):
        out_rows[first[t]:first[t] + mine[t]] = rows[t][flag[t]]
        out_loc[first[t]:first[t] + mine[t]] = loc[t][flag[t]]
    assert (out_rows >= 0).all()
    return out_rows, out_loc


def _load(rows, prio, req, levels, lw: int):
    """A flush's entry loads: each entry's row, its bucket (lower_bound over
    the Lw live levels; −1 where it is K, the reference's dropped bucket)
    and its requests as float32."""
    k = levels.size
    b = np.searchsorted(levels[:lw], prio[rows], side="left")
    return rows, np.where(b < k, b, -1), req[rows].astype(F32)


def _walk(tot, loc, rows, lvl, reqf, w0: int, wn: int, r: int, tile: int, log=None):
    """The window [w0, w0 + wn) of a flushed list into ``tot`` [wn, R+1,
    tile]: per group of 32 entries, each node's entries (the mask its
    __match_any_sync leader writes) low bit first, every channel (the
    count is channel R) of each entry in turn."""
    m = loc.size
    for g in range(0, m, WARP):
        grp = np.arange(g, min(g + WARP, m))
        inwin = (lvl[grp] >= w0) & (lvl[grp] < w0 + wn)
        for h in range(tile):
            for e in grp[inwin & (loc[grp] == h)]:  # low bit first
                l_ = lvl[e] - w0
                for ch in range(r + 1):
                    v = reqf[e, ch] if ch < r else F32(1.0)
                    tot[l_, ch, h] = F32(tot[l_, ch, h] + v)
                if log is not None:
                    log.append((h, lvl[e], int(rows[e])))


def _items(r: int, n: int, tile: int):
    """The tile's output vectors as (kind, node, channel, width): a node's 4
    channels where R is a multiple of 4, else one element; 4 nodes' counts
    where N is a multiple of 4, else one."""
    out = []
    if r % 4 == 0:
        out += [("req", (4 * i) // r, (4 * i) % r, 4) for i in range(tile * r // 4)]
    else:
        out += [("req", i // r, i % r, 1) for i in range(tile * r)]
    if n % 4 == 0:
        out += [("cnt", 4 * j, r, 4) for j in range(tile // 4)]
    else:
        out += [("cnt", j, r, 1) for j in range(tile)]
    return out


def _rows(prefix, cnt, writes, tot, carry, n0: int, n: int, r: int, k: int, lw: int,
          w0: int, wn: int, b_lo: int, b_hi: int, tile: int):
    """The window's rows: first each element's carry into each of the
    window's live 16-level blocks (exb; ``carry`` [R+1, tile] holds the
    carry between windows), then each (output vector, block) pair writes
    its block's rows from registers — XLA:CPU's blocked recurrence, levels
    below Lw from tot, a block past them adding 0.0 to the carry past the
    live blocks; row 0 by block 0; each element of each row written once."""
    b_live = -(-(w0 + wn) // CUMSUM_BASE)
    exb = np.zeros((b_live - b_lo + 1, r + 1, tile), F32)
    for ch in range(r + 1):
        for h in range(tile):
            e = F32(0.0) if w0 == 0 else carry[ch, h]
            for b in range(b_lo, b_live):
                exb[b - b_lo, ch, h] = e
                run = F32(0.0)
                for q in range(min(CUMSUM_BASE, k - b * CUMSUM_BASE)):
                    level = b * CUMSUM_BASE + q
                    x = tot[level - w0, ch, h] if level < lw else F32(0.0)
                    run = x if q == 0 else F32(run + x)
                e = run if b == 0 else F32(e + run)
            exb[b_live - b_lo, ch, h] = e
            carry[ch, h] = e
    for b in range(b_lo, max(b_hi, b_lo + 1)):
        for kind, h, ch0, width in _items(r, n, tile):
            if n0 + h >= n:
                continue
            els = [(ch0 + q, h) if kind == "req" else (r, h + q) for q in range(width)]
            for ch, hh in els:
                e = exb[min(b, b_live) - b_lo, ch, hh]
                for _dead in range(b_live, b):
                    e = F32(e + F32(0.0))
                if b == 0:
                    _write(prefix, cnt, writes, 0, n0 + hh, ch, r, F32(0.0))
                run = F32(0.0)
                for i in range(min(CUMSUM_BASE, k - b * CUMSUM_BASE)):
                    level = b * CUMSUM_BASE + i
                    x = tot[level - w0, ch, hh] if b < b_live and level < lw else F32(0.0)
                    run = x if i == 0 else F32(run + x)
                    y = run if b == 0 else F32(run + e)
                    _write(prefix, cnt, writes, level + 1, n0 + hh, ch, r, y)


def _write(prefix, cnt, writes, t: int, node: int, ch: int, r: int, v) -> None:
    writes[t, node, ch] += 1
    if ch < r:
        prefix[t, node, ch] = v
    else:
        cnt[t, node] = v


def k27_mirror(valid, node, prio, req, levels, n: int, *, tile: int = PREFIX_TILE,
               chunk: int = PREFIX_CHUNK, cap: int = PREFIX_CAP, window: int = None,
               stats: dict = None):
    """K27's walk over its grid → (prefix f32[K+1, N, R], prefix_cnt
    f32[K+1, N]); every output element written exactly once (asserted).
    ``window`` defaults to the kernel's plan; ``chunk`` is 16 rows a thread
    of a whole number of warps; ``stats`` collects the first tile's
    windows, the flushes, the overflowing tile-windows and each (node,
    level)'s pod rows in the order they were added."""
    assert chunk % (PPT * WARP) == 0
    p, r = req.shape
    k = levels.size
    w = window or k27_plan(r, k)[0]
    assert w % CUMSUM_BASE == 0
    lw = min(k, int(np.searchsorted(levels, I32_MAX, side="left")) + 1)
    prefix = np.full((k + 1, n, r), np.nan, F32)
    cnt = np.full((k + 1, n), np.nan, F32)
    writes = np.zeros((k + 1, n, r + 1), np.int64)
    st = stats if stats is not None else {}
    st.update(windows=0, flushes=0, overflows=0, order={})
    for n0 in range(0, n, tile):
        excl = np.zeros((r + 1, tile), F32)
        listed, lst = False, None
        w0 = 0
        while w0 == 0 or w0 < lw:
            wn, last = min(w, lw - w0), w0 + w >= lw
            tot = np.zeros((max(wn, 0), r + 1, tile), F32)
            st["windows"] += n0 == 0
            log = []
            if listed:
                _walk(tot, *lst, w0, wn, r, tile, log)
            elif wn > 0:
                pend_rows, pend_loc, overflow = [], [], False
                for c0 in range(0, p, chunk):
                    rows, loc = _gather(valid, node, n, n0, tile, c0, chunk)
                    base = 0
                    while base < rows.size:
                        take = min(rows.size - base, cap - sum(x.size for x in pend_rows))
                        pend_rows.append(rows[base:base + take])
                        pend_loc.append(loc[base:base + take])
                        base += take
                        if sum(x.size for x in pend_rows) == cap:  # a full round
                            rr = np.concatenate(pend_rows)
                            _walk(tot, np.concatenate(pend_loc),
                                  *_load(rr, prio, req, levels, lw), w0, wn, r, tile, log)
                            st["flushes"] += 1
                            pend_rows, pend_loc, overflow = [], [], True
                if pend_rows and sum(x.size for x in pend_rows):
                    rr = np.concatenate(pend_rows)
                    lst = (np.concatenate(pend_loc), *_load(rr, prio, req, levels, lw))
                    _walk(tot, *lst, w0, wn, r, tile, log)
                    st["flushes"] += 1
                else:
                    lst = (np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0, np.int64), np.zeros((0, r), F32))
                st["overflows"] += overflow
                listed = not overflow
            for h, lv_, e in log:
                st["order"].setdefault((n0 + h, lv_), []).append(e)
            b_lo = w0 // CUMSUM_BASE
            b_hi = -(-k // CUMSUM_BASE) if last else (w0 + w) // CUMSUM_BASE
            _rows(prefix, cnt, writes, tot, excl, n0, n, r, k, lw, w0, wn, b_lo, b_hi, tile)
            w0 += w
    assert (writes == 1).all(), np.argwhere(writes != 1)[:5]
    return prefix, cnt


# --- the problems ---------------------------------------------------------------------------


def _tier(seed: int, n: int, p: int, r: int, n_prio: int, *, hot: int = 0, past_n: bool = True,
          at_max: bool = True, above: bool = False):
    """A pod tier on ``n`` nodes: odd-KiB memory requests near 1.6M (sums
    past 2^24 round), a tenth invalid, a twentieth unbound; ``hot`` pods on
    node 3; a few valid pods on a node past N (the reference clips it to
    N − 1), at i32-max (the first pad's bucket) and, with ``above``, above
    every level of a full table (the dropped bucket K); the levels the
    scheduler builds (sorted unique priorities of valid pods, padded with
    i32-max to 128)."""
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
    if hot:
        node[:hot] = 3
        valid[:hot] = True
    if past_n:
        node[-3:], valid[-3:] = n + 5, True
    if at_max:
        prio[-6:-3], valid[-6:-3] = I32_MAX, True
        node[-6:-3] = np.arange(3) % n
    levels = np.full(128, I32_MAX, np.int32)
    u = np.unique(prio[valid & (prio < I32_MAX)])
    levels[: min(u.size, 128)] = u[:128]
    if above:
        assert u.size >= 128
        prio[-9:-6], valid[-9:-6], node[-9:-6] = prios.max() + 50, True, 1
    return valid, node, prio, req, levels


CASES = {
    # name: (tier kwargs, mirror kwargs)
    "two live levels (the path's)": (dict(seed=1, n=70, p=3000, r=8, n_prio=2), {}),
    "hot node past a round": (dict(seed=2, n=40, p=4000, r=4, n_prio=2, hot=1500), {}),
    "hot node, small chunks and rounds": (dict(seed=3, n=33, p=1500, r=4, n_prio=5, hot=600),
                                          dict(chunk=512, cap=48)),
    "128 levels, R = 16, list kept": (dict(seed=4, n=40, p=900, r=16, n_prio=130, above=True),
                                      {}),
    "128 levels, R = 16, rounds overflow": (dict(seed=5, n=40, p=3000, r=16, n_prio=130,
                                                 above=True), {}),
    "128 levels, windows of 16, small rounds": (dict(seed=6, n=37, p=1200, r=4, n_prio=128),
                                                dict(window=16, chunk=512, cap=40)),
    "R = 5, N = 61": (dict(seed=7, n=61, p=2000, r=5, n_prio=9), {}),
    "R = 1, N = 7": (dict(seed=8, n=7, p=300, r=1, n_prio=3, past_n=False), {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_k27_tile_walk_equals_plain(case):
    """The mirror equals ``priority_prefix_plain`` (the reference's scatter
    and XLA:CPU's blocked cumsum) bit for bit, writes every element once,
    and adds each (node, level)'s entries in ascending pod-row order."""
    kw, mkw = CASES[case]
    valid, node, prio, req, levels = _tier(**kw)
    n = kw["n"]
    st = {}
    got_p, got_c = k27_mirror(valid, node, prio, req, levels, n, stats=st, **mkw)
    want_p, want_c = priority_prefix_plain(*(torch.from_numpy(x) for x in (
        valid, node, prio, req, levels)), n)
    assert np.array_equal(got_p, want_p.numpy())
    assert np.array_equal(got_c, want_c.numpy())
    # the wrapper on CPU tensors is the plain version
    wp, wc = priority_prefix(*(torch.from_numpy(x) for x in (valid, node, prio, req, levels)),
                             n)
    assert torch.equal(wp, want_p) and torch.equal(wc, want_c)
    for (nd, _lv), rows in st["order"].items():
        assert rows == sorted(rows), (nd, _lv)
    # not vacuous: what the case is named for happened
    if "overflow" in case or "hot" in case:
        assert st["overflows"] > 0
    if "list kept" in case:
        assert st["overflows"] == 0
    if "R = 16" in case or "windows" in case:
        assert st["windows"] > 1
    if "two live" in case:
        assert st["windows"] == 1
    assert float(np.nanmax(got_c)) > 0


def test_k27_adds_each_node_in_row_order():
    """Across chunks, rounds and groups, each node's entries reach its lane
    in ascending pod-row order: the mirror's list order equals the rows
    sorted stably by node."""
    valid, node, prio, req, levels = _tier(3, 33, 1500, 4, 5, hot=600)
    n, tile = 33, PREFIX_TILE
    seen = {}
    for n0 in range(0, n, tile):
        for c0 in range(0, node.size, 512):
            rows, loc = _gather(valid, node, n, n0, tile, c0, 512)
            for rw, lc in zip(rows, loc):
                seen.setdefault(n0 + lc, []).append(int(rw))
    bound = valid & (node >= 0)
    for nd, rows in seen.items():
        want = np.flatnonzero(bound & (np.minimum(node, n - 1) == nd)).tolist()
        assert rows == want, nd
    assert len(seen[3]) > 600


def test_k27_mirror_pins_reference_on_ulp_boundaries():
    """The odd-KiB cluster: batch rows asking exactly for free + prefix[t]
    of the mirror's prefix on a node, and one ulp more; the JAX package's
    candidate_mask_device and K28's plain version over the mirror's prefix
    agree on every pair, and each pair splits."""
    c = _odd_kib_cluster(7)
    n = c["alloc"].shape[0]
    lv = _levels_of(dict(c, static_ok=None))
    prefix, prefix_cnt = k27_mirror(c["pod_valid"], c["pod_node"], c["pod_priority"],
                                    c["pod_request"], lv, n, chunk=512, cap=100)
    base = (c["alloc"].astype(F32) - c["requested"].astype(F32))[:, 1]
    rows, prios, targets = [], [], []
    n_lv = int((lv != I32_MAX).sum())
    for node in range(n):
        for th in (2, 5, 17, 18, 33, n_lv):
            if prefix_cnt[th, node] == 0:
                continue
            targets.append(node)
            v = float(F32(base[node] + prefix[th, node, 1]))
            ulp = max(1, int(np.spacing(F32(v))))
            rows += [int(v), int(v) + ulp]
            prios += [int(lv[th]) if th < n_lv else 1000] * 2
    b = len(rows)
    req = np.zeros((b, 4), np.int32)
    req[:, 1] = rows
    a = dict(c, request=req, priority=np.asarray(prios, np.int32),
             static_ok=np.ones((b, n), bool))
    want = _jax_candidate_mask(a, lv)
    t = {k_: torch.from_numpy(np.ascontiguousarray(v)) for k_, v in a.items()}
    got = candidate_fit_plain(torch.from_numpy(prefix), torch.from_numpy(prefix_cnt),
                              torch.from_numpy(lv), t["priority"], t["request"], t["alloc"],
                              t["requested"], t["static_ok"].to(torch.int32), 1).numpy()
    assert np.array_equal(got, want)
    assert len(targets) >= 4 * n
    for k_, node in enumerate(targets):
        assert got[2 * k_, node] and not got[2 * k_ + 1, node]


def test_k27_plan_windows():
    """kernel_work.k27_plan (the copy of prefix_plan): the path's R = 8
    keeps 64 levels a window (its 2 live levels in one), the check case's
    R = 4 all 128 levels, R = 16 windows of 16; a window is a multiple of 16,
    at least 16 and at most K rounded up; every plan fits 200 KiB."""
    assert k27_plan(8, 128) == (64, 1024 * 39 + (64 + 4 + 1) * 64 * 9 * 4)
    assert k27_plan(4, 128) == (128, 1024 * 23 + (128 + 8 + 1) * 64 * 5 * 4)
    assert k27_plan(16, 128)[0] == 16
    for r in range(17):
        for k in (0, 1, 16, 17, 128, 256):
            w, smem = k27_plan(r, k)
            assert w % 16 == 0 and 16 <= w <= max(16, -(-k // 16) * 16)
            assert smem <= 200 * 1024


def test_k27_work_counts_the_tier_it_needs():
    """K27's bound: the valid flags of the tier, a node per valid pod, a
    priority per valid bound pod and its requests where its bucket is
    below K, the levels, each output element once; an add a (kept pod,
    channel) and a (level, node, channel)."""
    valid = torch.tensor([True, True, False, True, True])
    node = torch.tensor([0, -1, 1, 1, 2], dtype=torch.int32)
    prio = torch.tensor([5, 5, 5, 99, 1], dtype=torch.int32)
    req = torch.ones((5, 2), dtype=torch.int32)
    levels = torch.tensor([1, 5], dtype=torch.int32)  # K = 2: priority 99 is dropped
    n, k, r = 3, 2, 2
    # valid: 5 bytes; nodes of 4 valid pods; priorities of 3 bound pods;
    # requests of 2 kept pods; 2 levels; outputs (K+1)·N·(R+1) floats
    want = 5 + 4 * 4 + 4 * 3 + 4 * r * 2 + 4 * k + 4 * (k + 1) * n * (r + 1)
    assert k27_work(valid, node, prio, req, levels, n) == (want, 2 * (r + 1) + k * n * (r + 1))
