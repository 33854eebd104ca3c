"""K23's Hopper decomposition, mirrored in numpy, against the JAX package
(exact).

K23 (csrc/selector_match.cu) is one launch over object tiles × chunks of
the result rows.  This mirror walks its inputs as the kernel does:

* a block's chunk of result rows names its unique rows through the index
  (a negative index wrapped as torch's); their set is a bitmap of U bits,
  walked in increasing order, each distinct row given the next slot (with
  no index the chunk's rows are their own slots);
* a thread evaluates its object of the tile for the work items, (row,
  term) pairs of the walked rows: the AND over the term's requirements
  (the rules of the plain version: pad and unknown ops true, NotIn on an
  absent key true, Gt / Lt in float32 with NaN false), none for a term
  that is not valid or a row that match_all / match_none decides; a
  warp's 32 verdicts become one ballot word an item, and a row's words
  are the OR of its items' (none for match_none, all for match_all);
* a result row finds its slot as the count of walked rows before it (the
  bitmap's words before its own, then a popcount);
* few unique rows (all of them staged at once) skip the bitmap: a row's
  slot is its own index;
* the result is written once: a row's bytes of the tile as 16-byte stores
  on 16-byte boundaries, 16 objects from the row's ballot words (4 bits → 4
  bytes by a multiply), the bytes before the first boundary (a row that
  does not start on 16 bytes) and after the last (the tail of O) one at a
  time.

Held against the JAX package's ``node_match_matrix``,
``label_match_matrix`` and ``requirements_match_matrix`` at the plans
``selectors.plan_for`` chooses (128 × 256, 64 × 512, 128 × 16) and 64 ×
128: every output byte is
written exactly once and equals the reference.  Cases: Gt / Lt with NaN
and absent keys, pad and unknown ops, invalid terms, match_all and
match_none, an index with repeats, U = 512, O = 8190 (a scalar tail and
unaligned rows), L = 8, 16 and 20.  Last, ``kernel_work.k23_work`` is held
to a hand count.

Tolerance: exact (integer compares, float32 compares).
"""

from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.state import selectors as JS
from kubernetes_tpu_torch.kernels.selectors import plan_for, selector_match
from kubernetes_tpu_torch.perf.kernel_work import k23_inputs, k23_work

# (mode, U, T, S, O, L, B, index, numeric), as kernel_work.K23_CASES, cut
# where the reference's broadcast [U·T, S, O, L] would be large
CASES = {
    "path: node selectors, U = 2, L = 16": ("node", 2, 2, 4, 8192, 16, 512, "repeats", "off"),
    "node selectors, Gt / Lt on vals_num": ("node", 8, 2, 4, 4096, 16, 256, "repeats",
                                            "vals_num"),
    "label selectors, side table, L = 8": ("label", 12, 1, 4, 2048, 8, 512, "repeats",
                                           "table"),
    "label selectors, numeric off": ("label", 12, 1, 4, 2048, 8, 300, "repeats", "off"),
    "requirement rows, no index": ("label", 64, 1, 4, 1024, 8, 64, None, "table"),
    "U = 512 distinct rows": ("node", 512, 2, 4, 270, 16, 512, "permuted", "vals_num"),
    "O = 8190": ("node", 2, 2, 4, 8190, 16, 512, "repeats", "off"),
    "L = 20": ("label", 12, 1, 4, 1024, 20, 512, "repeats", "vals_num"),
}
PLANS = [(128, 256), (64, 512), (128, 16), (64, 128)]


def _np(x):
    return None if x is None else x.numpy()


def case_arrays(label: str) -> dict:
    args, kw = k23_inputs(CASES[label], "cpu")
    names = ("req_key", "req_op", "req_vals", "req_num", "term_valid", "match_all",
             "match_none", "keys", "vals")
    c = {k: _np(a) for k, a in zip(names, args)}
    c.update(vals_num=_np(kw["vals_num"]), numeric=_np(kw["numeric"]),
             has_numeric=kw["has_numeric"], index=_np(kw["index"]))
    c["args"], c["kw"] = args, kw
    return c


def reference(c) -> np.ndarray:
    """The JAX package's match matrix for the case: node_match_matrix in
    node mode, label_match_matrix with an index, requirements_match_matrix
    on requirement rows with no index."""
    u, t, s = c["req_key"].shape
    num = dict(vals_num=None if c["vals_num"] is None else jnp.asarray(c["vals_num"]),
               numeric=None if c["numeric"] is None else jnp.asarray(c["numeric"]))
    keys, vals = jnp.asarray(c["keys"]), jnp.asarray(c["vals"])
    if c["term_valid"] is not None:
        cns = SimpleNamespace(req_key=c["req_key"], req_op=c["req_op"],
                              req_vals=c["req_vals"], req_num=c["req_num"],
                              term_valid=c["term_valid"], match_all=c["match_all"],
                              index=c["index"], has_numeric=c["has_numeric"])
        return np.asarray(JS.node_match_matrix(cns, keys, vals, **num))
    flat = dict(req_key=c["req_key"].reshape(u, s), req_op=c["req_op"].reshape(u, s),
                req_vals=c["req_vals"].reshape(u, s, -1), req_num=c["req_num"].reshape(u, s))
    if c["index"] is None:
        return np.asarray(JS.requirements_match_matrix(
            *flat.values(), keys, vals, has_numeric=c["has_numeric"], **num))
    cs = SimpleNamespace(**flat, match_none=c["match_none"], index=c["index"],
                         has_numeric=c["has_numeric"])
    return np.asarray(JS.label_match_matrix(cs, keys, vals, **num))


# --- the mirror ----------------------------------------------------------------------------

OP_IN, OP_NOT_IN, OP_EXISTS, OP_DOES_NOT_EXIST, OP_GT, OP_LT, OP_PAD = 0, 1, 2, 3, 4, 5, -1


def requirement(c, keys, vals, vnum, rs) -> np.ndarray:
    """A requirement's verdict for every object (its label set [·, L])."""
    op = int(c["req_op"].reshape(-1)[rs])
    n = keys.shape[0]
    if op == OP_PAD or op < OP_IN or op > OP_LT:
        return np.ones(n, bool)
    rk = int(c["req_key"].reshape(-1)[rs])
    numeric = c["has_numeric"] and op in (OP_GT, OP_LT)
    m = (keys == rk) if rk >= 0 else np.zeros(keys.shape, bool)
    present = m.any(1)
    val = np.where(m, vals, -1).max(1)
    if op == OP_EXISTS:
        return present
    if op == OP_DOES_NOT_EXIST:
        return ~present
    if op in (OP_GT, OP_LT):
        if not numeric:
            return np.zeros(n, bool)
        if vnum is None:  # the side table at the value id, NaN for an id < 0
            tab = c["numeric"]
            vnum = np.where(vals >= 0, tab[np.clip(vals, 0, tab.shape[0] - 1)], np.nan)
        with np.errstate(invalid="ignore"):
            vn = np.where(m, vnum, -np.inf).max(1)  # NaN propagates, as amax
            rn = c["req_num"].reshape(-1)[rs]
            return present & ((vn > rn) if op == OP_GT else (vn < rn))
    rv = c["req_vals"].reshape(-1, c["req_vals"].shape[-1])[rs]
    in_vals = (val >= 0) & (val[:, None] == rv[None, :]).any(1)
    return (present & in_vals) if op == OP_IN else (~present | ~in_vals)


def item_verdicts(c, keys, vals, vnum, u, t) -> np.ndarray:
    """Item (row u, term t)'s verdict for every object: the AND over the
    term's requirements; none for a term that is not valid or a row whose
    match flags decide it."""
    _u, t_, s_ = c["req_key"].shape
    n = keys.shape[0]
    flagged = (c["match_all"] is not None and c["match_all"][u]) or \
        (c["match_none"] is not None and c["match_none"][u])
    if flagged or (c["term_valid"] is not None and not c["term_valid"][u, t]):
        return np.zeros(n, bool)
    ok = np.ones(n, bool)
    for s in range(s_):
        ok &= requirement(c, keys, vals, vnum, (u * t_ + t) * s_ + s)
    return ok


def row_verdicts(c, keys, vals, vnum, u) -> np.ndarray:
    """Unique row u's verdict for every object: the OR of its items' words,
    none for match_none, all for match_all."""
    t_ = c["req_key"].shape[1]
    if c["match_none"] is not None and c["match_none"][u]:
        return np.zeros(keys.shape[0], bool)
    if c["match_all"] is not None and c["match_all"][u]:
        return np.ones(keys.shape[0], bool)
    out = np.zeros(keys.shape[0], bool)
    for t in range(t_):
        out |= item_verdicts(c, keys, vals, vnum, u, t)
    return out


def expand4(h: np.ndarray) -> np.ndarray:
    """4 bits → 4 bytes of 0 / 1 (bit e in byte e), by the kernel's multiply."""
    return ((h & np.uint64(0xF)) * np.uint64(0x00204081)) & np.uint64(0x01010101)


def stage_group(chunk: int, t: int, s: int, v: int) -> int:
    """The walked rows staged at a time: as many as 32 KB hold, 1 to chunk
    (every unique row at once where they fit it and the chunk)."""
    return max(1, min(chunk, (32 * 1024) // (t * s * (12 + 4 * v) + t + 1)))


def bits16(words: np.ndarray, li: np.ndarray) -> np.ndarray:
    """16 verdict bits of a row's tile from bit li on (words [..., W])."""
    w_n = words.shape[-1]
    w, sh = li >> 5, (li & 31).astype(np.uint64)
    lo = np.take_along_axis(words, w[..., None], -1)[..., 0]
    hi = np.take_along_axis(words, np.minimum(w + 1, w_n - 1)[..., None], -1)[..., 0]
    x = lo | np.where(w + 1 < w_n, hi, np.uint64(0)) << np.uint64(32)
    return (x >> sh) & np.uint64(0xFFFF)


def k23_mirror(c, tile: int, chunk: int):
    """→ (the result bytes [B, O], each byte's write count)."""
    u_n, t_n, s_n = c["req_key"].shape
    o_n, lab = c["keys"].shape
    b_n = u_n if c["index"] is None else c["index"].shape[0]
    g = stage_group(chunk, t_n, s_n, c["req_vals"].shape[-1])
    tiles = -(-o_n // tile)
    pad = tiles * tile - o_n  # threads past O: an empty label set, never stored
    keys = np.concatenate([c["keys"], np.full((pad, lab), -1, np.int32)])
    vals = np.concatenate([c["vals"], np.full((pad, lab), -1, np.int32)])
    vnum = None if c["vals_num"] is None else \
        np.concatenate([c["vals_num"], np.full((pad, lab), np.nan, np.float32)])
    cache = {}
    out = np.zeros(b_n * o_n, np.uint8)
    writes = np.zeros(b_n * o_n, np.int64)
    w_n = tile // 32
    for b0 in range(0, b_n, chunk):
        nb = min(chunk, b_n - b0)
        rows_u = np.arange(b0, b0 + nb) if c["index"] is None else \
            c["index"][b0:b0 + nb].astype(np.int64)
        rows_u = np.clip(np.where(rows_u < 0, rows_u + u_n, rows_u), 0, u_n - 1)
        if u_n <= g and u_n <= chunk:  # few unique rows: all staged, a slot its index
            walked, slots = list(range(u_n)), rows_u
        elif c["index"] is None:  # no index: the chunk's rows, each its own slot
            walked, slots = list(rows_u), np.arange(nb)
        else:  # the chunk's distinct rows: a bitmap walked in increasing order
            uw = (u_n + 31) // 32
            need = np.zeros(uw, np.uint64)
            for u in rows_u:
                need[u >> 5] |= np.uint64(1) << np.uint64(u & 31)
            walked, base = [], []
            for w in range(uw):
                base.append(len(walked))
                word = int(need[w])
                while word:
                    low = word & -word
                    walked.append(w * 32 + low.bit_length() - 1)
                    word ^= low
            slots = np.array([base[u >> 5] + bin(int(need[u >> 5]) & ((1 << (u & 31)) - 1))
                              .count("1") for u in rows_u])
            assert [walked[s] for s in slots] == list(rows_u)
        for o0 in range(0, tiles * tile, tile):
            for u in walked:
                if u not in cache:
                    cache[u] = row_verdicts(c, keys, vals, vnum, u)
            verdict = np.stack([cache[u][o0:o0 + tile] for u in walked])  # [slots, tile]
            lanes = verdict.reshape(len(walked), w_n, 32).astype(np.uint64)
            words = (lanes << np.arange(32, dtype=np.uint64)).sum(-1)[slots]  # [nb, W]
            # a row's bytes [o0, o_end): 16-byte stores on 16-byte boundaries
            # (the buffer starts on one), the bytes before and after one at a time
            o_end = min(o0 + tile, o_n)
            start = (b0 + np.arange(nb)) * o_n + o0
            head = np.minimum((16 - start % 16) % 16, o_end - o0)
            n16 = (o_end - o0 - head) // 16
            for seg in range(tile // 16):
                j = np.nonzero(seg < n16)[0]
                li = head[j] + 16 * seg
                h = bits16(words[j], li)
                st = np.stack([expand4(h >> np.uint64(4 * q)) for q in range(4)], -1)
                at = start[j, None] + li[:, None] + np.arange(16)
                assert (at[:, 0] % 16 == 0).all()
                out[at] = st.astype("<u4").view(np.uint8).reshape(-1, 16)
                np.add.at(writes, at.reshape(-1), 1)
            for j in range(nb):  # the head and the tail, a byte at a time
                for li in [*range(head[j]), *range(head[j] + 16 * n16[j], o_end - o0)]:
                    out[start[j] + li] = (int(words[j, li >> 5]) >> (li & 31)) & 1
                    writes[start[j] + li] += 1
    return out.reshape(b_n, o_n), writes.reshape(b_n, o_n)


@pytest.fixture(scope="module")
def refs():
    return {}


def _case(refs, label):
    if label not in refs:
        c = case_arrays(label)
        refs[label] = (c, reference(c))
    return refs[label]


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: f"tile{p[0]}-chunk{p[1]}")
@pytest.mark.parametrize("label", list(CASES))
def test_k23_mirror_equals_the_reference(refs, label, plan):
    c, want = _case(refs, label)
    assert 0 < int(want.sum()) < want.size  # not a degenerate matrix
    got, writes = k23_mirror(c, *plan)
    assert (writes == 1).all()  # each result byte written once
    np.testing.assert_array_equal(got.astype(bool), want)


@pytest.mark.parametrize("label", list(CASES))
def test_k23_plain_version_equals_the_reference(refs, label):
    """The port's K23 on CPU tensors (its plain version) on the same arrays."""
    c, want = _case(refs, label)
    got = selector_match(*c["args"], **c["kw"])
    np.testing.assert_array_equal(got.numpy(), want)


def test_k23_stores_cover_tails_and_unaligned_rows(refs):
    """At O = 8190 rows start on 16 bytes only every 8th row, and each row's
    last 14 objects are a scalar tail: both forms appear."""
    c, _want = _case(refs, "O = 8190")
    o_n = c["keys"].shape[0]
    starts = np.arange(512) * o_n
    assert (starts % 16 == 0).sum() == 64 and o_n % 16 == 14


def test_k23_plan_for_chooses_by_the_items():
    """The kernel's plan from U and T: at most 4 (row, term) items (the
    GangBasic path's U = 2, T = 2) 128 objects × 256 rows; at most 32 unique
    rows 64 × every row; more 128 × 16."""
    assert plan_for(2, 2) == (128, 256) and plan_for(4, 1) == (128, 256)
    assert plan_for(12, 1) == (64, 512) and plan_for(32, 2) == (64, 512)
    assert plan_for(64, 1) == (128, 16) and plan_for(512, 2) == (128, 16)


def test_k23_work_hand_count():
    """k23_work: node mode, U = 2 rows of T = 2 terms of S = 3
    requirements with V = 4 values, O = 10 objects of L = 5 labels, an
    index of B = 7 rows, vals_num on: requirements 4 · 2·2·3 (key, op,
    num) + 4 · 2·2·3·4 (values) + 2·2 (term_valid) + 2 (match_all) bytes;
    labels 4 · 10·5 · 3 (keys, values, numbers); the index 4 · 7; the
    result 7 · 10 bytes.  One compare per (row, term, requirement, object,
    label column): 2·2·3·10·5."""
    u, t, s, v, o, lab, b = 2, 2, 3, 4, 10, 5, 7
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32)  # noqa: E731
    args = (i32(u, t, s), i32(u, t, s), i32(u, t, s, v), torch.zeros(u, t, s),
            torch.zeros(u, t, dtype=torch.bool), torch.zeros(u, dtype=torch.bool), None,
            i32(o, lab), i32(o, lab))
    got = k23_work(*args, vals_num=torch.zeros(o, lab), has_numeric=True, index=i32(b))
    want = 4 * u * t * s * 3 + 4 * u * t * s * v + u * t + u + 4 * o * lab * 3 + 4 * b + b * o
    assert got == (want, u * t * s * o * lab)
    # numeric off: no numbers read; no index: B = U rows
    got = k23_work(*args, vals_num=torch.zeros(o, lab), has_numeric=False)
    want = 4 * u * t * s * 3 + 4 * u * t * s * v + u * t + u + 4 * o * lab * 2 + u * o
    assert got == (want, u * t * s * o * lab)
