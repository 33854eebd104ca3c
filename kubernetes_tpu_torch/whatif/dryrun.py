"""Preemption's dry-run fan-out: the candidate mask on the device and the
reprieve sweep + ranking on the host.

Reference: the JAX package's whatif/dryrun.py (``PRIORITY_LEVEL_CAP`` :27,
``candidate_mask_device`` :31-96, ``sweep_and_rank`` :99-185), itself after
pkg/scheduler/framework/preemption/preemption.go DryRunPreemption (:546),
which fans one goroutine per candidate node, and pickOneNodeForPreemption
(:397).

  - ``candidate_mask_device``: "would pod b fit node n with every
    lower-priority pod evicted" for every (pod, node) pair at once — K27 +
    K28 over the priority levels, or K29 without them (kernels/preempt.py);
  - ``sweep_and_rank``: the reprieve sweep + the 6-criteria ranking over
    flat candidate arrays — the host C++ pass (csrc/preempt_sweep.cpp, built
    with g++ at first use) or its plain numpy version.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..kernels import build
from ..kernels.preempt import candidate_dense, candidate_fit, priority_prefix

#: level-table capacity for the segment-sum candidate mask; clusters with
#: more distinct scheduled-pod priorities take the dense form (K29)
PRIORITY_LEVEL_CAP = 128

# calls that ran the C++ sweep (a path check reads it)
NATIVE_CALLS = [0]
_NATIVE = {}


def candidate_mask_device(batch, snap, dyn, static_bits, static_mask: int, levels=None):
    """bool[B, N]: pod b would resource-fit on node n with every
    lower-priority pod on n evicted, n holds at least one such pod, and the
    static (unresolvable) filters pass: every bit of ``static_mask`` set in
    ``static_bits`` (K1's pass-bit plane over the batch rows, zero on dead
    nodes and padding rows).

    ``levels`` (i32[K], sorted unique scheduled-pod priorities padded with
    i32-max — TorchScheduler._priority_levels) selects the level form: K27
    builds the [K+1, N, R] exclusive prefix of per-level request totals and
    K28 gathers each batch pod's threshold row.  Without levels, K29 sums
    the freed requests per (pod, node) directly (the reference's dense
    einsum).  ``dyn.requested`` is the cycle's dynamic state before this
    batch's own commits."""
    if levels is not None:
        prefix, prefix_cnt = priority_prefix(
            snap.pod_valid, snap.pod_node, snap.pod_priority, snap.pod_request,
            levels, snap.num_nodes)
        return candidate_fit(prefix, prefix_cnt, levels, batch.priority, batch.request,
                             snap.allocatable, dyn.requested, static_bits, static_mask)
    return candidate_dense(snap.pod_valid, snap.pod_node, snap.pod_priority,
                           snap.pod_request, batch.priority, batch.request,
                           snap.allocatable, dyn.requested, static_bits, static_mask)


def _native_sweep_fn():
    """csrc/preempt_sweep.cpp's entry point, built at first use, with its
    argument and result types declared."""
    fn = _NATIVE.get("sweep")
    if fn is None:
        fn = build.load("preempt_sweep").ktpu_preempt_sweep
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       i64p, i64p, i64p, u8p, u8p, i64p,
                       ctypes.POINTER(ctypes.c_double), i64p, u8p, i32p, i32p, u8p]
        fn.restype = ctypes.c_int64
        _NATIVE["sweep"] = fn
    return fn


def _sweep_native(base, alloc, vr, v_valid, v_viol, v_prio, v_ts, req_v):
    """The C++ pass (csrc/preempt_sweep.cpp)."""
    fn = _native_sweep_fn()
    c, vmax = v_valid.shape
    i64 = np.ascontiguousarray
    base_c = i64(base, dtype=np.int64)
    alloc_c = i64(alloc, dtype=np.int64)
    vr_c = i64(vr, dtype=np.int64)
    valid_c = np.ascontiguousarray(v_valid, dtype=np.uint8)
    viol_c = np.ascontiguousarray(v_viol, dtype=np.uint8)
    prio_c = i64(v_prio, dtype=np.int64)
    ts_c = np.ascontiguousarray(v_ts, dtype=np.float64)
    req_c = i64(req_v, dtype=np.int64)
    victim_mask = np.zeros((c, vmax), dtype=np.uint8)
    order = np.zeros(c, dtype=np.int32)
    nviol = np.zeros(c, dtype=np.int32)
    valid = np.zeros(c, dtype=np.uint8)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n_valid = fn(
        c, vmax, base_c.shape[1],
        p(base_c, ctypes.c_int64), p(alloc_c, ctypes.c_int64),
        p(vr_c, ctypes.c_int64), p(valid_c, ctypes.c_uint8),
        p(viol_c, ctypes.c_uint8), p(prio_c, ctypes.c_int64),
        p(ts_c, ctypes.c_double), p(req_c, ctypes.c_int64),
        p(victim_mask, ctypes.c_uint8), p(order, ctypes.c_int32),
        p(nviol, ctypes.c_int32), p(valid, ctypes.c_uint8),
    )
    NATIVE_CALLS[0] += 1
    if n_valid == 0:
        return victim_mask.astype(bool), nviol, order, None
    return victim_mask.astype(bool), nviol, order, valid.astype(bool)


def sweep_and_rank(base, alloc, vr, v_valid, v_viol, v_prio, v_ts, req_v,
                   native: bool = False):
    """The reprieve sweep + pickOneNodeForPreemption ranking over flat
    candidate arrays → (victim_mask, nviol, order, valid), or
    (..., None) when no candidate fits at all.

    OUTPUT CONTRACT — valid rows only: victim_mask/nviol/order carry
    meaningful values ONLY for rows where ``valid`` is True (and ``order``
    only up to the first invalid entry).  For infeasible candidates the
    C++ pass zeroes victim_mask/nviol while the numpy pass leaves real
    values there; callers gate on ``valid``.

    ``native`` runs the C++ pass (built at first use; a failed build
    raises); otherwise the numpy pass below, its plain version, runs."""
    c, vmax = v_valid.shape
    if native and c and vmax:
        return _sweep_native(base, alloc, vr, v_valid, v_viol, v_prio, v_ts, req_v)

    def fits(u):
        free = alloc - u
        return np.all((req_v == 0) | (req_v <= free), axis=1)

    feasible = fits(base)
    if not feasible.any():
        return None, None, None, None
    used = base.copy()
    reprieved = np.zeros_like(v_valid)
    for vi in range(v_valid.shape[1]):
        trial = used + vr[:, vi]
        ok = fits(trial) & v_valid[:, vi] & feasible
        used = np.where(ok[:, None], trial, used)
        reprieved[:, vi] = ok
    victim_mask = v_valid & ~reprieved
    count = victim_mask.sum(axis=1)
    valid = feasible & (count > 0)
    big = np.int64(1) << 60
    nviol = (victim_mask & v_viol).sum(axis=1)
    top_prio = np.where(victim_mask, v_prio, -big).max(axis=1)
    sum_key = np.where(victim_mask, v_prio + (1 << 31), 0).sum(axis=1)
    is_top = victim_mask & (v_prio == top_prio[:, None])
    earliest = np.where(is_top, v_ts, np.inf).min(axis=1)
    # pickOneNodeForPreemption's lexicographic chain; invalid rows rank
    # last, full ties resolve to the first candidate in window order
    # (np.lexsort is stable; last key is most significant)
    order = np.lexsort((
        -earliest, count, sum_key, top_prio,
        nviol, np.where(valid, 0, 1),
    ))
    return victim_mask, nviol, order, valid
