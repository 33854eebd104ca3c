"""The full auction on the port against the JAX package (exact).

* B8: the port's ``batch_assign`` without identity classes against the
  JAX package's ``batch_assign(..., classes=None)`` on the JAX encoder's
  arrays (through convert.py): ``node_row``, ``feasible_count``, the final
  ``requested`` / ``non_zero`` and the rounds, on a heterogeneous batch
  with nominated rows, a contended batch (every node claimed over several
  rounds; pods whose memory request is past 2^24 KiB, where the
  reference's float32 commit rounds), a coupled spread batch and coupled
  affinity batches in both count forms, with the reference's coupling
  flags.  The engine leaves its inputs unchanged.
* End to end: TorchScheduler(device="cpu") against TPUScheduler where the
  router takes the full auction (batches of more identity classes than
  half the batch; coupled batches with pods that could preempt) and with
  ``assign_mode="batch"`` or a ``coupled_fraction_threshold`` that keeps
  one-component coupled batches on the auctions, synchronous and
  pipelined at depth 2 and 3; and a mixed queue whose batches take the
  dedup engine, the full auction and the scan: the same node for every
  pod and, batch by batch, the same engine and the same dedup-fallback
  reason as the reference.

Tolerance: exact everywhere.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.framework.runtime import coupling_flags

from tests.test_torch_common import check_engine_parity
from tests.test_torch_scan import PROBLEMS, _eq, build


def _contended():
    """16 nodes, 20 identical pods and 8 of a second template — more pods
    than nodes free for them, so rounds of contention claim every node —
    plus 4 pods of 17 GiB + 1 KiB on the four 64 GiB nodes."""
    nodes = [{"name": f"n{i:02d}", "cpu": "2",
              "memory": "4Gi" if i < 12 else "64Gi", "pods": "110",
              "labels": {}, "taints": [], "images": [], "unschedulable": False,
              "not_ready": False} for i in range(16)]
    pods = [{"name": f"a{i:02d}", "ts": float(i), "req": {"cpu": "1500m", "memory": "1Gi"}}
            for i in range(20)]
    pods += [{"name": f"b{i:02d}", "ts": 20.0 + i, "req": {"cpu": "300m", "memory": "2Gi"}}
             for i in range(8)]
    pods += [{"name": f"g{i:02d}", "ts": 30.0 + i,
              "req": {"cpu": "100m", "memory": "17825793Ki"}} for i in range(4)]
    return build(nodes, [], pods)


FULL_PROBLEMS = {
    "plain": PROBLEMS["plain"],
    "contended": _contended,
    "spread_3zones": PROBLEMS["spread_3zones"],
    "affinity_tables": PROBLEMS["affinity_tables"],
    "affinity_planes": PROBLEMS["affinity_planes"],
}


@pytest.mark.parametrize("kind", list(FULL_PROBLEMS))
def test_batch_assign_full_path_equals_reference(kind):
    p = FULL_PROBLEMS[kind]()
    b = p["hbatch"].size
    coupling = coupling_flags(p["hbatch"])
    fw = p["fw"]
    jauxes = fw.prepare(p["batch"], p["dsnap"], p["dyn"], p["host_auxes"])
    jres = jax.jit(lambda *a: fw.batch_assign(*a, classes=None))(
        p["batch"], p["dsnap"], p["dyn"], jauxes, jnp.arange(b), coupling)
    tauxes = p["tfw"].prepare(p["tbatch"], p["tsnap"], p["tdyn"], p["thost"])
    before = [None if a is None else {f: v.clone() for f, v in a._asdict().items()
                                      if isinstance(v, torch.Tensor)} for a in tauxes]
    req0 = p["tdyn"].requested.clone()
    tres = p["tfw"].batch_assign(p["tbatch"], p["tsnap"], p["tdyn"], tauxes,
                                 torch.arange(b), coupling)
    _eq(jres.node_row, tres.node_row, "node_row")
    _eq(jres.feasible_count, tres.feasible_count, "feasible_count")
    _eq(jres.dyn.requested, tres.dyn.requested, "requested")
    _eq(jres.dyn.non_zero, tres.dyn.non_zero, "non_zero")
    assert int(jres.rounds) == tres.rounds >= 1
    _eq(req0, p["tdyn"].requested, "input requested")
    for aux, fields in zip(tauxes, before):
        for f, v in (fields or {}).items():
            _eq(v, getattr(aux, f), f"input aux {f}")
    rows = tres.node_row.numpy()
    valid = np.asarray(p["hbatch"].valid)
    assert (rows[valid] >= 0).any() and (rows[~valid] == -1).all()
    if kind == "contended":
        assert tres.rounds > 1 and (rows[valid] == -1).any()  # more pods than room
        assert len(set(rows[rows >= 0].tolist())) == 16  # every node claimed
        big = [p["enc"].node_rows[f"n{i:02d}"] for i in range(12, 16)]
        # the reference's float32 commit: 17825793 KiB lands as 17825792
        assert (np.asarray(jres.dyn.requested)[big, 1] % 2 == 0).all()
    if kind != "plain":
        assert np.asarray(coupling.reads).any() or kind == "contended"


@pytest.mark.parametrize("kind", ["hetero", "anti10"])
def test_router_takes_the_full_auction(kind, monkeypatch):
    """Under "auto": a batch of more identity classes than half its slots,
    and a coupled batch with pods that could preempt (a parallel-safe
    class, so no component is large), take the full auction."""
    check_engine_parity(kind, monkeypatch, {"full"})


@pytest.mark.parametrize("kind", ["spread10", "affinity10"])
def test_coupled_fraction_threshold_equals_reference(kind, monkeypatch):
    """``coupled_fraction_threshold=1.0`` passed to both schedulers: a
    coupled priority-10 batch whose one component the default 0.25 sends
    to the scan stays on the auctions, and the dedup gate sends it to the
    full auction — the reference's routes and bindings."""
    check_engine_parity(kind, monkeypatch, {"full"}, coupled_fraction_threshold=1.0)


@pytest.mark.parametrize("kind", ["spread10", "affinity10", "preferred10"])
def test_batch_mode_bindings_equal_reference(kind, monkeypatch):
    """assign_mode="batch": coupled components serialize inside the full
    auction (one head commit per component and round)."""
    check_engine_parity(kind, monkeypatch, {"full"}, assign_mode="batch")


@pytest.mark.parametrize("kind,depth,mode", [("hetero", 2, "auto"), ("anti10", 3, "auto"),
                                             ("spread10", 2, "batch")])
def test_pipelined_full_path_bindings_equal_reference(kind, depth, mode, monkeypatch):
    """The pipelined scheduler over full-auction batches (the affinity
    chain on): the reference's bindings and routes at depth 2 and 3."""
    check_engine_parity(kind, monkeypatch, {"full"}, assign_mode=mode, pipeline=True,
                        pipeline_depth=depth, chain_affinity=True)


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_routing_equals_reference_batch_by_batch(pipeline, monkeypatch):
    """One queue through every engine: batch by batch the port takes the
    reference's engine (dedup, full auction or scan) for the reference's
    dedup-fallback reason ("preemption", "heterogeneous")."""
    log = check_engine_parity("mixed", monkeypatch, {"dedup", "full", "scan"},
                              pipeline=pipeline)
    reasons = {r for _m, _d, r in log}
    assert {"preemption", "heterogeneous"} <= reasons
