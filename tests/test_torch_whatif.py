"""The counterfactual engine on the port against the JAX package (exact
throughout: predictions, bindings and forked arrays are compared for
equality).

* K30 / K31's plain versions (``apply_fork`` / ``apply_forks`` on CPU
  tensors) against the reference's ``whatif.fork.apply_fork`` under
  ``jax.jit``, on random snapshots and payloads fed to both through
  ``convert.fork_payload_from_numpy``: duplicate victims (a scatter-max
  mask, scatter-add deltas), −1 pads in every group, claim chips,
  affinity contributions, node removes and node adds; the stacked form
  equal to K single forks.  Where a fork adds a node at row 0 and pads
  follow it, the reference drops the add (ROADMAP Queue C); there the
  reference equals the port with that add left out.
* The reference's tests/test_whatif.py scenarios on both schedulers: the
  K-fork stacked == one-by-one parity under randomized churn, a victim
  fork == the real post-eviction bindings, a node-add fork == the real
  post-scale-up bindings, node-remove and scale-down-shaped forks, the
  refusals.
* The row-0 witness: a scale-up into a cluster whose row 0 is free; the
  port predicts the real post-scale-up binding, the reference does not.
* A node-tier growth between two evaluates (64 → 128 rows).
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import numpy as np
import pytest

import kubernetes_tpu.api.objects as jv1
import kubernetes_tpu.testutil as jtu
import kubernetes_tpu_torch.api.objects as tv1
import kubernetes_tpu_torch.testutil as ttu
from kubernetes_tpu.autoscaler import NodeGroup as JNodeGroup
from kubernetes_tpu.autoscaler import materialize_nodes as j_materialize
from kubernetes_tpu.metrics import scheduler_metrics as jm
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.sim.store import ObjectStore as JStore
from kubernetes_tpu.state import encoding as jenc
from kubernetes_tpu.whatif import ForkSpec as JForkSpec
from kubernetes_tpu.whatif import WhatIfEngine as JEngine
from kubernetes_tpu.whatif import fork as jfork
from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.autoscaler import NodeGroup as TNodeGroup
from kubernetes_tpu_torch.autoscaler import materialize_nodes as t_materialize
from kubernetes_tpu_torch.convert import fork_payload_from_numpy, snapshot_from_numpy
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.sim.store import ObjectStore as TStore
from kubernetes_tpu_torch.state.encoding import NODE_ARRAYS, SNAPSHOT_FIELDS, ClusterEncoder
from kubernetes_tpu_torch.whatif import ForkSpec as TForkSpec
from kubernetes_tpu_torch.whatif import WhatIfEngine as TEngine
from kubernetes_tpu_torch.whatif import apply_fork, apply_forks, stack_payloads

SLICE = "tpu.kubernetes.io/slice"

PKG = {
    "jax": SimpleNamespace(
        tu=jtu, v1=jv1, Store=JStore, Engine=JEngine, ForkSpec=JForkSpec,
        NodeGroup=JNodeGroup, materialize=j_materialize,
        sched=lambda store, **kw: TPUScheduler(store, **kw),
        forks=lambda engine: jm.whatif_forks.value(())),
    "torch": SimpleNamespace(
        tu=ttu, v1=tv1, Store=TStore, Engine=TEngine, ForkSpec=TForkSpec,
        NodeGroup=TNodeGroup, materialize=t_materialize,
        sched=lambda store, **kw: TorchScheduler(store, device="cpu", **kw),
        forks=lambda engine: engine.forks),
}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# --- K30 / K31: the plain versions against apply_fork --------------------------------


def _random_snapshot(rng):
    """Every snapshot field at the encoder's default tiers (N = 64, P = 256),
    random by dtype: integer-valued aff_counts (the encoder's counts)."""
    enc = ClusterEncoder(device="cpu")
    out = {}
    for name in SNAPSHOT_FIELDS:
        a = np.asarray(getattr(enc, name)) if name != "numeric" else np.zeros(1024, np.float32)
        if a.dtype == bool:
            out[name] = rng.random(a.shape) < 0.7
        elif a.dtype == np.int32:
            out[name] = rng.integers(-1, 5000, a.shape).astype(np.int32)
        else:
            out[name] = rng.integers(0, 40, a.shape).astype(np.float32)
    return out


def _random_payloads(rng, arrays, k, adds, chips):
    """K reference-format payloads built as the engine builds them: victims
    with duplicates, −1 pads in every group, adds on distinct rows with the
    pads at row 0 (ok = False, row 0's live values)."""
    n = arrays["node_valid"].shape[0]
    p = arrays["pod_valid"].shape[0]
    g, d = arrays["aff_counts"].shape
    vcap, acap, dcap = 16, 16, 8
    m = 8
    out = []
    for _ in range(k):
        nv = int(rng.integers(0, 12))
        vic = rng.integers(0, p, nv)
        if nv > 2:
            vic[1] = vic[0]  # a duplicate victim
        vic_p = np.full(vcap, -1, np.int32)
        vic_n = np.zeros(vcap, np.int32)
        vic_p[:nv] = vic
        vic_n[:nv] = rng.integers(0, n, nv)
        na = int(rng.integers(0, 12))
        aff_r = np.full(acap, -1, np.int32)
        aff_v = np.zeros(acap, np.int32)
        aff_r[:na] = rng.integers(0, g, na)
        aff_v[:na] = rng.integers(0, d, na)
        if na > 3:
            aff_r[3], aff_v[3] = aff_r[2], aff_v[2]  # a repeated contribution
        nd = int(rng.integers(0, 5))
        del_r = np.full(dcap, -1, np.int32)
        del_r[:nd] = rng.integers(0, n, nd)
        add_rows = add_ok = add_vals = None
        if adds:
            na_ = int(rng.integers(0, m + 1))
            rows = rng.choice(n, size=na_, replace=False)
            add_rows = np.zeros(m, np.int32)
            add_ok = np.zeros(m, bool)
            add_rows[:na_], add_ok[:na_] = rows, True
            add_vals = []
            for name in NODE_ARRAYS:
                live = arrays[name]
                v = np.stack([live[0]] * m)
                fresh = _random_like(rng, live[:na_])
                v[:na_] = fresh
                add_vals.append(v)
            add_vals = tuple(add_vals)
        vic_c = None
        if chips:
            vic_c = np.zeros(vcap, np.int32)
            vic_c[:nv] = rng.integers(0, 5, nv)
        out.append(jfork.ForkPayload(vic_p, vic_n, aff_r, aff_v, del_r, add_rows, add_ok,
                                     add_vals, vic_c))
    return out


def _random_like(rng, a):
    if a.dtype == bool:
        return rng.random(a.shape) < 0.5
    if a.dtype == np.int32:
        return rng.integers(0, 9000, a.shape).astype(np.int32)
    return rng.integers(0, 40, a.shape).astype(np.float32)


def _drop_row0_add(payload):
    """The payload with a real add at row 0 turned into a pad: what the
    reference's scatter keeps when pads follow that add."""
    ok = payload.add_ok.copy()
    ok[(payload.add_rows == 0) & ok] = False
    return payload._replace(add_ok=ok)


def _row0_witness(payload) -> bool:
    if payload.add_rows is None:
        return False
    real0 = (payload.add_rows == 0) & payload.add_ok
    return bool(real0.any()) and not bool(payload.add_ok.all())


def _fields(snap) -> dict:
    return {f: np.asarray(getattr(snap, f)) for f in SNAPSHOT_FIELDS}


def _assert_snap_equal(want: dict, got, what: str):
    for f in SNAPSHOT_FIELDS:
        g = getattr(got, f).numpy()
        np.testing.assert_array_equal(g, want[f], err_msg=f"{what}: {f}")


@pytest.mark.parametrize("seed,adds,chips", [(0, False, False), (1, True, False),
                                              (2, True, True), (3, False, True),
                                              (4, True, True)])
def test_fork_kernels_plain_equal_reference_apply_fork(seed, adds, chips):
    rng = np.random.default_rng(seed)
    arrays = _random_snapshot(rng)
    jsnap = jenc.DeviceSnapshot(**{k: jax.numpy.asarray(v) for k, v in arrays.items()})
    tsnap = snapshot_from_numpy(arrays, device="cpu")
    payloads = _random_payloads(rng, arrays, 4, adds, chips)
    ref = jax.jit(jfork.apply_fork)
    kernels.reset_launches()
    ported = [fork_payload_from_numpy(p) for p in payloads]
    singles = [apply_fork(tsnap, p) for p in ported]
    stacked = apply_forks(tsnap, stack_payloads(ported))
    for i, (jp, one, many) in enumerate(zip(payloads, singles, stacked)):
        _assert_snap_equal(_fields(one), many, f"fork {i}: stacked vs single")
        if _row0_witness(jp):
            # the reference drops a row-0 add that pads follow; the port
            # keeps it — elsewhere the two agree
            want = _fields(ref(jsnap, _drop_row0_add(jp)))
            _assert_snap_equal(want, apply_fork(tsnap, fork_payload_from_numpy(
                _drop_row0_add(jp))), f"fork {i} without its row-0 add")
            row = int(np.nonzero((jp.add_rows == 0) & jp.add_ok)[0][0])
            for ai, name in enumerate(NODE_ARRAYS):
                if name in ("node_valid", "requested", "non_zero_requested",
                            "claim_allocated"):
                    continue  # the masks may write row 0 after the add
                np.testing.assert_array_equal(getattr(one, name)[0].numpy(),
                                              jp.add_vals[ai][row], err_msg=name)
        else:
            _assert_snap_equal(_fields(ref(jsnap, jp)), one, f"fork {i}")
    # the live snapshot is untouched and nothing launched on the CPU
    _assert_snap_equal(arrays, tsnap, "live snapshot")
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_fork_masks_duplicates_and_pads_exact():
    """A hand-made case: one victim listed twice subtracts twice from its
    host's requested / non-zero / claim rows and masks its pod once; a
    −1 victim, a −1 affinity row and a −1 delete row are no-ops; an
    affinity contribution listed twice subtracts 2.0."""
    rng = np.random.default_rng(11)
    arrays = _random_snapshot(rng)
    arrays["pod_valid"][:] = True
    arrays["node_valid"][:] = True
    vic_p = np.array([5, 5, -1, 9], np.int32)
    vic_n = np.array([3, 3, 0, 4], np.int32)
    payload = jfork.ForkPayload(vic_p, vic_n, np.array([2, 2, -1], np.int32),
                                np.array([1, 1, 0], np.int32), np.array([7, -1], np.int32),
                                vic_claim_chips=np.array([2, 2, 9, 1], np.int32))
    got = apply_fork(snapshot_from_numpy(arrays, device="cpu"),
                     fork_payload_from_numpy(payload))
    req = arrays["requested"].copy()
    req[3] -= 2 * arrays["pod_request"][5]
    req[4] -= arrays["pod_request"][9]
    np.testing.assert_array_equal(got.requested.numpy(), req)
    nz = arrays["non_zero_requested"].copy()
    nz[3] -= 2 * arrays["pod_non_zero"][5]
    nz[4] -= arrays["pod_non_zero"][9]
    np.testing.assert_array_equal(got.non_zero_requested.numpy(), nz)
    claim = arrays["claim_allocated"].copy()
    claim[3] -= 4
    claim[4] -= 1
    np.testing.assert_array_equal(got.claim_allocated.numpy(), claim)
    pv = arrays["pod_valid"].copy()
    pv[[5, 9]] = False
    np.testing.assert_array_equal(got.pod_valid.numpy(), pv)
    nv = arrays["node_valid"].copy()
    nv[7] = False
    np.testing.assert_array_equal(got.node_valid.numpy(), nv)
    aff = arrays["aff_counts"].copy()
    aff[2, 1] -= 2.0
    np.testing.assert_array_equal(got.aff_counts.numpy(), aff)
    want = _fields(jax.jit(jfork.apply_fork)(
        jenc.DeviceSnapshot(**{k: jax.numpy.asarray(v) for k, v in arrays.items()}),
        payload))
    _assert_snap_equal(want, got, "hand-made fork")


# --- the engine on both schedulers -----------------------------------------------------


def _pod(k, name, cpu="2", node="", labels=None):
    w = k.tu.make_pod().name(name).uid(name).namespace("default").req({"cpu": cpu})
    for key, val in (labels or {}).items():
        w = w.label(key, val)
    if node:
        w = w.node(node)
    return w.obj()


def _cluster(k, n_nodes=6, batch_size=8):
    clock = FakeClock()
    store = k.Store()
    sched = k.sched(store, batch_size=batch_size, clock=clock, batch_wait=0)
    for i in range(n_nodes):
        store.create("Node", k.tu.make_node().name(f"n{i}")
                     .capacity({"cpu": "4", "pods": "10"}).obj())
    return clock, store, sched


def _group(k, max_size=8, slice_size=2, name="ng"):
    return k.NodeGroup(metadata=k.v1.ObjectMeta(name=name), max_size=max_size,
                       capacity={"cpu": "4", "pods": "10"}, slice_size=slice_size)


def _churn_rounds(pkg):
    """The reference's randomized-churn battery (tests/test_whatif.py:62):
    per round, the stacked and the one-by-one predictions of four forks
    (victims with an affinity-carrying one, adds, a remove, a mixed fork)."""
    k = PKG[pkg]
    clock, store, sched = _cluster(k)
    rng = np.random.default_rng(7)
    aff = (k.tu.make_pod().name("affv").uid("affv").namespace("default")
           .req({"cpu": "1"}).label("color", "g")
           .pod_affinity("kubernetes.io/hostname", {"color": "g"}, anti=True)
           .node("n0").obj())
    store.create("Pod", aff)
    for i in range(4):
        store.create("Pod", _pod(k, f"b{i}", cpu="2", node=f"n{i % 3}"))
    sched.schedule_cycle()
    engine = k.Engine(sched)
    group = _group(k)
    rounds = []
    churn_seq = 0
    for rnd in range(3):
        pend = [_pod(k, f"pend-{rnd}-{i}", cpu="3", labels={"color": "g"} if i == 0 else None)
                for i in range(3)]
        bound = [p for p in store.list("Pod")[0] if p.spec.node_name]
        victims = list(rng.choice(bound, size=min(2, len(bound)), replace=False))
        if aff.uid not in {v.uid for v in victims} and \
                store.get("Pod", "default", "affv") is not None:
            victims.append(store.get("Pod", "default", "affv"))
        live = [n.metadata.name for n in store.list("Node")[0]]
        forks = [
            k.ForkSpec(victims=victims, note="victims"),
            k.ForkSpec(add_nodes=k.materialize(group, 2, 10 * rnd, rnd, SLICE), note="adds"),
            k.ForkSpec(remove_nodes=[str(rng.choice(live))], note="removes"),
            k.ForkSpec(victims=victims[:1], remove_nodes=[str(rng.choice(live))],
                       add_nodes=k.materialize(group, 1, 100 + 10 * rnd, 100 + rnd, SLICE),
                       note="mixed"),
        ]
        before = k.forks(engine)
        vm = engine.evaluate(pend, forks, vmapped=True)
        seq = engine.evaluate(pend, forks, vmapped=False)
        assert k.forks(engine) >= before + 2 * len(forks)
        rounds.append(([p.placements for p in vm], [p.placements for p in seq],
                       [p.masked_victims for p in vm]))
        churn_seq += 1
        store.create("Pod", _pod(k, f"churn-{churn_seq}", cpu="1", node=f"n{churn_seq % 3}"))
        doomed = rng.choice([p for p in store.list("Pod")[0] if p.spec.node_name])
        store.delete("Pod", "default", doomed.metadata.name)
        sched.schedule_cycle()
    return rounds


def test_kfork_stacked_equals_one_by_one_and_reference_under_churn():
    """THE engine contract on the port: the stacked K-fork evaluate equals K
    one-fork evaluates, and both equal the reference's, across churn."""
    kernels.reset_launches()
    port = _churn_rounds("torch")
    ref = _churn_rounds("jax")
    for (vm, seq, masked), (jvm, jseq, jmasked) in zip(port, ref):
        assert vm == seq
        assert vm == jvm == jseq
        assert masked == jmasked
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def _victim_fork(pkg):
    k = PKG[pkg]
    clock, store, sched = _cluster(k, n_nodes=3)
    for i in range(3):
        store.create("Pod", _pod(k, f"v{i}", cpu="3", node=f"n{i}"))
    sched.schedule_cycle()
    engine = k.Engine(sched)
    victims = [store.get("Pod", "default", f"v{i}") for i in range(3)]
    pend = [_pod(k, f"p{i}", cpu="3") for i in range(3)]
    pred = engine.evaluate_one(pend, k.ForkSpec(victims=victims))
    assert pred is not None and pred.unplaced == 0 and pred.masked_victims == 3
    for i in range(3):
        store.delete("Pod", "default", f"v{i}")
    for p in pend:
        store.create("Pod", p)
    sched.run_until_idle(backoff_wait=1.0)
    actual = {p.uid: store.get("Pod", "default", p.metadata.name).spec.node_name
              for p in pend}
    assert actual == pred.placements
    return pred.placements


def test_victim_fork_matches_post_eviction_bindings():
    assert _victim_fork("torch") == _victim_fork("jax")


def _node_add_fork(pkg):
    k = PKG[pkg]
    clock, store, sched = _cluster(k, n_nodes=1)
    store.create("Pod", _pod(k, "filler", cpu="4", node="n0"))
    sched.schedule_cycle()
    engine = k.Engine(sched)
    group = _group(k, max_size=4)
    adds = k.materialize(group, 2, 0, 0, SLICE)
    pend = [_pod(k, f"p{i}", cpu="3") for i in range(2)]
    pred = engine.evaluate_one(pend, k.ForkSpec(add_nodes=adds))
    assert pred is not None and pred.unplaced == 0
    assert all(n in {"ng-0", "ng-1"} for n in pred.placements.values())
    assert store.get("Node", "", "ng-0") is None  # the simulation touched nothing
    for node in adds:
        store.create("Node", node)
    for p in pend:
        store.create("Pod", p)
    sched.run_until_idle(backoff_wait=1.0)
    actual = {p.uid: store.get("Pod", "default", p.metadata.name).spec.node_name
              for p in pend}
    assert actual == pred.placements
    return pred.placements


def test_node_add_fork_matches_post_scale_up_bindings():
    assert _node_add_fork("torch") == _node_add_fork("jax")


def _remove_forks(pkg):
    k = PKG[pkg]
    clock, store, sched = _cluster(k, n_nodes=2)
    sched.schedule_cycle()
    engine = k.Engine(sched)
    pend = [_pod(k, f"p{i}", cpu="3") for i in range(2)]
    pred = engine.evaluate_one(pend, k.ForkSpec(remove_nodes=["n1"]))
    # only n0 survives the fork; a 4-cpu host seats one 3-cpu pod
    assert sorted(pred.placements.values(), key=str) == [None, "n0"]
    pred2 = engine.evaluate_one(pend, k.ForkSpec())
    assert pred2.unplaced == 0  # the live state still has both nodes
    # the scale-down-shaped fork: remove a host AND mask its pod
    clock, store, sched = _cluster(k, n_nodes=3)
    store.create("Pod", _pod(k, "d0", cpu="2", node="n2"))
    store.create("Pod", _pod(k, "big", cpu="3", node="n0"))
    sched.schedule_cycle()
    engine = k.Engine(sched)
    pred3 = engine.evaluate_one([_pod(k, "whatif-d0", cpu="2")], k.ForkSpec(
        victims=[store.get("Pod", "default", "d0")], remove_nodes=["n2"]))
    assert pred3 is not None and pred3.unplaced == 0
    assert pred3.placements["whatif-d0"] in ("n0", "n1")
    return pred.placements, pred2.placements, pred3.placements


def test_node_remove_and_scale_down_shaped_forks():
    assert _remove_forks("torch") == _remove_forks("jax")


def test_engine_refusals():
    """The reference's refusal conditions: in-flight pipelined work, an
    empty or oversize batch, no forks, a node-add naming a live node."""
    k = PKG["torch"]
    clock, store, sched = _cluster(k, n_nodes=2, batch_size=2)
    sched.schedule_cycle()
    engine = k.Engine(sched)
    sched._inflight_q.append(object())
    try:
        assert engine.evaluate([_pod(k, "p0")], [k.ForkSpec()]) is None
    finally:
        sched._inflight_q.clear()
    assert engine.evaluate([], [k.ForkSpec()]) is None
    assert engine.evaluate([_pod(k, f"p{i}") for i in range(3)], [k.ForkSpec()]) is None
    assert engine.evaluate([_pod(k, "p0")], []) is None
    clash = k.tu.make_node().name("n0").capacity({"cpu": "4"}).obj()
    with pytest.raises(ValueError):
        engine.evaluate([_pod(k, "p0")], [k.ForkSpec(
            add_nodes=k.materialize(_group(k), 1, 0, 0, SLICE) + [clash])])
    # the scratch row encoded before the clash left the live encoder
    assert sched.encoder.node_rows == {"n0": 0, "n1": 1}
    assert engine.forks == 0


def test_descheduler_planner_routes_through_whatif():
    from kubernetes_tpu_torch.descheduler import planner as planner_mod
    from kubernetes_tpu_torch.descheduler.planner import WhatIfPlanner

    k = PKG["torch"]
    _clock, _store, sched = _cluster(k, n_nodes=2)
    p = WhatIfPlanner(sched)
    assert isinstance(p.engine, TEngine)
    assert not hasattr(planner_mod, "_fork_snapshot")


# --- the row-0 witness ------------------------------------------------------------------


def _row0(pkg, count):
    """One node created and deleted (row 0 free), one pending 2-cpu pod, a
    NodeGroup of 4-cpu nodes: the one-by-one prediction of adding
    ``count`` nodes, then the real binding after creating them."""
    k = PKG[pkg]
    clock, store, sched = _cluster(k, n_nodes=1)
    sched.schedule_cycle()
    store.delete("Node", "", "n0")
    sched.schedule_cycle()
    engine = k.Engine(sched)
    adds = k.materialize(_group(k, max_size=8, slice_size=0), count, 0, 0, SLICE)
    pend = _pod(k, "p0", cpu="2")
    pred = engine.evaluate([pend], [k.ForkSpec(add_nodes=adds)], vmapped=False)[0]
    for node in adds:
        store.create("Node", node)
    store.create("Pod", pend)
    sched.run_until_idle(backoff_wait=1.0)
    return pred.placements["p0"], store.get("Pod", "default", "p0").spec.node_name


def test_row0_add_wins_over_pads():
    """The reference's apply_fork pads a fork's node-add group with row 0
    (ok = False) and rewrites row 0's current values there; XLA:CPU's last
    write wins, so a real add at a free row 0 with pads behind it is lost.
    The port's K31 writes nothing for a pad: its prediction is the real
    post-scale-up binding."""
    for count, ref_pred in ((1, None), (2, "ng-1"), (4, "ng-0")):
        port_pred, port_bound = _row0("torch", count)
        jax_pred, jax_bound = _row0("jax", count)
        assert port_bound == jax_bound == "ng-0"
        assert port_pred == port_bound
        assert jax_pred == ref_pred


# --- node-tier growth between evaluates ---------------------------------------------------


def _growth(pkg):
    """60 full nodes (the 64-row tier), four 3-cpu pods pending: an evaluate
    adding 8 nodes grows the node tier to 128 rows during its scratch
    encodes; a second evaluate at the grown tier; then the real scale-up."""
    k = PKG[pkg]
    clock, store, sched = _cluster(k, n_nodes=60)
    for i in range(60):
        store.create("Pod", _pod(k, f"f{i}", cpu="4", node=f"n{i}"))
    sched.schedule_cycle()
    engine = k.Engine(sched)
    group = _group(k, max_size=16, slice_size=4)
    pend = [_pod(k, f"p{i}", cpu="3") for i in range(4)]
    first = engine.evaluate(pend, [k.ForkSpec(add_nodes=k.materialize(group, n, 0, 0, SLICE))
                                   for n in (4, 8)])
    tier = len(sched.encoder.node_valid)
    second = engine.evaluate(pend, [k.ForkSpec(add_nodes=k.materialize(group, 4, 0, 0, SLICE)),
                                    k.ForkSpec()])
    for node in k.materialize(group, 4, 0, 0, SLICE):
        store.create("Node", node)
    for p in pend:
        store.create("Pod", p)
    sched.run_until_idle(backoff_wait=1.0)
    bound = {p.uid: store.get("Pod", "default", p.metadata.name).spec.node_name for p in pend}
    return ([p.placements for p in first], [p.placements for p in second], tier, bound)


def test_node_tier_growth_between_evaluates():
    port = _growth("torch")
    assert port[2] == 128
    assert port[1][0] == port[3]  # the grown-tier prediction is the real binding
    assert port[1][1] == {f"p{i}": None for i in range(4)}
    assert port == _growth("jax")
