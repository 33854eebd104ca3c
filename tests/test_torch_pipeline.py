"""The pipelined scheduler on the port against the JAX package (exact).

* End to end: TorchScheduler(pipeline=True) at depths 2 and 3 against
  TPUScheduler(pipeline=True) at the same depth and against the port's
  synchronous scheduler, on a plain cluster, one with host-port pods (they
  cannot chain), a spread cluster, the three pod-affinity kinds with the
  affinity chain forced on, a node deleted mid-chain, the overlapped sync
  under seeded churn, micro-bucket dispatch at a forced sub-bucket, and
  the micro-bucket policy fed by its tier bursts on a clock the test
  moves (the same per-tier latency profile as the reference's): every
  pod on the same node, and every dispatch with the same chained tail,
  the same ``_infos_block_deep`` answer and the same pad as the
  reference's.  Each reference dispatch finishes its program before its
  host goes on (``_settle_reference``).
* The chain hooks: PodTopologySpreadPlugin.chain_prev and
  InterPodAffinityPlugin.chain_prev (their plain versions) against the JAX
  hooks on inputs carried over by convert.py — every aux field equal, in
  both IPA count forms, with and without term groups on the carry; a
  no-op carry is the identity, and chaining a no-op slot before a real
  carry equals chaining the real carry alone.
* apply_scatter's plain version against JAX's on a payload whose row list
  repeats a row (the pow-2 pad); prev_delta_apply's plain version against
  the reference's arithmetic, the snapshot arrays left as they were.

Tolerance: exact everywhere (integer tables, integer-valued float scores).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.framework.podbatch import PodBatchCompiler as JCompiler
from kubernetes_tpu.framework.runtime import BatchedFramework as JFramework
from kubernetes_tpu.framework.runtime import PrevBatch as JPrev
from kubernetes_tpu.framework.runtime import initial_dynamic_state
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.scheduler import default_plugins as j_default_plugins
from kubernetes_tpu.sim.store import ObjectStore as JStore
from kubernetes_tpu.state.cache import Cache as JCache, Snapshot as JSnapshot
from kubernetes_tpu.state.encoding import ClusterEncoder as JEncoder
from kubernetes_tpu.state.encoding import PendingScatter as JPending
from kubernetes_tpu.state.encoding import apply_scatter as j_apply_scatter
from kubernetes_tpu_torch.convert import batch_from_numpy, dyn_from_numpy, snapshot_from_numpy
from kubernetes_tpu_torch.framework.interface import DynamicState
from kubernetes_tpu_torch.framework.runtime import BatchedFramework as TFramework
from kubernetes_tpu_torch.framework.runtime import PrevBatch as TPrev
from kubernetes_tpu_torch.framework.runtime import apply_prev_delta
from kubernetes_tpu_torch.kernels.prev_delta import prev_delta_apply
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.scheduler import default_plugins as t_default_plugins
from kubernetes_tpu_torch.sim.store import ObjectStore as TStore
from kubernetes_tpu_torch.state.encoding import PendingScatter as TPending
from kubernetes_tpu_torch.state.encoding import apply_scatter as t_apply_scatter

from tests.test_torch_common import fake_clock, make_node_obj, make_pod_obj
from tests.test_torch_plugins import batch_arrays, snapshot_arrays

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
GROUPS = ("req_affinity", "req_anti_affinity", "pref_affinity", "pref_anti_affinity")


def _eq(a, b, what):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), (what, np.argwhere(a != b)[:5])


def _node(name, cpu="8", labels=None, taint=False):
    return {"name": name, "cpu": cpu, "memory": "16Gi", "pods": "110",
            "labels": dict(labels or {}), "unschedulable": False, "not_ready": False,
            "images": [], "taints": [("churn", "1", "NoSchedule")] if taint else []}


def _pod(name, ts, cpu="200m", **kw):
    return dict({"name": name, "ts": float(ts), "req": {"cpu": cpu, "memory": "512Mi"}}, **kw)


# --- the clusters -----------------------------------------------------------------


def _plain():
    nodes = [_node(f"n{i:03d}") for i in range(24)]
    pods = [_pod(f"p{i:03d}", i, cpu=f"{250 + 50 * (i % 5)}m") for i in range(80)]
    return nodes, pods, 16


def _ports():
    nodes = [_node(f"n{i:03d}") for i in range(24)]
    pods = [_pod(f"p{i:03d}", i, host_ports=[(8080, "TCP", "")] if i % 23 == 5 else [])
            for i in range(64)]
    return nodes, pods, 8


def _spread():
    nodes = [_node(f"n{i:03d}", labels={"zone": f"z{i % 3}"}) for i in range(12)]
    pods = [_pod(f"sp{i:03d}", i, cpu="100m", labels={"grp": "a"},
                 spread=[(2, "zone", "DoNotSchedule", {"grp": "a"}, None)])
            for i in range(40)]
    return nodes, pods, 8


def _affinity(kind):
    nodes = [_node(f"n{i:03d}", labels={HOST: f"n{i:03d}", "zone": f"z{i % 3}"})
             for i in range(24)]
    term = {"anti": (HOST, {"color": "green"}, True, None, None),
            "affinity": ("zone", {"color": "green"}, False, None, None),
            "preferred": (HOST, {"color": "green"}, False, 3, None)}[kind]
    pods = [_pod(f"a{i:03d}", i, labels={"color": "green"}, pod_affinity=[term])
            for i in range(20)]
    # a mixed tail: plain pods behind the affinity pods break the chain of
    # an affinity batch (its terms need a batch with affinity content)
    pods += [_pod(f"q{i:03d}", 100 + i) for i in range(12)]
    return nodes, pods, 8


CLUSTERS = {"plain": _plain, "ports": _ports, "spread": _spread,
            "anti": lambda: _affinity("anti"), "affinity": lambda: _affinity("affinity"),
            "preferred": lambda: _affinity("preferred")}


# --- driving both schedulers --------------------------------------------------------


def _settle_reference(fl):
    """Let the reference's dispatched program finish before its host goes
    on.  JAX's CPU backend takes numpy buffers without a copy (device_put
    aliases them) and runs programs asynchronously, so a pipelined
    reference whose next cycle re-encodes its host mirrors while the last
    program still reads them computes on a mix of two states — rarely, and
    only under load.  Waiting here changes no decision the reference
    makes; it only fixes the state its program reads to the one it was
    dispatched with."""
    if fl is not None and fl.node_row_dev is not None:
        jax.block_until_ready(fl.node_row_dev)


def _log_dispatches(pkg, monkeypatch):
    """Record (chained carries, interacts, pad) for every dispatch."""
    log = []
    if pkg == "jax":
        orig = TPUScheduler._dispatch_batch

        def dispatch(self, infos, prevs=None, interacts=None, pad=None):
            log.append((len(prevs or ()), interacts, pad or self.batch_size))
            fl = orig(self, infos, prevs=prevs, interacts=interacts, pad=pad)
            _settle_reference(fl)
            return fl

        monkeypatch.setattr(TPUScheduler, "_dispatch_batch", dispatch)
    else:
        orig = TorchScheduler._dispatch

        def dispatch(self, infos, prevs=(), interacts=True, pad=None):
            log.append((len(prevs), interacts, pad or self.batch_size))
            return orig(self, infos, prevs=prevs, interacts=interacts, pad=pad)

        monkeypatch.setattr(TorchScheduler, "_dispatch", dispatch)
    return log


def _scheduler(pkg, store, batch, **kw):
    if pkg == "jax":
        return TPUScheduler(store, batch_size=batch, rng_key=None, clock=fake_clock(),
                            batch_wait=0, **kw)
    return TorchScheduler(store, batch_size=batch, device="cpu", clock=fake_clock(),
                          batch_wait=0, **kw)


def _bindings(store):
    pods, _ = store.list("Pod")
    return {p.metadata.name: p.spec.node_name for p in pods}


def _run(pkg, cluster, monkeypatch, *, pipeline, depth=3, **kw):
    nodes, pods, batch = CLUSTERS[cluster]()
    store = JStore() if pkg == "jax" else TStore()
    if pipeline:
        kw.update(pipeline=True, pipeline_depth=depth)
        if cluster in ("anti", "affinity", "preferred"):
            kw["chain_affinity"] = True
    sched = _scheduler(pkg, store, batch, **kw)
    sched.presize(32, 128)
    for d in nodes:
        store.create("Node", make_node_obj(pkg, d))
    for d in pods:
        store.create("Pod", make_pod_obj(pkg, d))
    log = _log_dispatches(pkg, monkeypatch)
    sched.run_until_idle()
    monkeypatch.undo()
    sched.close()
    return _bindings(store), log


_SYNC = {}


def _sync_bindings(cluster, monkeypatch):
    if cluster not in _SYNC:
        _SYNC[cluster] = _run("torch", cluster, monkeypatch, pipeline=False)[0]
    return _SYNC[cluster]


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("cluster", list(CLUSTERS))
def test_pipelined_bindings_equal_reference_and_sync(cluster, depth, monkeypatch):
    jb, jlog = _run("jax", cluster, monkeypatch, pipeline=True, depth=depth)
    tb, tlog = _run("torch", cluster, monkeypatch, pipeline=True, depth=depth)
    sync = _sync_bindings(cluster, monkeypatch)
    assert tb == jb
    assert tb == sync
    # every dispatch: the same chained tail, the same _infos_block_deep
    # answer and the same pad as the reference's
    assert tlog == jlog
    chained = [c for c, _i, _p in tlog]
    if cluster == "ports":
        assert any(i for _c, i, _p in tlog) and max(chained) >= 1
    else:
        assert max(chained) == depth - 1, tlog
    if cluster != "anti":  # anti: 20 pods on 24 hostnames fit too, checked below
        assert all(tb.values())
    else:
        assert sum(1 for v in tb.values() if v) == len(tb)


def test_node_delete_mid_chain_breaks_the_tail(monkeypatch):
    """A node delete while batches are chained in flight: the next dispatch
    chains nothing (a reused encoder row would charge the wrong node), and
    every pod binds exactly once, as in the reference."""

    def run(pkg):
        store = JStore() if pkg == "jax" else TStore()
        # no backoff: the deleted node's pods retry at the next pop, so the
        # segmentation does not depend on how often each package reads its
        # clock
        sched = _scheduler(pkg, store, 8, pipeline=True, pipeline_depth=3,
                           pod_initial_backoff=0.0, pod_max_backoff=0.0)
        sched.presize(32, 96)
        for i in range(24):
            store.create("Node", make_node_obj(pkg, _node(f"n{i:03d}")))
        binds = {}

        def on_bind(ev):
            if ev.kind == "Pod" and ev.obj.spec.node_name:
                binds[ev.obj.metadata.name] = binds.get(ev.obj.metadata.name, 0) + 1

        store.watch(on_bind)
        for i in range(48):
            store.create("Pod", make_pod_obj(pkg, _pod(f"p{i:03d}", i,
                                                       cpu=f"{250 + 50 * (i % 3)}m")))
        log = _log_dispatches(pkg, monkeypatch)
        sched.schedule_cycle()
        sched.schedule_cycle()
        assert log[-1][0] == 1, "the chain never formed"
        store.delete("Node", "", "n000")
        sched.schedule_cycle()
        assert log[-1][0] == 0, "the dispatch after a node delete kept its tail"
        sched.run_until_idle(backoff_wait=1.0)
        monkeypatch.undo()
        sched.close()
        return _bindings(store), binds, log

    jb, jbinds, jlog = run("jax")
    tb, tbinds, tlog = run("torch")
    assert tb == jb and tlog == jlog
    assert all(tb.values()) and all(v != "n000" for v in tb.values())
    assert len(tbinds) == 48 and all(v == 1 for v in tbinds.values())


def _churn_run(pkg, overlap, monkeypatch):
    """Waves of pods with seeded node churn between the cycles (tainted
    churn nodes, so no pod lands on them); the node tier is presized past
    the small-tier bound so the deferred row-scatter runs."""
    store = JStore() if pkg == "jax" else TStore()
    sched = _scheduler(pkg, store, 16, pipeline=True, pipeline_depth=3, overlap_sync=overlap)
    sched.presize(1100, 160)
    for i in range(24):
        store.create("Node", make_node_obj(pkg, _node(f"n{i:03d}")))

    def churn_node(k):
        return make_node_obj(pkg, _node(f"churn{k}", taint=True))

    for k in range(4):
        store.create("Node", churn_node(k))
    rng = np.random.default_rng(7)
    log = _log_dispatches(pkg, monkeypatch)
    pod_i = 0
    for _wave in range(8):
        for _ in range(12):
            store.create("Pod", make_pod_obj(pkg, _pod(f"p{pod_i:03d}", pod_i,
                                                       cpu=f"{100 + 50 * (pod_i % 4)}m")))
            pod_i += 1
        sched.schedule_cycle()
        if rng.random() < 0.75:
            k = int(rng.integers(0, 4))
            if store.get("Node", "", f"churn{k}") is not None:
                store.delete("Node", "", f"churn{k}")
            else:
                store.create("Node", churn_node(k))
        sched.schedule_cycle()
    sched.run_until_idle()
    monkeypatch.undo()
    sched.close()
    return _bindings(store), log, sched


def test_overlapped_sync_under_churn_equals_reference(monkeypatch):
    jb, jlog, _ = _churn_run("jax", True, monkeypatch)
    tb, tlog, tsched = _churn_run("torch", True, monkeypatch)
    sync_b, _, _ = _churn_run("torch", False, monkeypatch)
    assert tb == jb and tlog == jlog
    assert tb == sync_b and all(tb.values())
    assert tsched.phase_wall["sync_overlap"] > 0
    assert tsched.encoder._n > 1024  # the row-scatter path ran, not the full upload


def test_micro_bucket_at_a_forced_tier_equals_reference(monkeypatch):
    """Sub-bucket dispatch at the same segmentation: a forced pad of 16 in
    a 32-batch pipelined scheduler equals the reference's and a synchronous
    16-batch scheduler's bindings; a sub-bucket chains at most one batch."""

    def run(pkg, pipeline, batch, forced=None):
        store = JStore() if pkg == "jax" else TStore()
        kw = {"pipeline": True, "latency_target_ms": 10_000.0} if pipeline else {}
        sched = _scheduler(pkg, store, batch, **kw)
        sched.presize(32, 128)
        sched._forced_bucket = forced
        for i in range(24):
            store.create("Node", make_node_obj(pkg, _node(f"n{i:03d}", cpu="16")))
        for i in range(64):
            store.create("Pod", make_pod_obj(pkg, _pod(f"p{i:03d}", i,
                                                       cpu=f"{100 + 25 * (i % 3)}m")))
        log = _log_dispatches(pkg, monkeypatch)
        sched.run_until_idle()
        monkeypatch.undo()
        sched.close()
        return _bindings(store), log

    jb, jlog = run("jax", True, 32, forced=16)
    tb, tlog = run("torch", True, 32, forced=16)
    sync_b, _ = run("torch", False, 16)
    assert tb == jb and tlog == jlog
    assert tb == sync_b and all(tb.values())
    assert {p for _c, _i, p in tlog} == {16}
    assert max(c for c, _i, _p in tlog) == 1


def test_micro_bucket_policy_engages_and_descends():
    """The policy itself (timing-driven, so held to its rules rather than to
    the reference's segmentation): a cold scheduler with an unmeetable
    target descends to the smallest tier; warmed tier profiles pick the
    largest tier under the target."""
    store = TStore()
    sched = TorchScheduler(store, batch_size=32, device="cpu", batch_wait=0,
                           pipeline=True, latency_target_ms=0.001)
    assert sched.bucket_tiers() == [16]
    sched.presize(32, 256)
    for i in range(16):
        store.create("Node", make_node_obj("torch", _node(f"n{i:03d}", cpu="16")))
    for i in range(160):
        store.create("Pod", make_pod_obj("torch", _pod(f"p{i:03d}", i, cpu="50m")))
    pads = []
    orig = sched._dispatch
    sched._dispatch = lambda infos, **kw: pads.append(kw["pad"]) or orig(infos, **kw)
    sched.run_until_idle()
    sched.close()
    assert all(_bindings(store).values())
    assert pads[0] == 32 and min(pads) == 16
    assert set(sched._tier_p99) >= {16}
    # profiles in hand: a target above the 16-tier's fits 16 but not the
    # predicted full batch (twice the 16-tier)
    sched._tier_p99 = {16: 0.010}
    sched.latency_target_ms = 15.0
    assert sched._bucket_from_latency() == 16
    sched.latency_target_ms = 30.0
    assert sched._bucket_from_latency() == 32
    sched.latency_target_ms = None
    assert sched._pick_bucket([object()], interacts=False) == 32


class _StepClock:
    """A scheduler clock that only the test moves (reads are free), so that
    both packages see the same latencies however often they read it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_micro_bucket_latency_feed_equals_reference(monkeypatch):
    """The per-tier latency profile is fed as the reference feeds it: the
    batch's algorithm time (dispatch start → result on the host) plus the
    pod's own bind segment, not the cycles the batch waits in flight.  On a
    clock the test moves — a compile costs 1 ms a pad slot, a batch then
    waits 50 ms in flight, a bind costs 1 ms — the tier bursts leave both
    packages with the same ``_tier_p99``, and the window dispatches the same
    pads, chains the same tails and binds the same nodes."""
    a_slot, in_flight, bind_cost = 1e-3, 0.05, 1e-3
    monkeypatch.setattr("kubernetes_tpu.utils.compilemon.monitor.snapshot",
                        lambda: (0, 0.0))  # no batch here waits on a compile

    def run(pkg):
        clk = _StepClock()
        store = JStore() if pkg == "jax" else TStore()
        cls = TPUScheduler if pkg == "jax" else TorchScheduler
        kw = {"rng_key": None} if pkg == "jax" else {"device": "cpu"}
        sched = cls(store, batch_size=64, clock=clk, batch_wait=0, pipeline=True,
                    latency_target_ms=50.0, **kw)
        sched.presize(32, 512)
        compile_ = sched.compiler.compile

        def compile_timed(pods, pad_to=None):
            clk.t += a_slot * (pad_to or sched.batch_size)
            return compile_(pods, pad_to=pad_to)

        sched.compiler.compile = compile_timed
        bind_ = store.bind_pod

        def bind_timed(*args, **kw):
            clk.t += bind_cost
            return bind_(*args, **kw)

        store.bind_pod = bind_timed
        dispatch_name = "_dispatch_batch" if pkg == "jax" else "_dispatch"
        dispatch = getattr(sched, dispatch_name)
        log = None  # (chained carries, interacts, pad) of each window dispatch

        def dispatch_then_wait(infos, prevs=None, interacts=None, pad=None):
            if log is not None:
                log.append((len(prevs or ()), interacts, pad or sched.batch_size))
            fl = dispatch(infos, prevs=prevs or (), interacts=interacts, pad=pad)
            if pkg == "jax":
                _settle_reference(fl)
            if fl.fetch_thread is not None:  # the result lands before the wait
                fl.fetch_thread.join()
            clk.t += in_flight
            return fl

        setattr(sched, dispatch_name, dispatch_then_wait)
        for i in range(24):
            store.create("Node", make_node_obj(pkg, _node(f"n{i:03d}", cpu="32")))
        assert sched.bucket_tiers() == [32, 16]
        for tier in sched.bucket_tiers():  # the harness's tier bursts
            names = [f"w{tier}x{j:03d}" for j in range(3 * tier)]
            for j, name in enumerate(names):
                store.create("Pod", make_pod_obj(pkg, _pod(name, j, cpu="10m")))
            sched._forced_bucket = tier
            sched.run_until_idle()
            for name in names:
                store.delete("Pod", "default", name)
        sched._forced_bucket = None
        profile = dict(sched._tier_p99)
        log = []
        for i in range(96):
            store.create("Pod", make_pod_obj(pkg, _pod(f"p{i:03d}", 1000 + i,
                                                       cpu=f"{100 + 25 * (i % 3)}m")))
        sched.run_until_idle()
        sched.close()
        return profile, log, _bindings(store)

    jprof, jlog, jb = run("jax")
    tprof, tlog, tb = run("torch")
    # tier 32: 32 ms of algorithm time + 1 ms of bind; tier 16: 16 + 1 ms
    assert jprof == pytest.approx({32: 0.033, 16: 0.017}, abs=1e-9)
    assert tprof == jprof
    assert tlog == jlog and tb == jb and all(tb.values())
    # 32 fits 90% of 50 ms; the full 64 (predicted at twice tier 32) does not
    assert {p for _c, _i, p in tlog} == {32}


def test_pods_block_deep_equals_reference():
    """Host-port pods cannot chain; spread, (anti)affinity and plain pods
    can; a pod that could preempt blocks (the scheduler's own gate refines
    that rule, held against the reference through the dispatch logs)."""
    from kubernetes_tpu.scheduler import _pods_block_deep as j_block
    from kubernetes_tpu_torch.scheduler import _pods_block_deep as t_block

    descs = {
        "anti": _pod("a", 0, labels={"color": "green"},
                     pod_affinity=[(HOST, {"color": "green"}, True, None, None)]),
        "spread": _pod("s", 1, spread=[(1, "zone", "DoNotSchedule", {"x": "y"}, None)]),
        "ports": _pod("hp", 2, host_ports=[(8080, "TCP", "")]),
        "preemptor": _pod("pr", 3, priority=10),
        "plain": _pod("p", 4),
    }
    for combo in (["anti"], ["spread"], ["ports"], ["preemptor"], ["plain"],
                  ["plain", "anti"], ["plain", "ports"]):
        want = j_block([make_pod_obj("jax", descs[k]) for k in combo])
        assert t_block([make_pod_obj("torch", descs[k]) for k in combo]) == want, combo
        assert want == any(k in ("ports", "preemptor") for k in combo)


def test_scope_of_pipeline_arguments():
    with pytest.raises(ValueError):
        TorchScheduler(TStore(), device="cpu", pipeline=True, pipeline_depth=4)
    s = TorchScheduler(TStore(), device="cpu", pipeline=True)
    assert s.overlap_sync and not s.chain_affinity  # "auto" on the CPU
    assert not TorchScheduler(TStore(), device="cpu").overlap_sync


# --- the chain hooks -----------------------------------------------------------------


def _compile_problem(nodes, sched_pods, pods, prev_pods, placed_frac=0.7, seed=0):
    """The JAX encoder's snapshot, this batch and a prev batch (compiled by
    one compiler, so the dictionary ids agree), with random decided rows for
    the prev batch; and the same carried over into the port."""
    cache = JCache()
    for d in nodes:
        cache.add_node(make_node_obj("jax", d))
    for d in sched_pods:
        cache.add_pod(make_pod_obj("jax", d))
    snap = JSnapshot()
    cache.update_snapshot(snap)
    enc = JEncoder()
    enc.full_sync(snap)
    comp = JCompiler(enc)
    hbatch = comp.compile([make_pod_obj("jax", d) for d in pods], pad_to=16)
    hprev = comp.compile([make_pod_obj("jax", d) for d in prev_pods], pad_to=16)
    fw = JFramework(j_default_plugins(enc.domain_cap))
    host_auxes = fw.host_prepare(hbatch, snap, enc)
    dsnap = enc.to_device()
    rng = np.random.default_rng(seed)
    live = np.asarray(dsnap.node_valid).nonzero()[0]
    rows = np.where(rng.random(hprev.size) < placed_frac,
                    live[rng.integers(0, len(live), size=hprev.size)], -1).astype(np.int32)
    rows[~np.asarray(hprev.valid)] = -1
    batch = jax.tree_util.tree_map(jnp.asarray, hbatch)
    prev = jax.tree_util.tree_map(jnp.asarray, hprev)
    return dict(fw=fw, enc=enc, hbatch=hbatch, hprev=hprev, batch=batch, prev=prev,
                dsnap=dsnap, dyn=initial_dynamic_state(dsnap), host_auxes=host_auxes,
                rows=rows, tfw=TFramework(t_default_plugins(enc.domain_cap)),
                tsnap=snapshot_from_numpy(snapshot_arrays(dsnap), device="cpu"),
                tbatch=batch_from_numpy(batch_arrays(batch), device="cpu"),
                tprev_batch=batch_from_numpy(batch_arrays(prev), device="cpu"))


def _carries(p, rows, groups: bool):
    """(JAX PrevBatch, port PrevBatch) for the problem's prev batch."""
    pb, tb = p["prev"], p["tprev_batch"]
    jg = {g: getattr(pb, g) for g in GROUPS} if groups else {}
    tg = {g: getattr(tb, g) for g in GROUPS} if groups else {}
    jprev = JPrev(rows=jnp.asarray(rows), req=pb.request, nz=pb.non_zero, valid=pb.valid,
                  label_keys=pb.label_keys, label_vals=pb.label_vals, ns=pb.ns, **jg)
    tprev = TPrev(rows=torch.from_numpy(rows.copy()), req=tb.request, nz=tb.non_zero,
                  valid=tb.valid, label_keys=tb.label_keys, label_vals=tb.label_vals,
                  ns=tb.ns, group_present=tuple(p["hprev"].group_present), **tg)
    return jprev, tprev


def _plugin_index(fw, name):
    return next(i for i, pw in enumerate(fw.plugins) if pw.plugin.name == name)


def _chain_both(p, name, rows, groups):
    idx = _plugin_index(p["fw"], name)
    jplug, tplug = p["fw"].plugins[idx].plugin, p["tfw"].plugins[idx].plugin
    jaux = p["fw"].prepare(p["batch"], p["dsnap"], p["dyn"], p["host_auxes"])[idx]
    host = {"InterPodAffinity": p["host_auxes"].get("InterPodAffinity")}
    tdyn = dyn_from_numpy({"requested": np.asarray(p["dyn"].requested),
                           "non_zero": np.asarray(p["dyn"].non_zero)}, device="cpu")
    taux = p["tfw"].prepare(p["tbatch"], p["tsnap"], tdyn, host)[idx]
    jprev, tprev = _carries(p, rows, groups)
    jout = jax.jit(lambda a, b, s, pr: jplug.chain_prev(a, b, s, pr))(
        jaux, p["batch"], p["dsnap"], jprev)
    tout = tplug.chain_prev(taux, p["tbatch"], p["tsnap"], tprev)
    return jaux, jout, taux, tout, tplug, tprev


def _spread_problem():
    rng = np.random.default_rng(3)
    nodes = [_node(f"n{i:03d}", cpu="4", labels={} if i in (4, 17) else
                   {ZONE: f"moon-{i % 3}", "disk": "ssd" if i % 3 == 0 else "hdd"})
             for i in range(30)]
    names = [d["name"] for d in nodes]
    sched = [_pod(f"s{i:03d}", -500 + i, cpu="100m",
                  labels={"color": str(rng.choice(["blue", "red"]))},
                  node=names[int(rng.integers(len(names)))]) for i in range(30)]
    blue = {"color": "blue"}
    temps = [dict(labels=blue, spread=[(1, ZONE, "DoNotSchedule", blue, None)]),
             dict(labels={"color": "red"}, spread=[(1, ZONE, "ScheduleAnyway", blue, None)]),
             dict(labels=blue, node_selector={"disk": "ssd"},
                  spread=[(3, ZONE, "DoNotSchedule", blue, None),
                          (2, ZONE, "ScheduleAnyway", {"color": "red"}, None)]),
             dict(labels=blue)]
    pods = [_pod(f"p{i:03d}", i, cpu="100m", **temps[i % 4]) for i in range(12)]
    prev = [_pod(f"q{i:03d}", 50 + i, cpu="100m",
                 labels={"color": str(rng.choice(["blue", "red"]))},
                 ns="other" if i % 5 == 4 else "default") for i in range(14)]
    return _compile_problem(nodes, sched, pods, prev, seed=3)


def test_spread_chain_prev_equals_reference():
    p = _spread_problem()
    jaux, jout, taux, tout, tplug, tprev = _chain_both(p, "PodTopologySpread", p["rows"], False)
    for field in jout._fields:
        _eq(getattr(jout, field), getattr(tout, field), field)
    assert not np.array_equal(np.asarray(jout.hard_counts), np.asarray(jaux.hard_counts))
    assert not np.array_equal(np.asarray(jout.soft_counts), np.asarray(jaux.soft_counts))
    # the aux passed in is unchanged (the hook returns new tables)
    _eq(jaux.hard_counts, taux.hard_counts, "input tables")
    _noop_checks(tplug, taux, p, tprev)


def _ipa_problem(form):
    rng = np.random.default_rng(11 if form == "tables" else 12)
    key = ZONE if form == "tables" else HOST
    nodes = [_node(f"n{i:03d}", cpu="4", labels=dict(
        {} if i in (4, 17) else {ZONE: f"moon-{i % 3}"}, **{HOST: f"n{i:03d}"}))
        for i in range(30)]
    names = [d["name"] for d in nodes]
    own = [[(key, {"color": "red"}, True, None, None)], [(key, {"color": "blue"}, False, 4, None)],
           []]
    sched = [_pod(f"s{i:03d}", -500 + i, cpu="100m",
                  labels={"color": str(rng.choice(["blue", "red", "green"]))},
                  pod_affinity=own[i % 3], node=names[int(rng.integers(len(names)))])
             for i in range(30)]
    temps = [
        [(key, {"color": "blue"}, False, None, None)],
        [(key, {"color": "red"}, True, None, ["default", "other"])],
        [(key, {"color": "blue"}, False, 5, None), (ZONE, {"color": "green"}, True, 3, None)],
        [(ZONE, {"color": "blue"}, False, None, None), (key, {"color": "blue"}, False, None, None)],
        [],
    ]
    colors = ["blue", "red", "green", "blue", "blue"]
    pods = [_pod(f"p{i:03d}", i, cpu="100m", labels={"color": colors[i % 5]},
                 pod_affinity=temps[i % 5]) for i in range(14)]
    prev = [_pod(f"q{i:03d}", 50 + i, cpu="100m", labels={"color": colors[(i + 1) % 5]},
                 pod_affinity=temps[(i + 2) % 5], ns="other" if i % 6 == 5 else "default")
            for i in range(14)]
    return _compile_problem(nodes, sched, pods, prev, seed=5)


@pytest.mark.parametrize("form", ["tables", "planes"])
@pytest.mark.parametrize("groups", [True, False], ids=["groups", "no_groups"])
def test_ipa_chain_prev_equals_reference(form, groups):
    p = _ipa_problem(form)
    jaux, jout, taux, tout, tplug, tprev = _chain_both(p, "InterPodAffinity", p["rows"],
                                                       groups)
    for field in jout._fields:
        _eq(getattr(jout, field), getattr(tout, field), field)
    n = p["tsnap"].num_nodes
    assert (taux.aff_cnt.shape[-1] == n) == (form == "planes")
    if groups:
        # both halves reached: counts bumped, the prev terms block and score
        assert not np.array_equal(np.asarray(jout.anti_cnt), np.asarray(jaux.anti_cnt))
        assert not np.array_equal(np.asarray(jout.aff_total), np.asarray(jaux.aff_total))
        assert bool(np.asarray(jout.block_dyn).any())
        s = np.asarray(jout.score_dyn)
        assert (s > 0).any() and (s < 0).any()
    else:
        # a group-free carry leaves the aux as it is (the static gate)
        assert tout is taux
    _noop_checks(tplug, taux, p, tprev)


def _noop_checks(tplug, taux, p, tprev):
    """A no-op carry (no row placed) is the identity; a no-op slot before a
    real carry gives what the real carry alone gives — so the port may skip
    the reference's no-op padding slots."""
    noop = tprev._replace(rows=torch.full_like(tprev.rows, -1))
    same = tplug.chain_prev(taux, p["tbatch"], p["tsnap"], noop)
    for field in taux._fields:
        a, b = getattr(taux, field), getattr(same, field)
        if isinstance(a, torch.Tensor):
            _eq(a, b, f"{field} after a no-op carry")
    real = tplug.chain_prev(taux, p["tbatch"], p["tsnap"], tprev)
    padded = tplug.chain_prev(same, p["tbatch"], p["tsnap"], tprev)
    for field in taux._fields:
        a, b = getattr(real, field), getattr(padded, field)
        if isinstance(a, torch.Tensor):
            _eq(a, b, f"{field}: a no-op slot then the carry")
    dyn = DynamicState(requested=p["tsnap"].requested, non_zero=p["tsnap"].non_zero_requested)
    one = apply_prev_delta(dyn, [tprev])
    two = apply_prev_delta(dyn, [noop, tprev])
    _eq(one.requested, two.requested, "requested with a no-op slot")
    _eq(one.non_zero, two.non_zero, "non_zero with a no-op slot")


# --- B1 and B2 plain versions -------------------------------------------------------


def test_apply_scatter_with_duplicate_pad_rows_equals_reference():
    p = _spread_problem()
    dsnap, tsnap = p["dsnap"], p["tsnap"]
    rng = np.random.default_rng(1)
    from kubernetes_tpu.state.encoding import _AFF_ARRAYS, _NODE_ARRAYS, _POD_ARRAYS

    def group(names, n_rows, dirty):
        rows = np.sort(rng.choice(n_rows, size=dirty, replace=False)).astype(np.int32)
        padded = np.concatenate([rows, np.full(8 - dirty, rows[0], np.int32)])
        vals = []
        for k in names:
            v = np.asarray(getattr(p["enc"], k))[padded].copy()
            # new values for the dirty rows; the repeated pad rows carry
            # their row's value, as the encoder's payload does
            if v.dtype == bool:
                v[:dirty] = ~v[:dirty]
            else:
                v[:dirty] = v[:dirty] + np.asarray(1, v.dtype)
            v[dirty:] = v[0]
            vals.append(v)
        return padded, vals

    groups = [group(_NODE_ARRAYS, dsnap.num_nodes, 5), group(_POD_ARRAYS, dsnap.num_pods, 3),
              group(_AFF_ARRAYS, np.asarray(dsnap.aff_valid).shape[0], 2)]
    jupd = JPending(node_rows=(jnp.asarray(groups[0][0]), tuple(map(jnp.asarray, groups[0][1]))),
                    pod_rows=(jnp.asarray(groups[1][0]), tuple(map(jnp.asarray, groups[1][1]))),
                    aff_rows=(jnp.asarray(groups[2][0]), tuple(map(jnp.asarray, groups[2][1]))))
    tupd = TPending(*[(torch.from_numpy(g[0].astype(np.int64)),
                       tuple(torch.from_numpy(v) for v in g[1])) for g in groups])
    jout = jax.jit(j_apply_scatter)(dsnap, jupd)
    tout = t_apply_scatter(tsnap, tupd)
    for k in _NODE_ARRAYS + _POD_ARRAYS + _AFF_ARRAYS:
        _eq(getattr(jout, k), getattr(tout, k), k)
        # out of place: the snapshot it started from is unchanged
        _eq(getattr(dsnap, k), getattr(tsnap, k), f"{k} (input)")
    assert not np.array_equal(np.asarray(jout.requested), np.asarray(dsnap.requested))


def test_prev_delta_apply_plain_leaves_the_snapshot_unaliased():
    rng = np.random.default_rng(4)
    n, r = 12, 8
    requested = torch.from_numpy(rng.integers(0, 50, size=(n, r)).astype(np.int32))
    non_zero = torch.from_numpy(rng.integers(0, 50, size=(n, 2)).astype(np.int32))
    before = (requested.clone(), non_zero.clone())
    bundles = []
    want_req, want_nz = requested.numpy().astype(np.int64), non_zero.numpy().astype(np.int64)
    for _ in range(2):
        rows = rng.integers(-1, n, size=9).astype(np.int32)
        rows[:3] = [5, 5, -1]  # two pods on one node, one unplaced
        req = rng.integers(0, 9, size=(9, r)).astype(np.int32)
        nz = rng.integers(0, 9, size=(9, 2)).astype(np.int32)
        for j in range(9):  # the reference: .at[clip(rows)].add(where(rows >= 0, x, 0))
            if rows[j] >= 0:
                want_req[rows[j]] += req[j]
                want_nz[rows[j]] += nz[j]
        bundles.append(tuple(torch.from_numpy(a) for a in (rows, req, nz)))
    got_req, got_nz = prev_delta_apply(requested, non_zero, bundles)
    _eq(got_req, want_req.astype(np.int32), "requested")
    _eq(got_nz, want_nz.astype(np.int32), "non_zero")
    _eq(requested, before[0], "snapshot requested")
    _eq(non_zero, before[1], "snapshot non_zero")
    assert got_req.data_ptr() != requested.data_ptr()
    with pytest.raises(ValueError):
        prev_delta_apply(requested, non_zero, bundles * 2)
