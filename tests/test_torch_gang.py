"""Gang scheduling on the port against the JAX package (exact).

* The directory and waiting-pods decisions (quorum, release once with more
  members than ``min_member``, a drained dead group evicted) and the
  directory's gang counters against the reference's gang metrics.
* The end-to-end scenarios of the JAX package's tests/test_gang.py on both
  schedulers, one fake clock each: bindings, PodGroup phases, held binds
  (``_waiting_binds``), pending counts and gang counters must be equal —
  two gangs bind and a starved one times out and requeues atomically; a
  gang packs one slice; a quorum reject unblocks when the siblings arrive;
  deleting a held member fails its gang fast.
* GangBasic at 64Nodes and 500Nodes (scaled) through ``TorchScheduler`` and
  ``TPUScheduler(pipeline=False, rng_key=None)``: equal bindings pod for
  pod; the port's pipelined scheduler binds the same; the perf harness at
  64Nodes on the CPU reports GangThroughput and TimeToFullSlice.
* The plain versions of K20–K23 against the JAX functions they replace, on
  seeded numpy inputs, exactly: K20 against ``gang_all_or_nothing``; K21's
  term against the reference's ``run_scores`` contribution of
  ``CoschedulingPlugin`` (a row whose anchor slice holds no feasible node
  among them), and the kernel's closed form against the plain version;
  K22 against ``diagnose_bits`` and the fused program's ``pack_diag``;
  K23 against ``requirements_match_matrix`` / ``label_match_matrix`` /
  ``node_match_matrix`` with every operator, NaN and absent keys, empty
  terms, match_all and match_none.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.api.objects as jv1
import kubernetes_tpu.testutil as jtu
import kubernetes_tpu_torch.api.objects as tv1
import kubernetes_tpu_torch.testutil as ttu
from kubernetes_tpu.framework.interface import PluginWithWeight as JPW
from kubernetes_tpu.framework.runtime import BatchedFramework as JFramework
from kubernetes_tpu.framework.waiting_pods import WaitingPodsMap as JWaiting
from kubernetes_tpu.gang import CoschedulingPlugin as JCosched
from kubernetes_tpu.gang import GangDirectory as JDirectory
from kubernetes_tpu.gang import gang_all_or_nothing as j_gang
from kubernetes_tpu.metrics import scheduler_metrics as jm
from kubernetes_tpu.perf import workloads as jw
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.scheduler import _unpack_diag as j_unpack_diag
from kubernetes_tpu.sim.store import ObjectStore as JStore
from kubernetes_tpu.state import selectors as jsel
from kubernetes_tpu.state.dictionary import Dictionary as JDictionary
from kubernetes_tpu_torch.convert import cosched_aux_from_numpy
from kubernetes_tpu_torch.framework.runtime import BatchedFramework as TFramework
from kubernetes_tpu_torch.framework.waiting_pods import WaitingPodsMap as TWaiting
from kubernetes_tpu_torch.gang import GangDirectory as TDirectory
from kubernetes_tpu_torch.gang import POD_GROUP_LABEL, SLICE_LABEL
from kubernetes_tpu_torch.kernels import LAUNCHES, reset_launches
from kubernetes_tpu_torch.kernels.cosched import cosched_score_into
from kubernetes_tpu_torch.kernels.diag import diag_pack
from kubernetes_tpu_torch.kernels.gang import gang_all_or_nothing
from kubernetes_tpu_torch.perf import workloads as tw
from kubernetes_tpu_torch.perf.harness import run_workload
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.sim.store import ObjectStore as TStore
from kubernetes_tpu_torch.state import selectors as tsel

PKG = {"jax": (jtu, jv1, JStore), "torch": (ttu, tv1, TStore)}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _group(pkg, store, name, min_member, timeout=30, created=1000.0):
    _, v1, _ = PKG[pkg]
    pg = v1.PodGroup(metadata=v1.ObjectMeta(name=name, namespace="default"),
                     min_member=min_member, schedule_timeout_seconds=timeout)
    pg.metadata.creation_timestamp = created
    store.create("PodGroup", pg)
    return pg


def _gang_pod(pkg, group, i, cpu="3", created=None):
    tu, _, _ = PKG[pkg]
    p = (tu.make_pod().name(f"{group}-{i}").uid(f"{group}-{i}").namespace("default")
         .label(POD_GROUP_LABEL, group).req({"cpu": cpu}).obj())
    # fixed identity fields: the defaults come from per-process counters
    p.metadata.creation_timestamp = 500.0 + i if created is None else created
    return p


def _node(pkg, name, cpu="4", slice_=None):
    tu, _, _ = PKG[pkg]
    w = tu.make_node().name(name).capacity({"cpu": cpu, "pods": "10"})
    if slice_ is not None:
        w = w.label(SLICE_LABEL, slice_)
    n = w.obj()
    n.metadata.uid = name
    n.metadata.creation_timestamp = 0.0
    return n


def _scheduler(pkg, store, clock, batch_size):
    if pkg == "jax":
        return TPUScheduler(store, batch_size=batch_size, clock=clock, batch_wait=0,
                            pipeline=False, rng_key=None)
    return TorchScheduler(store, batch_size=batch_size, clock=clock, batch_wait=0,
                          device="cpu")


_J_ATTEMPTS = ("quorum_reject", "scheduled", "timeout", "rejected")


class _JCounters:
    """The reference's global gang metrics, read as deltas from creation."""

    def __init__(self):
        self.a0 = {k: jm.gang_scheduling_attempts.value((k,)) for k in _J_ATTEMPTS}
        self.t0 = jm.gang_timeouts.value()

    def read(self):
        return ({k: int(jm.gang_scheduling_attempts.value((k,)) - self.a0[k])
                 for k in _J_ATTEMPTS}, int(jm.gang_timeouts.value() - self.t0))


def _port_counters(d: TDirectory):
    return dict(d.attempts), d.timeouts


def _state(store, sched):
    pods = {p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]}
    phases = {g.metadata.name: g.phase for g in store.list("PodGroup")[0]}
    return pods, phases, len(sched._waiting_binds), sched.queue.pending_count()


# --- the directory and the waiting-pods map -------------------------------------


def _directory_run(pkg):
    clock = FakeClock()
    _, _, Store = PKG[pkg]
    store = Store()
    d = (JDirectory if pkg == "jax" else TDirectory)(store, clock=clock)
    wp = (JWaiting if pkg == "jax" else TWaiting)(clock=clock)
    d.bind_runtime(wp)
    log = []
    _group(pkg, store, "g", 3)
    pods = [_gang_pod(pkg, "g", i) for i in range(3)]
    for p in pods:
        d.on_pod_event("ADDED", p, False)
    lone = _gang_pod(pkg, "tiny", 0)
    _group(pkg, store, "tiny", 3)
    d.on_pod_event("ADDED", lone, False)
    st = d.prefilter(lone)
    log.append(("lone", None if st is None else (int(st.code), st.message())))
    st = d.prefilter(_gang_pod(pkg, "ghost", 0))
    log.append(("ghost", None if st is None else (int(st.code), st.message())))
    log.append(("full", d.prefilter(pods[0])))
    for i, node in ((0, "n0"), (1, "n1")):
        log.append(("permit", i, d.on_permit(pods[i])))
        wp.add(pods[i], "Coscheduling", 30.0)
        d.note_waiting(pods[i], node)
        clock.advance(2.5)
    log.append(("preempt", d.allows_preemption(pods[2]), d.allows_preemption(lone)))
    log.append(("release", d.on_permit(pods[2])))
    log.append(("waits", wp.wait_on_permit(pods[0]), wp.wait_on_permit(pods[1])))
    # release once with more members than min_member
    _group(pkg, store, "big", 2)
    big = [_gang_pod(pkg, "big", i) for i in range(4)]
    for p in big:
        d.on_pod_event("ADDED", p, False)
    log.append(("big0", d.on_permit(big[0])))
    d.note_waiting(big[0], "n0")
    for p in big[1:]:
        log.append(("big", d.on_permit(p)))
        d.on_bound(p, "n0")
    log.append(("big_phase", store.get("PodGroup", "default", "big").phase))
    # a waiting member rolled back fails the group
    _group(pkg, store, "f", 3)
    fp = [_gang_pod(pkg, "f", i) for i in range(3)]
    for p in fp:
        d.on_pod_event("ADDED", p, False)
    wp.add(fp[0], "Coscheduling", 5.0)
    d.note_waiting(fp[0], "n2")
    wp.add(fp[1], "Coscheduling", 5.0)
    d.note_waiting(fp[1], "n3")
    clock.advance(6.0)
    reason = wp.wait_on_permit(fp[0])
    d.note_wait_rejected(fp[0], reason)
    d.on_unreserve(fp[0])
    log.append(("failed", reason, wp.wait_on_permit(fp[1]),
                store.get("PodGroup", "default", "f").phase))
    # a drained dead group is evicted
    pg = store.get("PodGroup", "default", "tiny")
    store.delete("PodGroup", "default", "tiny")
    d.on_group_event("DELETED", pg)
    d.on_pod_event("DELETED", lone, False)
    log.append(("groups", sorted(d._groups)))
    return log, d


def test_directory_decisions_equal_reference():
    jc = _JCounters()
    jlog, jd = _directory_run("jax")
    jcount = jc.read()
    tlog, td = _directory_run("torch")
    assert tlog == jlog
    assert _port_counters(td) == jcount
    assert td.attempts["scheduled"] == 2 and td.timeouts == 1
    assert td.wait_durations == [5.0, 0.0, 6.0]


def test_waiting_pods_deadlines_on_the_injected_clock():
    out = {}
    for pkg in ("jax", "torch"):
        clock = FakeClock()
        wp = (JWaiting if pkg == "jax" else TWaiting)(clock=clock)
        p = _gang_pod(pkg, "g", 0)
        wp.add(p, "Coscheduling", 10.0)
        wp.add(p, "Other", 4.0)
        steps = [wp.next_deadline(), wp.wait_on_permit(p)]
        clock.advance(4.0)
        steps += [wp.wait_on_permit(p), wp.get(p.uid) is None]
        out[pkg] = steps
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 4.0 and out["torch"][-1]


# --- end to end: the reference's gang scenarios on both schedulers -------------


def _counters(pkg, sched, jc):
    return jc.read() if pkg == "jax" else _port_counters(sched.gangs)


def _two_gangs_starved(pkg):
    jc = _JCounters()
    clock = FakeClock()
    _, _, Store = PKG[pkg]
    store = Store()
    sched = _scheduler(pkg, store, clock, 4)
    for i in range(20):
        store.create("Node", _node(pkg, f"n{i:02d}", slice_=f"s{i // 8}"))
    for gi, g in enumerate(["ga", "gb", "gc"]):
        _group(pkg, store, g, 8, timeout=30, created=1000.0 + gi)
        for i in range(8):
            store.create("Pod", _gang_pod(pkg, g, i, created=1000.0 + gi))
    trace = []
    for _ in range(30):
        s = sched.schedule_cycle()
        trace.append((s.attempted, s.scheduled, s.unschedulable, len(sched._waiting_binds)))
        clock.advance(0.5)
    before = _state(store, sched)
    clock.advance(40.0)
    s = sched.schedule_cycle()
    return (trace, before, _state(store, sched), (s.attempted, s.scheduled, s.unschedulable),
            _counters(pkg, sched, jc))


def _packs_one_slice(pkg):
    jc = _JCounters()
    clock = FakeClock()
    _, _, Store = PKG[pkg]
    store = Store()
    sched = _scheduler(pkg, store, clock, 8)
    for i in range(16):
        store.create("Node", _node(pkg, f"n{i:02d}", slice_=f"s{i // 8}"))
    _group(pkg, store, "g", 8)
    for i in range(8):
        store.create("Pod", _gang_pod(pkg, "g", i))
    stats = sched.run_until_idle(backoff_wait=1.0)
    return stats.scheduled, _state(store, sched), _counters(pkg, sched, jc)


def _quorum_then_siblings(pkg):
    jc = _JCounters()
    clock = FakeClock()
    _, _, Store = PKG[pkg]
    store = Store()
    sched = _scheduler(pkg, store, clock, 4)
    for i in range(4):
        store.create("Node", _node(pkg, f"n{i}"))
    _group(pkg, store, "g", 4)
    for i in range(2):
        store.create("Pod", _gang_pod(pkg, "g", i))
    s = sched.schedule_cycle()
    first = (s.attempted, s.scheduled, s.unschedulable, sched.queue.pending_count())
    for i in range(2, 4):
        store.create("Pod", _gang_pod(pkg, "g", i))
    stats = sched.run_until_idle(backoff_wait=1.0)
    return first, stats.scheduled, _state(store, sched), _counters(pkg, sched, jc)


def _delete_held_member(pkg):
    jc = _JCounters()
    clock = FakeClock()
    _, _, Store = PKG[pkg]
    store = Store()
    sched = _scheduler(pkg, store, clock, 2)
    for i in range(3):  # capacity for 3 of the 4 members
        store.create("Node", _node(pkg, f"n{i}"))
    _group(pkg, store, "g", 4, timeout=1000)
    for i in range(4):
        store.create("Pod", _gang_pod(pkg, "g", i))
    for _ in range(6):
        sched.schedule_cycle()
        clock.advance(0.5)
    held = sorted(sched._waiting_binds)
    name = sched._waiting_binds[held[0]].qi.pod.metadata.name
    store.delete("Pod", "default", name)
    after_delete = sorted(sched._waiting_binds)
    sched.schedule_cycle()
    return held, name, after_delete, _state(store, sched), _counters(pkg, sched, jc)


@pytest.mark.parametrize("scenario", [_two_gangs_starved, _packs_one_slice,
                                      _quorum_then_siblings, _delete_held_member],
                         ids=["two_gangs_bind_starved_gang_times_out",
                              "gang_packs_one_slice",
                              "quorum_reject_then_sibling_arrival_unblocks",
                              "deleting_held_member_fails_gang_fast"])
def test_gang_scenarios_equal_reference(scenario):
    """Bindings, phases, held binds, pending counts and the gang counters
    (the port directory's own against the reference's metric deltas)."""
    j = scenario("jax")
    reset_launches()
    t = scenario("torch")
    assert t == j
    assert sum(t[-1][0].values()) > 0
    # the port's schedulers run on the CPU here: no kernel launched
    assert all(v == 0 for v in LAUNCHES.values())


def test_two_gangs_bind_and_the_starved_gang_requeues_atomically():
    """The acceptance scenario on the port alone: 16 pods bound in two
    whole gangs, the starved gang held then rolled back together."""
    trace, before, after, last, (attempts, timeouts) = _two_gangs_starved("torch")
    pods, phases, waiting, _ = before
    assert sum(1 for v in pods.values() if v) == 16
    assert waiting > 0
    assert not any(pods[f"gc-{i}"] for i in range(8))
    pods, phases, waiting, pending = after
    assert waiting == 0 and last[2] > 0
    assert sum(1 for v in pods.values() if v) == 16
    assert phases == {"ga": "Scheduled", "gb": "Scheduled", "gc": "Unschedulable"}
    assert pending == (8, 0, 0)
    assert attempts["scheduled"] == 2 and timeouts == 1


# --- GangBasic through both schedulers and the harness ---------------------------


def _feed_workload(w, store):
    for op in w.ops:
        if op.opcode == "createNodes":
            for i in range(op.count):
                n = op.node_template(i)
                n.metadata.uid = n.metadata.name
                n.metadata.creation_timestamp = 0.0
                store.create("Node", n)
        elif op.opcode == "createObjects":
            for i in range(op.count):
                kind, obj = op.object_template(i)
                obj.metadata.creation_timestamp = 1.0
                store.create(kind, obj)
        else:
            for i in range(op.count):
                p = op.pod_template(i)
                p.metadata.creation_timestamp = 2.0 + i
                store.create("Pod", p)


def _gang_basic_bindings(pkg, size, scale, pipeline=False):
    w = (jw if pkg == "jax" else tw).build_workload("GangBasic", size, scale=scale)
    store = JStore() if pkg == "jax" else TStore()
    clock = FakeClock()
    if pkg == "jax":
        sched = TPUScheduler(store, batch_size=w.batch_size, pipeline=False, rng_key=None,
                             clock=clock, batch_wait=0)
    else:
        sched = TorchScheduler(store, batch_size=w.batch_size, device="cpu", clock=clock,
                               batch_wait=0, pipeline=pipeline)
    _feed_workload(w, store)
    for _ in range(100):
        s = sched.schedule_cycle()
        if s.attempted == 0 and s.in_flight == 0 and s.waiting == 0:
            break
    pods = {p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]}
    phases = {g.metadata.name: g.phase for g in store.list("PodGroup")[0]}
    return pods, phases


@pytest.mark.parametrize("size,scale", [("64Nodes", 1.0), ("500Nodes", 0.2)])
def test_gang_basic_bindings_equal_reference(size, scale):
    jb, jp = _gang_basic_bindings("jax", size, scale)
    tb, tp = _gang_basic_bindings("torch", size, scale)
    assert tb == jb and tp == jp
    assert all(tb.values())
    assert set(tp.values()) == {"Scheduled"}
    pb, pp = _gang_basic_bindings("torch", size, scale, pipeline=True)
    assert pb == jb and pp == jp


def test_gang_basic_workload_equals_reference():
    for size in jw.SUITES["GangBasic"].sizes:
        for scale in (1.0, 0.02):
            j = jw.build_workload("GangBasic", size, scale=scale)
            t = tw.build_workload("GangBasic", size, scale=scale)
            assert (t.name, t.batch_size, t.gang_size) == (j.name, j.batch_size, j.gang_size)
            assert [(o.opcode, o.count) for o in t.ops] == [(o.opcode, o.count) for o in j.ops]
            jk, jpg = j.ops[1].object_template(3)
            tk, tpg = t.ops[1].object_template(3)
            assert (tk, tpg.metadata.name, tpg.min_member, tpg.schedule_timeout_seconds) == \
                (jk, jpg.metadata.name, jpg.min_member, jpg.schedule_timeout_seconds)


def test_gang_basic_harness_on_cpu():
    w = tw.build_workload("GangBasic", "64Nodes")
    items = run_workload(w, device="cpu")
    by = {it.labels["Metric"]: it for it in items}
    assert by["GangThroughput"].unit == "gangs/s"
    assert by["GangThroughput"].data["Gangs"] == 7.0
    assert by["GangThroughput"].data["Average"] > 0
    tfs = by["TimeToFullSlice"].data
    assert 0 < tfs["Perc50"] <= tfs["Perc90"] <= tfs["Perc99"] <= tfs["Max"]
    assert by["SchedulingThroughput"].data["Average"] > 0
    assert set(by["KernelLaunchesInWindow"].data.values()) == {0.0}


# --- K20–K23: the plain versions against the JAX functions ------------------------


def test_k20_plain_equals_reference():
    rng = np.random.default_rng(20)
    cases = [(np.full(16, 3, np.int32), np.full(16, -1, np.int32))]  # no gangs
    one = np.arange(24, dtype=np.int32)
    one[5] = -1
    seg = np.full(24, -1, np.int32)
    seg[4:12] = 0  # one incomplete gang
    cases.append((one, seg))
    for b in (64, 512, 1024):
        node_row = rng.integers(-1, 200, size=b).astype(np.int32)
        node_row[rng.random(b) < 0.05] = -1
        seg = np.full(b, -1, np.int32)
        members = rng.permutation(b)[: b // 2]
        seg[members] = rng.integers(0, b // 8, size=members.size)
        cases.append((node_row, seg))
    for node_row, seg in cases:
        j = np.asarray(j_gang(jnp.asarray(node_row), jnp.asarray(seg)))
        t = gang_all_or_nothing(torch.from_numpy(node_row), torch.from_numpy(seg)).numpy()
        assert np.array_equal(j, t)
    assert np.array_equal(t[seg < 0], node_row[seg < 0])


def _cosched_inputs(rng, c, n, slices):
    slice_dom = rng.integers(-1, slices, size=n).astype(np.int32)
    anchor = rng.integers(-2, slices, size=c).astype(np.int32)
    mask = rng.random((c, n)) < 0.6
    # row 0: its anchor slice holds no feasible node; row 1: nothing is
    # feasible; row 2: anchor −2 (no gang); row 3: every node feasible
    anchor[0] = 0
    mask[0, slice_dom == 0] = False
    mask[1] = False
    anchor[2] = -2
    mask[3] = True
    return slice_dom, anchor, mask


@pytest.mark.parametrize("c,n,slices,weight", [(8, 64, 4, 1), (33, 257, 9, 2), (1, 128, 3, 1)])
def test_k21_plain_equals_reference_run_scores(c, n, slices, weight):
    rng = np.random.default_rng(21 + c)
    slice_dom, anchor, mask = _cosched_inputs(rng, c, n, slices) if c > 3 else (
        rng.integers(-1, slices, size=n).astype(np.int32), np.array([1], np.int32),
        rng.random((c, n)) < 0.5)
    jfw = JFramework([JPW(JCosched(), weight)])
    jtotal = np.asarray(jfw.run_scores(None, None, None, ((slice_dom, anchor),),
                                       jnp.asarray(mask)))
    full = 7
    bits = torch.from_numpy(np.where(mask, full, 3).astype(np.int32))
    total = torch.where(torch.from_numpy(mask), 0.0, float("-inf"))
    aux = cosched_aux_from_numpy((slice_dom, anchor), device="cpu")
    out = cosched_score_into(bits, full, total, aux.anchor, aux.slice_dom, float(weight))
    assert out is total
    assert np.array_equal(out.numpy(), jtotal)
    # the kernel's closed form: w · 100 on a feasible node of the anchor
    # slice, 0 elsewhere where feasible, −inf off the mask
    closed = np.where(mask, weight * 100.0 * ((anchor[:, None] >= 0)
                                              & (slice_dom[None, :] == anchor[:, None])),
                      -np.inf).astype(np.float32)
    assert np.array_equal(closed, jtotal)
    if c > 3:
        assert (jtotal[0][mask[0]] == 0).all() and (jtotal[1] == -np.inf).all()


def _ref_pack_diag():
    """The reference's own pack_diag: a closure of the fused programs that
    TPUScheduler._build_jitted compiles (scheduler.py:918)."""
    sched = TPUScheduler(JStore(), batch_size=4, pipeline=False, rng_key=None)
    fw = sched._framework()
    fused = sched._jitted_by[next(iter(sched.profiles))]["batch"].__wrapped__
    cells = dict(zip(fused.__code__.co_freevars, fused.__closure__))
    diagnostics = cells["diagnostics"].cell_contents
    inner = dict(zip(diagnostics.__code__.co_freevars, diagnostics.__closure__))
    return inner["pack_diag"].cell_contents, len(fw.filter_names)


def test_k22_plain_equals_reference_diagnose_and_pack():
    ref_pack, nf = _ref_pack_diag()
    rng = np.random.default_rng(22)
    for c, b, n in ((4, 64, 300), (64, 64, 129), (1, 16, 50)):
        plane = rng.integers(0, 1 << nf, size=(c, n)).astype(np.int32)
        plane[0] = (1 << nf) - 1 - (1 << 3)  # filter 3 fails every node of row 0
        plane[-1, :] = np.where(rng.random(n) < 0.9, 0, plane[-1, :])
        class_of = rng.integers(0, c, size=b).astype(np.int64) if c != b else None
        node_row = rng.integers(-1, n, size=b).astype(np.int32)
        rounds = int(rng.integers(1, 40))
        # the reference's diagnose_bits on the same plane: per filter, any node
        jbits = np.asarray(jnp.any(((jnp.asarray(plane)[:, :, None]
                                     >> jnp.arange(nf, dtype=jnp.int32)) & 1) > 0, axis=1))
        if class_of is not None:
            jbits = jbits[class_of]
        jpacked = np.asarray(ref_pack(jnp.asarray(jbits), jnp.asarray(node_row),
                                      jnp.asarray(rounds, jnp.int32)))
        t = diag_pack(torch.from_numpy(plane), nf,
                      None if class_of is None else torch.from_numpy(class_of),
                      torch.from_numpy(node_row), rounds).numpy()
        assert np.array_equal(t, jpacked)
        assert np.array_equal(j_unpack_diag(t[1], nf), jbits)
    # 31 filters: the widest bitmask one int32 holds
    plane = rng.integers(0, 1 << 31, size=(8, 70)).astype(np.int32)
    t = diag_pack(torch.from_numpy(plane), 31, None, torch.zeros(8, dtype=torch.int32), 5)
    want = np.bitwise_or.reduce(plane, axis=1)
    assert np.array_equal(t[1].numpy(), want)
    with pytest.raises(NotImplementedError):
        diag_pack(torch.from_numpy(plane), 32, None, torch.zeros(8, dtype=torch.int32), 5)


# K23: every operator, NaN and absent keys, empty terms, match_all / match_none

_LABEL_SETS = [
    {"zone": "z1", "disk": "ssd", "gen": "3", "rack": "r7"},
    {"zone": "z2", "gen": "12", "note": "x"},
    {"zone": "z1", "gen": "abc"},  # a value that is no number (NaN)
    {},
    {"disk": "hdd", "gen": "-4", "rack": "r1"},
    {"zone": "z3", "disk": "ssd", "gen": "7"},
]


def _req(key, op, vals=()):
    return (key, op, list(vals))


_OPS = ["In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"]


def _label_selectors(v1):
    LS, E = v1.LabelSelector, v1.LabelSelectorRequirement
    sels = [
        LS(match_labels={"zone": "z1"}),
        LS(match_expressions=[E(key="zone", operator="NotIn", values=["z1", "z9"])]),
        LS(match_expressions=[E(key="disk", operator="Exists")]),
        LS(match_expressions=[E(key="disk", operator="DoesNotExist")]),
        LS(match_expressions=[E(key="gen", operator="Gt", values=["5"])]),
        LS(match_expressions=[E(key="gen", operator="Lt", values=["5"])]),
        LS(match_expressions=[E(key="gen", operator="Gt", values=["nan"])]),
        LS(match_expressions=[E(key="absent", operator="NotIn", values=["a"]),
                              E(key="absent", operator="Lt", values=["100"])]),
        LS(match_expressions=[E(key="rack", operator="In", values=["r1", "r7", "r8"]),
                              E(key="zone", operator="NotIn", values=["z2"])]),
        LS(),  # empty: matches everything
        None,  # the None selector: matches nothing (match_none)
        LS(match_labels={"zone": "z1"}),  # a duplicate: deduplicated
    ]
    return sels


def _node_selectors(v1):
    NS, T, E = v1.NodeSelector, v1.NodeSelectorTerm, v1.NodeSelectorRequirement
    return [
        NS(node_selector_terms=[T(match_expressions=[E(key="zone", operator="In",
                                                       values=["z1", "z3"])])]),
        NS(node_selector_terms=[T(match_expressions=[E(key="gen", operator="Gt",
                                                       values=["5"])]),
                                T(match_expressions=[E(key="disk", operator="DoesNotExist")])]),
        NS(node_selector_terms=[T(match_expressions=[]),  # an empty term: nothing
                                T(match_expressions=[E(key="rack", operator="Exists"),
                                                     E(key="gen", operator="Lt",
                                                       values=["0"])])]),
        NS(node_selector_terms=[T(match_expressions=[])]),  # only an empty term
        None,  # nil selector: match_all
    ]


def _label_arrays(dic, label_sets, width=8):
    keys = np.full((len(label_sets), width), -1, np.int32)
    vals = np.full((len(label_sets), width), -1, np.int32)
    for o, ls in enumerate(label_sets):
        for j, (k, v) in enumerate(sorted(ls.items())):
            keys[o, j] = dic.intern(k)
            vals[o, j] = dic.intern(v)
    return keys, vals


def _to_port(cs, cls):
    import dataclasses

    return cls(**{f.name: getattr(cs, f.name) for f in dataclasses.fields(cls)})


@pytest.mark.parametrize("numbers", ["side_table", "vals_num"])
def test_k23_plain_equals_reference(numbers):
    dic = JDictionary()
    jcs = jsel.compile_label_selectors(_label_selectors(jv1), dic)
    jns = jsel.compile_node_selectors(_node_selectors(jv1), dic)
    keys, vals = _label_arrays(dic, _LABEL_SETS)
    numeric = dic.numeric_table(min_size=64)
    vals_num = np.where(vals >= 0, numeric[np.clip(vals, 0, numeric.shape[0] - 1)],
                        np.nan).astype(np.float32)
    vn = vals_num if numbers == "vals_num" else None
    assert jcs.has_numeric and jns.has_numeric
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
    tvn = None if vn is None else torch.from_numpy(vn)
    tnum = torch.from_numpy(numeric)

    j = np.asarray(jsel.label_match_matrix(jcs, keys, vals, vals_num=vn, numeric=numeric))
    t = tsel.label_match_matrix(_to_port(jcs, tsel.CompiledLabelSelectors), tk, tv,
                                vals_num=tvn, numeric=tnum).numpy()
    assert np.array_equal(t, j)
    j = np.asarray(jsel.node_match_matrix(jns, keys, vals, vals_num=vn, numeric=numeric))
    t = tsel.node_match_matrix(_to_port(jns, tsel.CompiledNodeSelectors), tk, tv,
                               vals_num=tvn, numeric=tnum).numpy()
    assert np.array_equal(t, j)
    for has_numeric in (True, False):
        j = np.asarray(jsel.requirements_match_matrix(
            jcs.req_key, jcs.req_op, jcs.req_vals, jcs.req_num, keys, vals,
            vals_num=vn, numeric=numeric, has_numeric=has_numeric))
        t = tsel.requirements_match_matrix(
            torch.from_numpy(jcs.req_key), torch.from_numpy(jcs.req_op),
            torch.from_numpy(jcs.req_vals), torch.from_numpy(jcs.req_num), tk, tv,
            vals_num=tvn, numeric=tnum, has_numeric=has_numeric).numpy()
        assert np.array_equal(t, j)
    # the pins: NotIn matches an absent key, Gt on a NaN value or NaN
    # right-hand side is false, the None selector matches nothing, the empty
    # selector everything, a node selector of only empty terms nothing, the
    # nil node selector everything
    lm = tsel.label_match_matrix(_to_port(jcs, tsel.CompiledLabelSelectors), tk, tv,
                                 vals_num=tvn, numeric=tnum).numpy()
    assert lm[1].tolist() == [False, True, False, True, True, True]
    assert lm[4].tolist() == [False, True, False, False, False, True]
    assert not lm[6].any() and lm[9].all() and not lm[10].any()
    nm = tsel.node_match_matrix(_to_port(jns, tsel.CompiledNodeSelectors), tk, tv,
                                vals_num=tvn, numeric=tnum).numpy()
    assert not nm[3].any() and nm[4].all()
    assert nm[2].tolist() == [False, False, False, False, True, False]


def test_k23_random_selectors_equal_reference():
    """Seeded random selectors of every operator over random label sets."""
    rng = np.random.default_rng(23)
    keys_pool = ["a", "b", "c", "d", "n"]
    vals_pool = ["1", "2", "10", "x", "y", "-3"]
    E = jv1.LabelSelectorRequirement
    sels = []
    for _ in range(40):
        exprs = []
        for _ in range(int(rng.integers(0, 4))):
            op = _OPS[int(rng.integers(len(_OPS)))]
            k = keys_pool[int(rng.integers(len(keys_pool)))]
            if op in ("Exists", "DoesNotExist"):
                vs = []
            elif op in ("Gt", "Lt"):
                vs = [vals_pool[int(rng.integers(len(vals_pool)))]]
            else:
                vs = list(rng.choice(vals_pool, size=int(rng.integers(1, 4)), replace=False))
            exprs.append(E(key=k, operator=op, values=vs))
        sels.append(jv1.LabelSelector(match_expressions=exprs))
    label_sets = []
    for _ in range(50):
        ks = rng.choice(keys_pool, size=int(rng.integers(0, 5)), replace=False)
        label_sets.append({str(k): str(rng.choice(vals_pool)) for k in ks})
    dic = JDictionary()
    jcs = jsel.compile_label_selectors(sels, dic)
    keys, vals = _label_arrays(dic, label_sets)
    numeric = dic.numeric_table(min_size=32)
    j = np.asarray(jsel.label_match_matrix(jcs, keys, vals, numeric=numeric))
    t = tsel.label_match_matrix(_to_port(jcs, tsel.CompiledLabelSelectors),
                                torch.from_numpy(keys), torch.from_numpy(vals),
                                numeric=torch.from_numpy(numeric)).numpy()
    assert np.array_equal(t, j)
    assert 0 < t.sum() < t.size


def test_gang_mask_takes_its_plain_version_on_cpu():
    """On CPU tensors K20's wrapper runs its plain version and launches
    nothing."""
    reset_launches()
    x = gang_all_or_nothing(torch.tensor([1, -1, 2], dtype=torch.int32),
                            torch.tensor([0, 0, -1], dtype=torch.int32))
    assert x.tolist() == [-1, -1, 2]
    assert LAUNCHES["gang_all_or_nothing"] == 0
