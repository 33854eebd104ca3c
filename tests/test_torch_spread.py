"""PodTopologySpread on the port against the JAX package (exact).

* B10: the port's ops/segment.py gathers and scatters equal the JAX
  one-hot einsums on random tables, the trash slot D included.
* TOPO_LOG: the port's score weight table holds XLA:CPU's float32
  log(k + 2) bit for bit, and torch.log differs from it (at 7: five
  domains), which is why the table exists.
* B11, plugin level: the prepared count tables, the filter, the raw score,
  the normalized score, the composed mask / total / diagnosis (through the
  K6 / K7 plain versions) and update_batch_classes (through the K8 plain
  version) equal the JAX plugin's, for 3 and 5 zones, with keyless nodes,
  minDomains, ScheduleAnyway and two-constraint pods; and at a domain
  count of 379 under five domains and maxSkew 1, where a score weight from
  torch.log would round to another raw score.
* Routing: for hand-built batches the port's engine choice, coupling flags
  and dedup gate equal TPUScheduler's.
* End to end: TorchScheduler (cpu) against TPUScheduler (pipeline=False,
  rng_key=None) on TopologySpreading-, PreferredTopologySpreading- and
  mixed-shaped clusters: the same node for every pod, the same
  unschedulable pods and the same engine rounds in every cycle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.framework.podbatch import PodBatchCompiler as JCompiler
from kubernetes_tpu.framework.podbatch import identity_classes
from kubernetes_tpu.framework.runtime import BatchedFramework as JFramework
from kubernetes_tpu.framework.runtime import initial_dynamic_state
from kubernetes_tpu.metrics import scheduler_metrics as jmetrics
from kubernetes_tpu.ops import segment as jseg
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.scheduler import default_plugins as j_default_plugins
from kubernetes_tpu.sim.store import ObjectStore as JStore
from kubernetes_tpu.state.cache import Cache as JCache, Snapshot as JSnapshot
from kubernetes_tpu.state.encoding import ClusterEncoder as JEncoder
from kubernetes_tpu_torch.convert import batch_from_numpy, dyn_from_numpy, snapshot_from_numpy
from kubernetes_tpu_torch.framework.runtime import BatchedFramework as TFramework
from kubernetes_tpu_torch.kernels.spread import TOPO_LOG_MAX, topo_log_table
from kubernetes_tpu_torch.ops import segment as tseg
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.scheduler import default_plugins as t_default_plugins
from kubernetes_tpu_torch.sim.store import ObjectStore as TStore

from tests.test_torch_common import fake_clock, make_node_obj, make_pod_obj
from tests.test_torch_plugins import batch_arrays, snapshot_arrays

ZONE = "topology.kubernetes.io/zone"
HARD, SOFT = "DoNotSchedule", "ScheduleAnyway"
BLUE = {"color": "blue"}


def _eq(a, b, what):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), \
        (what, np.argwhere(~((a == b) | (np.isnan(a) & np.isnan(b))
                             if a.dtype.kind == "f" else a == b))[:5])


# --- B10: the segment ops ---------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_ops_equal_reference(seed):
    rng = np.random.default_rng(seed)
    d = 7
    table = rng.integers(0, 50, size=(3, 2, d + 1)).astype(np.int32)
    dom = rng.integers(0, d + 1, size=(3, 2, 40)).astype(np.int32)  # D = trash
    vals = rng.integers(0, 5, size=(3, 2, 40)).astype(np.int32)
    mask = rng.random((3, 2, 40)) < 0.4
    t = torch.from_numpy
    _eq(jseg.domain_gather(jnp.asarray(table), jnp.asarray(dom)),
        tseg.domain_gather(t(table), t(dom)).float(), "domain_gather")
    _eq(jseg.domain_scatter_add(jnp.asarray(vals), jnp.asarray(dom), d + 1),
        tseg.domain_scatter_add(t(vals), t(dom), d + 1).float(), "domain_scatter_add")
    # a [C, N] value plane broadcast against [C, Cc, N] domains
    plane = vals[:, 0, :]
    _eq(jseg.domain_scatter_add(jnp.asarray(plane)[:, None, :], jnp.asarray(dom), d + 1),
        tseg.domain_scatter_add(t(plane)[:, None, :], t(dom), d + 1).float(),
        "domain_scatter_add broadcast")
    _eq(jseg.domain_any(jnp.asarray(mask), jnp.asarray(dom), d + 1),
        tseg.domain_any(t(mask), t(dom), d + 1), "domain_any")
    dom_at = rng.integers(0, d + 1, size=(3, 2)).astype(np.int32)
    inc = rng.integers(0, 3, size=(3, 2)).astype(np.int32)
    _eq(jseg.point_scatter_add(jnp.asarray(table), jnp.asarray(dom_at), jnp.asarray(inc)),
        tseg.point_scatter_add(t(table), t(dom_at), t(inc)), "point_scatter_add")


def test_count_bound_refuses_counts_past_float32_exactness():
    tseg.check_count_bound((1 << 24) - 1)
    with pytest.raises(OverflowError):
        tseg.check_count_bound(1 << 24)


# --- the score weight table ----------------------------------------------------------


def test_topo_log_table_is_xla_cpu_log_bit_for_bit():
    ref = np.asarray(jnp.log(jnp.arange(2, TOPO_LOG_MAX + 3, dtype=jnp.float32)))
    table = topo_log_table().numpy()
    assert table.shape == ref.shape == (TOPO_LOG_MAX + 1,)
    assert np.array_equal(table.view(np.int32), ref.view(np.int32))
    # torch.log is correctly rounded at log(7) where XLA:CPU is one ulp off
    naive = torch.log(torch.arange(2, TOPO_LOG_MAX + 3, dtype=torch.float32)).numpy()
    assert naive[7 - 2] != ref[7 - 2]
    # and that ulp moves the rounded score term at a count of 379
    assert np.rint(np.float32(379) * naive[5]) != np.rint(np.float32(379) * ref[5])


# --- B11: plugin-level parity ------------------------------------------------------


def _zone_nodes(n, zones, keyless=(), disk_every=3):
    out = []
    for i in range(n):
        labels = {"disk": "ssd" if i % disk_every == 0 else "hdd"}
        if i not in keyless:
            labels[ZONE] = f"moon-{i % zones}"
        out.append({"name": f"n{i:04d}", "cpu": "4", "memory": "32Gi", "pods": "110",
                    "labels": labels, "taints": [], "images": [],
                    "unschedulable": False, "not_ready": False})
    return out


def _spread_templates():
    req = {"cpu": "100m", "memory": "500Mi"}
    return [
        # the suite's template: self-matching, DoNotSchedule
        {"req": req, "labels": BLUE, "spread": [(1, ZONE, HARD, BLUE, None)]},
        # minDomains above the present domains: the global minimum becomes 0
        {"req": req, "labels": BLUE, "spread": [(2, ZONE, HARD, BLUE, 9)]},
        # ScheduleAnyway, not self-matching
        {"req": req, "labels": {"color": "red"}, "spread": [(1, ZONE, SOFT, BLUE, None)]},
        # two constraints, one of each kind, under a nodeSelector
        {"req": req, "labels": BLUE, "node_selector": {"disk": "ssd"},
         "spread": [(3, ZONE, HARD, BLUE, None), (2, ZONE, SOFT, {"color": "red"}, None)]},
        # no constraint: a constraint-free row of a spread batch
        {"req": req, "labels": BLUE},
    ]


def _build(nodes, sched, pods, pad_to=32):
    cache = JCache()
    for d in nodes:
        cache.add_node(make_node_obj("jax", d))
    for d in sched:
        cache.add_pod(make_pod_obj("jax", d))
    snap = JSnapshot()
    cache.update_snapshot(snap)
    enc = JEncoder()
    enc.full_sync(snap)
    hbatch = JCompiler(enc).compile([make_pod_obj("jax", d) for d in pods], pad_to=pad_to)
    fw = JFramework(j_default_plugins(enc.domain_cap))
    host_auxes = fw.host_prepare(hbatch, snap, enc)
    batch = jax.tree_util.tree_map(jnp.asarray, hbatch)
    dsnap = enc.to_device()
    dyn = initial_dynamic_state(dsnap)
    tsnap = snapshot_from_numpy(snapshot_arrays(dsnap), device="cpu")
    tbatch = batch_from_numpy(batch_arrays(batch), device="cpu")
    tdyn = dyn_from_numpy({"requested": np.asarray(dyn.requested),
                           "non_zero": np.asarray(dyn.non_zero)}, device="cpu")
    tfw = TFramework(t_default_plugins(enc.domain_cap))
    return dict(fw=fw, enc=enc, hbatch=hbatch, batch=batch, dsnap=dsnap, dyn=dyn,
                host_auxes=host_auxes, tfw=tfw, tbatch=tbatch, tsnap=tsnap, tdyn=tdyn)


def _spread_index(fw):
    return next(i for i, pw in enumerate(fw.plugins) if pw.plugin.name == "PodTopologySpread")


def _spread_problem(zones: int, seed: int):
    rng = np.random.default_rng(seed)
    nodes = _zone_nodes(30, zones, keyless=(4, 17))
    names = [d["name"] for d in nodes]
    sched = [{"name": f"s{i:03d}", "ts": -500.0 + i, "req": {"cpu": "100m"},
              "labels": {"color": str(rng.choice(["blue", "red", "green"]))},
              "node": names[int(rng.integers(len(names)))]} for i in range(45)]
    temps = _spread_templates()
    pods = [dict(temps[int(rng.integers(len(temps)))], name=f"p{i:03d}", ts=float(i))
            for i in range(24)]
    return _build(nodes, sched, pods)


def _jax_all(p, batch, auxes):
    fw, idx = p["fw"], _spread_index(p["fw"])

    def run(batch, dsnap, dyn, auxes):
        mask = fw.run_filters(batch, dsnap, dyn, auxes)
        plug = fw.plugins[idx].plugin
        raw = plug.score(batch, dsnap, dyn, auxes[idx], mask=mask)
        return {"mask": mask, "scores": fw.run_scores(batch, dsnap, dyn, auxes, mask),
                "diag": fw.diagnose_bits(batch, dsnap, dyn, auxes),
                "filter": plug.filter(batch, dsnap, dyn, auxes[idx]),
                "raw": raw, "norm": plug.normalize(raw, mask)}

    out = jax.jit(run)(batch, p["dsnap"], p["dyn"], auxes)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module", params=[(3, 0), (5, 1)], ids=["3zones", "5zones"])
def spread_problem(request):
    return _spread_problem(*request.param)


def test_prepare_tables_equal(spread_problem):
    p = spread_problem
    jaux = p["fw"].prepare(p["batch"], p["dsnap"], p["dyn"], p["host_auxes"])
    taux = p["tfw"].prepare(p["tbatch"], p["tsnap"], p["tdyn"])
    idx = _spread_index(p["fw"])
    ja, ta = jaux[idx], taux[idx]
    assert ta is not None and all(a is None for i, a in enumerate(taux) if i != idx)
    for field in ja._fields:
        _eq(getattr(ja, field), getattr(ta, field), field)
    assert np.asarray(ja.hard_counts).any() and np.asarray(ja.soft_counts).any()
    assert (~np.asarray(ja.has_key)).any()  # keyless nodes are in the problem


def test_filter_score_normalize_and_composition_equal(spread_problem):
    p = spread_problem
    jaux = p["fw"].prepare(p["batch"], p["dsnap"], p["dyn"], p["host_auxes"])
    taux = p["tfw"].prepare(p["tbatch"], p["tsnap"], p["tdyn"])
    idx = _spread_index(p["fw"])
    j = _jax_all(p, p["batch"], jaux)
    plug = p["tfw"].plugins[idx].plugin
    tmask = torch.from_numpy(j["mask"].copy())
    _eq(j["filter"], plug.filter(p["tbatch"], p["tsnap"], p["tdyn"], taux[idx]), "filter")
    traw = plug.score(p["tbatch"], p["tsnap"], p["tdyn"], taux[idx], mask=tmask)
    _eq(j["raw"], traw, "raw score")
    _eq(j["norm"], plug.normalize(traw, tmask), "normalized score")
    # the filter fails somewhere and the scores are not flat
    assert not j["filter"][np.asarray(p["hbatch"].valid)].all()
    assert np.isnan(j["raw"]).any() and (np.nan_to_num(j["raw"]) > 0).any()
    # K1 + K6 bits, K2 + K7 total, diagnosis — through the kernel wrappers'
    # plain versions
    tm, ts = p["tfw"].compute(p["tbatch"], p["tsnap"], p["tdyn"], taux)
    _eq(j["mask"], tm, "mask")
    _eq(j["scores"], ts, "total")
    _eq(j["diag"], p["tfw"].diagnose_bits(p["tbatch"], p["tsnap"], p["tdyn"], taux),
        "diagnosis")


def test_update_batch_classes_equal(spread_problem):
    """One round's commits at class granularity: the JAX hook on the commits'
    class one-hot against the port's hook (K8's plain version)."""
    p = spread_problem
    class_of, reps = identity_classes(p["hbatch"])
    cpad = max(4, 1 << (len(reps) - 1).bit_length())
    rep_rows = np.full(cpad, reps[0], dtype=np.int32)
    rep_rows[: len(reps)] = reps
    idx = _spread_index(p["fw"])
    jrep = p["batch"].take(jnp.asarray(rep_rows))
    jplug = p["fw"].plugins[idx].plugin
    jaux = jplug.prepare(jrep, p["dsnap"], p["dyn"])
    trep = p["tbatch"].take(torch.from_numpy(rep_rows.astype(np.int64)))
    tplug = p["tfw"].plugins[idx].plugin
    taux = tplug.engine_copy(tplug.prepare(trep, p["tsnap"], p["tdyn"]))
    rng = np.random.default_rng(5)
    b, n = p["hbatch"].size, p["tsnap"].num_nodes
    for _ in range(3):
        commit = (rng.random(b) < 0.6) & np.asarray(p["hbatch"].valid)
        choice = rng.integers(0, n, size=b).astype(np.int32)
        u_c = jnp.zeros((cpad, n), jnp.float32).at[
            jnp.asarray(class_of), jnp.asarray(choice)].add(jnp.asarray(commit, jnp.float32))
        jaux = jplug.update_batch_classes(jaux, u_c, p["batch"], jrep, p["dsnap"],
                                          jnp.asarray(class_of))
        tplug.update_batch_classes(taux, torch.from_numpy(commit), torch.from_numpy(choice),
                                   torch.from_numpy(class_of.astype(np.int64)))
        _eq(jaux.hard_counts, taux.hard_counts, "hard_counts after a round")
        _eq(jaux.soft_counts, taux.soft_counts, "soft_counts after a round")


def test_score_at_count_379_under_five_domains_equals_reference():
    """379 matching pods in one of five zones, a ScheduleAnyway constraint
    with maxSkew 1: the raw score there is round(379 · log(7)), which a
    correctly rounded log(7) would put one higher than the reference."""
    nodes = _zone_nodes(20, 5)
    zone0 = [d["name"] for d in nodes if d["labels"][ZONE] == "moon-0"]
    sched = [{"name": f"s{i:03d}", "ts": -1000.0 + i, "req": {"cpu": "1m"},
              "labels": BLUE, "node": zone0[i % len(zone0)]} for i in range(379)]
    pods = [{"name": f"p{i}", "ts": float(i), "req": {"cpu": "100m"},
             "labels": {"color": "red"}, "spread": [(1, ZONE, SOFT, BLUE, None)]}
            for i in range(4)]
    p = _build(nodes, sched, pods, pad_to=8)
    jaux = p["fw"].prepare(p["batch"], p["dsnap"], p["dyn"], p["host_auxes"])
    taux = p["tfw"].prepare(p["tbatch"], p["tsnap"], p["tdyn"])
    j = _jax_all(p, p["batch"], jaux)
    idx = _spread_index(p["fw"])
    plug = p["tfw"].plugins[idx].plugin
    traw = plug.score(p["tbatch"], p["tsnap"], p["tdyn"], taux[idx],
                      mask=torch.from_numpy(j["mask"].copy()))
    _eq(j["raw"], traw, "raw score")
    enc_rows = np.asarray([p["enc"].node_rows[name] for name in zone0])
    w_ref = np.asarray(jnp.log(jnp.float32(7.0)))
    assert (j["raw"][0, enc_rows] == np.rint(np.float32(379) * w_ref)).all()
    assert np.rint(np.float32(379) * np.float32(np.log(7.0))) != j["raw"][0, enc_rows[0]]
    tm, ts = p["tfw"].compute(p["tbatch"], p["tsnap"], p["tdyn"], taux)
    _eq(j["scores"], ts, "total")


# --- routing ---------------------------------------------------------------------------


def _routing_batches():
    req = {"cpu": "100m", "memory": "500Mi"}
    spread = {"req": req, "labels": BLUE, "spread": [(5, ZONE, HARD, BLUE, None)]}
    plain = {"req": req}
    out = {
        "one_spread_class": [dict(spread, name=f"a{i}", ts=float(i)) for i in range(24)],
        "few_spread_in_plain": ([dict(spread, name=f"a{i}", ts=float(i)) for i in range(6)]
                                + [dict(plain, name=f"b{i}", ts=10.0 + i) for i in range(20)]),
        "red_selects_blue": ([{"req": req, "labels": {"color": "red"}, "name": f"r{i}",
                               "ts": float(i), "spread": [(1, ZONE, SOFT, BLUE, None)]}
                              for i in range(8)]
                             + [dict(plain, labels=BLUE, name=f"b{i}", ts=10.0 + i)
                                for i in range(8)]),
        "heterogeneous_spread": [dict(spread, name=f"h{i}", ts=float(i),
                                      req={"cpu": f"{100 + i}m"}) for i in range(20)],
        "spread_preemptor": [dict(spread, name="x0", ts=0.0, priority=10)],
    }
    return out


@pytest.mark.parametrize("kind", list(_routing_batches()))
def test_routing_equals_reference(kind):
    nodes = _zone_nodes(12, 3)
    running = {"name": "run", "ts": -1.0, "req": {"cpu": "100m"}, "node": "n0000"}
    pods = _routing_batches()[kind]
    js, ts = JStore(), TStore()
    jsched = TPUScheduler(js, batch_size=32, pipeline=False, rng_key=None,
                          clock=fake_clock(), batch_wait=0)
    tsched = TorchScheduler(ts, batch_size=32, device="cpu", clock=fake_clock(), batch_wait=0)
    for pkg, store in (("jax", js), ("torch", ts)):
        for d in nodes:
            store.create("Node", make_node_obj(pkg, d))
        store.create("Pod", make_pod_obj(pkg, running))
    jfw = jsched._framework()
    jsched.encoder.sync(jsched.snapshot, jsched.cache.update_snapshot(jsched.snapshot))
    tsched.encoder.sync(tsched.snapshot, tsched.cache.update_snapshot(tsched.snapshot))
    jb = jsched.compiler.compile([make_pod_obj("jax", d) for d in pods], pad_to=32)
    tb = tsched.compiler.compile([make_pod_obj("torch", d) for d in pods], pad_to=32)
    jmode, jc, _ = jsched.engine_choice(jb)
    tmode, tc, _ = tsched.engine_choice(tb, tsched._framework())
    assert jmode == tmode
    for f in ("reads", "solo", "comp", "multi"):
        _eq(getattr(jc, f), getattr(tc, f), f)
    host_auxes = jfw.host_prepare(jb, jsched.snapshot, jsched.encoder)
    jcls = jsched._dedup_classes(jb, host_auxes, fw=jfw)
    tcls = tsched._dedup_classes(tb, None, tsched._framework())
    if jcls is None:
        assert tcls[0] is None and tcls[2]
    else:
        _eq(jcls[0], tcls[0], "class_of")
        _eq(jcls[1].astype(np.int64), tcls[1], "rep_rows")
    expect = {"one_spread_class": ("batch", True), "few_spread_in_plain": ("batch", True),
              "red_selects_blue": ("batch", True), "heterogeneous_spread": ("scan", None),
              "spread_preemptor": ("batch", False)}[kind]
    assert tmode == expect[0]
    if expect[1] is not None:
        assert (tcls[0] is not None) == expect[1]


# --- end to end ------------------------------------------------------------------------


def _cluster(kind):
    """60 nodes in 3 zones, 30 running-first pod_default pods, then spread
    pods (TopologySpreading's templates, the suite cut to size)."""
    nodes = [{"name": f"node-{i:06d}", "cpu": "4", "memory": "32Gi", "pods": "110",
              "labels": {ZONE: f"moon-{i % 3}"}, "taints": [], "images": [],
              "unschedulable": False, "not_ready": False} for i in range(60)]
    req = {"cpu": "100m", "memory": "500Mi"}
    first = [{"name": f"pod-{i:06d}", "ts": float(i), "req": req} for i in range(30)]
    when = SOFT if kind == "preferred" else HARD
    measured = []
    for i in range(150):
        d = {"name": f"spread-{i:06d}", "ts": 1000.0 + i, "req": req, "labels": BLUE,
             "spread": [(5, ZONE, when, BLUE, None)]}
        if kind == "mixed" and i % 3 == 0:
            d = {"name": f"plain-{i:06d}", "ts": 1000.0 + i,
                 "req": {"cpu": "3500m", "memory": "1Gi"}}  # fills nodes: contention
        measured.append(d)
    return nodes, first, measured


def _drive(sched, store, rounds_of):
    per_cycle = []
    for _ in range(60):
        r0 = rounds_of()
        if sched.schedule_cycle().attempted == 0:
            break
        per_cycle.append(int(rounds_of() - r0))
    pods, _ = store.list("Pod")
    return {p.metadata.name: p.spec.node_name for p in pods}, per_cycle


@pytest.fixture(scope="module", params=["spread", "preferred", "mixed"])
def e2e(request):
    cluster = _cluster(request.param)
    out = {}
    for pkg, store in (("jax", JStore()), ("torch", TStore())):
        if pkg == "jax":
            sched = TPUScheduler(store, batch_size=64, pipeline=False, rng_key=None,
                                 clock=fake_clock(), batch_wait=0)

            def rounds_of():
                return jmetrics.assignment_rounds.value(("batch",))
        else:
            sched = TorchScheduler(store, batch_size=64, device="cpu", clock=fake_clock(),
                                   batch_wait=0)

            def rounds_of(s=sched):
                return s.rounds_total
        nodes, first, measured = cluster
        for d in nodes:
            store.create("Node", make_node_obj(pkg, d))
        for d in first + measured:
            store.create("Pod", make_pod_obj(pkg, d))
        out[pkg] = _drive(sched, store, rounds_of) + (sched,)
    return request.param, out


def test_e2e_same_node_for_every_pod(e2e):
    kind, out = e2e
    jb, tb = out["jax"][0], out["torch"][0]
    assert jb.keys() == tb.keys()
    diff = {k: (jb[k], tb[k]) for k in jb if jb[k] != tb[k]}
    assert not diff, f"{len(diff)} pods differ, e.g. {list(diff.items())[:3]}"
    # the spread pods end within maxSkew across the zones
    zone_of = {f"node-{i:06d}": i % 3 for i in range(60)}
    counts = np.bincount([zone_of[v] for k, v in tb.items()
                          if k.startswith("spread-") and v], minlength=3)
    if kind == "spread":
        assert counts.max() - counts.min() <= 5


def test_e2e_same_pods_unschedulable(e2e):
    kind, out = e2e
    ju = {k for k, v in out["jax"][0].items() if not v}
    tu = {k for k, v in out["torch"][0].items() if not v}
    assert ju == tu
    if kind != "mixed":
        assert not tu


def test_e2e_same_rounds_every_cycle(e2e):
    """One commit per round in a coupled spread component: the rounds per
    cycle are the reference's, cycle by cycle."""
    kind, out = e2e
    assert out["jax"][1] == out["torch"][1]
    assert max(out["torch"][1]) > 32  # serialized spread components
