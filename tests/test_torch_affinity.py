"""InterPodAffinity on the port against the JAX package (exact).

* The existing-pod affinity index: after a random sequence of scheduled,
  removed and re-homed affinity pods the port encoder's ``aff_*`` arrays
  equal the JAX encoder's and the port's own ``rebuild``; ``match_batch``
  equals the reference's, None cases included.
* B12, plugin level: ``prepare`` (every IPAAux field), ``filter``,
  ``score``, ``normalize``, the composed mask / total / diagnosis (through
  the K10 / K11 plain versions) and ``update_batch_classes`` after one and
  several commits (through the K12 plain version) equal the JAX plugin's,
  in the tables form (zone keys) and the planes form (hostname keys), with
  all four term groups, an existing-pod host aux holding block, required
  and negative preferred groups, and the first-pod escape.  The JAX aux,
  carried over by convert.py, gives the same planes in the port.
* Normalize at max − min of 97 and 100: bit-equal, and the top node scores
  100 — where a reciprocal form of the division would not.
* Routing: for hand-built affinity batches the port's engine choice,
  coupling flags, parallel-safety test and dedup gate equal TPUScheduler's.
* End to end: TorchScheduler (cpu) against TPUScheduler (pipeline=False,
  rng_key=None) on the three pod-affinity suites cut small and a mixed
  queue: the same node for every pod, the same unschedulable pods and the
  same engine rounds in every cycle.
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
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.scheduler import default_plugins as j_default_plugins
from kubernetes_tpu.sim.store import ObjectStore as JStore
from kubernetes_tpu.state.cache import Cache as JCache, Snapshot as JSnapshot
from kubernetes_tpu.state.encoding import ClusterEncoder as JEncoder
from kubernetes_tpu_torch.convert import (
    batch_from_numpy,
    dyn_from_numpy,
    ipa_aux_from_numpy,
    snapshot_from_numpy,
)
from kubernetes_tpu_torch.framework.podbatch import PodBatchCompiler as TCompiler
from kubernetes_tpu_torch.framework.runtime import BatchedFramework as TFramework
from kubernetes_tpu_torch.kernels.interpodaffinity import ipa_normalize
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.scheduler import default_plugins as t_default_plugins
from kubernetes_tpu_torch.sim.store import ObjectStore as TStore
from kubernetes_tpu_torch.state.cache import Cache as TCache, Snapshot as TSnapshot
from kubernetes_tpu_torch.state.encoding import ClusterEncoder as TEncoder

from tests.test_torch_common import fake_clock, make_node_obj, make_pod_obj
from tests.test_torch_plugins import batch_arrays, snapshot_arrays

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
AFF_FIELDS = ("aff_valid", "aff_kind", "aff_weight", "aff_slot", "aff_counts")


def _eq(a, b, what):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), (what, np.argwhere(a != b)[:5])


def _nodes(n, zones=3, keyless=()):
    out = []
    for i in range(n):
        labels = {"disk": "ssd" if i % 3 == 0 else "hdd"}
        if i not in keyless:
            labels[ZONE] = f"moon-{i % zones}"
        out.append({"name": f"n{i:04d}", "cpu": "4", "memory": "32Gi", "pods": "110",
                    "labels": labels, "taints": [], "images": [],
                    "unschedulable": False, "not_ready": False})
    return out


def _term(key, sel, anti=False, weight=None, namespaces=None):
    return (key, sel, anti, weight, namespaces)


def _scheduled(rng, names, k, key=ZONE, with_terms=True):
    """Scheduled pods with random labels and namespaces; some carry their own
    terms (required anti, required affinity, preferred ± — the index's
    BLOCK, SCORE_REQ and signed SCORE groups)."""
    own = [
        [_term(key, {"color": "red"}, anti=True)],
        [_term(key, {"color": "blue"})],
        [_term(key, {"color": "green"}, weight=4)],
        [_term(key, {"color": "blue"}, anti=True, weight=6)],
        [],
    ]
    out = []
    for i in range(k):
        d = {"name": f"s{i:03d}", "ts": -500.0 + i, "req": {"cpu": "100m"},
             "labels": {"color": str(rng.choice(["blue", "red", "green"]))},
             "ns": str(rng.choice(["default", "other"])),
             "node": names[int(rng.integers(len(names)))]}
        if with_terms:
            d["pod_affinity"] = own[int(rng.integers(len(own)))]
        out.append(d)
    return out


def _templates(key):
    req = {"cpu": "100m", "memory": "500Mi"}
    return [
        # required affinity to blue (the suite's shape), itself blue
        {"req": req, "labels": {"color": "blue"}, "pod_affinity": [_term(key, {"color": "blue"})]},
        # required anti-affinity to red, across namespaces
        {"req": req, "labels": {"color": "red"},
         "pod_affinity": [_term(key, {"color": "red"}, anti=True,
                                namespaces=["default", "other"])]},
        # preferred affinity and preferred anti-affinity: ± weights
        {"req": req, "labels": {"color": "green"},
         "pod_affinity": [_term(key, {"color": "blue"}, weight=5),
                          _term(ZONE, {"color": "green"}, anti=True, weight=3)]},
        # two required terms: pods matching ALL of them count
        {"req": req, "labels": {"color": "blue"},
         "pod_affinity": [_term(ZONE, {"color": "blue"}), _term(key, {"color": "blue"})]},
        # the first pod of a series: no purple pod anywhere, itself purple
        {"req": req, "labels": {"color": "purple"},
         "pod_affinity": [_term(key, {"color": "purple"})]},
        # no terms: a constraint-free row of an affinity batch
        {"req": req, "labels": {"color": "blue"}},
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
    ipa_host = {"InterPodAffinity": host_auxes.get("InterPodAffinity")}
    return dict(fw=fw, enc=enc, hbatch=hbatch, batch=batch, dsnap=dsnap, dyn=dyn,
                host_auxes=host_auxes, ipa_host=ipa_host, tfw=tfw, tbatch=tbatch,
                tsnap=tsnap, tdyn=tdyn)


def _ipa_index(fw):
    return next(i for i, pw in enumerate(fw.plugins) if pw.plugin.name == "InterPodAffinity")


def _problem(form: str, seed: int):
    rng = np.random.default_rng(seed)
    key = ZONE if form == "tables" else HOST
    nodes = _nodes(30, keyless=(4, 17))
    names = [d["name"] for d in nodes]
    sched = _scheduled(rng, names, 40, key=key)
    temps = _templates(key)
    pods = [dict(temps[int(rng.integers(len(temps)))], name=f"p{i:03d}", ts=float(i))
            for i in range(24)]
    pods[0] = dict(temps[4], name="p000", ts=0.0)  # the first-pod escape is present
    return _build(nodes, sched, pods)


@pytest.fixture(scope="module", params=[("tables", 0), ("planes", 1)],
                ids=["tables", "planes"])
def ipa_problem(request):
    return request.param[0], _problem(*request.param)


def _prepared(p):
    idx = _ipa_index(p["fw"])
    jaux = p["fw"].prepare(p["batch"], p["dsnap"], p["dyn"], p["host_auxes"])[idx]
    taux = p["tfw"].prepare(p["tbatch"], p["tsnap"], p["tdyn"], p["ipa_host"])[idx]
    return idx, jaux, taux


def test_prepare_equals_reference(ipa_problem):
    form, p = ipa_problem
    idx, jaux, taux = _prepared(p)
    assert taux is not None
    for field in jaux._fields:
        _eq(getattr(jaux, field), getattr(taux, field), field)
    n = p["tsnap"].num_nodes
    assert (taux.aff_cnt.shape[-1] == n) == (form == "planes")
    # the problem reaches what it is built for: every group present, an
    # existing-pod block and a negative static score, a first pod
    assert set(taux.present) == {"req_affinity", "req_anti_affinity", "pref_affinity",
                                 "pref_anti_affinity"}
    assert bool(taux.exist_anti_block.any()) and bool((taux.score_static < 0).any())
    assert bool(((taux.aff_total == 0) & taux.self_match_all).any())
    kinds = set(np.asarray(p["dsnap"].aff_kind)[np.asarray(p["dsnap"].aff_valid)].tolist())
    assert kinds == {0, 1, 2}


def _jax_planes(p, auxes):
    fw, idx = p["fw"], _ipa_index(p["fw"])

    def run(batch, dsnap, dyn, auxes):
        mask = fw.run_filters(batch, dsnap, dyn, auxes)
        plug = fw.plugins[idx].plugin
        raw = plug.score(batch, dsnap, dyn, auxes[idx], mask=mask)
        return {"mask": mask, "scores": fw.run_scores(batch, dsnap, dyn, auxes, mask),
                "diag": fw.diagnose_bits(batch, dsnap, dyn, auxes),
                "filter": plug.filter(batch, dsnap, dyn, auxes[idx]),
                "raw": raw, "norm": plug.normalize(raw, mask)}

    out = jax.jit(run)(p["batch"], p["dsnap"], p["dyn"], auxes)
    return {k: np.asarray(v) for k, v in out.items()}


def test_filter_score_normalize_and_composition_equal(ipa_problem):
    form, p = ipa_problem
    idx = _ipa_index(p["fw"])
    jauxes = p["fw"].prepare(p["batch"], p["dsnap"], p["dyn"], p["host_auxes"])
    tauxes = p["tfw"].prepare(p["tbatch"], p["tsnap"], p["tdyn"], p["ipa_host"])
    j = _jax_planes(p, jauxes)
    plug = p["tfw"].plugins[idx].plugin
    tmask = torch.from_numpy(j["mask"].copy())
    _eq(j["filter"], plug.filter(p["tbatch"], p["tsnap"], p["tdyn"], tauxes[idx]), "filter")
    traw = plug.score(p["tbatch"], p["tsnap"], p["tdyn"], tauxes[idx], mask=tmask)
    _eq(j["raw"], traw, "raw score")
    _eq(j["norm"], plug.normalize(traw, tmask), "normalized score")
    valid = np.asarray(p["hbatch"].valid)
    assert not j["filter"][valid].all() and j["filter"][valid].any()
    assert (j["raw"] < 0).any() and (j["raw"] > 0).any()
    # K1 + K10 bits, K2 + K11 total, diagnosis — through the kernel wrappers'
    # plain versions
    tm, ts = p["tfw"].compute(p["tbatch"], p["tsnap"], p["tdyn"], tauxes)
    _eq(j["mask"], tm, "mask")
    _eq(j["scores"], ts, "total")
    _eq(j["diag"], p["tfw"].diagnose_bits(p["tbatch"], p["tsnap"], p["tdyn"], tauxes),
        "diagnosis")
    # the reference's aux carried over by convert.py gives the same planes
    caux = ipa_aux_from_numpy({f: np.asarray(getattr(jauxes[idx], f))
                               for f in jauxes[idx]._fields},
                              p["tbatch"], plug._d(p["tbatch"]), device="cpu")
    _eq(j["filter"], plug.filter(p["tbatch"], p["tsnap"], p["tdyn"], caux), "filter (converted)")
    _eq(j["raw"], plug.score(p["tbatch"], p["tsnap"], p["tdyn"], caux), "raw (converted)")


def _class_view(p, rep_rows):
    idx = _ipa_index(p["fw"])
    jrep = p["batch"].take(jnp.asarray(rep_rows))
    jplug = p["fw"].plugins[idx].plugin
    jhost = jplug.host_aux_take(p["host_auxes"].get("InterPodAffinity"), jnp.asarray(rep_rows))
    jaux = jplug.prepare(jrep, p["dsnap"], p["dyn"], jhost)
    trep = p["tbatch"].take(torch.from_numpy(rep_rows.astype(np.int64)))
    tplug = p["tfw"].plugins[idx].plugin
    thost = tplug.host_aux_take(p["ipa_host"]["InterPodAffinity"], rep_rows)
    taux = tplug.engine_copy(tplug.prepare(trep, p["tsnap"], p["tdyn"], thost))
    return jplug, jrep, jaux, tplug, trep, taux


def test_update_batch_classes_equal(ipa_problem):
    """Rounds of commits at class granularity: the JAX hook on the commits'
    class one-hot against the port's hook (K12's plain version), after one
    and after several rounds; then the planes read from the updated state."""
    form, p = ipa_problem
    class_of, reps = identity_classes(p["hbatch"])
    cpad = max(4, 1 << (len(reps) - 1).bit_length())
    rep_rows = np.full(cpad, reps[0], dtype=np.int32)
    rep_rows[: len(reps)] = reps
    jplug, jrep, jaux, tplug, trep, taux = _class_view(p, rep_rows)
    rng = np.random.default_rng(7)
    b, n = p["hbatch"].size, p["tsnap"].num_nodes
    live = np.asarray(p["tsnap"].node_valid).nonzero()[0]
    for _ in range(3):
        commit = (rng.random(b) < 0.5) & np.asarray(p["hbatch"].valid)
        choice = live[rng.integers(0, len(live), size=b)].astype(np.int32)
        u_c = jnp.zeros((cpad, n), jnp.float32).at[
            jnp.asarray(class_of), jnp.asarray(choice)].add(jnp.asarray(commit, jnp.float32))
        jaux = jplug.update_batch_classes(jaux, u_c, p["batch"], jrep, p["dsnap"],
                                          jnp.asarray(class_of))
        tplug.update_batch_classes(taux, torch.from_numpy(commit), torch.from_numpy(choice),
                                   torch.from_numpy(class_of.astype(np.int64)))
        for field in jaux._fields:
            _eq(getattr(jaux, field), getattr(taux, field), f"{field} after a round")
    assert bool(taux.block_dyn.any()) and bool((taux.score_dyn != 0).any())
    mask = jnp.ones((cpad, n), bool)
    _eq(jplug.filter(jrep, p["dsnap"], p["dyn"], jaux),
        tplug.filter(trep, p["tsnap"], p["tdyn"], taux), "filter after rounds")
    _eq(jplug.normalize(jplug.score(jrep, p["dsnap"], p["dyn"], jaux), mask),
        tplug.normalize(tplug.score(trep, p["tsnap"], p["tdyn"], taux),
                        torch.ones((cpad, n), dtype=torch.bool)), "score after rounds")


@pytest.mark.parametrize("diff", [97, 100])
def test_normalize_floor_boundaries_equal_reference(diff):
    """Raw scores spanning [0, diff]: the port's normalize is bit-equal to the
    reference's, the top node scores exactly 100, and the two reorderings a
    kernel might take instead each move a floor at this diff."""
    rng = np.random.default_rng(diff)
    s = rng.integers(0, diff + 1, size=(2, 64)).astype(np.float32)
    s[:, 0], s[:, 1] = 0.0, float(diff)
    mask = np.ones(s.shape, bool)
    idx = _ipa_index(JFramework(j_default_plugins(8)))
    jplug = j_default_plugins(8)[idx].plugin
    ref = np.asarray(jplug.normalize(jnp.asarray(s), jnp.asarray(mask)))
    got = ipa_normalize(torch.from_numpy(s), torch.from_numpy(mask))
    _eq(ref, got, "normalize")
    assert (np.floor(ref[:, 1]) == 100.0).all()
    v = np.arange(diff + 1, dtype=np.float32)
    exact = np.floor(np.float32(100) * v / np.float32(diff))
    reciprocal = np.floor(v * (np.float32(100) / np.float32(diff)))
    divide_first = np.floor((v / np.float32(diff)) * np.float32(100))
    if diff == 97:
        assert exact[-1] == 100.0 and reciprocal[-1] == 99.0
    else:
        assert exact[53] == 53.0 and divide_first[53] == 52.0
        assert exact[59] == 59.0 and divide_first[59] == 58.0


def test_normalize_reorderings_flip_floors_at_28_diffs():
    """Over every integer max − min in 1..400 and every integer score in
    range, float32 100·(s − min)/diff floors differently from a reciprocal
    form or a divide-first form at 28 diffs — why K11 spells the reference's
    order."""
    f = np.float32
    flips = []
    for d in range(1, 401):
        v = np.arange(d + 1, dtype=np.float32)
        exact = np.floor(f(100) * v / f(d))
        reciprocal = np.floor(v * (f(100) / f(d)))
        divide_first = np.floor((v / f(d)) * f(100))
        if (exact != reciprocal).any() or (exact != divide_first).any():
            flips.append(d)
    assert len(flips) == 28 and flips[:3] == [97, 99, 100]


# --- the existing-pod affinity index ------------------------------------------------------


def test_affinity_index_equals_reference_under_churn():
    """Scheduled, removed and re-homed affinity pods, applied to both
    packages' caches and encoders in the same order: the aff_* arrays equal
    after every step, equal the port's own rebuild, and match_batch equals
    the reference's (None when no live group matches)."""
    rng = np.random.default_rng(3)
    nodes = _nodes(12, keyless=(5,))
    names = [d["name"] for d in nodes]
    pods = _scheduled(rng, names, 30, key=ZONE) + _scheduled(rng, names, 10, key=HOST)
    for i, d in enumerate(pods):
        d["name"] = f"e{i:03d}"
    caches = {"jax": (JCache(), JSnapshot(), JEncoder()),
              "torch": (TCache(), TSnapshot(), TEncoder(device="cpu"))}
    for pkg, (cache, _, _) in caches.items():
        for d in nodes:
            cache.add_node(make_node_obj(pkg, d))

    def sync():
        for cache, snap, enc in caches.values():
            enc.sync(snap, cache.update_snapshot(snap))
        jenc, tenc = caches["jax"][2], caches["torch"][2]
        for f in AFF_FIELDS:
            _eq(getattr(jenc, f), getattr(tenc, f), f)

    placed = {}
    for step in range(60):
        u = rng.random()
        d = pods[int(rng.integers(len(pods)))]
        if d["name"] not in placed:
            d = dict(d, node=names[int(rng.integers(len(names)))])
            for pkg, (cache, _, _) in caches.items():
                cache.add_pod(make_pod_obj(pkg, d))
            placed[d["name"]] = d
        elif u < 0.5:  # re-home onto another node
            old = placed[d["name"]]
            new = dict(old, node=names[int(rng.integers(len(names)))])
            for pkg, (cache, _, _) in caches.items():
                cache.update_pod(make_pod_obj(pkg, old), make_pod_obj(pkg, new))
            placed[d["name"]] = new
        else:
            old = placed.pop(d["name"])
            for pkg, (cache, _, _) in caches.items():
                cache.remove_pod(make_pod_obj(pkg, old))
        if step % 5 == 4:
            sync()
    sync()
    tcache, tsnap, tenc = caches["torch"]
    assert tenc.aff.live_groups > 0 and int(tenc.aff.aff_counts.sum()) > 0
    before = {f: getattr(tenc, f).copy() for f in AFF_FIELDS}
    tenc.aff.rebuild(tsnap)
    for f in AFF_FIELDS:
        _eq(before[f], getattr(tenc, f), f"{f} vs rebuild")

    # match_batch: the pending pods each live group matches
    temps = _templates(ZONE)
    pend = [dict(temps[k % len(temps)], name=f"q{k}", ts=float(k),
                 ns=("default" if k % 3 else "other")) for k in range(12)]
    outside = [dict(temps[0], name="x0", ts=0.0, ns="nowhere", labels={"color": "cyan"})]
    jenc = caches["jax"][2]
    for batch in (pend, outside):
        jm = jenc.aff.match_batch([make_pod_obj("jax", d) for d in batch], 16)
        tm = tenc.aff.match_batch([make_pod_obj("torch", d) for d in batch], 16)
        if jm is None:
            assert tm is None
        else:
            _eq(jm["match"], tm["match"], "match_batch")
    assert tenc.aff.match_batch([make_pod_obj("torch", outside[0])], 16) is None
    empty = TEncoder(device="cpu")
    assert empty.aff.match_batch([make_pod_obj("torch", pend[0])], 16) is None


# --- routing ---------------------------------------------------------------------------


def _routing_cases():
    req = {"cpu": "100m", "memory": "500Mi"}

    def pod(i, terms, labels, **kw):
        return dict({"name": f"a{i:02d}", "ts": float(i), "req": req, "labels": labels,
                     "pod_affinity": terms}, **kw)

    green = {"color": "green"}
    blue = {"color": "blue"}
    anti = [_term(HOST, green, anti=True)]
    aff = [_term(ZONE, blue)]
    pref = [_term(HOST, {"color": "red"}, weight=1)]
    return {
        "anti_hostname": (3, [pod(i, anti, green) for i in range(24)], ("batch", True)),
        "affinity_one_zone": (1, [pod(i, aff, blue) for i in range(24)], ("batch", True)),
        "affinity_three_zones": (3, [pod(i, aff, blue) for i in range(24)], ("batch", True)),
        "preferred_hostname": (3, [pod(i, pref, {"color": "red"}) for i in range(24)],
                               ("batch", True)),
        "affinity_preemptor": (1, [pod(0, aff, blue, priority=10)], ("batch", False)),
        "heterogeneous_affinity": (3, [dict(pod(i, aff, blue), req={"cpu": f"{100 + i}m"})
                                       for i in range(20)], ("scan", None)),
    }


@pytest.mark.parametrize("kind", list(_routing_cases()))
def test_routing_equals_reference(kind):
    zones, pods, expect = _routing_cases()[kind]
    nodes = _nodes(12, zones=zones)
    running = {"name": "run", "ts": -1.0, "req": {"cpu": "100m"}, "node": "n0000",
               "labels": {"color": "blue"}}
    js, ts = JStore(), TStore()
    jsched = TPUScheduler(js, batch_size=32, pipeline=False, rng_key=None,
                          clock=fake_clock(), batch_wait=0)
    tsched = TorchScheduler(ts, batch_size=32, device="cpu", clock=fake_clock(), batch_wait=0)
    for pkg, store in (("jax", js), ("torch", ts)):
        for d in nodes:
            store.create("Node", make_node_obj(pkg, d))
        store.create("Pod", make_pod_obj(pkg, running))
    jsched.encoder.sync(jsched.snapshot, jsched.cache.update_snapshot(jsched.snapshot))
    tsched.encoder.sync(tsched.snapshot, tsched.cache.update_snapshot(tsched.snapshot))
    jb = jsched.compiler.compile([make_pod_obj("jax", d) for d in pods], pad_to=32)
    tb = tsched.compiler.compile([make_pod_obj("torch", d) for d in pods], pad_to=32)
    jfw = jsched._framework()
    tfw = tsched._framework()
    rep_j, rep_t = make_pod_obj("jax", pods[0]), make_pod_obj("torch", pods[0])
    assert jsched._class_parallel_safe(rep_j) == tsched._class_parallel_safe(rep_t)
    jmode, jc, _ = jsched.engine_choice(jb)
    tmode, tc, _ = tsched.engine_choice(tb, tfw)
    assert jmode == tmode == expect[0]
    for f in ("reads", "solo", "comp", "multi"):
        _eq(getattr(jc, f), getattr(tc, f), f)
    jhost = jfw.host_prepare(jb, jsched.snapshot, jsched.encoder)
    thost = tfw.host_prepare(tb, tsched.snapshot, tsched.encoder)
    jcls = jsched._dedup_classes(jb, jhost, fw=jfw)
    tcls = tsched._dedup_classes(tb, thost, tfw)
    if jcls is None:
        assert tcls[0] is None and tcls[2]
    else:
        _eq(jcls[0], tcls[0].astype(np.int32), "class_of")
        _eq(jcls[1].astype(np.int64), tcls[1], "rep_rows")
    if expect[1] is not None:
        assert (tcls[0] is not None) == expect[1]
    if kind in ("anti_hostname", "affinity_one_zone"):
        assert not np.asarray(tc.multi).any()  # parallel-safe: no serialized component
    if kind in ("affinity_three_zones", "preferred_hostname"):
        assert np.asarray(tc.multi).sum() == 24  # one coupled component


# --- end to end ------------------------------------------------------------------------


def _suite(kind):
    """The pod-affinity suites of perf/workloads.py cut small: 60 nodes,
    30 first pods in sched-0, then 120 measured pods in sched-1 (the mixed
    queue: affinity, spread and pod_default pods in one backlog)."""
    req = {"cpu": "100m", "memory": "500Mi"}
    zoned = kind in ("affinity", "mixed")
    nodes = [{"name": f"node-{i:06d}", "cpu": "4", "memory": "32Gi", "pods": "110",
              "labels": ({ZONE: "zone1" if kind == "affinity" else f"moon-{i % 3}"}
                         if zoned else {HOST: f"node-{i:06d}"}),
              "taints": [], "images": [], "unschedulable": False, "not_ready": False}
             for i in range(60)]

    def pod(i, ns, ts, k):
        if k == "anti":
            return {"name": f"anti-{ns}-{i:06d}", "ns": ns, "ts": ts, "req": req,
                    "labels": {"color": "green"},
                    "pod_affinity": [_term(HOST, {"color": "green"}, anti=True,
                                           namespaces=["sched-0", "sched-1"])]}
        if k == "affinity":
            return {"name": f"aff-{ns}-{i:06d}", "ns": ns, "ts": ts, "req": req,
                    "labels": {"color": "blue"},
                    "pod_affinity": [_term(ZONE, {"color": "blue"},
                                           namespaces=["sched-0", "sched-1"])]}
        if k == "preferred":
            return {"name": f"paff-{ns}-{i:06d}", "ns": ns, "ts": ts, "req": req,
                    "labels": {"color": "red"},
                    "pod_affinity": [_term(HOST, {"color": "red"}, weight=1,
                                           namespaces=["sched-1", "sched-0"])]}
        if k == "spread":
            return {"name": f"spread-{i:06d}", "ts": ts, "req": req, "labels": {"color": "blue"},
                    "spread": [(5, ZONE, "DoNotSchedule", {"color": "blue"}, None)]}
        return {"name": f"pod-{ns}-{i:06d}", "ns": ns, "ts": ts, "req": req}

    if kind == "mixed":
        first = [pod(i, "sched-0", float(i), "affinity") for i in range(30)]
        cycle = ("affinity", "spread", "default", "preferred")
        measured = [pod(i, "sched-1", 1e5 + i, cycle[i % 4]) for i in range(120)]
    else:
        first = [pod(i, "sched-0", float(i), kind) for i in range(30)]
        measured = [pod(i, "sched-1", 1e5 + i, kind) for i in range(120)]
    return nodes, first, measured


def _drive(sched, store, rounds_of, pods):
    per_cycle = []
    for d in pods:
        store.create("Pod", d)
    for _ in range(60):
        r0 = rounds_of()
        if sched.schedule_cycle().attempted == 0:
            break
        per_cycle.append(int(rounds_of() - r0))
    return per_cycle


@pytest.fixture(scope="module", params=["anti", "affinity", "preferred", "mixed"])
def e2e(request):
    nodes, first, measured = _suite(request.param)
    out = {}
    for pkg, store in (("jax", JStore()), ("torch", TStore())):
        if pkg == "jax":
            sched = TPUScheduler(store, batch_size=32, pipeline=False, rng_key=None,
                                 clock=fake_clock(), batch_wait=0)

            def rounds_of():
                return jmetrics.assignment_rounds.value(("batch",))
        else:
            sched = TorchScheduler(store, batch_size=32, device="cpu", clock=fake_clock(),
                                   batch_wait=0)

            def rounds_of(s=sched):
                return s.rounds_total
        for d in nodes:
            store.create("Node", make_node_obj(pkg, d))
        per = _drive(sched, store, rounds_of, [make_pod_obj(pkg, d) for d in first])
        per += _drive(sched, store, rounds_of, [make_pod_obj(pkg, d) for d in measured])
        pods, _ = store.list("Pod")
        out[pkg] = ({p.metadata.name: p.spec.node_name for p in pods}, per, sched)
    return request.param, out


def test_e2e_same_node_for_every_pod(e2e):
    kind, out = e2e
    jb, tb = out["jax"][0], out["torch"][0]
    assert jb.keys() == tb.keys()
    diff = {k: (jb[k], tb[k]) for k in jb if jb[k] != tb[k]}
    assert not diff, f"{len(diff)} pods differ, e.g. {list(diff.items())[:3]}"
    if kind == "anti":  # no two green pods share a host
        hosts = [v for k, v in tb.items() if v]
        assert len(hosts) == len(set(hosts)) == 60


def test_e2e_same_pods_unschedulable(e2e):
    kind, out = e2e
    ju = {k for k, v in out["jax"][0].items() if not v}
    tu = {k for k, v in out["torch"][0].items() if not v}
    assert ju == tu
    assert bool(tu) == (kind == "anti")  # 60 hosts for 150 anti pods


def test_e2e_same_rounds_every_cycle(e2e):
    """The coupled preferred class commits one pod per round; the
    parallel-safe anti and one-zone affinity classes commit together: the
    rounds per cycle are the reference's, cycle by cycle."""
    kind, out = e2e
    assert out["jax"][1] == out["torch"][1]
    assert out["torch"][2].phase_wall["host_prepare"] > 0
    if kind == "preferred":
        assert max(out["torch"][1]) == 32
    if kind in ("anti", "affinity"):
        assert max(out["torch"][1]) <= 3


def test_scheduled_affinity_pods_enter_the_index(e2e):
    """The first pods' own terms are recorded by the port's encoder (one
    live group per suite signature) and equal the reference's arrays."""
    kind, out = e2e
    for pkg in ("jax", "torch"):  # the last cycle's binds reach the encoder at a sync
        sched = out[pkg][2]
        sched.encoder.sync(sched.snapshot, sched.cache.update_snapshot(sched.snapshot))
    jenc, tenc = out["jax"][2].encoder, out["torch"][2].encoder
    assert tenc.aff.live_groups >= 1
    for f in AFF_FIELDS:
        _eq(getattr(jenc, f), getattr(tenc, f), f)
    # each bound affinity pod holds one term on a keyed node
    bound = sum(1 for k, v in out["torch"][0].items()
                if v and k.startswith(("anti-", "aff-", "paff-")))
    assert int(tenc.aff.aff_counts.sum()) == bound
