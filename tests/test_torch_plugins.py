"""Plugin parity: every plugin of the default set, port against the JAX package.

The JAX encoder's arrays go into the port through convert.py, so both
packages evaluate the same inputs.  For every plugin of ``default_plugins``
the filter plane, the raw score plane and the normalized plane must be
equal with no tolerance; so must the composed mask / total, the diagnosis
bits, and the kernels' plain versions (K1 bit plane + raw planes, K2 total)
at class granularity.  The clusters cover taints of all three effects,
tolerations (Exists / Equal / empty key), nodeSelector, required and
preferred node affinity, host ports with and without a host IP,
multi-image pods, unschedulable and NotReady nodes, and capacities that put
scores exactly on a floor boundary.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.framework.podbatch import PodBatchCompiler as JCompiler
from kubernetes_tpu.framework.podbatch import identity_classes
from kubernetes_tpu.framework.runtime import BatchedFramework as JFramework
from kubernetes_tpu.framework.runtime import initial_dynamic_state
from kubernetes_tpu.scheduler import default_plugins as j_default_plugins
from kubernetes_tpu.state.cache import Cache as JCache, Snapshot as JSnapshot
from kubernetes_tpu.state.encoding import ClusterEncoder as JEncoder
from kubernetes_tpu_torch.convert import (
    batch_from_numpy,
    dyn_from_numpy,
    snapshot_from_numpy,
)
from kubernetes_tpu_torch.framework.runtime import BatchedFramework as TFramework
from kubernetes_tpu_torch.kernels.filter_score import filter_score_planes_plain
from kubernetes_tpu_torch.kernels.normalize import normalize_combine_plain
from kubernetes_tpu_torch.plugins.nodeaffinity import NodeAffinityPlugin
from kubernetes_tpu_torch.plugins.trivial import image_scaled_by_id
from kubernetes_tpu_torch.scheduler import default_plugins as t_default_plugins
from kubernetes_tpu_torch.state.encoding import SNAPSHOT_FIELDS

from tests.test_torch_common import (
    make_node_obj,
    make_pod_obj,
    node_descs,
    pod_descs,
    scheduled_descs,
)


def batch_arrays(batch) -> dict:
    """A JAX PodBatch as a dict of numpy arrays (nested structs as dicts)."""
    out = {}
    for f in dataclasses.fields(batch):
        if f.name == "pods":
            continue
        v = getattr(batch, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = batch_arrays(v)
        elif isinstance(v, (np.ndarray, jnp.ndarray)):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = v
    return out


def snapshot_arrays(dsnap) -> dict:
    return {k: np.asarray(getattr(dsnap, k)) for k in SNAPSHOT_FIELDS}


def build_problem(seed: int, n_nodes: int = 48, n_sched: int = 30, n_pods: int = 40,
                  boundary: bool = False):
    """JAX-side problem + the same inputs converted into the port."""
    rng = np.random.default_rng(seed)
    nodes = node_descs(rng, n_nodes)
    if boundary:
        # empty 1000m / 4Gi nodes: a 250m / 1Gi pod scores Fit exactly
        # 75 per dimension and BalancedAllocation exactly 100
        for d in nodes[:8]:
            d.update(cpu="1000m", memory="4Gi", taints=[], unschedulable=False,
                     not_ready=False)
    names = [d["name"] for d in nodes]
    sched = scheduled_descs(rng, n_sched, names[8:] if boundary else names)
    pods = pod_descs(rng, n_pods)
    if boundary:
        pods[0] = dict(pods[0], req={"cpu": "250m", "memory": "1Gi"})
    cache = JCache()
    for d in nodes:
        cache.add_node(make_node_obj("jax", d))
    for d in sched:
        cache.add_pod(make_pod_obj("jax", d))
    snap = JSnapshot()
    cache.update_snapshot(snap)
    enc = JEncoder()
    enc.full_sync(snap)
    hbatch = JCompiler(enc).compile([make_pod_obj("jax", d) for d in pods], pad_to=64)
    fw = JFramework(j_default_plugins(enc.domain_cap))
    host_auxes = fw.host_prepare(hbatch, snap, enc)
    batch = jax.tree_util.tree_map(jnp.asarray, hbatch)
    dsnap = enc.to_device()
    dyn = initial_dynamic_state(dsnap)
    auxes = fw.prepare(batch, dsnap, dyn, host_auxes)
    tsnap = snapshot_from_numpy(snapshot_arrays(dsnap), device="cpu")
    tbatch = batch_from_numpy(batch_arrays(batch), device="cpu")
    tdyn = dyn_from_numpy({"requested": np.asarray(dyn.requested),
                           "non_zero": np.asarray(dyn.non_zero)}, device="cpu")
    tfw = TFramework(t_default_plugins(enc.domain_cap))
    return dict(fw=fw, batch=batch, hbatch=hbatch, dsnap=dsnap, dyn=dyn,
                auxes=auxes, tfw=tfw, tbatch=tbatch, tsnap=tsnap, tdyn=tdyn,
                host_auxes=host_auxes, planes=_jax_planes(fw, batch, dsnap, dyn, auxes))


def _jax_planes(fw, batch, dsnap, dyn, auxes):
    """Every plugin's filter / raw score / normalized plane, the composed
    mask and total, and the diagnosis bits — from ONE jitted program, the
    way the reference scheduler evaluates them."""

    def planes(batch, dsnap, dyn, auxes):
        mask = fw.run_filters(batch, dsnap, dyn, auxes)
        out = {"mask": mask,
               "scores": fw.run_scores(batch, dsnap, dyn, auxes, mask),
               "diag": fw.diagnose_bits(batch, dsnap, dyn, auxes)}
        for pw, aux in zip(fw.plugins, auxes):
            p = pw.plugin
            if hasattr(p, "filter"):
                out[p.name + ".filter"] = p.filter(batch, dsnap, dyn, aux)
            if hasattr(p, "score"):
                raw = p.score(batch, dsnap, dyn, aux, mask=mask)
                out[p.name + ".score"] = raw
                out[p.name + ".normalize"] = p.normalize(raw, mask)
        return out

    res = jax.jit(planes)(batch, dsnap, dyn, auxes)
    return {k: np.asarray(v) for k, v in res.items()}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b, what):
    a, b = _np(a), _np(b)
    a = np.broadcast_to(a, b.shape) if a.shape != b.shape else a
    assert a.shape == b.shape, what
    assert np.array_equal(a, b), (what, np.argwhere(a != b)[:5])


@pytest.fixture(scope="module", params=[0, 1, 2])
def problem(request):
    return build_problem(request.param, boundary=request.param == 2)


def test_plugin_list_matches(problem):
    jn = [(pw.plugin.name, pw.weight) for pw in problem["fw"].plugins]
    tn = [(pw.plugin.name, pw.weight) for pw in problem["tfw"].plugins]
    assert jn == tn
    assert problem["fw"].filter_names == problem["tfw"].filter_names
    # every registered requeue event matches, plugin by plugin
    for jp, tp in zip(problem["fw"].plugins, problem["tfw"].plugins):
        je = [(e.resource.value, int(e.action_type), e.label)
              for e in jp.plugin.events_to_register()]
        te = [(e.resource.value, int(e.action_type), e.label)
              for e in tp.plugin.events_to_register()]
        assert je == te, jp.plugin.name


def test_per_plugin_planes_equal(problem):
    p, jp_ = problem, problem["planes"]
    jmask = jp_["mask"]
    tmask = p["tfw"].run_filters(p["tbatch"], p["tsnap"], p["tdyn"])
    _eq(jmask, tmask, "mask")
    assert jmask.any() and not jmask.all()
    tm = torch.from_numpy(jmask.copy())
    for tpw in p["tfw"].plugins:
        tp = tpw.plugin
        if hasattr(tp, "filter"):
            _eq(jp_[tp.name + ".filter"],
                tp.filter(p["tbatch"], p["tsnap"], p["tdyn"], None),
                f"{tp.name} filter")
        if hasattr(tp, "score"):
            traw = tp.score(p["tbatch"], p["tsnap"], p["tdyn"], None, mask=tm)
            _eq(jp_[tp.name + ".score"], traw, f"{tp.name} score")
            _eq(jp_[tp.name + ".normalize"], tp.normalize(traw, tm),
                f"{tp.name} normalize")


def test_compute_and_diagnosis_equal(problem):
    p, jp_ = problem, problem["planes"]
    tm, ts = p["tfw"].compute(p["tbatch"], p["tsnap"], p["tdyn"])
    _eq(jp_["mask"], tm, "compute mask")
    _eq(jp_["scores"], ts, "compute scores")
    _eq(jp_["diag"], p["tfw"].diagnose_bits(p["tbatch"], p["tsnap"], p["tdyn"]),
        "diagnose_bits")


def test_kernel_plain_versions_equal_reference(problem):
    """K1's bit plane + raw planes and K2's total, at class granularity,
    against the JAX plugins run on the class representatives."""
    p = problem
    class_of, reps = identity_classes(p["hbatch"])
    jrep = p["batch"].take(jnp.asarray(reps))
    jrep_aux = p["fw"].prepare(jrep, p["dsnap"], p["dyn"], {
        k: (v if v is None or k != "Coscheduling" else (v[0], v[1][reps]))
        for k, v in p["host_auxes"].items()})
    jp_ = _jax_planes(p["fw"], jrep, p["dsnap"], p["dyn"], jrep_aux)
    jm, js = jp_["mask"], jp_["scores"]
    trep = p["tbatch"].take(torch.from_numpy(reps.astype(np.int64)))
    fs_plan, comb_plan = p["tfw"].kernel_plans()
    na = NodeAffinityPlugin()
    bits, raw = filter_score_planes_plain(
        trep, p["tsnap"], p["tdyn"], na.filter(trep, p["tsnap"], p["tdyn"]),
        na.score(trep, p["tsnap"], p["tdyn"]), image_scaled_by_id(p["tsnap"]),
        fs_plan)
    n_filters = len(p["tfw"].filter_names)
    full = (1 << n_filters) - 1
    _eq(jm, bits == full, "K1 mask")
    # each bit is that filter's plane AND live AND valid
    live = np.asarray(p["dsnap"].node_valid & p["dsnap"].node_ready)[None, :] \
        & np.asarray(jrep.valid)[:, None]
    k = 0
    for jpw in p["fw"].plugins:
        if not hasattr(jpw.plugin, "filter"):
            continue
        plane = jp_[jpw.plugin.name + ".filter"] & live
        _eq(plane, ((bits >> k) & 1).bool(), f"K1 bit {jpw.plugin.name}")
        k += 1
    raw_names = ["TaintToleration", "NodeAffinity", "NodeResourcesFit",
                 "NodeResourcesBalancedAllocation", "ImageLocality"]
    for i, name in enumerate(raw_names):
        _eq(jp_[name + ".score"], raw[i], f"K1 raw {name}")
    total, feas = normalize_combine_plain(bits, full, raw, comb_plan)
    _eq(js, total, "K2 total")
    _eq(np.asarray(jm).sum(axis=1).astype(np.int32), feas, "K2 feasible count")


def test_floor_boundary_scores_are_exact():
    """The boundary nodes score Fit = 75 and BalancedAllocation = 100 for
    the 250m / 1Gi pod — exact floors, equal in both packages."""
    p = build_problem(2, boundary=True)
    fit = [pw.plugin for pw in p["tfw"].plugins if pw.plugin.name == "NodeResourcesFit"][0]
    ba = [pw.plugin for pw in p["tfw"].plugins
          if pw.plugin.name == "NodeResourcesBalancedAllocation"][0]
    f = fit.score(p["tbatch"], p["tsnap"], p["tdyn"])
    b = ba.score(p["tbatch"], p["tsnap"], p["tdyn"])
    assert torch.all(f[0, :8] == 75.0)
    assert torch.all(b[0, :8] == 100.0)


# --- Fit's three scoring strategies (LeastAllocated, MostAllocated, RTCR) ------------

FIT_CASES = [
    ("LeastAllocated", None, None),
    ("MostAllocated", None, None),
    ("MostAllocated", None, {"cpu": 3, "memory": 1}),
    ("RequestedToCapacityRatio", None, None),  # the default shape
    ("RequestedToCapacityRatio", [(0, 10), (100, 0)], None),  # descending
    # a flat segment (dx = 0 at 30), a point left of 0 and one past 100
    ("RequestedToCapacityRatio", [(0, 0), (30, 7), (30, 2), (70, 9), (100, 3)],
     {"cpu": 3, "memory": 5}),
    ("RequestedToCapacityRatio", [(10, 3), (50, 8), (90, 1)], None),
]


def _fit_inputs(seed: int):
    """Random node / pod arrays with zero allocatables, over-full nodes,
    extended resources and totals on exact floor boundaries."""
    rng = np.random.default_rng(seed)
    n, b, r = 2048, 48, 8
    alloc = rng.integers(0, 5000, (n, r)).astype(np.int32)
    alloc[:, 0] = rng.choice([1000, 3500, 4000, 400, 0], n)
    alloc[rng.random((n, r)) < 0.05] = 0
    req = (alloc * rng.random((n, r))).astype(np.int32)
    nz = np.stack([req[:, 0], req[:, 1]], axis=1).astype(np.int32)
    nz[rng.random(n) < 0.3] += 100
    preq = rng.integers(0, 300, (b, r)).astype(np.int32)
    preq[:, 4:] *= rng.random((b, 4)) < 0.3
    pnz = np.stack([preq[:, 0], preq[:, 1]], axis=1).astype(np.int32)
    # floor boundaries: totals that are exact multiples of alloc / 100
    pnz[:8, 0] = [0, 250, 40, 1000, 350, 1, 999, 4000]
    nz[:64, 0] = 0
    return alloc, req, nz, preq, pnz


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("strategy,shape,resources", FIT_CASES)
def test_fit_strategies_plain_equal_reference(strategy, shape, resources, seed):
    """FitPlugin.score of the port equals the JAX plugin's under jax.jit
    for every strategy, bit for bit (RTCR through jnp.interp's binary
    search and its fused multiply-add)."""
    from types import SimpleNamespace as NS

    from kubernetes_tpu.plugins.noderesources import FitPlugin as JFit
    from kubernetes_tpu_torch.plugins.noderesources import FitPlugin as TFit

    alloc, req, nz, preq, pnz = _fit_inputs(seed)
    jp = JFit(strategy, resources=resources, shape=shape)
    tp = TFit(strategy, resources=resources, shape=shape)
    want = np.asarray(jax.jit(lambda a, rq, z, pr, pz: jp.score(
        NS(request=pr, non_zero=pz), NS(allocatable=a), NS(requested=rq, non_zero=z)))(
        alloc, req, nz, preq, pnz))
    t = torch.from_numpy
    got = tp.score(NS(request=t(preq), non_zero=t(pnz)), NS(allocatable=t(alloc)),
                   NS(requested=t(req), non_zero=t(nz))).numpy()
    _eq(want, got, f"Fit {strategy} {shape}")
    assert len(np.unique(want)) > 10


def test_rtcr_interp_equals_jnp_interp():
    """rtcr_interp equals jnp.interp under jax.jit over a dense utilization
    grid, for ascending, descending and flat-segment shapes."""
    from kubernetes_tpu_torch.plugins.noderesources import rtcr_interp

    x = np.linspace(-5, 105, 110001).astype(np.float32)
    for pts in ([(0, 0), (100, 100)], [(0, 100), (100, 0)],
                [(0, 0), (30, 70), (30, 20), (70, 90), (100, 30)], [(10, 30), (90, 10)]):
        xp = np.asarray([p[0] for p in pts], np.float32)
        fp = np.asarray([p[1] for p in pts], np.float32)
        want = np.asarray(jax.jit(jnp.interp)(x, xp, fp))
        got = rtcr_interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp))
        _eq(want, got, f"interp {pts}")


@pytest.mark.parametrize("strategy,shape,resources", FIT_CASES[1:6])
def test_k1_fit_plane_under_strategies_equals_reference(problem, strategy, shape, resources):
    """K1's plain version with a plan whose Fit plugin uses the strategy:
    its Fit raw plane equals the reference plugin's score on the encoded
    cluster."""
    from kubernetes_tpu.plugins.noderesources import FitPlugin as JFit
    from kubernetes_tpu_torch.plugins.noderesources import FitPlugin as TFit

    p = problem
    jp = JFit(strategy, resources=resources, shape=shape)
    want = np.asarray(jax.jit(lambda b, s, d: jp.score(b, s, d))(p["batch"], p["dsnap"],
                                                                   p["dyn"]))
    fs_plan, _ = p["tfw"].kernel_plans()
    plan = dataclasses.replace(fs_plan, fit=TFit(strategy, resources=resources, shape=shape))
    na = NodeAffinityPlugin()
    _bits, raw = filter_score_planes_plain(
        p["tbatch"], p["tsnap"], p["tdyn"], na.filter(p["tbatch"], p["tsnap"], p["tdyn"]),
        na.score(p["tbatch"], p["tsnap"], p["tdyn"]), image_scaled_by_id(p["tsnap"]), plan)
    _eq(want, raw[2], f"K1 Fit plane {strategy}")


# --- K2's plain version against the reference's run_scores / compute_packed ---------


class _GivenPlane:
    """A plugin of the reference's framework whose plane is its prepared
    aux: a filter when ``normalizer`` is None, else a score plane that
    ``normalizer`` (a reference plugin) normalizes."""

    def __init__(self, name, normalizer=None):
        self.name = name
        if normalizer is None:
            self.filter = lambda batch, snap, dyn, aux: aux
        else:
            self.score = lambda batch, snap, dyn, aux, mask=None: aux
            self.normalize = normalizer.normalize

    def prepare(self, batch, snap, dyn, host_aux):
        return host_aux


@pytest.mark.parametrize("special", ["random", "zero max", "no feasible node"])
@pytest.mark.parametrize("c", [1, 4, 32])
def test_normalize_combine_plain_equals_run_scores(c, special):
    """K2's plain version (total, feasible count, packed mode) against the
    reference's run_scores and compute_packed over the same planes, made
    from a numpy seed: Fit's identity, NodeAffinity's default and
    TaintToleration's reversed normalize, a zero plane under the reversed
    kind (the port's const_add), integer and fractional scores; one row
    whose normalized planes have maximum 0 on the feasible nodes (larger
    values off them) or that has no feasible node."""
    from kubernetes_tpu.framework.interface import PluginWithWeight
    from kubernetes_tpu.plugins.nodeaffinity import NodeAffinityPlugin
    from kubernetes_tpu.plugins.noderesources import FitPlugin
    from kubernetes_tpu.plugins.tainttoleration import TaintTolerationPlugin
    from kubernetes_tpu_torch.kernels.normalize import CombinePlan, normalize_combine

    rng = np.random.default_rng(100 * c + len(special))
    n, full = 40, 0b111
    kinds, weights = (0, 1, 2, 1, 0), (1, 2, 1, 3, 1)
    norm_of = {0: FitPlugin(), 1: NodeAffinityPlugin(), 2: TaintTolerationPlugin()}
    mask = rng.random((c, n)) < 0.7
    raw = np.where(rng.random((5, c, n)) < 0.5, rng.integers(0, 101, (5, c, n)),
                   rng.random((5, c, n)) * 100).astype(np.float32)
    row = 0 if c == 1 else 1
    if special == "zero max":
        for p_, k in enumerate(kinds):
            if k:
                raw[p_, row] = np.where(mask[row], 0.0, raw[p_, row] + 50.0)
    elif special == "no feasible node":
        mask[row] = False
    bits = np.where(mask, full, full & ~(1 << rng.integers(0, 3, (c, n)))).astype(np.int32)

    plugins = [PluginWithWeight(_GivenPlane("Mask"), 1)]
    plugins += [PluginWithWeight(_GivenPlane(f"P{p_}", norm_of[k]), w)
                for p_, (k, w) in enumerate(zip(kinds, weights))]
    plugins.append(PluginWithWeight(_GivenPlane("Zero", TaintTolerationPlugin()), 2))
    fw = JFramework(plugins)
    batch = dataclasses.make_dataclass("B", ["valid"])(jnp.ones(c, bool))
    snap = dataclasses.make_dataclass("S", ["node_valid"])(jnp.ones(n, bool))
    auxes = (jnp.asarray(mask),) + tuple(jnp.asarray(x) for x in raw) \
        + (jnp.zeros((c, n), jnp.float32),)
    want = np.asarray(jax.jit(lambda a: fw.run_scores(batch, snap, None, a, a[0]))(auxes))
    want_packed = np.asarray(jax.jit(lambda a: fw.compute_packed(batch, snap, None, a))(auxes))

    plan = CombinePlan(kinds=kinds, weights=tuple(float(w) for w in weights),
                       const_add=2 * 100.0)
    tb, tr = torch.from_numpy(bits), torch.from_numpy(raw)
    total, feas = normalize_combine_plain(tb, full, tr, plan)
    _eq(want, total, "K2 total")
    _eq(mask.sum(axis=1).astype(np.int32), feas, "K2 feasible count")
    _eq(want_packed, normalize_combine(tb, full, tr, plan, packed=True), "K2 packed")
    if special == "zero max":  # the normalized planes give 0 (default) and 100 (reversed)
        ident = sum(w * np.floor(raw[p_, row]) for p_, (k, w) in enumerate(zip(kinds, weights))
                    if k == 0)
        _eq(np.where(mask[row], ident + 100.0 + 200.0, -np.inf).astype(np.float32),
            total[row], "K2 zero-max row")
    if special == "no feasible node":
        assert int(feas[row]) == 0 and bool(torch.isinf(total[row]).all())
