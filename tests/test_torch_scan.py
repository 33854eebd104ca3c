"""The exact serial scan on the port against the JAX package (exact).

* B9: the port's ``greedy_assign`` against the JAX package's jitted
  ``greedy_assign`` on the JAX encoder's arrays (through convert.py):
  ``node_row``, ``feasible_count``, the final ``requested`` / ``non_zero``
  and the step count, on a heterogeneous batch with nominated rows (one
  feasible, one not), pods that fit nowhere and padding rows; spread
  batches of 3 and 5 zones (DoNotSchedule, ScheduleAnyway, minDomains, two
  constraints, keyless nodes) and the count-379 case under five zones; and
  affinity batches with all four term groups, an existing-pod host aux and
  the first-pod escape, in the count-tables and count-planes forms.  The
  scan leaves its inputs unchanged.
* The per-pod halves the engines run, on one aux, against the JAX
  package's hooks: PodTopologySpread's and InterPodAffinity's
  ``filter_bits`` / ``score_into`` on pod i's ``row`` against
  ``filter_row`` / ``score_row`` (normalized, floored, weighted),
  ``update`` (a chain of placements, keyless nodes among them, every aux
  field equal after each; a pod that was not placed changes nothing) and
  ``update_batch_classes`` at identity classes against ``update_batch``
  (rounds of random commits); K1 over one pod's row against Fit's and
  BalancedAllocation's ``filter_row`` / ``score_row``.
* The scan reads nothing from the device between its first step and its
  last: no ``.item()``, ``bool(tensor)`` or other host conversion of a
  tensor there.
* End to end: TorchScheduler(device="cpu") against TPUScheduler with
  ``assign_mode="scan"`` and under ``"auto"`` where the router itself
  scans (coupled priority-10 batches), synchronous and pipelined at depth
  2 and 3: the same node for every pod, the same engine for every
  dispatch and the same step count.

Tolerance: exact everywhere (integer tables, integer-valued float scores,
NaN where the reference has NaN).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu_torch.framework.runtime as truntime
from kubernetes_tpu.framework.podbatch import PodBatchCompiler as JCompiler
from kubernetes_tpu.framework.runtime import BatchedFramework as JFramework
from kubernetes_tpu.framework.runtime import initial_dynamic_state
from kubernetes_tpu.scheduler import default_plugins as j_default_plugins
from kubernetes_tpu.state.cache import Cache as JCache, Snapshot as JSnapshot
from kubernetes_tpu.state.encoding import ClusterEncoder as JEncoder
from kubernetes_tpu_torch.convert import batch_from_numpy, dyn_from_numpy, snapshot_from_numpy
from kubernetes_tpu_torch.framework.runtime import BatchedFramework as TFramework
from kubernetes_tpu_torch.kernels.filter_score import RAW_PLANES, filter_score_planes, pod_row
from kubernetes_tpu_torch.scheduler import default_plugins as t_default_plugins
from kubernetes_tpu_torch.state.encoding import live_nodes

from tests.test_torch_affinity import _nodes as _aff_nodes
from tests.test_torch_affinity import _scheduled as _aff_scheduled
from tests.test_torch_affinity import _templates as _aff_templates
from tests.test_torch_common import (
    check_engine_parity,
    make_node_obj,
    make_pod_obj,
    node_descs,
    pod_descs,
    scheduled_descs,
)
from tests.test_torch_plugins import batch_arrays, snapshot_arrays
from tests.test_torch_spread import _spread_templates, _zone_nodes

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def _eq(a, b, what):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), (what, np.argwhere(a != b)[:5])


def build(nodes, sched, pods, pad_to=32, nominated=None):
    """The JAX problem (encoder, batch, snapshot, dyn, host auxes) and the
    same inputs carried over into the port; ``nominated`` maps pod names to
    the node each is nominated to."""
    cache = JCache()
    for d in nodes:
        cache.add_node(make_node_obj("jax", d))
    for d in sched:
        cache.add_pod(make_pod_obj("jax", d))
    snap = JSnapshot()
    cache.update_snapshot(snap)
    enc = JEncoder()
    enc.full_sync(snap)
    objs = [make_pod_obj("jax", d) for d in pods]
    for pod in objs:
        if pod.metadata.name in (nominated or {}):
            pod.status.nominated_node_name = nominated[pod.metadata.name]
    hbatch = JCompiler(enc).compile(objs, pad_to=pad_to)
    fw = JFramework(j_default_plugins(enc.domain_cap))
    host_auxes = fw.host_prepare(hbatch, snap, enc)
    batch = jax.tree_util.tree_map(jnp.asarray, hbatch)
    dsnap = enc.to_device()
    dyn = initial_dynamic_state(dsnap)
    return dict(
        fw=fw, enc=enc, hbatch=hbatch, batch=batch, dsnap=dsnap, dyn=dyn,
        host_auxes=host_auxes,
        thost={"InterPodAffinity": host_auxes.get("InterPodAffinity")},
        tfw=TFramework(t_default_plugins(enc.domain_cap)),
        tbatch=batch_from_numpy(batch_arrays(batch), device="cpu"),
        tsnap=snapshot_from_numpy(snapshot_arrays(dsnap), device="cpu"),
        tdyn=dyn_from_numpy({"requested": np.asarray(dyn.requested),
                             "non_zero": np.asarray(dyn.non_zero)}, device="cpu"))


def _plain():
    """Heterogeneous nodes and the eight pod templates (one fits nowhere),
    30 pods in a 32-row batch, two of them nominated: p0001 to a node where
    it fits, p0002 to an unschedulable node."""
    rng = np.random.default_rng(21)
    nodes = node_descs(rng, 40)
    names = [d["name"] for d in nodes]
    nodes[7].update(unschedulable=True)
    pods = pod_descs(rng, 30)
    pods[1] = {"name": pods[1]["name"], "ts": pods[1]["ts"],
               "req": {"cpu": "100m", "memory": "100Mi"}}
    nodes[3].update(taints=[], unschedulable=False, not_ready=False)
    return build(nodes, scheduled_descs(rng, 20, names), pods,
                 nominated={"p0001": names[3], "p0002": names[7]})


def _spread(zones, seed):
    rng = np.random.default_rng(seed)
    nodes = _zone_nodes(30, zones, keyless=(4, 17))
    names = [d["name"] for d in nodes]
    sched = [{"name": f"s{i:03d}", "ts": -500.0 + i, "req": {"cpu": "100m"},
              "labels": {"color": str(rng.choice(["blue", "red", "green"]))},
              "node": names[int(rng.integers(len(names)))]} for i in range(45)]
    temps = _spread_templates()
    pods = [dict(temps[int(rng.integers(len(temps)))], name=f"p{i:03d}", ts=float(i))
            for i in range(24)]
    return build(nodes, sched, pods)


def _spread379():
    """379 blue pods in one of five zones; ScheduleAnyway pods selecting
    blue: the raw score there is round(379 · log 7) with XLA:CPU's log."""
    nodes = _zone_nodes(20, 5)
    zone0 = [d["name"] for d in nodes if d["labels"][ZONE] == "moon-0"]
    sched = [{"name": f"s{i:03d}", "ts": -1000.0 + i, "req": {"cpu": "1m"},
              "labels": {"color": "blue"}, "node": zone0[i % len(zone0)]}
             for i in range(379)]
    pods = [{"name": f"p{i}", "ts": float(i), "req": {"cpu": "100m"},
             "labels": {"color": "red"},
             "spread": [(1, ZONE, "ScheduleAnyway", {"color": "blue"}, None)]}
            for i in range(6)]
    return build(nodes, sched, pods, pad_to=8)


def _affinity(form, seed):
    rng = np.random.default_rng(seed)
    key = ZONE if form == "tables" else HOST
    nodes = _aff_nodes(30, keyless=(4, 17))
    names = [d["name"] for d in nodes]
    temps = _aff_templates(key)
    pods = [dict(temps[int(rng.integers(len(temps)))], name=f"p{i:03d}", ts=float(i))
            for i in range(24)]
    pods[0] = dict(temps[4], name="p000", ts=0.0)  # the first-pod escape
    return build(nodes, _aff_scheduled(rng, names, 40, key=key), pods)


PROBLEMS = {
    "plain": _plain,
    "spread_3zones": lambda: _spread(3, 0),
    "spread_5zones": lambda: _spread(5, 1),
    "spread_379": _spread379,
    "affinity_tables": lambda: _affinity("tables", 0),
    "affinity_planes": lambda: _affinity("planes", 1),
}


def _index(fw, name):
    return next(i for i, pw in enumerate(fw.plugins) if pw.plugin.name == name)


@pytest.fixture(scope="module", params=list(PROBLEMS))
def scanned(request):
    p = PROBLEMS[request.param]()
    b = p["hbatch"].size
    jauxes = p["fw"].prepare(p["batch"], p["dsnap"], p["dyn"], p["host_auxes"])
    jres = jax.jit(p["fw"].greedy_assign)(p["batch"], p["dsnap"], p["dyn"], jauxes,
                                         jnp.arange(b), None)
    tauxes = p["tfw"].prepare(p["tbatch"], p["tsnap"], p["tdyn"], p["thost"])
    before = [None if a is None else {f: v.clone() for f, v in a._asdict().items()
                                      if isinstance(v, torch.Tensor)} for a in tauxes]
    req0 = p["tdyn"].requested.clone()
    tres = p["tfw"].greedy_assign(p["tbatch"], p["tsnap"], p["tdyn"], tauxes, np.arange(b))
    return request.param, p, jres, tres, tauxes, before, req0


def test_greedy_assign_equals_reference(scanned):
    kind, p, jres, tres, tauxes, before, req0 = scanned
    _eq(jres.node_row, tres.node_row, "node_row")
    _eq(jres.feasible_count, tres.feasible_count, "feasible_count")
    _eq(jres.dyn.requested, tres.dyn.requested, "requested")
    _eq(jres.dyn.non_zero, tres.dyn.non_zero, "non_zero")
    assert int(jres.rounds) == tres.rounds == int(np.asarray(p["hbatch"].valid).sum())
    # the scan worked on copies: the dynamic state and the auxes are as prepared
    _eq(req0, p["tdyn"].requested, "input requested")
    for aux, fields in zip(tauxes, before):
        for f, v in (fields or {}).items():
            _eq(v, getattr(aux, f), f"input aux {f}")
    rows = tres.node_row.numpy()
    valid = np.asarray(p["hbatch"].valid)
    assert (rows[~valid] == -1).all() and (rows[valid] >= 0).any()
    if kind == "plain":
        names = p["enc"].node_rows
        assert rows[1] == names["n0003"]  # the nominated node, taken
        assert rows[2] != names["n0007"]  # an unschedulable nominated node is not
        assert (rows[valid] == -1).any()  # the 64-cpu template fits nowhere
    if kind != "spread_379":  # (ScheduleAnyway alone filters nothing)
        # the constraints bite: the feasible counts differ between the pods
        assert len(set(tres.feasible_count.numpy()[valid].tolist())) > 1


# --- the per-pod hooks ----------------------------------------------------------------


@pytest.fixture(scope="module", params=["spread_3zones", "affinity_tables", "affinity_planes"])
def hook_problem(request):
    return request.param, PROBLEMS[request.param]()


def _plugin(p, kind):
    name = "PodTopologySpread" if kind.startswith("spread") else "InterPodAffinity"
    idx = _index(p["fw"], name)
    jaux = p["fw"].prepare(p["batch"], p["dsnap"], p["dyn"], p["host_auxes"])[idx]
    tplug = p["tfw"].plugins[idx].plugin
    taux = tplug.engine_copy(p["tfw"].prepare(p["tbatch"], p["tsnap"], p["tdyn"],
                                              p["thost"])[idx])
    return p["fw"].plugins[idx].plugin, jaux, tplug, taux


def _aux_eq(jaux, taux, what):
    for f in jaux._fields:
        _eq(getattr(jaux, f), getattr(taux, f), f"{f} {what}")


def test_row_hooks_equal_reference(hook_problem):
    """The scan's per-step filter and score of a coupled plugin — its
    ``filter_bits`` and ``score_into`` (K6 / K7, K10 / K11) on pod i's
    ``row`` — equal the reference's ``filter_row`` and its ``score_row``
    normalized, floored and weighted, as its greedy_assign folds them."""
    kind, p = hook_problem
    jplug, jaux, tplug, taux = _plugin(p, kind)
    weight = float(p["tfw"].plugins[_index(p["fw"], tplug.name)].weight)
    rng = np.random.default_rng(3)
    n = p["tsnap"].num_nodes
    bit, full = 3, 0b1111
    for i in range(0, 24, 5):
        row = tplug.row(taux, i)
        bits = torch.full((1, n), full, dtype=torch.int32)
        tplug.filter_bits(row, bits, bit)
        _eq(jplug.filter_row(p["batch"], p["dsnap"], p["dyn"], jaux, i),
            (bits[0] >> bit) & 1 == 1, f"filter_row {i}")
        mask = rng.random(n) < 0.7
        raw = jplug.score_row(p["batch"], p["dsnap"], p["dyn"], jaux, i,
                              mask_row=jnp.asarray(mask))
        want = weight * jnp.floor(jplug.normalize(raw[None, :], jnp.asarray(mask)[None, :]))
        total = torch.zeros((1, n), dtype=torch.float32)
        tplug.score_into(row, torch.where(torch.from_numpy(mask), full, 0)[None, :]
                         .to(torch.int32), full, total, weight)
        _eq(np.where(mask, want[0], 0.0), torch.where(torch.from_numpy(mask), total[0], 0.0),
            f"score_row {i}")


def test_update_equals_reference(hook_problem):
    """A chain of placements through ``update`` — live rows, keyless rows —
    every aux field equal after each; a pod not placed changes nothing."""
    kind, p = hook_problem
    jplug, jaux, tplug, taux = _plugin(p, kind)
    rng = np.random.default_rng(4)
    live = np.asarray(p["tsnap"].node_valid).nonzero()[0]
    keyless = [p["enc"].node_rows[f"n{k:04d}"] for k in (4, 17)]
    valid = np.asarray(p["hbatch"].valid).nonzero()[0]
    for step, i in enumerate(valid.tolist()):
        node = int(keyless[step % 2]) if step % 3 == 2 else int(live[rng.integers(len(live))])
        jaux = jplug.update(jaux, i, jnp.int32(node), p["batch"], p["dsnap"])
        tplug.update(taux, i, torch.tensor([node], dtype=torch.int32), p["tbatch"],
                     p["tsnap"])
        _aux_eq(jaux, taux, f"after update {step} (pod {i}, node {node})")
    snapshot = {f: v.clone() for f, v in taux._asdict().items() if isinstance(v, torch.Tensor)}
    tplug.update(taux, int(valid[0]), -1, p["tbatch"], p["tsnap"])
    for f, v in snapshot.items():
        _eq(v, getattr(taux, f), f"{f} after an unplaced pod")
    if kind.startswith("affinity"):
        assert bool(taux.block_dyn.any()) and bool((taux.score_dyn != 0).any())
    else:
        assert not np.array_equal(np.asarray(p["fw"].prepare(
            p["batch"], p["dsnap"], p["dyn"], p["host_auxes"])[_index(
                p["fw"], "PodTopologySpread")].hard_counts), taux.hard_counts.numpy())


def test_update_batch_equals_reference(hook_problem):
    """Rounds of commits through ``update_batch_classes`` at identity
    classes (the full auction's round update) against the reference's
    ``update_batch`` on its commit one-hot."""
    kind, p = hook_problem
    jplug, jaux, tplug, taux = _plugin(p, kind)
    rng = np.random.default_rng(6)
    b, n = p["hbatch"].size, p["tsnap"].num_nodes
    live = np.asarray(p["tsnap"].node_valid).nonzero()[0]
    for r in range(3):
        commit = (rng.random(b) < 0.4) & np.asarray(p["hbatch"].valid)
        choice = live[rng.integers(0, len(live), size=b)].astype(np.int32)
        u = ((choice[:, None] == np.arange(n)[None, :]) & commit[:, None]).astype(np.float32)
        jaux = jplug.update_batch(jaux, jnp.asarray(commit), jnp.asarray(choice),
                                  jnp.asarray(u), p["batch"], p["dsnap"])
        tplug.update_batch_classes(taux, torch.from_numpy(commit), torch.from_numpy(choice),
                                   torch.arange(b))
        _aux_eq(jaux, taux, f"after round {r}")


def test_resource_row_hooks_equal_reference():
    """The scan's per-step K1 over pod i's one row (``pod_row``) gives Fit's
    bit and Fit's and BalancedAllocation's raw planes equal to the
    reference's ``filter_row`` / ``score_row`` (on live nodes: K1 clears
    every bit elsewhere)."""
    p = PROBLEMS["plain"]()
    tfw = p["tfw"]
    fs_plan, _ = tfw.kernel_plans()
    na_mask, na_pref, img = tfw.static_inputs(p["tbatch"], p["tsnap"], p["tdyn"])
    live = live_nodes(p["tsnap"]).numpy()
    fit_bit = fs_plan.bit_of["NodeResourcesFit"]
    for i in (0, 1, 5, 29):
        bits, raw = filter_score_planes(pod_row(p["tbatch"], i), p["tsnap"], p["tdyn"],
                                        na_mask[i:i + 1], na_pref[i:i + 1], img, fs_plan)
        for name in ("NodeResourcesFit", "NodeResourcesBalancedAllocation"):
            jplug = p["fw"].plugins[_index(p["fw"], name)].plugin
            if name == "NodeResourcesFit":
                want = np.asarray(jplug.filter_row(p["batch"], p["dsnap"], p["dyn"], None, i))
                _eq(want & live & bool(np.asarray(p["hbatch"].valid)[i]),
                    (bits[0] >> fit_bit) & 1 == 1, f"{name} filter_row {i}")
            _eq(jplug.score_row(p["batch"], p["dsnap"], p["dyn"], None, i),
                raw[RAW_PLANES.index(name), 0], f"{name} score_row {i}")


# --- no read on the host inside the scan ----------------------------------------------

_READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")


@pytest.mark.parametrize("kind", ["spread_5zones", "affinity_planes"])
def test_scan_reads_nothing_on_the_host_between_steps(kind, monkeypatch):
    """Every host conversion of a tensor is counted; the count at the first
    step's start equals the count after the last step's update."""
    p = PROBLEMS[kind]()
    tauxes = p["tfw"].prepare(p["tbatch"], p["tsnap"], p["tdyn"], p["thost"])
    reads = [0]
    for name in _READS:
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **kw):
            reads[0] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    marks = []
    orig_planes = truntime.filter_score_planes
    orig_apply = TFramework._apply_dynamic

    def planes(*a, **kw):
        marks.append(("step", reads[0]))
        return orig_planes(*a, **kw)

    def apply_dynamic(*a, **kw):
        out = orig_apply(*a, **kw)
        marks.append(("updated", reads[0]))
        return out

    monkeypatch.setattr(truntime, "filter_score_planes", planes)
    monkeypatch.setattr(TFramework, "_apply_dynamic", staticmethod(apply_dynamic))
    b = p["hbatch"].size
    p["tfw"].greedy_assign(p["tbatch"], p["tsnap"], p["tdyn"], tauxes, np.arange(b))
    monkeypatch.undo()
    steps = int(np.asarray(p["hbatch"].valid).sum())
    assert [m for m, _ in marks] == ["step", "updated"] * steps
    assert marks[0][1] == marks[-1][1], f"{marks[-1][1] - marks[0][1]} host reads in the scan"
    assert reads[0] >= 1  # the one read before the first step: the valid rows


# --- end to end -------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["hetero", "spread10", "affinity10", "preferred10"])
def test_scan_mode_bindings_equal_reference(kind, monkeypatch):
    """assign_mode="scan": every batch through the exact scan."""
    check_engine_parity(kind, monkeypatch, {"scan"}, assign_mode="scan")


@pytest.mark.parametrize("kind", ["spread10", "affinity10", "preferred10"])
def test_router_scans_coupled_priority_batches(kind, monkeypatch):
    """Under "auto" a coupled batch with pods that could preempt and one
    component over the threshold goes to the scan, as in the reference."""
    check_engine_parity(kind, monkeypatch, {"scan"})


@pytest.mark.parametrize("kind,depth,mode", [("spread10", 3, "auto"),
                                             ("preferred10", 2, "scan"),
                                             ("affinity10", 3, "scan")])
def test_pipelined_scan_bindings_equal_reference(kind, depth, mode, monkeypatch):
    """The pipelined scheduler over scan batches, the affinity chain on: the
    reference's bindings and routes at depth 2 and 3."""
    check_engine_parity(kind, monkeypatch, {"scan"}, assign_mode=mode, pipeline=True,
                        pipeline_depth=depth, chain_affinity=True)
