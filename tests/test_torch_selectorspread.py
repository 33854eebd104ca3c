"""SelectorSpread on the port against the JAX package's.

* The reference's scenario (tests/test_selectorspread.py): two Service
  pods on n0 (zone z0), n1 alone in zone z1 — the exact scan picks n1.
* ``host_prepare``'s counts, zone counts and zone flags equal the
  reference's Python loops on random clusters: Services and ReplicaSets
  (equality and expression selectors) in two namespaces, terminating pods,
  nodes with either zone label key or none, pods with no owner.
* K32's plain version equals the reference's ``score`` under ``jax.jit``
  on random masks and count planes, and at every row maximum 1–399 (the
  multiply-first division, the float32 zone weights and the fused blend).
* The exact scan and the full auction under a profile with the
  store-backed SelectorSpread give the reference's bindings.
"""

from __future__ import annotations

from types import SimpleNamespace as NS

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.plugins as JP
import kubernetes_tpu_torch.plugins as TP
from kubernetes_tpu.framework.podbatch import PodBatchCompiler as JCompiler
from kubernetes_tpu.sim.store import ObjectStore as JStore
from kubernetes_tpu.state.cache import Cache as JCache, Snapshot as JSnapshot
from kubernetes_tpu.state.encoding import ClusterEncoder as JEncoder
from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.api import objects as v1
from kubernetes_tpu_torch.framework.interface import PluginWithWeight as PW
from kubernetes_tpu_torch.framework.podbatch import PodBatchCompiler, batch_to_device
from kubernetes_tpu_torch.framework.runtime import BatchedFramework, initial_dynamic_state
from kubernetes_tpu_torch.kernels.selectorspread import (
    selector_spread_score,
    selector_spread_score_plain,
)
from kubernetes_tpu_torch.sim.store import ObjectStore as TStore
from kubernetes_tpu_torch.state.cache import Cache, Snapshot
from kubernetes_tpu_torch.state.encoding import ClusterEncoder
from kubernetes_tpu_torch.testutil import make_node, make_pod

from test_torch_profiles import profile_cluster, run_profiles


def test_selector_spread_prefers_empty_node():
    store = TStore()
    svc = v1.Service(selector={"app": "web"})
    svc.metadata.name = "web"
    store.create("Service", svc)
    cache = Cache()
    for i in range(3):
        cache.add_node(make_node().name(f"n{i}")
                       .label("topology.kubernetes.io/zone", f"z{i % 2}").obj())
    for i in range(2):  # two service pods already on n0
        cache.add_pod(make_pod().name(f"sp{i}").uid(f"sp{i}").namespace("default")
                      .label("app", "web").req({"cpu": "1"}).node("n0").obj())
    snap = Snapshot()
    cache.update_snapshot(snap)
    enc = ClusterEncoder(device="cpu")
    comp = PodBatchCompiler(enc)
    pod = make_pod().name("p").uid("p").namespace("default").label("app", "web") \
        .req({"cpu": "1"}).obj()
    batch = comp.compile([pod])
    enc.full_sync(snap)
    fw = BatchedFramework([PW(TP.FitPlugin(), 1), PW(TP.SelectorSpreadPlugin(store), 1)])
    host_auxes = fw.host_prepare(batch, snap, enc)
    dsnap = enc.to_device()
    dbatch = batch_to_device(batch, "cpu")
    dyn = initial_dynamic_state(dsnap)
    auxes = fw.prepare(dbatch, dsnap, dyn, host_auxes)
    res = fw.greedy_assign(dbatch, dsnap, dyn, auxes, np.arange(batch.size))
    name_of = {r: n for n, r in enc.node_rows.items()}
    # n0 is crowded (2 service pods, zone z0); n1 shares zone z1 alone → best
    assert name_of[int(res.node_row[0])] == "n1"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_prepare_equals_reference(seed):
    tables = {}
    for pkg in ("jax", "torch"):
        store = JStore() if pkg == "jax" else TStore()
        cache = JCache() if pkg == "jax" else Cache()
        objs, _pending = profile_cluster(pkg, seed, n_nodes=40, n_bound=120)
        pending = []
        for kind, obj in objs:
            if kind == "Node":
                cache.add_node(obj)
            elif kind == "Pod" and obj.spec.node_name:
                cache.add_pod(obj)
            elif kind == "Pod":
                pending.append(obj)
            else:
                store.create(kind, obj)
        snap = JSnapshot() if pkg == "jax" else Snapshot()
        cache.update_snapshot(snap)
        enc = JEncoder() if pkg == "jax" else ClusterEncoder(device="cpu")
        batch = (JCompiler if pkg == "jax" else PodBatchCompiler)(enc).compile(
            pending, pad_to=128)
        enc.full_sync(snap)
        plugin = (JP if pkg == "jax" else TP).SelectorSpreadPlugin(store)
        aux = plugin.host_prepare(batch, snap, enc)
        rows = sorted(enc.node_rows.items())
        cols = [r for _n, r in rows]
        tables[pkg] = {k: np.asarray(aux[k])[..., cols] for k in aux}
        assert [n for n, _r in rows] == sorted(o.metadata.name for k, o in objs
                                                if k == "Node")
    for k in ("counts", "zone_counts", "has_zone"):
        assert tables["jax"][k].dtype == tables["torch"][k].dtype, k
        assert np.array_equal(tables["jax"][k], tables["torch"][k]), k
    counts = tables["torch"]["counts"]
    assert counts.max() > 1 and (counts.sum(axis=1) == 0).any()
    assert tables["torch"]["has_zone"].any() and not tables["torch"]["has_zone"].all()


def _reference_score(counts, zone_counts, has_zone, mask):
    plugin = JP.SelectorSpreadPlugin()
    n = counts.shape[1]
    fn = jax.jit(lambda v, m, a: plugin.score(NS(valid=v), NS(num_nodes=n), None,
                                              aux=a, mask=m))
    return np.asarray(fn(jnp.ones(counts.shape[0], bool), mask,
                         {"counts": counts, "zone_counts": zone_counts,
                          "has_zone": has_zone}))


def _k32_plain(counts, zone_counts, has_zone, mask, weight=1.0):
    """K32's plain version through the wrapper on CPU tensors: the term it
    adds into a zero total, per unit of weight."""
    c, n = counts.shape
    bits = torch.from_numpy(np.where(mask, 7, 3).astype(np.int32))
    total = torch.zeros((c, n), dtype=torch.float32)
    out = selector_spread_score(bits, 7, total, torch.from_numpy(counts),
                                torch.from_numpy(zone_counts), torch.from_numpy(has_zone),
                                weight)
    assert out is total
    return out.numpy() / weight


@pytest.mark.parametrize("seed", [0, 1])
def test_k32_plain_equals_reference_random(seed):
    rng = np.random.default_rng(seed)
    c, n = 256, 1024
    mx = rng.integers(1, 400, c)
    counts = np.floor(rng.random((c, n)) * (mx[:, None] + 1)).astype(np.float32)
    zone = np.floor(rng.random((c, n)) * (3 * mx[:, None] + 1)).astype(np.float32)
    zone[:8] = 0  # rows with no zone counts: the node score alone
    mask = rng.random((c, n)) < 0.7
    mask[8] = False  # an all-masked row adds nothing
    has_zone = rng.random(n) < 0.8
    want = _reference_score(counts, zone, has_zone, mask)
    kernels.reset_launches()
    got = _k32_plain(counts, zone, has_zone, mask)
    assert kernels.LAUNCHES["selector_spread_score"] == 0  # the CPU takes the plain version
    assert np.array_equal(np.where(mask, want, 0.0), got)
    direct = selector_spread_score_plain(torch.from_numpy(mask), torch.from_numpy(counts),
                                         torch.from_numpy(zone), torch.from_numpy(has_zone))
    assert np.array_equal(want[mask], direct.numpy()[mask])
    # weight 2 doubles the floored score (integer terms)
    assert np.array_equal(2.0 * got, _k32_plain(counts, zone, has_zone, mask, 2.0) * 2.0)


def test_k32_plain_equals_reference_at_every_maximum():
    """Rows whose maxima run 1–399 over every count 0..max: the
    multiply-first division and the blend land each floor where the
    reference's do (the reciprocal form flips floors at 24 maxima)."""
    rows_c, rows_z = [], []
    for m in range(1, 400):
        c = np.arange(m + 1, dtype=np.float32)
        rows_c.append(np.pad(c, (0, 400 - c.size)))
        z = np.round(np.linspace(0, 3 * m, m + 1)).astype(np.float32)
        rows_z.append(np.pad(z, (0, 400 - z.size)))
    counts, zone = np.stack(rows_c), np.stack(rows_z)
    mask = np.zeros(counts.shape, bool)
    for i in range(counts.shape[0]):
        mask[i, : i + 2] = True
    has_zone = np.ones(400, bool)
    has_zone[::7] = False
    want = _reference_score(counts, zone, has_zone, mask)
    got = _k32_plain(counts, zone, has_zone, mask)
    assert np.array_equal(np.where(mask, want, 0.0), got)


@pytest.mark.parametrize("assign_mode", ["scan", "batch"])
def test_scan_and_full_auction_bindings_equal_reference(assign_mode):
    """A SelectorSpread profile's batches through the exact scan and the
    full auction (the dedup gate refuses its pod-indexed counts): the
    reference's bindings."""
    want, _ = run_profiles("jax", 4, batch_size=16, assign_mode=assign_mode)
    kernels.reset_launches()
    got, sched = run_profiles("torch", 4, batch_size=16, assign_mode=assign_mode)
    assert got == want
    assert any(got["default-scheduler"].values())
