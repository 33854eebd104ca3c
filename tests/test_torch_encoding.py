"""Encoder parity: the port's ClusterEncoder against the JAX package's.

One seeded cluster goes through both packages' Cache → ClusterEncoder
(full_sync, then sync after churn: adds, deletes, binds, node add/remove).
The numpy mirrors must be byte-equal, the device snapshots from to_device
and from to_device_deferred + apply_scatter must equal ``np.asarray`` of
the JAX ones (a tier above 1024 nodes forces the row-scatter path), and
the compiled PodBatch fields must be equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from kubernetes_tpu.framework.podbatch import PodBatchCompiler as JCompiler
from kubernetes_tpu.state.cache import Cache as JCache, Snapshot as JSnapshot
from kubernetes_tpu.state.encoding import ClusterEncoder as JEncoder
from kubernetes_tpu.state.encoding import apply_scatter as j_apply_scatter
from kubernetes_tpu_torch.framework.podbatch import PodBatchCompiler as TCompiler
from kubernetes_tpu_torch.framework.podbatch import identity_classes as t_identity
from kubernetes_tpu_torch.state.cache import Cache as TCache, Snapshot as TSnapshot
from kubernetes_tpu_torch.state.encoding import (
    SNAPSHOT_FIELDS,
    _AFF_ARRAYS,
    _NODE_ARRAYS,
    _POD_ARRAYS,
)
from kubernetes_tpu_torch.state.encoding import ClusterEncoder as TEncoder
from kubernetes_tpu_torch.state.encoding import apply_scatter as t_apply_scatter

from tests.test_torch_common import (
    make_node_obj,
    make_pod_obj,
    node_descs,
    pod_descs,
    scheduled_descs,
)

MIRRORS = _NODE_ARRAYS + _POD_ARRAYS + _AFF_ARRAYS


class _Side:
    """One package's cache + snapshot + encoder, driven by descriptions."""

    def __init__(self, pkg, nodes, sched):
        self.pkg = pkg
        if pkg == "jax":
            self.cache, self.snap, self.enc = JCache(), JSnapshot(), JEncoder()
        else:
            self.cache, self.snap = TCache(), TSnapshot()
            self.enc = TEncoder(device="cpu")
        self.pods = {}
        for d in nodes:
            self.cache.add_node(make_node_obj(pkg, d))
        for d in sched:
            self.add_pod(d)

    def add_pod(self, d):
        pod = make_pod_obj(self.pkg, d)
        self.pods[d["name"]] = pod
        self.cache.add_pod(pod)

    def sync(self, full=False):
        changed = self.cache.update_snapshot(self.snap)
        if full:
            self.enc.full_sync(self.snap)
        else:
            self.enc.sync(self.snap, changed)


def _assert_mirrors_equal(j, t):
    for k in MIRRORS:
        a, b = getattr(j.enc, k), getattr(t.enc, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert j.enc.node_rows == t.enc.node_rows
    assert j.enc.pod_rows == t.enc.pod_rows
    assert j.enc.topo_value_maps == t.enc.topo_value_maps
    assert len(j.enc.dic) == len(t.enc.dic)
    assert [j.enc.dic.string(i) for i in range(len(j.enc.dic))] == \
        [t.enc.dic.string(i) for i in range(len(t.enc.dic))]


def _assert_snapshot_equal(jd, td):
    for k in SNAPSHOT_FIELDS:
        a = np.asarray(getattr(jd, k))
        b = getattr(td, k).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def _churn(side, rng_seed, node_names, extra_nodes, prefix):
    """The same mutation sequence on either side (derived from a seed)."""
    rng = np.random.default_rng(rng_seed)
    new = pod_descs(rng, 24, prefix=prefix, start_ts=500.0)
    for i, d in enumerate(new):
        pod = make_pod_obj(side.pkg, d)
        side.pods[d["name"]] = pod
        side.cache.assume_pod(pod, node_names[(7 * i) % len(node_names)])
    names = sorted(side.pods)
    for name in names[::5]:  # deletes (scheduled and assumed pods)
        side.cache.remove_pod(side.pods.pop(name))
    for name in sorted(side.pods)[::3]:  # binds confirm assumed pods
        pod = side.pods[name]
        if side.cache.is_assumed(pod):
            side.cache.finish_binding(pod)
    for d in extra_nodes:
        side.cache.add_node(make_node_obj(side.pkg, d))
    side.cache.remove_node(node_names[len(prefix)])


@pytest.mark.parametrize("n_nodes", [40, 1100])
def test_encoder_mirrors_and_snapshots_equal(n_nodes):
    rng = np.random.default_rng(11 + n_nodes)
    nodes = node_descs(rng, n_nodes)
    names = [d["name"] for d in nodes]
    sched = scheduled_descs(rng, 3 * n_nodes // 4, names)
    extra = node_descs(np.random.default_rng(5), 6)
    for d in extra:
        d["name"] = "x" + d["name"]
    j, t = _Side("jax", nodes, sched), _Side("torch", nodes, sched)
    j.sync(full=True)
    t.sync(full=True)
    _assert_mirrors_equal(j, t)
    # full upload
    _assert_snapshot_equal(j.enc.to_device(), t.enc.to_device())
    _assert_mirrors_equal(j, t)

    # eager upload after churn: row scatters above the small-node tier
    for side in (j, t):
        _churn(side, 3, names, extra[:3], prefix="c")
        side.sync()
    _assert_mirrors_equal(j, t)
    _assert_snapshot_equal(j.enc.to_device(), t.enc.to_device())

    # deferred upload after more churn: the payload applied afterwards
    for side in (j, t):
        _churn(side, 4, names, extra[3:], prefix="cc")
        side.sync()
    _assert_mirrors_equal(j, t)
    jd, jupd = j.enc.to_device_deferred()
    td, tupd = t.enc.to_device_deferred()
    # tiers ≤ 1024 nodes take the full upload, larger ones the scatter
    assert (jupd is None) == (tupd is None) == (n_nodes <= 1024)
    jd2 = j_apply_scatter(jd, jupd)
    td2 = t_apply_scatter(td, tupd)
    _assert_snapshot_equal(jd2, td2)
    j.enc.commit_device(jd2)
    t.enc.commit_device(td2)
    # and the scattered snapshot equals a fresh full upload of the mirrors
    _assert_snapshot_equal(jd2, t.enc.to_device(force_full=True))


def test_podbatch_compile_equal():
    rng = np.random.default_rng(4)
    nodes = node_descs(rng, 24)
    j, t = _Side("jax", nodes, []), _Side("torch", nodes, [])
    j.sync(full=True)
    t.sync(full=True)
    pods = pod_descs(rng, 40)
    jpods = [make_pod_obj("jax", d) for d in pods]
    tpods = [make_pod_obj("torch", d) for d in pods]
    # one nominated pod resolves its node row at compile time
    jpods[3].status.nominated_node_name = nodes[5]["name"]
    tpods[3].status.nominated_node_name = nodes[5]["name"]
    jb = JCompiler(j.enc).compile(jpods, pad_to=64)
    tb = TCompiler(t.enc).compile(tpods, pad_to=64)

    def flat(obj, prefix=""):
        out = {}
        for f in dataclasses.fields(obj):
            if f.name == "pods":
                continue
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                out.update(flat(v, prefix + f.name + "."))
            else:
                out[prefix + f.name] = v
        return out

    fj, ft = flat(jb), flat(tb)
    assert fj.keys() == ft.keys()
    for k in fj:
        a, b = fj[k], ft[k]
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
        else:
            assert a == b, k
    from kubernetes_tpu.framework.podbatch import identity_classes as j_identity

    cj, rj = j_identity(jb)
    ct, rt = t_identity(tb)
    assert np.array_equal(cj, ct) and np.array_equal(rj, rt)
    # take() gathers the same rows on host arrays and on tensors
    from kubernetes_tpu_torch.framework.podbatch import batch_to_device

    dev = batch_to_device(tb, "cpu")
    rows = torch.from_numpy(rt.astype(np.int64))
    took = dev.take(rows)
    assert np.array_equal(took.request.numpy(), jb.take(rj).request)
    assert np.array_equal(took.node_affinity.index.numpy(),
                          jb.take(rj).node_affinity.index)
