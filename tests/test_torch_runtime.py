"""Dedup-engine parity: the port's ``_batch_assign_dedup`` against the JAX
package's, on the JAX encoder's arrays (through convert.py).

node_row, feasible_count, rounds and the final dynamic state must be
equal, and so must the diagnosis bits, their [3, B] packing, and
``gang_all_or_nothing`` — for uncoupled batches and for a coupled
topology-spread batch whose class count tables ride the rounds.  The shapes follow the JAX package's
tests/test_batch_assign.py dedup tests: multi-round contention where every
node is claimed, tie-heavy identical nodes, templates that fit nowhere,
and a nominated pod.  On the CPU the engine runs each kernel's plain
version; the K3 plain version is also held against ``jax.lax.top_k``.
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
from kubernetes_tpu.framework.runtime import coupling_flags, initial_dynamic_state
from kubernetes_tpu.gang import gang_all_or_nothing as j_gang
from kubernetes_tpu.scheduler import _unpack_diag as j_unpack_diag
from kubernetes_tpu.scheduler import default_plugins as j_default_plugins
from kubernetes_tpu.state.cache import Cache as JCache, Snapshot as JSnapshot
from kubernetes_tpu.state.encoding import ClusterEncoder as JEncoder
from kubernetes_tpu_torch.convert import (
    batch_from_numpy,
    dyn_from_numpy,
    snapshot_from_numpy,
)
from kubernetes_tpu_torch.framework.runtime import BatchedFramework as TFramework
from kubernetes_tpu_torch.framework.runtime import (
    diagnose_bits_from_plane,
    pack_diag,
)
from kubernetes_tpu_torch.gang import gang_all_or_nothing as t_gang
from kubernetes_tpu_torch.kernels.topk import topk_rows_plain
from kubernetes_tpu_torch.scheduler import default_plugins as t_default_plugins

from tests.test_torch_common import (
    make_node_obj,
    make_pod_obj,
    node_descs,
    scheduled_descs,
)
from tests.test_torch_plugins import batch_arrays, snapshot_arrays


def _uniform_nodes(n, cpu="4"):
    return [{"name": f"n{i:02d}", "cpu": cpu, "memory": "16Gi", "pods": "110",
             "labels": {"slot": f"s{i}"}, "taints": [], "images": [],
             "unschedulable": False, "not_ready": False} for i in range(n)]


def _pods(template, n, prefix, ts0=0.0, labels=None):
    return [dict(template, name=f"{prefix}{i}", ts=ts0 + i, labels=labels or {})
            for i in range(n)]


def _run_both(nodes, sched, pods, nominated=None):
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
    for name, node in (nominated or {}).items():
        next(p for p in objs if p.metadata.name == name) \
            .status.nominated_node_name = node
    hbatch = JCompiler(enc).compile(objs, pad_to=64)
    fw = JFramework(j_default_plugins(enc.domain_cap))
    host_auxes = fw.host_prepare(hbatch, snap, enc)
    dsnap = enc.to_device()
    dyn = initial_dynamic_state(dsnap)
    class_of, reps = identity_classes(hbatch)
    cpad = max(4, 1 << (len(reps) - 1).bit_length())
    rep_rows = np.full(cpad, reps[0], dtype=np.int32)
    rep_rows[: len(reps)] = reps
    coupling = coupling_flags(hbatch)
    assert not np.asarray(coupling.reads).any()
    rep_host = {k: (v if v is None or k != "Coscheduling" else (v[0], v[1][rep_rows]))
                for k, v in host_auxes.items()}

    def run(batch, dsnap, dyn, order, coupling, class_of, rep_rows):
        auxes = fw.prepare(batch, dsnap, dyn, host_auxes)
        rb = batch.take(rep_rows)
        ra = fw.prepare(rb, dsnap, dyn, rep_host)
        res = fw.batch_assign(batch, dsnap, dyn, auxes, order, coupling,
                              classes=(class_of, rb, ra))
        bits = fw.diagnose_bits(rb, dsnap, dyn, ra)[class_of]
        return res, bits

    batch = jax.tree_util.tree_map(jnp.asarray, hbatch)
    jres, jbits = jax.jit(run)(batch, dsnap, dyn, jnp.arange(hbatch.size),
                               coupling, class_of, rep_rows)

    tsnap = snapshot_from_numpy(snapshot_arrays(dsnap), device="cpu")
    tbatch = batch_from_numpy(batch_arrays(batch), device="cpu")
    tdyn = dyn_from_numpy({"requested": np.asarray(dyn.requested),
                           "non_zero": np.asarray(dyn.non_zero)}, device="cpu")
    tfw = TFramework(t_default_plugins(enc.domain_cap))
    b = hbatch.size
    trep = tbatch.take(torch.from_numpy(rep_rows.astype(np.int64)))
    class_t = torch.from_numpy(class_of.astype(np.int64))
    tres = tfw._batch_assign_dedup(
        tbatch, tsnap, tdyn, None, torch.arange(b), coupling, (class_t, trep, None))
    tbits = diagnose_bits_from_plane(tres.diag_plane, len(tfw.filter_names))[class_t]
    return jres, np.asarray(jbits), tres, tbits, enc


def _assert_equal(jres, jbits, tres, tbits):
    assert np.array_equal(np.asarray(jres.node_row), tres.node_row.numpy())
    assert np.array_equal(np.asarray(jres.feasible_count), tres.feasible_count.numpy())
    assert int(jres.rounds) == int(tres.rounds)
    assert np.array_equal(np.asarray(jres.dyn.requested), tres.dyn.requested.numpy())
    assert np.array_equal(np.asarray(jres.dyn.non_zero), tres.dyn.non_zero.numpy())
    assert np.array_equal(jbits, tbits.numpy())
    # the packed [3, B] fetch decodes to the same rows / bits / rounds
    packed = pack_diag(tbits, tres.node_row, tres.rounds).numpy()
    assert np.array_equal(packed[0], np.asarray(jres.node_row))
    assert np.array_equal(j_unpack_diag(packed[1], jbits.shape[1]), jbits)
    assert (packed[2] == int(jres.rounds)).all()


def test_dedup_matches_under_contention():
    """20 identical + 4 second-template pods over 24 nodes: multi-round
    contention where every node is claimed."""
    rng = np.random.default_rng(7)
    nodes = node_descs(rng, 24, taints=False, images=False)
    for d in nodes:
        d.update(unschedulable=False, not_ready=False)
    sched = scheduled_descs(rng, 8, [d["name"] for d in nodes])
    pods = _pods({"req": {"cpu": "1", "memory": "1Gi"}}, 20, "p", labels={"app": "web"})
    pods += _pods({"req": {"cpu": "2", "memory": "1Gi"}}, 4, "q", 100.0,
                  labels={"app": "db"})
    jres, jbits, tres, tbits, _ = _run_both(nodes, sched, pods)
    _assert_equal(jres, jbits, tres, tbits)
    assert (tres.node_row.numpy()[:24] >= 0).all()


def test_dedup_matches_tie_heavy_identical_nodes():
    """Identical nodes: every candidate ties, so the (value desc, row asc)
    order alone decides; 48 pods on 12 four-cpu nodes take several rounds."""
    nodes = _uniform_nodes(12)
    pods = _pods({"req": {"cpu": "1", "memory": "1Gi"}}, 48, "p")
    jres, jbits, tres, tbits, _ = _run_both(nodes, [], pods)
    _assert_equal(jres, jbits, tres, tbits)
    assert int(tres.rounds) > 1


def test_dedup_matches_failures_and_nominated():
    """Unschedulable rows (-1) and the nominated-node fast path."""
    nodes = _uniform_nodes(6)
    pods = _pods({"req": {"cpu": "3", "memory": "1Gi"}}, 8, "p")
    pods += _pods({"req": {"cpu": "64", "memory": "1Gi"}}, 3, "x", 50.0)
    pods += _pods({"req": {"cpu": "1", "memory": "1Gi"}}, 1, "nom", 90.0)
    jres, jbits, tres, tbits, enc = _run_both(nodes, [], pods,
                                              nominated={"nom0": "n04"})
    _assert_equal(jres, jbits, tres, tbits)
    rows = tres.node_row.numpy()
    assert (rows[8:11] == -1).all()
    assert rows[11] == enc.node_rows["n04"]
    # the 64-cpu rows fail on NodeResourcesFit only
    assert not jbits[8].all() and jbits[8].sum() == jbits.shape[1] - 1


@pytest.mark.parametrize("seed", [0, 1])
def test_dedup_matches_heterogeneous(seed):
    """Mixed templates over a heterogeneous cluster (taints, selectors,
    affinity, ports, images, unschedulable and NotReady nodes)."""
    from tests.test_torch_common import pod_descs

    rng = np.random.default_rng(100 + seed)
    nodes = node_descs(rng, 40)
    sched = scheduled_descs(rng, 25, [d["name"] for d in nodes])
    pods = pod_descs(rng, 56)
    jres, jbits, tres, tbits, _ = _run_both(nodes, sched, pods)
    _assert_equal(jres, jbits, tres, tbits)


def test_gang_all_or_nothing_equal():
    rng = np.random.default_rng(3)
    for _ in range(20):
        b = 32
        node_row = rng.integers(-1, 10, size=b).astype(np.int32)
        seg = rng.integers(-1, 6, size=b).astype(np.int32)
        j = np.asarray(j_gang(jnp.asarray(node_row), jnp.asarray(seg)))
        t = t_gang(torch.from_numpy(node_row), torch.from_numpy(seg)).numpy()
        assert np.array_equal(j, t)


def test_topk_plain_matches_lax_top_k():
    """(value desc, row asc) with ties and −inf rows, as lax.top_k orders."""
    rng = np.random.default_rng(9)
    rows = [
        rng.integers(0, 5, size=300).astype(np.float32),      # heavy ties
        np.full(300, -np.inf, dtype=np.float32),              # all infeasible
        np.where(rng.random(300) < 0.7, -np.inf,
                 rng.integers(0, 3, size=300)).astype(np.float32),
        rng.standard_normal(300).astype(np.float32),
    ]
    eff = np.stack(rows)
    for k in (1, 64, 300):
        jv, ji = jax.lax.top_k(jnp.asarray(eff), k)
        tv, ti = topk_rows_plain(torch.from_numpy(eff), k)
        assert np.array_equal(np.asarray(jv), tv.numpy())
        # −inf entries carry no placement; their order is pinned where the
        # values are finite
        finite = np.isfinite(np.asarray(jv))
        assert np.array_equal(np.asarray(ji)[finite], ti.numpy()[finite])


def test_topk_plain_matches_lax_top_k_at_k1024():
    """K = 1024 over N = 5000 with the K-th value tied across hundreds of
    columns (512 larger values scattered, a run of 600 equal values in the
    middle; one row with −inf holes below them): values and columns equal
    lax.top_k's, ties by ascending column."""
    rng = np.random.default_rng(10)
    n, k = 5000, 1024
    rows = []
    for _ in range(3):
        row = rng.integers(0, 3, size=n).astype(np.float32)
        row[rng.permutation(n)[: k // 2]] = 10.0
        row[n // 2 - 300: n // 2 + 300] = 5.0
        rows.append(row)
    eff = np.stack(rows)
    eff[2, (rng.random(n) < 0.3) & (eff[2] < 5.0)] = -np.inf  # holes below the ties
    jv, ji = jax.lax.top_k(jnp.asarray(eff), k)
    tv, ti = topk_rows_plain(torch.from_numpy(eff), k)
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert (tv.numpy()[:, -1] == 5.0).all()


def test_dedup_matches_coupled_spread_component():
    """A coupled batch: self-matching DoNotSchedule spread pods (one
    component, one commit per round), ScheduleAnyway pods whose selector
    matches them, and plain pods, over zoned nodes with running matching
    pods.  The rep auxes carry PodTopologySpread's class count tables
    through every round (K5–K8's plain versions); node_row,
    feasible_count, rounds, the final dynamic state and the diagnosis bits
    equal the JAX engine's."""
    from kubernetes_tpu.framework.conflict import conflict_components

    zone = "topology.kubernetes.io/zone"
    nodes = [dict(d, labels={zone: f"z{i % 3}"}) for i, d in enumerate(_uniform_nodes(15))]
    sched = [{"name": f"s{i}", "ts": -100.0 + i, "req": {"cpu": "100m"},
              "labels": {"color": "blue"}, "node": f"n{(3 * i) % 15:02d}"} for i in range(7)]
    blue = {"color": "blue"}
    pods = _pods({"req": {"cpu": "1", "memory": "1Gi"},
                  "spread": [(1, zone, "DoNotSchedule", blue, None)]}, 20, "p", labels=blue)
    pods += _pods({"req": {"cpu": "500m", "memory": "1Gi"},
                   "spread": [(1, zone, "ScheduleAnyway", blue, None)]}, 6, "q", 50.0,
                  labels={"color": "red"})
    pods += _pods({"req": {"cpu": "2", "memory": "1Gi"}}, 4, "r", 80.0)

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
    hbatch = JCompiler(enc).compile(objs, pad_to=64)
    fw = JFramework(j_default_plugins(enc.domain_cap))
    dsnap = enc.to_device()
    dyn = initial_dynamic_state(dsnap)
    class_of, reps = identity_classes(hbatch)
    rep_rows = np.full(4, reps[0], dtype=np.int32)
    rep_rows[: len(reps)] = reps
    coupling = coupling_flags(hbatch, info=conflict_components(objs, hbatch.size))
    assert np.asarray(coupling.multi).sum() == 26  # spread pods + the red pods
    host_auxes = fw.host_prepare(hbatch, snap, enc)
    rep_host = {k: (v if v is None or k != "Coscheduling" else (v[0], v[1][rep_rows]))
                for k, v in host_auxes.items()}

    def run(batch, dsnap, dyn, order, coupling, class_of, rep_rows):
        rb = batch.take(rep_rows)
        ra = fw.prepare(rb, dsnap, dyn, rep_host)
        res = fw.batch_assign(batch, dsnap, dyn, None, order, coupling,
                              classes=(class_of, rb, ra))
        return res, fw.diagnose_bits(rb, dsnap, dyn, ra)[class_of]

    batch = jax.tree_util.tree_map(jnp.asarray, hbatch)
    jres, jbits = jax.jit(run)(batch, dsnap, dyn, jnp.arange(hbatch.size), coupling,
                               class_of, rep_rows)
    tsnap = snapshot_from_numpy(snapshot_arrays(dsnap), device="cpu")
    tbatch = batch_from_numpy(batch_arrays(batch), device="cpu")
    tdyn = dyn_from_numpy({"requested": np.asarray(dyn.requested),
                           "non_zero": np.asarray(dyn.non_zero)}, device="cpu")
    tfw = TFramework(t_default_plugins(enc.domain_cap))
    trep = tbatch.take(torch.from_numpy(rep_rows.astype(np.int64)))
    trep_aux = tfw.prepare(trep, tsnap, tdyn)
    class_t = torch.from_numpy(class_of.astype(np.int64))
    tres = tfw._batch_assign_dedup(tbatch, tsnap, tdyn, None, torch.arange(hbatch.size),
                                   coupling, (class_t, trep, trep_aux))
    tbits = diagnose_bits_from_plane(tres.diag_plane, len(tfw.filter_names))[class_t]
    _assert_equal(jres, np.asarray(jbits), tres, tbits)
    assert int(tres.rounds) >= 20  # the spread component commits one pod per round
