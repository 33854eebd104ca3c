"""Device claims (DRA) on the port against the JAX package (exact).

* The plain versions of K24–K26 against the JAX plugin they replace, on
  seeded numpy inputs with pinned, blocked and zero-demand rows, nodes with
  no inventory and negative free chips: K24 against ``filter`` /
  ``filter_row``; K25 against ``score`` / ``score_row`` normalized, floored
  and weighted as ``run_scores`` adds them, and over the full floor grid
  (capacity 1–256 × used 0–capacity; the pins (61, 61) and (53, 100), where
  a reordered float32 division moves the floor); K26 against ``update``,
  ``update_batch`` and ``update_batch_classes``.
* The port's DraIndex against the reference's under one event sequence:
  node capacity and allocation, ``resolve``, the named devices ``reserve``
  picks, the rollback of partial assumes, and the claim-plane writes of
  ``flush_to_encoder``.
* The end-to-end scenarios of the JAX package's tests/test_dra.py on
  ``TorchScheduler(device="cpu")`` and ``TPUScheduler(pipeline=False,
  rng_key=None)`` side by side, one fake clock each: bindings and every
  claim's state, node, devices and consumer equal — a pod binds with named
  devices; an allocated claim pins its pod; too few chips leave the pod
  unschedulable; a gang lands all-or-nothing in the one slice with enough
  free chips; a starved gang's timeout releases every claim; a
  template-stamped member schedules.  The PreBind rollback under a
  terminal store fault on the second claim, with the claim series.
* Claim pods through the full auction, ``assign_mode="scan"`` and
  ``pipeline=True``, and a claim-free batch on a cluster with inventory
  (DynamicResources' aux is None; the dedup engine): bindings, routes and
  claims equal to the reference.
* DeviceClaimGang/64Nodes from both packages' workloads: equal bindings,
  claims and claims-allocated count; the workload's shape; the port's
  harness reports ClaimsAllocated.

Tolerance: exact everywhere.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.api.objects as jv1
import kubernetes_tpu.testutil as jtu
import kubernetes_tpu_torch.api.objects as tv1
import kubernetes_tpu_torch.testutil as ttu
from kubernetes_tpu.dra import api as jdapi
from kubernetes_tpu.dra import DraIndex as JIndex
from kubernetes_tpu.dra import ResourceClaimController as JController
from kubernetes_tpu.dra.plugin import DraAux as JDraAux
from kubernetes_tpu.dra.plugin import DynamicResourcesPlugin as JDRA
from kubernetes_tpu.metrics import scheduler_metrics as jm
from kubernetes_tpu.perf import workloads as jw
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.sim.store import ObjectStore as JStore
from kubernetes_tpu_torch.convert import dra_aux_from_numpy
from kubernetes_tpu_torch.dra import api as tdapi
from kubernetes_tpu_torch.dra import DraIndex as TIndex
from kubernetes_tpu_torch.dra import ResourceClaimController as TController
from kubernetes_tpu_torch.dra.plugin import DynamicResourcesPlugin as TDRA
from kubernetes_tpu_torch.gang import POD_GROUP_LABEL, SLICE_LABEL
from kubernetes_tpu_torch.kernels.dra import (
    dra_filter_bits,
    dra_raw_plane,
    dra_score_into,
    dra_take,
)
from kubernetes_tpu_torch.perf import workloads as tw
from kubernetes_tpu_torch.perf.harness import run_workload
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.sim.store import ADDED, DELETED, MODIFIED
from kubernetes_tpu_torch.sim.store import ObjectStore as TStore

from tests.test_torch_common import route_log

PKG = {"jax": (jtu, jv1, JStore, jdapi), "torch": (ttu, tv1, TStore, tdapi)}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# --- K24–K26: the plain versions against the JAX plugin ----------------------------


def _claim_case(seed: int, c: int, n: int):
    """demand / pinned / blocked per row, capacity / allocated per node:
    zero-demand rows, pinned rows (some to a node without inventory),
    blocked rows, nodes without inventory, and allocated above capacity
    (negative free: a slice that shrank under allocated claims)."""
    rng = np.random.default_rng(seed)
    demand = rng.integers(0, 9, c).astype(np.int32)
    demand[rng.random(c) < 0.2] = 0
    pinned = np.where(rng.random(c) < 0.2, rng.integers(0, n, c), -1).astype(np.int32)
    blocked = rng.random(c) < 0.1
    cap = rng.choice(np.array([0, 2, 4, 8, 16], np.int32), n)
    cap[: min(n, 3)] = 0
    alloc = np.minimum(rng.integers(0, 18, n), cap + 3).astype(np.int32)
    alloc[cap == 0] = 0
    alloc[3 % n] = cap[3 % n] + 2  # negative free
    host = {"demand": demand, "pinned": pinned, "blocked": blocked}
    return host, cap, alloc


def _jaux(host, cap, alloc):
    return JDraAux(demand=jnp.asarray(host["demand"]), pinned=jnp.asarray(host["pinned"]),
                   blocked=jnp.asarray(host["blocked"]),
                   free=jnp.asarray((cap - alloc).astype(np.int32)))


def _jsnap(cap):
    return SimpleNamespace(num_nodes=int(cap.shape[0]), claim_capacity=jnp.asarray(cap))


@pytest.mark.parametrize("c,n,bit", [(64, 200, 11), (7, 33, 0), (1, 64, 30)])
def test_k24_plain_equals_reference_filter(c, n, bit):
    host, cap, alloc = _claim_case(24 + c, c, n)
    jaux, snap = _jaux(host, cap, alloc), _jsnap(cap)
    want = np.asarray(JDRA().filter(None, snap, None, jaux))
    taux = dra_aux_from_numpy(host, cap, alloc, device="cpu")
    rng = np.random.default_rng(c)
    seed = rng.integers(0, 1 << 31, (c, n)).astype(np.int32) | np.int32(1 << bit)
    bits = dra_filter_bits(torch.from_numpy(seed.copy()), bit, taux.demand, taux.pinned,
                           taux.blocked, taux.free).numpy()
    assert np.array_equal((bits >> bit) & 1 == 1, want)
    assert np.array_equal(bits | np.int32(1 << bit), seed)  # no other bit moves
    assert 0 < want.sum() < want.size
    # one row at a time, as the scan runs it
    plugin = TDRA()
    for i in range(c):
        row_bits = torch.full((1, n), 1 << bit, dtype=torch.int32)
        plugin.filter_bits(plugin.row(taux, i), row_bits, bit)
        want_row = np.asarray(JDRA().filter_row(None, snap, None, jaux, i))
        assert np.array_equal(row_bits.numpy()[0] == (1 << bit), want_row)


def _reference_term(jaux, snap, mask, weight, i=None):
    """What ``run_scores`` adds for DynamicResources: weight ·
    floor(normalize(score)) (score_row for one row ``i``)."""
    plugin = JDRA()
    raw = plugin.score(None, snap, None, jaux) if i is None \
        else plugin.score_row(None, snap, None, jaux, i)[None, :]
    return weight * np.floor(np.asarray(plugin.normalize(raw, jnp.asarray(mask))))


@pytest.mark.parametrize("c,n,weight", [(64, 200, 1.0), (5, 40, 2.0)])
def test_k25_plain_equals_reference_score(c, n, weight):
    host, cap, alloc = _claim_case(25 + c, c, n)
    jaux, snap = _jaux(host, cap, alloc), _jsnap(cap)
    taux = dra_aux_from_numpy(host, cap, alloc, device="cpu")
    rng = np.random.default_rng(n)
    full = (1 << 16) - 1
    bits = np.where(rng.random((c, n)) < 0.7, full, rng.integers(0, full, (c, n))).astype(
        np.int32)
    mask = bits == full
    total0 = np.where(mask, rng.integers(0, 400, (c, n)), -np.inf).astype(np.float32)
    want = np.where(mask, total0 + _reference_term(jaux, snap, mask, weight), total0)
    got = dra_score_into(torch.from_numpy(bits), full, torch.from_numpy(total0.copy()),
                         taux.capacity, taux.free, taux.demand, weight).numpy()
    assert np.array_equal(got, want.astype(np.float32))
    assert (got[mask] != total0[mask]).any()
    plugin = TDRA()
    for i in range(c):
        row = total0[i:i + 1].copy()
        got_row = plugin.score_into(plugin.row(taux, i), torch.from_numpy(bits[i:i + 1]), full,
                                    torch.from_numpy(row), weight).numpy()
        want_row = np.where(mask[i:i + 1], total0[i:i + 1] + _reference_term(
            jaux, snap, mask[i:i + 1], weight, i), total0[i:i + 1])
        assert np.array_equal(got_row, want_row.astype(np.float32))


def test_k25_floor_grid_equals_reference():
    """Every (used, capacity) pair with capacity 1–256 and used 0–capacity:
    one row of demand 1 over one node per pair, free = capacity − used + 1,
    so (capacity − free) + demand = used.  The raw score equals the
    reference's, equals the integer floor(100 · used / capacity), and so
    does the score K25 adds; the pins (61, 61) → 100 and (53, 100) → 53 are
    where a reciprocal or a divide-first form gives 99 and 52."""
    pairs = [(u, cp) for cp in range(1, 257) for u in range(cp + 1)]
    used = np.array([u for u, _ in pairs], np.int32)
    cap = np.array([cp for _, cp in pairs], np.int32)
    free = (cap - used + 1).astype(np.int32)
    host = {"demand": np.ones(1, np.int32), "pinned": np.full(1, -1, np.int32),
            "blocked": np.zeros(1, bool)}
    jaux = JDraAux(demand=jnp.asarray(host["demand"]), pinned=jnp.asarray(host["pinned"]),
                   blocked=jnp.asarray(host["blocked"]), free=jnp.asarray(free))
    want = np.asarray(JDRA().score(None, _jsnap(cap), None, jaux))[0]
    taux = dra_aux_from_numpy(host, cap, cap - free, device="cpu")
    raw = dra_raw_plane(taux.capacity, taux.free, taux.demand).numpy()[0]
    assert np.array_equal(raw, want)
    assert np.array_equal(raw, (used.astype(np.int64) * 100 // cap).astype(np.float32))
    full = 1
    total = dra_score_into(torch.ones((1, len(pairs)), dtype=torch.int32), full,
                           torch.zeros((1, len(pairs))), taux.capacity, taux.free,
                           taux.demand, 1.0).numpy()[0]
    assert np.array_equal(total, want)
    at = {p: k for k, p in enumerate(pairs)}
    assert total[at[(61, 61)]] == 100.0 and total[at[(53, 100)]] == 53.0
    f32 = np.float32
    assert np.floor(f32(f32(61 * 100) * f32(f32(1) / f32(61)))) == 99.0
    assert np.floor(f32(f32(f32(53) / f32(100)) * f32(100))) == 52.0


def test_k26_plain_equals_reference_updates():
    c, n = 48, 40
    host, cap, alloc = _claim_case(26, c, n)
    jaux = _jaux(host, cap, alloc)
    taux = dra_aux_from_numpy(host, cap, alloc, device="cpu")
    plugin, ref = TDRA(), JDRA()
    # update: the scan's one pod, at a node or not placed
    for i, node in [(0, 5), (3, 0), (7, n - 1), (9, -1), (11, 3)]:
        got = plugin.engine_copy(taux)
        plugin.update(got, i, torch.tensor([node], dtype=torch.int32), None, None)
        want = np.asarray((cap - alloc)) if node < 0 else \
            np.asarray(ref.update(jaux, i, node, None, None).free)
        assert np.array_equal(got.free.numpy(), want)
    assert np.array_equal(taux.free.numpy(), cap - alloc)  # engine_copy kept it
    # update_batch: one auction round's commits, several on one node
    rng = np.random.default_rng(126)
    commit = rng.random(c) < 0.6
    choice = rng.integers(0, n, c).astype(np.int32)
    choice[:6] = 4
    u = (np.eye(n, dtype=np.float32)[choice] * commit[:, None]).astype(np.float32)
    want = np.asarray(ref.update_batch(jaux, jnp.asarray(commit), jnp.asarray(choice),
                                       jnp.asarray(u), None, None).free)
    got = plugin.engine_copy(taux)
    plugin.update_batch_classes(got, torch.from_numpy(commit), torch.from_numpy(choice),
                                torch.arange(c))
    assert np.array_equal(got.free.numpy(), want)
    assert (want < cap - alloc).any()
    # update_batch_classes: pods of 6 class rows (the rows' demand)
    cls = rng.integers(0, 6, c).astype(np.int32)
    u_c = np.zeros((6, n), np.float32)
    np.add.at(u_c, (cls[commit], choice[commit]), 1.0)
    jaux6 = jaux._replace(demand=jaux.demand[:6])
    want = np.asarray(ref.update_batch_classes(jaux6, jnp.asarray(u_c), None, None, None,
                                               jnp.asarray(cls)).free)
    got = plugin.engine_copy(taux._replace(demand=taux.demand[:6]))
    plugin.update_batch_classes(got, torch.from_numpy(commit), torch.from_numpy(choice),
                                torch.from_numpy(cls))
    assert np.array_equal(got.free.numpy(), want)


def test_dra_kernels_take_their_plain_versions_on_cpu():
    """On CPU tensors the wrappers compute on the host; a CUDA tensor would
    launch the kernel (there is no fallback)."""
    free = torch.tensor([4, 4, 0], dtype=torch.int32)
    dra_take(free, torch.tensor([1, 1, -1], dtype=torch.int32),
             torch.tensor([2, 1, 5], dtype=torch.int32))
    assert free.tolist() == [4, 1, 0]
    bits = torch.full((1, 3), 3, dtype=torch.int32)
    dra_filter_bits(bits, 1, torch.tensor([1], dtype=torch.int32),
                    torch.tensor([-1], dtype=torch.int32), torch.tensor([False]), free)
    assert bits.tolist() == [[3, 3, 1]]


# --- the DraIndex against the reference's -------------------------------------------


def mk_class(pkg, name="tpu", selectors=None):
    api = PKG[pkg][3]
    dc = api.DeviceClass(selectors=dict(selectors or {}))
    dc.metadata.name = name
    return dc


def mk_slice(pkg, name, node, pool, chips=4):
    api = PKG[pkg][3]
    sl = api.ResourceSlice(node_name=node, pool=pool, devices=[
        api.Device(name=f"{node}-chip{i}", attributes={
            api.ATTR_SLICE: pool, api.ATTR_HOST: node, api.ATTR_CHIP_INDEX: str(i)})
        for i in range(chips)])
    sl.metadata.name = name
    return sl


def mk_claim(pkg, name, cls="tpu", count=4, node="", devices=(), reserved_for=""):
    api = PKG[pkg][3]
    c = api.ResourceClaim(request=api.DeviceRequest(device_class_name=cls, count=count))
    c.metadata.name = name
    c.metadata.namespace = "default"
    if node:
        c.state = api.CLAIM_RESERVED
        c.allocated_node = node
        c.allocated_devices = list(devices)
        c.reserved_for = reserved_for
    return c


def mk_pod(pkg, name, claims=(), templates=(), cpu="1", group=None, ts=None):
    tu = PKG[pkg][0]
    w = tu.make_pod().name(name).uid(name).namespace("default").req({"cpu": cpu})
    for cl in claims:
        w = w.claim(cl)
    for tpl, local in templates:
        w = w.claim_template(tpl, name=local)
    if group is not None:
        w = w.label(POD_GROUP_LABEL, group)
    p = w.obj()
    # fixed identity fields: the defaults come from per-process counters
    p.metadata.creation_timestamp = 100.0 if ts is None else ts
    return p


class _PlaneRecorder:
    def __init__(self, rows):
        self.node_rows = rows
        self.writes = []

    def set_claim_row(self, name, capacity, allocated):
        if name not in self.node_rows:
            return False
        self.writes.append((name, capacity, allocated))
        return True


def _index_story(pkg):
    """One event sequence on one package's DraIndex → what it answers."""
    idx = (JIndex if pkg == "jax" else TIndex)(None)
    out = []
    idx.on_event(ADDED, mk_class(pkg))
    idx.on_event(ADDED, mk_class(pkg, "s1-only", {"slice": "s1"}))
    for i in range(4):
        idx.on_event(ADDED, mk_slice(pkg, f"rs-n{i}", f"n{i}", f"s{i // 2}",
                                     chips=4 if i != 3 else 2))
    idx.on_event(ADDED, mk_slice(pkg, "rs-n0b", "n0", "s0x", chips=2))  # second slice
    idx.on_event(ADDED, mk_claim(pkg, "held", count=2, node="n0",
                                 devices=["s0/n0-chip0", "s0/n0-chip1"], reserved_for="z"))
    for name, count, cls in (("c1", 3, "tpu"), ("c2", 3, "tpu"), ("c3", 1, "s1-only"),
                             ("c4", 2, "tpu"), ("big", 9, "tpu")):
        idx.on_event(ADDED, mk_claim(pkg, name, cls=cls, count=count))
    nodes = [f"n{i}" for i in range(4)]
    out.append([(idx.node_capacity(x), idx.node_allocated(x)) for x in nodes])
    pods = {"p1": mk_pod(pkg, "p1", ["c1"]), "p12": mk_pod(pkg, "p12", ["c1", "c2"]),
            "p3": mk_pod(pkg, "p3", ["c3"]), "pz": mk_pod(pkg, "pz", ["held"]),
            "z": mk_pod(pkg, "z", ["held"]), "ghost": mk_pod(pkg, "ghost", ["nope"]),
            "p4": mk_pod(pkg, "p4", ["c4", "c3"])}
    out.append({k: idx.resolve(p) for k, p in pods.items()})
    # a failing second claim rolls the first claim's assume back
    out.append(idx.reserve(pods["p12"], "n1")[1])
    out.append([(idx.node_capacity(x), idx.node_allocated(x)) for x in nodes])
    for pod, node in (("p1", "n0"), ("p3", "n0"), ("p3", "n2"), ("p4", "n2"), ("z", "n0"),
                      ("pz", "n0")):
        dec, why = idx.reserve(pods[pod], node)
        out.append((pod, node, why, None if dec is None else
                    [(c.metadata.name, devs) for c, devs in dec]))
    out.append([(idx.node_capacity(x), idx.node_allocated(x)) for x in nodes])
    rec = _PlaneRecorder({"n0": 0, "n1": 1, "n2": 2})
    idx.flush_to_encoder(rec)
    out.append(sorted(rec.writes))
    idx.unreserve(pods["p4"])
    idx.on_event(MODIFIED, mk_slice(pkg, "rs-n3", "n2", "s1", chips=4))  # moves node
    idx.on_event(DELETED, mk_claim(pkg, "held"))
    idx.on_event(DELETED, mk_slice(pkg, "rs-n0b", "n0", "s0x"))
    out.append([(idx.node_capacity(x), idx.node_allocated(x)) for x in nodes])
    idx.flush_to_encoder(rec)
    out.append(sorted(rec.writes))
    out.append(idx.pod_claim_demand(pods["p12"]))
    return out


def test_index_equals_reference():
    got, want = _index_story("torch"), _index_story("jax")
    assert got == want
    assert want[2] is not None and "free devices" in want[2]  # the partial assume
    assert want[1]["ghost"] == (0, None, False) and want[1]["pz"][2] is False


# --- end to end: the reference's scenarios on both schedulers ----------------------


def _tpu_cluster(pkg, n_nodes=4, chips=4, slice_hosts=2, cpu="8"):
    """n_nodes hosts labelled into slices of ``slice_hosts``, one
    ResourceSlice per host publishing ``chips`` chips into its slice's
    pool (the reference test's _tpu_cluster)."""
    tu, _, Store, _ = PKG[pkg]
    clock, store = FakeClock(), Store()
    if pkg == "jax":
        sched = TPUScheduler(store, batch_size=8, clock=clock, batch_wait=0,
                             pipeline=False, rng_key=None)
    else:
        sched = TorchScheduler(store, batch_size=8, clock=clock, batch_wait=0, device="cpu")
    store.create("DeviceClass", mk_class(pkg))
    for i in range(n_nodes):
        pool = f"s{i // slice_hosts}"
        node = (tu.make_node().name(f"n{i}").capacity({"cpu": cpu, "pods": "20"})
                .label(SLICE_LABEL, pool).obj())
        node.metadata.uid = node.metadata.name
        node.metadata.creation_timestamp = 0.0
        store.create("Node", node)
        store.create("ResourceSlice", mk_slice(pkg, f"rs-n{i}", f"n{i}", pool, chips))
    return clock, store, sched


def _group(pkg, store, name, min_member, timeout):
    v1 = PKG[pkg][1]
    pg = v1.PodGroup(metadata=v1.ObjectMeta(name=name, namespace="default"),
                     min_member=min_member, schedule_timeout_seconds=timeout)
    pg.metadata.creation_timestamp = 50.0
    store.create("PodGroup", pg)


def _claims(store):
    return {c.metadata.name: (c.state, c.allocated_node, list(c.allocated_devices),
                              c.reserved_for)
            for c in store.list("ResourceClaim")[0]}


def _outcome(store, sched):
    pods = {p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]}
    return pods, _claims(store), len(sched._waiting_binds), sched.queue.pending_count()


def _named_devices(pkg):
    _clock, store, sched = _tpu_cluster(pkg, n_nodes=2)
    store.create("ResourceClaim", mk_claim(pkg, "c1", count=4))
    store.create("Pod", mk_pod(pkg, "p", ["c1"]))
    sched.run_until_idle(backoff_wait=0)
    return _outcome(store, sched)


def _pinned(pkg):
    _clock, store, sched = _tpu_cluster(pkg, n_nodes=4)
    store.create("ResourceClaim", mk_claim(pkg, "c1", count=2, node="n3",
                                           devices=["s1/chip0", "s1/chip1"], reserved_for="p"))
    store.create("Pod", mk_pod(pkg, "p", ["c1"]))
    sched.run_until_idle(backoff_wait=0)
    return _outcome(store, sched)


def _insufficient(pkg):
    _clock, store, sched = _tpu_cluster(pkg, n_nodes=1, chips=2)
    store.create("ResourceClaim", mk_claim(pkg, "c1", count=4))
    store.create("Pod", mk_pod(pkg, "p", ["c1"]))
    sched.run_until_idle(max_cycles=5, backoff_wait=0)
    return _outcome(store, sched)


def _gang_one_slice(pkg):
    clock, store, sched = _tpu_cluster(pkg, n_nodes=4, chips=4, slice_hosts=2)
    store.create("ResourceClaim", mk_claim(pkg, "ghost", count=1, node="n0",
                                           devices=["s0/n0-chip0"], reserved_for="ghost-pod"))
    ghost = mk_pod(pkg, "ghost-pod", ["ghost"], cpu="0")
    ghost.spec.node_name = "n0"
    store.create("Pod", ghost)
    _group(pkg, store, "g", 2, 30)
    for i in range(2):
        store.create("ResourceClaim", mk_claim(pkg, f"g-{i}-tpu", count=4))
        store.create("Pod", mk_pod(pkg, f"g-{i}", [f"g-{i}-tpu"], group="g", ts=100.0 + i))
    for _ in range(8):
        sched.schedule_cycle()
        clock.advance(0.5)
    return _outcome(store, sched)


def _starved_gang(pkg):
    clock, store, sched = _tpu_cluster(pkg, n_nodes=2, chips=4, slice_hosts=2)
    _group(pkg, store, "g", 3, 2)
    for i in range(3):  # 3 members × 4 chips > the 8 chips that exist
        store.create("ResourceClaim", mk_claim(pkg, f"g-{i}-tpu", count=4))
        store.create("Pod", mk_pod(pkg, f"g-{i}", [f"g-{i}-tpu"], group="g", ts=100.0 + i))
    for _ in range(4):
        sched.schedule_cycle()
        clock.advance(0.5)
    clock.advance(10.0)
    sched.schedule_cycle()
    return _outcome(store, sched) + ([sched.dra.node_allocated(f"n{i}") for i in range(2)],)


def _template_stamped(pkg):
    clock, store, sched = _tpu_cluster(pkg, n_nodes=2)
    api = PKG[pkg][3]
    tpl = api.ResourceClaimTemplate(request=api.DeviceRequest(device_class_name="tpu",
                                                              count=4))
    tpl.metadata.name = "tpu-tmpl"
    tpl.metadata.namespace = "default"
    store.create("ResourceClaimTemplate", tpl)
    store.create("Pod", mk_pod(pkg, "job-0", templates=[("tpu-tmpl", "tpu")]))
    before = sched.run_until_idle(max_cycles=3, backoff_wait=0).scheduled
    (JController if pkg == "jax" else TController)(store, index=sched.dra).sync_once()
    for _ in range(10):  # the claim ADD event requeues; ride out the backoff
        sched.schedule_cycle()
        clock.advance(5.0)
        if store.get("Pod", "default", "job-0").spec.node_name:
            break
    return (before,) + _outcome(store, sched)


SCENARIOS = {"named_devices": _named_devices, "pinned": _pinned,
             "insufficient": _insufficient, "gang_one_slice": _gang_one_slice,
             "starved_gang": _starved_gang, "template_stamped": _template_stamped}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_dra_scenarios_equal_reference(scenario):
    want, got = SCENARIOS[scenario]("jax"), SCENARIOS[scenario]("torch")
    assert got == want
    pods, claims = (got[1], got[2]) if scenario == "template_stamped" else got[:2]
    if scenario == "named_devices":
        node = pods["p"]
        state, at, devs, owner = claims["c1"]
        assert node and state == "Reserved" and at == node and owner == "p"
        assert len(set(devs)) == 4 and all(d.startswith("s0/") for d in devs)
    elif scenario == "pinned":
        assert pods["p"] == "n3"
    elif scenario == "insufficient":
        assert not pods["p"] and claims["c1"][0] == "Pending"
    elif scenario == "gang_one_slice":
        assert {pods["g-0"], pods["g-1"]} <= {"n2", "n3"}  # s0 has 7 free chips of 8
        devs = claims["g-0-tpu"][2] + claims["g-1-tpu"][2]
        assert len(set(devs)) == 8 and all(d.startswith("s1/") for d in devs)
    elif scenario == "starved_gang":
        assert not any(pods.values()) and got[2] == 0
        assert all(c[0] == "Pending" and not c[2] for c in claims.values())
        assert got[4] == [0, 0]
    else:
        assert got[0] == 0 and pods["job-0"]
        assert claims["job-0-tpu"][0] == "Reserved" and len(claims["job-0-tpu"][2]) == 4


class _InjectedFault(RuntimeError):
    """A terminal store fault (what a 429 storm that outlasts the client's
    retries looks like to the plugin)."""


def _fail_second_claim_store(pkg):
    """A store whose first write of claim c2 with an allocation fails."""
    base = PKG[pkg][2]

    class FailSecondClaimStore(base):
        armed = True

        def update(self, kind, obj, expected_rv=None, **kw):
            if (self.armed and kind == "ResourceClaim" and obj.metadata.name == "c2"
                    and obj.allocated_node):
                self.armed = False
                raise _InjectedFault("injected storm")
            return super().update(kind, obj, expected_rv=expected_rv, **kw)

    return FailSecondClaimStore()


_RESULTS = ("allocated", "conflict", "error", "rollback")


def _prebind_rollback(pkg):
    tu = PKG[pkg][0]
    clock, store = FakeClock(), _fail_second_claim_store(pkg)
    if pkg == "jax":
        sched = TPUScheduler(store, batch_size=8, clock=clock, batch_wait=0,
                             pipeline=False, rng_key=None)
        before = {k: jm.dra_claims_allocated.value((k,)) for k in _RESULTS}
    else:
        sched = TorchScheduler(store, batch_size=8, clock=clock, batch_wait=0, device="cpu")
    store.create("DeviceClass", mk_class(pkg))
    for i in range(2):
        node = tu.make_node().name(f"n{i}").capacity({"cpu": "8", "pods": "20"}).obj()
        node.metadata.uid, node.metadata.creation_timestamp = f"n{i}", 0.0
        store.create("Node", node)
        store.create("ResourceSlice", mk_slice(pkg, f"rs-n{i}", f"n{i}", "s0"))
    store.create("ResourceClaim", mk_claim(pkg, "c1", count=2))
    store.create("ResourceClaim", mk_claim(pkg, "c2", count=2))
    store.create("Pod", mk_pod(pkg, "p", ["c1", "c2"]))
    for _ in range(10):  # past the failed pod's backoff window
        sched.schedule_cycle()
        clock.advance(5.0)
        if store.get("Pod", "default", "p").spec.node_name:
            break
    if pkg == "jax":
        series = {k: int(jm.dra_claims_allocated.value((k,)) - before[k]) for k in _RESULTS}
    else:
        series = dict(sched.dra_plugin.claims_allocated)
    return _outcome(store, sched), series


def test_prebind_terminal_fault_rolls_back_written_claims():
    """The second claim's write fails for good: the first claim's allocation
    rolls back, the pod requeues, and the retry lands both claims — the
    same claims, bindings and claim series as the reference."""
    want, got = _prebind_rollback("jax"), _prebind_rollback("torch")
    assert got == want
    (pods, claims, _w, _q), series = got
    assert series["rollback"] >= 1 and series["error"] == 1
    assert pods["p"] and all(claims[c][1] == pods["p"] and claims[c][3] == "p"
                             for c in ("c1", "c2"))


# --- the engines: full auction, scan, pipelined; a claim-free batch --------------------


def _engine_cluster(pkg, kind):
    """12 hosts in three 4-host slices (n5 publishes no chips, n7 eight),
    claim pods of 1–4 chips (some with two claims), claim-free pods, a pod
    whose claim is already allocated (pinned), one whose claim is missing
    (blocked) and one claiming more chips than any host has; or, for
    ``claim_free``, only the claim-free pods on the same inventory."""
    tu = PKG[pkg][0]
    store = PKG[pkg][2]()
    store.create("DeviceClass", mk_class(pkg))
    for i in range(12):
        node = (tu.make_node().name(f"n{i:02d}").capacity({"cpu": "4", "pods": "20"})
                .label(SLICE_LABEL, f"s{i // 4}").obj())
        node.metadata.uid, node.metadata.creation_timestamp = node.metadata.name, 0.0
        store.create("Node", node)
        if i != 5:
            store.create("ResourceSlice", mk_slice(pkg, f"rs-n{i:02d}", f"n{i:02d}",
                                                   f"s{i // 4}", 8 if i == 7 else 4))
    pods = []
    if kind != "claim_free":
        rng = np.random.default_rng(7)
        for j in range(20):
            names = [f"c{j}a"] + ([f"c{j}b"] if j % 5 == 0 else [])
            for nm in names:
                store.create("ResourceClaim", mk_claim(pkg, nm, count=int(rng.integers(1, 5))))
            pods.append(mk_pod(pkg, f"cp{j:02d}", names, cpu=f"{500 + 100 * (j % 4)}m",
                               ts=10.0 + j))
        store.create("ResourceClaim", mk_claim(
            pkg, "pin", count=1, node="n09", devices=["s2/n09-chip0"], reserved_for="pinned"))
        pods.append(mk_pod(pkg, "pinned", ["pin"], ts=40.0))
        pods.append(mk_pod(pkg, "blocked", ["missing"], ts=41.0))
        store.create("ResourceClaim", mk_claim(pkg, "huge", count=9))
        pods.append(mk_pod(pkg, "huge", ["huge"], ts=42.0))
    for j in range(6):
        pods.append(mk_pod(pkg, f"free{j}", cpu="250m", ts=50.0 + j))
    for p in pods:
        store.create("Pod", p)
    return store


def _run_engines(pkg, kind, monkeypatch, **kw):
    store = _engine_cluster(pkg, kind)
    if pkg == "jax":
        sched = TPUScheduler(store, batch_size=8, rng_key=None, clock=FakeClock(),
                             batch_wait=0, **kw)
    else:
        sched = TorchScheduler(store, batch_size=8, device="cpu", clock=FakeClock(),
                               batch_wait=0, **kw)
    log = route_log(pkg, monkeypatch)
    sched.run_until_idle(max_cycles=20, backoff_wait=0)
    monkeypatch.undo()
    pods = {p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]}
    return pods, _claims(store), log


ENGINE_RUNS = {"full": {}, "scan": {"assign_mode": "scan"},
               "pipelined": {"pipeline": True}, "claim_free": {}}


@pytest.mark.parametrize("run", list(ENGINE_RUNS))
def test_claim_pods_through_the_engines_equal_reference(run, monkeypatch):
    kind = "claim_free" if run == "claim_free" else "claims"
    want = _run_engines("jax", kind, monkeypatch, **ENGINE_RUNS[run])
    got = _run_engines("torch", kind, monkeypatch, **ENGINE_RUNS[run])
    assert got == want
    pods, claims, log = got
    engines = {"scan" if m == "scan" else ("dedup" if d else "full") for m, d, _r in log}
    if run == "claim_free":
        assert engines == {"dedup"} and all(pods.values()) and not any(
            c[1] for c in claims.values())
        return
    if run == "scan":
        assert engines == {"scan"}
    else:
        # claim batches leave the dedup engine for their pod-indexed host
        # aux; the claim-free tail batch dedups
        assert "full" in engines <= {"full", "dedup"}
        assert {r for m, d, r in log if m == "batch" and not d} == {"pod_indexed_aux"}
    assert pods["pinned"] == "n09" and not pods["blocked"] and not pods["huge"]
    assert sum(1 for v in pods.values() if v) > 12
    held = [d for c in claims.values() for d in c[2]]
    assert len(held) == len(set(held))  # no chip handed out twice
    for name, (state, node, devs, owner) in claims.items():
        if owner and name != "pin":
            assert state == "Reserved" and pods[owner] == node
            assert all(d.startswith(f"s{int(node[1:]) // 4}/{node}-") for d in devs)


# --- DeviceClaimGang ---------------------------------------------------------------------


def _feed_workload(w, store):
    """The workload's objects, as the harness creates them (node indices run
    across the createNodes ops), with fixed identity fields."""
    node_idx = 0
    for op in w.ops:
        if op.opcode == "createNodes":
            for _ in range(op.count):
                n = op.node_template(node_idx)
                node_idx += 1
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


def _device_claim_gang(pkg):
    w = (jw if pkg == "jax" else tw).build_workload("DeviceClaimGang", "64Nodes")
    store = PKG[pkg][2]()
    clock = FakeClock()
    if pkg == "jax":
        sched = TPUScheduler(store, batch_size=w.batch_size, pipeline=False, rng_key=None,
                             clock=clock, batch_wait=0)
        a0 = jm.dra_claims_allocated.value(("allocated",))
    else:
        sched = TorchScheduler(store, batch_size=w.batch_size, device="cpu", clock=clock,
                               batch_wait=0)
    _feed_workload(w, store)
    for _ in range(100):
        s = sched.schedule_cycle()
        if s.attempted == 0 and s.in_flight == 0 and s.waiting == 0:
            break
    allocated = int(jm.dra_claims_allocated.value(("allocated",)) - a0) if pkg == "jax" \
        else sched.dra_plugin.claims_allocated["allocated"]
    pods = {p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]}
    return pods, _claims(store), allocated


def test_device_claim_gang_bindings_equal_reference():
    want, got = _device_claim_gang("jax"), _device_claim_gang("torch")
    assert got == want
    pods, claims, allocated = got
    assert len(pods) == 56 and all(pods.values()) and allocated == 56
    held = [d for c in claims.values() for d in c[2]]
    assert len(held) == 224 == len(set(held))
    for i in range(56):
        state, node, devs, owner = claims[f"gangclaim-{i:06d}"]
        assert owner == f"dgang-{i:06d}" and node == pods[owner] and state == "Reserved"
        assert devs == [f"slice-{int(node[5:]) // 8:05d}/{node}-chip{c}" for c in range(4)]


def test_device_claim_gang_workload_shape():
    """The DeviceClaimGang suite's generators agree with each other: pod i
    references claim gangclaim-i, warm pods are singleton gangs pinned to
    the warm node, and the suite is flagged dra for the harness (the
    reference's test, on the port); its ops equal the reference's."""
    from kubernetes_tpu_torch.dra.api import pod_claim_names

    w = tw.build_workload("DeviceClaimGang", "64Nodes")
    assert w.dra is True and w.gang_size
    assert "DeviceClaimGang" in tw.SUITES and "DeviceClaimGang" not in tw.UNPORTED
    op = next(o for o in w.ops if o.opcode == "createPods")
    pod = op.pod_template(0)
    assert pod_claim_names(pod) == ["gangclaim-000000"]
    warm = op.pod_template(9_990_000)
    assert pod_claim_names(warm) == ["warmclaim-0"]
    assert warm.spec.node_selector == {"dra-warm": "1"}
    assert warm.metadata.labels[POD_GROUP_LABEL] == "wg-0"
    for size in jw.SUITES["DeviceClaimGang"].sizes:
        j = jw.build_workload("DeviceClaimGang", size)
        t = tw.build_workload("DeviceClaimGang", size)
        assert (t.name, t.batch_size, t.gang_size, t.dra) == \
            (j.name, j.batch_size, j.gang_size, j.dra)
        assert [(o.opcode, o.count) for o in t.ops] == [(o.opcode, o.count) for o in j.ops]
        for jo, to in zip(j.ops, t.ops):
            if jo.object_template is not None:
                jk, jobj = jo.object_template(3)
                tk, tobj = to.object_template(3)
                for obj in (jobj, tobj):  # per-process counters
                    obj.metadata.uid, obj.metadata.creation_timestamp = "", 0.0
                assert (tk, repr(tobj).replace("kubernetes_tpu_torch.", "")) == \
                    (jk, repr(jobj).replace("kubernetes_tpu.", ""))


def test_device_claim_gang_harness_on_cpu():
    items = run_workload(tw.build_workload("DeviceClaimGang", "64Nodes"), device="cpu")
    by = {it.labels["Metric"]: it for it in items}
    assert by["ClaimsAllocated"].unit == "claims/s"
    assert by["ClaimsAllocated"].data["Count"] == 56.0  # the warm pods' commits excluded
    assert by["ClaimsAllocated"].data["PerSecond"] > 0
    assert by["GangThroughput"].data["Gangs"] == 7.0
