"""Scheduler profiles on the port against the JAX package's.

* The reference's tests/test_profiles.py scenarios on the port: two
  profiles with distinct plugin sets (Fit and a filter plugin of the port's
  own kind that pins each profile to its nodes) place each pod by its own
  profile and ignore a pod naming an unknown scheduler; the queue pops one
  profile's pods per batch.
* Three profiles — the default set plus SelectorSpread with the store,
  Fit under MostAllocated (bin packing), Fit under RequestedToCapacityRatio
  — with Services, ReplicaSets, two namespaces, terminating pods and both
  zone label keys: bindings equal the JAX scheduler's, synchronous and
  pipelined, and the pods naming an unknown scheduler stay pending.
* A profile with default plugins disabled (kernel filters without a bit,
  raw planes at weight 0): bindings equal the reference's.
* Per-profile frameworks are rebuilt on a domain growth and keep their
  DynamicResources series; every profile's registrations feed the event
  map.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import kubernetes_tpu.api.objects as jv1
import kubernetes_tpu.config as jcfg
import kubernetes_tpu.plugins as JP
import kubernetes_tpu_torch.api.objects as tv1
import kubernetes_tpu_torch.config as tcfg
import kubernetes_tpu_torch.plugins as TP
from kubernetes_tpu.framework.interface import PluginWithWeight as JPW
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.scheduler import default_plugins as j_default_plugins
from kubernetes_tpu.sim.store import ObjectStore as JStore
from kubernetes_tpu_torch.framework.interface import Plugin as TPlugin
from kubernetes_tpu_torch.framework.interface import PluginWithWeight as TPW
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.scheduler import default_plugins as t_default_plugins
from kubernetes_tpu_torch.sim.store import ObjectStore as TStore
from kubernetes_tpu_torch.testutil import make_node, make_pod

from test_torch_common import PKGS, make_node_obj, make_pod_obj

ZONE = "topology.kubernetes.io/zone"
ZONE_BETA = "failure-domain.beta.kubernetes.io/zone"


# --- the reference's scenarios (tests/test_profiles.py) ---------------------------------


class PinPlugin(TPlugin):
    """A filter of the port's own kind (a dynamic filter: its aux is the
    node mask, and it clears its bit of the engines' pass-bit plane where
    the mask is off): passes only the node rows whose name ends with
    ``suffix`` (rows taken from the scheduler's encoder)."""

    dynamic = True

    def __init__(self, suffix: str, rows: dict):
        self.name = f"PinTo{suffix}"
        self.suffix = suffix
        self.rows = rows

    def prepare(self, batch, snap, dyn, host_aux=None):
        ok = torch.zeros(snap.node_valid.shape, dtype=torch.bool)
        for row, name in self.rows.items():
            if name.endswith(self.suffix):
                ok[row] = True
        return ok.to(snap.device)

    def filter(self, batch, snap, dyn, aux=None):
        return self.prepare(batch, snap, dyn)[None, :]

    def filter_bits(self, aux, bits, bit: int):
        bits &= torch.where(aux, -1, ~(1 << bit)).to(torch.int32)[None, :]
        return bits

    def engine_copy(self, aux):
        return aux

    def row(self, aux, i: int):
        return aux


def test_two_profiles_distinct_plugin_sets():
    store = TStore()
    rows = {}

    def profile_a(domain_cap):
        return [TPW(TP.FitPlugin(), 1), TPW(PinPlugin("0", rows), 0)]

    def profile_b(domain_cap):
        return [TPW(TP.FitPlugin(), 1), TPW(PinPlugin("1", rows), 0)]

    sched = TorchScheduler(store, batch_size=4, device="cpu",
                           profiles={"sched-a": profile_a, "sched-b": profile_b})
    store.create("Node", make_node().name("n0").obj())
    store.create("Node", make_node().name("n1").obj())
    sched.cache.update_snapshot(sched.snapshot)
    sched.encoder.sync(sched.snapshot, [n.node_name for n in sched.snapshot.node_info_list])
    rows.update(sched.encoder.row_to_name())
    pods = {}
    for name, sname in (("pa", "sched-a"), ("pb", "sched-b"), ("px", "someone-else")):
        p = make_pod().name(name).uid(name).namespace("default").req({"cpu": "1"}).obj()
        p.spec.scheduler_name = sname
        pods[name] = p
        store.create("Pod", p)
    stats = sched.run_until_idle()
    assert stats.scheduled == 2
    assert store.get("Pod", "default", "pa").spec.node_name == "n0"
    assert store.get("Pod", "default", "pb").spec.node_name == "n1"
    # a pod for an unknown scheduler is ignored entirely (responsibleForPod)
    assert store.get("Pod", "default", "px").spec.node_name == ""
    assert set(sched._fws) == {"sched-a", "sched-b"}


def test_pop_batch_groups_by_profile():
    store = TStore()
    sched = TorchScheduler(store, batch_size=8, device="cpu",
                           profiles={"sched-a": t_default_plugins,
                                     "sched-b": t_default_plugins})
    store.create("Node", make_node().name("n0").obj())
    for i in range(6):
        p = make_pod().name(f"p{i}").uid(f"p{i}").namespace("default").req({"cpu": "1m"}).obj()
        p.spec.scheduler_name = "sched-a" if i % 2 == 0 else "sched-b"
        store.create("Pod", p)
    infos = sched.queue.pop_batch(8, group_key=lambda qi: qi.pod.spec.scheduler_name)
    names = {qi.pod.spec.scheduler_name for qi in infos}
    assert len(names) == 1 and len(infos) == 3
    rest = sched.queue.pop_batch(8, group_key=lambda qi: qi.pod.spec.scheduler_name)
    assert len(rest) == 3 and {qi.pod.spec.scheduler_name for qi in rest} != names


# --- three profiles: SelectorSpread, MostAllocated, RequestedToCapacityRatio ------------

PROFILE_NAMES = ("default-scheduler", "bin-packing", "rtcr")


def _config(pkg: str):
    """The bin-packing and rtcr profiles as a KubeSchedulerConfiguration
    (the upstream "Resource Bin Packing" page's form)."""
    cfg = jcfg if pkg == "jax" else tcfg
    return cfg.load_config({
        "apiVersion": "kubescheduler.config.k8s.io/v1beta3",
        "profiles": [
            {"schedulerName": "bin-packing",
             "pluginConfig": [{"name": "NodeResourcesFit", "args": {"scoringStrategy": {
                 "type": "MostAllocated",
                 "resources": [{"name": "cpu", "weight": 1}, {"name": "memory", "weight": 1}]}}}]},
            {"schedulerName": "rtcr",
             "pluginConfig": [{"name": "NodeResourcesFit", "args": {"scoringStrategy": {
                 "type": "RequestedToCapacityRatio"}}}]},
        ]})


def profile_factories(pkg: str, store, disabled=()):
    """schedulerName → plugins factory: the default set plus SelectorSpread
    at weight 1 with the store, and the two Fit-strategy profiles built
    from the configuration; ``disabled`` removes default plugins by name
    from the first profile."""
    cfg = _config(pkg)
    build = (jcfg if pkg == "jax" else tcfg).build_plugins_for_profile
    if pkg == "jax":
        base, ss, pw = j_default_plugins, JP.SelectorSpreadPlugin, JPW
    else:
        base, ss, pw = t_default_plugins, TP.SelectorSpreadPlugin, TPW

    def default(d):
        return [p for p in base(d) if p.plugin.name not in disabled] + [pw(ss(store), 1)]

    return {"default-scheduler": default,
            "bin-packing": lambda d: build(cfg.profile("bin-packing"), domain_cap=d),
            "rtcr": lambda d: build(cfg.profile("rtcr"), domain_cap=d)}


def _meta(v1, name, ns):
    return v1.ObjectMeta(name=name, namespace=ns, uid=f"{ns}/{name}", creation_timestamp=0.0)


def profile_cluster(pkg: str, seed: int, n_nodes: int = 48, n_bound: int = 60,
                    per_profile=(40, 40, 24), n_unknown: int = 4):
    """(store objects in creation order, pending pod names by profile): nodes
    labelled with either zone key or none, Services and ReplicaSets in two
    namespaces (equality, expression and empty-match selectors), pre-bound
    replicas (some terminating), and pending pods for the three profiles
    and an unknown scheduler."""
    tu, v1 = PKGS[pkg]
    rng = np.random.default_rng(seed)
    objs = []
    shapes = [("4", "16Gi"), ("8", "32Gi"), ("2", "8Gi"), ("3500m", "1000Mi")]
    names = []
    for i in range(n_nodes):
        cpu, mem = shapes[int(rng.integers(len(shapes)))]
        labels = {}
        u = rng.random()
        if u < 0.6:
            labels[ZONE] = f"z{i % 3}"
        elif u < 0.85:
            labels[ZONE_BETA] = f"b{i % 2}"
        d = {"name": f"n{i:03d}", "cpu": cpu, "memory": mem, "pods": "110",
             "labels": labels, "taints": [], "images": [], "unschedulable": False,
             "not_ready": False}
        names.append(d["name"])
        objs.append(("Node", make_node_obj(pkg, d)))
    for ns in ("default", "team"):
        for k in range(4):
            objs.append(("Service", v1.Service(metadata=_meta(v1, f"svc-{k}", ns),
                                               selector={"app": f"web-{k}"})))
        for k in range(2, 6):
            sel = v1.LabelSelector(match_labels={"app": f"web-{k}"})
            if k == 3:
                sel = v1.LabelSelector(match_expressions=[v1.LabelSelectorRequirement(
                    key="tier", operator="In", values=["front", "edge"])],
                    match_labels={"app": "web-3"})
            objs.append(("ReplicaSet", v1.ReplicaSet(metadata=_meta(v1, f"rs-{k}", ns),
                                                     selector=sel)))
    for i in range(n_bound):
        ns = "default" if rng.random() < 0.7 else "team"
        labels = {"app": f"web-{int(rng.integers(6))}"}
        if rng.random() < 0.5:
            labels["tier"] = str(rng.choice(["front", "back", "edge"]))
        d = {"name": f"b{i:03d}", "ns": ns, "ts": -1000.0 + i, "labels": labels,
             "req": {"cpu": "100m", "memory": "200Mi"},
             "node": names[int(min(rng.geometric(0.08), n_nodes) - 1)]}
        pod = make_pod_obj(pkg, d)
        if rng.random() < 0.1:
            pod.metadata.deletion_timestamp = 1.0
        objs.append(("Pod", pod))
    pending = {}
    reqs = [{"cpu": "250m", "memory": "512Mi"}, {"cpu": "1", "memory": "1Gi"},
            {"cpu": "500m", "memory": "3Gi"}, {"cpu": "100m", "memory": "100Mi"}]
    for prof, count in zip(PROFILE_NAMES + ("someone-else",), per_profile + (n_unknown,)):
        for i in range(count):
            ns = "default" if rng.random() < 0.75 else "team"
            labels = {"app": f"web-{int(rng.integers(6))}"}
            if rng.random() < 0.5:
                labels["tier"] = str(rng.choice(["front", "back"]))
            d = {"name": f"{prof[:3]}{i:03d}", "ns": ns, "ts": float(len(pending) + i),
                 "labels": labels, "req": reqs[int(rng.integers(len(reqs)))]}
            pod = make_pod_obj(pkg, d)
            pod.spec.scheduler_name = prof
            objs.append(("Pod", pod))
            pending.setdefault(prof, []).append((ns, d["name"]))
    return objs, pending


def run_profiles(pkg: str, seed: int, disabled=(), **kw):
    """Create the cluster, schedule until idle → (bindings of the pending
    pods by profile, the scheduler)."""
    store = JStore() if pkg == "jax" else TStore()
    objs, pending = profile_cluster(pkg, seed)
    profiles = profile_factories(pkg, store, disabled)
    if pkg == "jax":
        sched = TPUScheduler(store, profiles=profiles, **kw)
    else:
        sched = TorchScheduler(store, profiles=profiles, device="cpu", **kw)
    for kind, obj in objs:
        store.create(kind, obj)
    sched.run_until_idle()
    out = {prof: {name: store.get("Pod", ns, name).spec.node_name for ns, name in pods}
           for prof, pods in pending.items()}
    return out, sched


@pytest.mark.parametrize("seed,pipeline", [(0, False), (1, False), (2, True)])
def test_three_profiles_bindings_equal_reference(seed, pipeline):
    want, _ = run_profiles("jax", seed, batch_size=16, pipeline=pipeline)
    got, sched = run_profiles("torch", seed, batch_size=16, pipeline=pipeline)
    assert got == want
    # every profile bound pods; the unknown scheduler's pods stay pending
    for prof in PROFILE_NAMES:
        assert any(got[prof].values()), prof
    assert not any(got["someone-else"].values())
    assert set(sched._fws) == set(PROFILE_NAMES)
    fit = {p: next(pw.plugin.strategy for pw in sched._fws[p].plugins
                   if pw.plugin.name == "NodeResourcesFit") for p in PROFILE_NAMES}
    assert fit == {"default-scheduler": "LeastAllocated", "bin-packing": "MostAllocated",
                   "rtcr": "RequestedToCapacityRatio"}


def test_selector_spread_counts_move_the_bindings():
    """The store-backed SelectorSpread changes where the default profile's
    pods land (against the same profile without it), in both packages."""
    with_ss, _ = run_profiles("torch", 0, batch_size=16)
    plain = {}
    for pkg in ("jax", "torch"):
        store = JStore() if pkg == "jax" else TStore()
        objs, pending = profile_cluster(pkg, 0)
        fac = profile_factories(pkg, store)
        fac["default-scheduler"] = (lambda d, pkg=pkg: (j_default_plugins if pkg == "jax"
                                                        else t_default_plugins)(d))
        sched = (TPUScheduler(store, profiles=fac, batch_size=16) if pkg == "jax" else
                 TorchScheduler(store, profiles=fac, batch_size=16, device="cpu"))
        for kind, obj in objs:
            store.create(kind, obj)
        sched.run_until_idle()
        plain[pkg] = {name: store.get("Pod", ns, name).spec.node_name
                      for ns, name in pending["default-scheduler"]}
    assert plain["jax"] == plain["torch"]
    assert plain["torch"] != with_ss["default-scheduler"]


@pytest.mark.parametrize("disabled", [
    ("TaintToleration", "ImageLocality"),
    ("NodeResourcesFit", "NodeAffinity", "NodeResourcesBalancedAllocation"),
])
def test_disabled_default_plugins_equal_reference(disabled):
    """A profile without some default plugins: their kernel filter bits are
    absent and their raw planes take weight 0; the bindings equal the
    reference's."""
    want, _ = run_profiles("jax", 3, disabled=disabled, batch_size=16)
    got, sched = run_profiles("torch", 3, disabled=disabled, batch_size=16)
    assert got == want
    names = sched._fws["default-scheduler"].filter_names
    assert not set(disabled) & set(names)
    fs_plan, comb = sched._fws["default-scheduler"].kernel_plans()
    assert not set(disabled) & set(fs_plan.bit_of)
    from kubernetes_tpu_torch.kernels.filter_score import RAW_PLANES

    for name, w in zip(RAW_PLANES, comb.weights):
        assert (w == 0.0) == (name in disabled), (name, w)


def test_frameworks_rebuild_on_domain_growth_and_union_events():
    store = TStore()
    fac = profile_factories("torch", store)
    sched = TorchScheduler(store, profiles=fac, batch_size=8, device="cpu")
    fws = {p: sched._framework(p) for p in PROFILE_NAMES}
    dra = sched.dra_plugin
    dra.claims_allocated["allocated"] = 7
    # a key with more values than the cap: the domain bound doubles
    sched.encoder.topo_value_maps.append({f"v{i}": i for i in range(2 * sched._fw_domain_cap)})
    rebuilt = {p: sched._framework(p) for p in PROFILE_NAMES}
    assert all(rebuilt[p] is not fws[p] for p in PROFILE_NAMES)
    assert sched.dra_plugin.claims_allocated["allocated"] == 7
    # SelectorSpread's Service registration reaches the queue's event map
    from kubernetes_tpu_torch.framework.events import EventResource

    svc = [ev for ev in sched.queue._cluster_event_map if ev.resource == EventResource.SERVICE]
    assert svc and "SelectorSpread" in set().union(
        *(sched.queue._cluster_event_map[ev] for ev in svc))
    # the DRA index reaches the default profile's DynamicResources
    assert sched.dra_plugin.index is sched.dra
