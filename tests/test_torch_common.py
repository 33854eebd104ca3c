"""Shared builders for the PyTorch-port parity tests (and a few checks of
the builders themselves).

One seeded cluster description (plain dicts, made with numpy) is built into
either package's API objects, so the JAX package and the port see the same
nodes and pods in the same order.  The other ``test_torch_*`` modules import
these helpers.
"""

from __future__ import annotations

from typing import Dict, List

import jax
import numpy as np
import pytest

import kubernetes_tpu.api.objects as jv1
import kubernetes_tpu.testutil as jtu
import kubernetes_tpu_torch.api.objects as tv1
import kubernetes_tpu_torch.testutil as ttu
from kubernetes_tpu.metrics import scheduler_metrics as jmetrics
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.sim.store import ObjectStore as JStore
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.sim.store import ObjectStore as TStore

PKGS = {"jax": (jtu, jv1), "torch": (ttu, tv1)}

_MB = 1024 * 1024


def node_descs(rng, n: int, *, taints=True, images=True) -> List[Dict]:
    """Heterogeneous nodes: a few shapes (some on exact floor boundaries),
    zones, disks, taints of all three effects, images, unschedulable and
    NotReady nodes."""
    shapes = [
        ("4", "32Gi"),        # node_default
        ("8", "16Gi"),
        ("1000m", "4Gi"),     # 250m / 1Gi pods land on exact 75-point floors
        ("3500m", "1000Mi"),  # odd capacities: non-representable ratios
        ("16", "64Gi"),
    ]
    out = []
    for i in range(n):
        cpu, mem = shapes[int(rng.integers(len(shapes)))]
        d = {
            "name": f"n{i:04d}", "cpu": cpu, "memory": mem, "pods": "110",
            "labels": {"zone": f"z{i % 3}",
                       "disk": str(rng.choice(["ssd", "hdd"]))},
            "taints": [], "images": [], "unschedulable": False,
            "not_ready": False,
        }
        if taints:
            u = rng.random()
            if u < 0.12:
                d["taints"].append(("dedicated", "gpu", "NoSchedule"))
            elif u < 0.18:
                d["taints"].append(("evict", "", "NoExecute"))
            if rng.random() < 0.25:
                d["taints"].append(("flaky", "", "PreferNoSchedule"))
            if rng.random() < 0.1:
                d["taints"].append(("spot", "yes", "PreferNoSchedule"))
        if images:
            for img, size in (("img-a", 300 * _MB), ("img-b", 23 * _MB),
                              ("img-c", 900 * _MB)):
                if rng.random() < 0.4:
                    d["images"].append((img, size))
        d["unschedulable"] = bool(rng.random() < 0.06)
        d["not_ready"] = bool(rng.random() < 0.04)
        out.append(d)
    return out


# pending-pod templates: the main-path plugins' content, each a class
TEMPLATES = [
    {"req": {"cpu": "100m", "memory": "500Mi"}},                      # pod_default
    {"req": {"cpu": "250m", "memory": "1Gi"}, "node_selector": {"disk": "ssd"}},
    {"req": {"cpu": "500m", "memory": "333Mi"},
     "tolerations": [("dedicated", "gpu", "NoSchedule", "Equal")]},
    {"req": {"cpu": "1", "memory": "1Gi"}, "affinity_in": ("zone", ["z0", "z1"]),
     "preferred": [(10, "disk", ["ssd"]), (3, "zone", ["z1"])]},
    {"req": {"cpu": "200m", "memory": "256Mi"}, "host_ports": [(8080, "TCP", "")],
     "images": ["img-a", "img-c"]},
    {"req": {"cpu": "300m", "memory": "700Mi"},
     "tolerations": [("", "", "", "Exists")], "images": ["img-b"]},
    {"req": {"cpu": "150m", "memory": "400Mi"},
     "tolerations": [("flaky", "", "PreferNoSchedule", "Exists"),
                     ("node.kubernetes.io/unschedulable", "", "NoSchedule",
                      "Exists")],
     "host_ports": [(9090, "TCP", "10.0.0.1")]},
    {"req": {"cpu": "64", "memory": "1Gi"}},                          # fits nowhere
]


def pod_descs(rng, k: int, templates=TEMPLATES, prefix="p", start_ts=0.0) -> List[Dict]:
    out = []
    for i in range(k):
        t = templates[int(rng.integers(len(templates)))]
        d = dict(t)
        d["name"] = f"{prefix}{i:04d}"
        d["ts"] = start_ts + float(i)
        out.append(d)
    return out


def port_sync_pdbs(store) -> None:
    """The reference disruption controller's ``sync_pdbs`` arithmetic
    (controllers/disruption.py:42-73) for integer minAvailable, on a port
    store: the port has no disruption controller, and its eviction gate
    reads ``disruptions_allowed``."""
    from kubernetes_tpu_torch.api.labels import match_label_selector

    pods, _ = store.list("Pod")
    for pdb in store.list("PodDisruptionBudget")[0]:
        matching = [p for p in pods if p.namespace == pdb.metadata.namespace
                    and match_label_selector(pdb.selector, p.metadata.labels)]
        healthy = sum(1 for p in matching if p.spec.node_name)
        desired = max(0, int(pdb.min_available or 0))
        pdb.expected_pods, pdb.current_healthy = len(matching), healthy
        pdb.desired_healthy, pdb.disruptions_allowed = desired, max(0, healthy - desired)
        store.update("PodDisruptionBudget", pdb)


def scheduled_descs(rng, k: int, node_names: List[str], prefix="s") -> List[Dict]:
    out = []
    for i in range(k):
        out.append({
            "name": f"{prefix}{i:04d}", "ts": -1000.0 + i,
            "req": {"cpu": str(rng.choice(["100m", "1", "250m"])),
                    "memory": str(rng.choice(["1Gi", "500Mi"]))},
            "labels": {"app": str(rng.choice(["web", "db"]))},
            "node": node_names[int(rng.integers(len(node_names)))],
            "host_ports": [(8080, "TCP", "")] if rng.random() < 0.1 else [],
        })
    return out


def make_node_obj(pkg: str, d: Dict):
    tu, v1 = PKGS[pkg]
    w = tu.make_node().name(d["name"]).capacity(
        {"cpu": d["cpu"], "memory": d["memory"], "pods": d["pods"]})
    for k, v in d["labels"].items():
        w = w.label(k, v)
    for key, val, eff in d["taints"]:
        w = w.taint(key, val, eff)
    for img, size in d["images"]:
        w = w.image(img, size)
    if d["unschedulable"]:
        w = w.unschedulable()
    node = w.obj()
    # fixed identity fields: the default uid and timestamp come from
    # per-process counters and clocks that differ between the packages
    node.metadata.uid = d["name"]
    node.metadata.creation_timestamp = 0.0
    if d["not_ready"]:
        node.status.conditions = [{"type": "Ready", "status": "False"}]
    return node


def make_pod_obj(pkg: str, d: Dict):
    tu, v1 = PKGS[pkg]
    w = (tu.make_pod().name(d["name"]).uid(d["name"]).namespace(d.get("ns", "default"))
         .req(d["req"]).creation_timestamp(d["ts"]))
    for k, v in d.get("labels", {}).items():
        w = w.label(k, v)
    if d.get("node_selector"):
        w = w.node_selector(d["node_selector"])
    for key, val, eff, op in d.get("tolerations", []):
        w = w.toleration(key, val, eff, operator=op)
    if d.get("affinity_in"):
        w = w.node_affinity_in(*d["affinity_in"])
    for weight, key, values in d.get("preferred", []):
        w = w.preferred_node_affinity(weight, key, values)
    for port, proto, ip in d.get("host_ports", []):
        w = w.host_port(port, proto, ip)
    # topology spread: (maxSkew, topologyKey, whenUnsatisfiable, selector
    # labels, minDomains or None)
    for skew, key, when, sel, min_domains in d.get("spread", []):
        w = w.topology_spread(skew, key, when, labels=sel, min_domains=min_domains)
    # pod (anti)affinity: (topologyKey, selector labels, anti, weight or None
    # for a required term, namespaces or None)
    for key, sel, anti, weight, namespaces in d.get("pod_affinity", []):
        w = w.pod_affinity(key, sel, anti=anti, weight=weight, namespaces=namespaces)
    if d.get("priority") is not None:
        w = w.priority(d["priority"])
    if d.get("node"):
        w = w.node(d["node"])
    pod = w.obj()
    for j, img in enumerate(d.get("images", [])):
        if j == 0:
            pod.spec.containers[0].image = img
        else:
            pod.spec.containers.append(v1.Container(name=f"c{j}", image=img))
    return pod


# --- clusters and a runner for the full auction and the exact scan ---------------------

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def _plain_node(i, labels):
    return {"name": f"n{i:03d}", "cpu": "4", "memory": "16Gi", "pods": "110",
            "labels": labels, "taints": [], "images": [], "unschedulable": False,
            "not_ready": False}


def engine_cluster(kind: str):
    """(nodes, scheduled pods, pending pods, batch size) of a small cluster
    whose batches the reference takes off its dedup engine:

    * "hetero": every pod its own identity class (distinct cpu requests on
      heterogeneous nodes, a template that fits nowhere among them) — more
      classes than half of every batch;
    * "spread10": self-matching zone spread pods (DoNotSchedule maxSkew 1,
      and ScheduleAnyway) at priority 10 over running priority-0 pods —
      coupled batches with pods that could preempt;
    * "anti10": self-matching required hostname anti-affinity at priority
      10 (a parallel-safe class);
    * "affinity10": self-matching required zone affinity over three zones
      at priority 10 (one coupled component; the first pod of the series
      finds no match; count tables);
    * "preferred10": self-matching preferred hostname affinity at priority
      10 with a preferred zone anti-affinity term (count planes);
    * "mixed": one queue whose batches take every engine — zone spread and
      hostname anti-affinity at priority 10, then identical pod_default
      pods, then pods of distinct requests."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    req = {"cpu": "100m", "memory": "500Mi"}
    if kind == "hetero":
        nodes = node_descs(rng, 24, images=False)
        pre = scheduled_descs(rng, 10, [d["name"] for d in nodes])
        pods = [{"name": f"h{i:03d}", "ts": float(i),
                 "req": {"cpu": f"{100 + 7 * i}m", "memory": f"{200 + 3 * i}Mi"}}
                for i in range(40)]
        pods[5] = dict(pods[5], req={"cpu": "64", "memory": "1Gi"})  # fits nowhere
        return nodes, pre, pods, 16
    zoned = [_plain_node(i, {ZONE: f"moon-{i % 3}", HOST: f"n{i:03d}"}) for i in range(12)]
    pre = [{"name": f"r{i:02d}", "ts": -100.0 + i, "req": {"cpu": "100m"},
            "labels": {"color": "blue" if i % 2 else "red"}, "node": f"n{(5 * i) % 12:03d}"}
           for i in range(8)]
    blue = {"color": "blue"}
    if kind == "spread10":
        pods = [{"name": f"sp{i:03d}", "ts": float(i), "req": req, "labels": blue,
                 "priority": 10,
                 "spread": [(1, ZONE, "DoNotSchedule" if i % 4 else "ScheduleAnyway",
                             blue, None)]} for i in range(36)]
        return zoned, pre, pods, 8
    if kind == "anti10":
        nodes = [_plain_node(i, {HOST: f"n{i:03d}"}) for i in range(24)]
        pods = [{"name": f"an{i:03d}", "ts": float(i), "req": req,
                 "labels": {"color": "green"}, "priority": 10,
                 "pod_affinity": [(HOST, {"color": "green"}, True, None, None)]}
                for i in range(20)]
        return nodes, [], pods, 8
    if kind == "affinity10":
        purple = {"color": "purple"}
        pods = [{"name": f"af{i:03d}", "ts": float(i), "req": req, "labels": purple,
                 "priority": 10, "pod_affinity": [(ZONE, purple, False, None, None)]}
                for i in range(20)]
        return zoned, pre, pods, 8
    if kind == "mixed":
        pods = [{"name": f"sp{i:03d}", "ts": float(i), "req": req, "labels": blue,
                 "priority": 10, "spread": [(1, ZONE, "DoNotSchedule", blue, None)]}
                for i in range(16)]
        pods += [{"name": f"an{i:03d}", "ts": 16.0 + i, "req": req,
                  "labels": {"color": "green"}, "priority": 10,
                  "pod_affinity": [(HOST, {"color": "green"}, True, None, None)]}
                 for i in range(8)]
        pods += [{"name": f"pd{i:03d}", "ts": 100.0 + i, "req": req} for i in range(16)]
        pods += [{"name": f"hx{i:03d}", "ts": 200.0 + i,
                  "req": {"cpu": f"{50 + 9 * i}m", "memory": "300Mi"}} for i in range(16)]
        return zoned, pre, pods, 8
    assert kind == "preferred10"
    pods = [{"name": f"pf{i:03d}", "ts": float(i), "req": req, "labels": {"color": "red"},
             "priority": 10,
             "pod_affinity": [(HOST, {"color": "red"}, False, 3, None),
                              (ZONE, blue, True, 2, None)]} for i in range(24)]
    return zoned, pre, pods, 8


def _settle(fl):
    """Let a pipelined reference dispatch finish before its host goes on
    (see tests/test_torch_pipeline.py _settle_reference)."""
    if fl is not None and fl.node_row_dev is not None:
        jax.block_until_ready(fl.node_row_dev)


def route_log(pkg, monkeypatch):
    """Record, for every dispatch, (engine, deduped, dedup-fallback reason):
    the reference's from its _run_assignment and fallback counter, the
    port's from its dedup gate and fused cycle."""
    log = []
    if pkg == "jax":
        orig = TPUScheduler._run_assignment

        def run_assignment(self, *a, **kw):
            before = jmetrics.dedup_fallback.items()
            out = orig(self, *a, **kw)
            after = jmetrics.dedup_fallback.items()
            reason = [k[0] for k, v in after.items() if v != before.get(k, 0.0)]
            dedup = out[1] == "batch" and self._last_dedup
            log.append((out[1], dedup, reason[0] if reason else None))
            return out

        orig_dispatch = TPUScheduler._dispatch_batch

        def dispatch(self, *a, **kw):
            fl = orig_dispatch(self, *a, **kw)
            _settle(fl)
            return fl

        monkeypatch.setattr(TPUScheduler, "_run_assignment", run_assignment)
        monkeypatch.setattr(TPUScheduler, "_dispatch_batch", dispatch)
    else:
        reasons = []
        orig_gate = TorchScheduler._dedup_classes
        orig_cycle = TorchScheduler._fused_cycle

        def dedup_classes(self, *a, **kw):
            out = orig_gate(self, *a, **kw)
            reasons.append(out[2])
            return out

        def fused_cycle(self, batch, mode, classes, *a, **kw):
            reason = reasons.pop() if mode == "batch" else None
            log.append((mode, classes is not None, reason))
            return orig_cycle(self, batch, mode, classes, *a, **kw)

        monkeypatch.setattr(TorchScheduler, "_dedup_classes", dedup_classes)
        monkeypatch.setattr(TorchScheduler, "_fused_cycle", fused_cycle)
    return log


def run_engine_cluster(pkg, kind, monkeypatch, **kw):
    """Drive one package's scheduler (``kw``: assign_mode, pipeline, …) over
    ``engine_cluster(kind)`` until idle → (bindings, route log, rounds)."""
    nodes, pre, pods, batch = engine_cluster(kind)
    if pkg == "jax":
        store = JStore()
        sched = TPUScheduler(store, batch_size=batch, rng_key=None, clock=fake_clock(),
                             batch_wait=0, **kw)

        def rounds():
            return sum(jmetrics.assignment_rounds.value((e,)) for e in ("batch", "scan"))
    else:
        store = TStore()
        sched = TorchScheduler(store, batch_size=batch, device="cpu", clock=fake_clock(),
                               batch_wait=0, **kw)

        def rounds():
            return sched.rounds_total
    for d in nodes:
        store.create("Node", make_node_obj(pkg, d))
    for d in pre:
        store.create("Pod", make_pod_obj(pkg, d))
    for d in pods:
        store.create("Pod", make_pod_obj(pkg, d))
    log = route_log(pkg, monkeypatch)
    r0 = rounds()
    # a pod that fits nowhere waits in backoff: no spin for it
    sched.run_until_idle(backoff_wait=0)
    monkeypatch.undo()
    if pkg == "torch":
        sched.close()
    bound, _ = store.list("Pod")
    return {p.metadata.name: p.spec.node_name for p in bound}, log, rounds() - r0


def check_engine_parity(kind, monkeypatch, engines, **kw):
    """The port's bindings, per-dispatch routes and engine rounds equal the
    reference's on ``engine_cluster(kind)``; every pending pod is bound
    unless its template fits nowhere; the dispatches took ``engines``
    (a set of "scan" / "full" / "dedup")."""
    jb, jlog, jrounds = run_engine_cluster("jax", kind, monkeypatch, **kw)
    tb, tlog, trounds = run_engine_cluster("torch", kind, monkeypatch, **kw)
    assert tb == jb, {k: (jb[k], tb[k]) for k in jb if jb[k] != tb.get(k)}
    unbound = {k for k, v in tb.items() if not v}
    assert unbound == ({"h005"} if kind == "hetero" else set())
    assert [(m, d, r) for m, d, r in tlog] == jlog
    assert trounds == jrounds > 0
    took = {"scan" if m == "scan" else ("dedup" if d else "full") for m, d, _r in tlog}
    assert took == set(engines), tlog
    return tlog


def fake_clock():
    """A deterministic scheduler clock (each read advances 1 ms)."""
    t = [0.0]

    def clock():
        t[0] += 1e-3
        return t[0]

    return clock


@pytest.mark.parametrize("seed", [0, 1])
def test_builders_give_equal_objects(seed):
    """The two packages' builders turn one description into objects with
    the same serialized content."""
    rng = np.random.default_rng(seed)
    nodes = node_descs(rng, 12)
    pods = pod_descs(rng, 16)
    for d in nodes:
        a, b = make_node_obj("jax", d), make_node_obj("torch", d)
        assert repr(a).replace("kubernetes_tpu.", "") == \
            repr(b).replace("kubernetes_tpu_torch.", "")
    for d in pods:
        a, b = make_pod_obj("jax", d), make_pod_obj("torch", d)
        assert a.spec.containers[0].image == b.spec.containers[0].image
        assert a.metadata.creation_timestamp == b.metadata.creation_timestamp
        assert repr(a.spec) == repr(b.spec)
