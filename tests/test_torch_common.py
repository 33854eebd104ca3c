"""Shared builders for the PyTorch-port parity tests (and a few checks of
the builders themselves).

One seeded cluster description (plain dicts, made with numpy) is built into
either package's API objects, so the JAX package and the port see the same
nodes and pods in the same order.  The other ``test_torch_*`` modules import
these helpers.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import pytest

import kubernetes_tpu.api.objects as jv1
import kubernetes_tpu.testutil as jtu
import kubernetes_tpu_torch.api.objects as tv1
import kubernetes_tpu_torch.testutil as ttu

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
