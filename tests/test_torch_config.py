"""ComponentConfig on the port against the JAX package's config/.

* The reference's tests/test_config.py scenarios on the port: YAML
  defaults and typed args, disable + weight override, the empty config's
  default profile, two profiles through ``scheduler_from_config``, v1beta2
  accepted and a foreign apiVersion refused.
* For every configuration here, the effective plugin list (names and
  weights, in order) and the built plugins' names, weights and typed args
  equal the reference's.
* The reference's two faults, kept on the port: SelectorSpread built from
  a configuration has no store in both packages, and a
  RequestedToCapacityRatio ``shape`` argument is ignored in both.
* On the port: nodeAxisSharding "on" or a device count above 1 raises
  naming Queue A item 11, the volume plugins raise naming item 8c, and the
  default device is the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import kubernetes_tpu.config as jcfg
import kubernetes_tpu_torch.config as tcfg
from kubernetes_tpu.sim.store import ObjectStore as JStore
from kubernetes_tpu_torch.sim.store import ObjectStore as TStore
from kubernetes_tpu_torch.testutil import make_node, make_pod

YAML_DOC = """
apiVersion: kubescheduler.config.k8s.io/v1beta3
kind: KubeSchedulerConfiguration
parallelism: 8
podInitialBackoffSeconds: 2
profiles:
  - schedulerName: default-scheduler
    pluginConfig:
      - name: InterPodAffinity
        args:
          hardPodAffinityWeight: 5
      - name: NodeResourcesFit
        args:
          scoringStrategy:
            type: MostAllocated
            resources:
              - name: cpu
                weight: 2
              - name: memory
                weight: 1
  - schedulerName: spread-scheduler
    plugins:
      score:
        disabled:
          - name: ImageLocality
        enabled:
          - name: PodTopologySpread
            weight: 5
"""

CONFIGS = {
    "yaml": YAML_DOC,
    "empty": {},
    "two profiles": {
        "apiVersion": "kubescheduler.config.k8s.io/v1beta3",
        "profiles": [
            {"schedulerName": "default-scheduler"},
            {"schedulerName": "no-spread",
             "plugins": {"multiPoint": {"disabled": [
                 {"name": "PodTopologySpread"}, {"name": "InterPodAffinity"}]}}},
        ],
        "podInitialBackoffSeconds": 2,
    },
    "v1beta2": {
        "apiVersion": "kubescheduler.config.k8s.io/v1beta2",
        "kind": "KubeSchedulerConfiguration",
        "profiles": [{"schedulerName": "default-scheduler",
                      "plugins": {"score": {"disabled": [{"name": "ImageLocality"}]}}}],
        "percentageOfNodesToScore": 50,
    },
    "selector spread + rtcr": {
        "profiles": [
            {"schedulerName": "spread",
             "plugins": {"multiPoint": {"enabled": [{"name": "SelectorSpread", "weight": 1}]}},
             "pluginConfig": [{"name": "NodeResourcesFit", "args": {"scoringStrategy": {
                 "type": "RequestedToCapacityRatio",
                 "requestedToCapacityRatio": {"shape": [
                     {"utilization": 0, "score": 10}, {"utilization": 100, "score": 0}]},
                 "shape": [(0, 10), (100, 0)]}}}]},
            {"schedulerName": "wiped",
             "plugins": {"multiPoint": {"disabled": [{"name": "*"}],
                                        "enabled": [{"name": "NodeResourcesFit", "weight": 3},
                                                    {"name": "TaintToleration"},
                                                    {"name": "NotAPlugin", "weight": 2}]}}},
        ],
    },
}


def _args(plugin) -> dict:
    """The typed args a built plugin carries (for the parity check)."""
    out = {}
    for attr in ("strategy", "hard_weight", "domain_cap", "store"):
        if hasattr(plugin, attr):
            out[attr] = getattr(plugin, attr)
    for attr in ("weights", "sel", "shape_x", "shape_y"):
        if hasattr(plugin, attr):
            out[attr] = np.asarray(getattr(plugin, attr)).tolist()
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_effective_plugins_equal_reference(name):
    j, t = jcfg.load_config(CONFIGS[name]), tcfg.load_config(CONFIGS[name])
    assert [p.scheduler_name for p in t.profiles] == [p.scheduler_name for p in j.profiles]
    assert (t.parallelism, t.percentage_of_nodes_to_score, t.pod_initial_backoff_seconds,
            t.pod_max_backoff_seconds, t.node_axis_sharding, t.latency_target_ms) == \
        (j.parallelism, j.percentage_of_nodes_to_score, j.pod_initial_backoff_seconds,
         j.pod_max_backoff_seconds, j.node_axis_sharding, j.latency_target_ms)
    for jp, tp in zip(j.profiles, t.profiles):
        assert [(e.name, e.weight) for e in tp.effective_plugins()] == \
            [(e.name, e.weight) for e in jp.effective_plugins()]
        jb = jcfg.build_plugins_for_profile(jp, domain_cap=8)
        tb = tcfg.build_plugins_for_profile(tp, domain_cap=8)
        assert [(pw.plugin.name, pw.weight, _args(pw.plugin)) for pw in tb] == \
            [(pw.plugin.name, pw.weight, _args(pw.plugin)) for pw in jb]


def test_load_yaml_defaults():
    cfg = tcfg.load_config(YAML_DOC)
    assert cfg.parallelism == 8
    assert cfg.pod_initial_backoff_seconds == 2
    assert len(cfg.profiles) == 2
    plugins = tcfg.build_plugins_for_profile(cfg.profile("default-scheduler"), domain_cap=8)
    by_name = {pw.plugin.name: pw for pw in plugins}
    assert by_name["InterPodAffinity"].plugin.hard_weight == 5.0
    assert by_name["NodeResourcesFit"].plugin.strategy == "MostAllocated"
    assert by_name["TaintToleration"].weight == 3  # default weight kept


def test_profile_disable_and_weight_override():
    cfg = tcfg.load_config(YAML_DOC)
    plugins = tcfg.build_plugins_for_profile(cfg.profile("spread-scheduler"), domain_cap=8)
    assert "ImageLocality" not in {pw.plugin.name for pw in plugins}
    assert {pw.plugin.name: pw for pw in plugins}["PodTopologySpread"].weight == 5


def test_empty_config_gets_default_profile():
    cfg = tcfg.load_config({})
    assert len(cfg.profiles) == 1
    plugins = tcfg.build_plugins_for_profile(cfg.profiles[0], domain_cap=8)
    assert {pw.plugin.name for pw in plugins} >= {
        "NodeResourcesFit", "TaintToleration", "NodeAffinity",
        "PodTopologySpread", "InterPodAffinity"}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_scheduler_from_config_two_profiles(pkg):
    cfg_mod = jcfg if pkg == "jax" else tcfg
    cfg = cfg_mod.load_config(CONFIGS["two profiles"])
    if pkg == "jax":
        from kubernetes_tpu.testutil import make_node as mk_node, make_pod as mk_pod

        store = JStore()
        sched = cfg_mod.scheduler_from_config(store, cfg, batch_size=4)
    else:
        mk_node, mk_pod = make_node, make_pod
        store = TStore()
        sched = cfg_mod.scheduler_from_config(store, cfg, batch_size=4, device="cpu")
    assert set(sched.profiles) == {"default-scheduler", "no-spread"}
    assert sched.queue._initial_backoff == 2
    store.create("Node", mk_node().name("n0").obj())
    p = mk_pod().name("p").uid("p").namespace("default").req({"cpu": "1m"}).obj()
    p.spec.scheduler_name = "no-spread"
    store.create("Pod", p)
    stats = sched.run_until_idle()
    assert stats.scheduled == 1
    assert store.get("Pod", "default", "p").spec.node_name == "n0"
    assert "PodTopologySpread" not in {pw.plugin.name for pw in sched._fws["no-spread"].plugins}


def test_v1beta2_config_accepted():
    prof = tcfg.load_config(CONFIGS["v1beta2"]).profile()
    names = [e.name for e in prof.effective_plugins()]
    assert "ImageLocality" not in names and "NodeResourcesFit" in names
    with pytest.raises(ValueError):
        tcfg.load_config({"apiVersion": "not.a.scheduler/v1"})
    for bad in ({"nodeAxisSharding": 3}, {"nodeAxisSharding": "sideways"},
                {"latencyTargetMs": -1}):
        for mod in (jcfg, tcfg):
            with pytest.raises(ValueError):
                mod.load_config(bad)


def test_reference_faults_kept():
    """SelectorSpread from a configuration is built without the store (it
    finds no selector: every node scores 100), and the RTCR ``shape``
    argument is dropped (the default [(0, 0), (100, 10)] stays) — in both
    packages alike."""
    for mod in (jcfg, tcfg):
        prof = mod.load_config(CONFIGS["selector spread + rtcr"]).profile("spread")
        by = {pw.plugin.name: pw for pw in mod.build_plugins_for_profile(prof, domain_cap=8)}
        ss = by["SelectorSpread"]
        assert ss.weight == 1 and ss.plugin.store is None
        assert ss.plugin._selectors_for(make_pod().label("app", "web").obj()) == []
        fit = by["NodeResourcesFit"].plugin
        assert fit.strategy == "RequestedToCapacityRatio"
        assert np.asarray(fit.shape_x).tolist() == [0.0, 100.0]
        assert np.asarray(fit.shape_y).tolist() == [0.0, 100.0]


def test_port_refusals_name_their_items():
    store = TStore()
    for sharding in ("on", True, 2, 4):
        cfg = tcfg.load_config({"nodeAxisSharding": sharding})
        with pytest.raises(NotImplementedError, match="Queue A item 11"):
            tcfg.scheduler_from_config(store, cfg, device="cpu")
    for sharding in ("auto", "off", 1):
        cfg = tcfg.load_config({"nodeAxisSharding": sharding})
        tcfg.scheduler_from_config(TStore(), cfg, device="cpu").close()
    for name in ("VolumeBinding", "VolumeZone", "NodeVolumeLimits", "EBSLimits"):
        cfg = tcfg.load_config({"profiles": [{"plugins": {"multiPoint": {
            "enabled": [{"name": name}]}}}]})
        with pytest.raises(NotImplementedError, match="Queue A item 8c"):
            tcfg.build_plugins_for_profile(cfg.profiles[0], domain_cap=8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcfg.scheduler_from_config(store, tcfg.load_config({}))
