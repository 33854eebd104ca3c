"""KubeSchedulerConfiguration: v1beta3-schema-compatible componentconfig, on
the port.

Reference: the JAX package's config/componentconfig.py (``PluginEnable`` /
``PluginSet`` :41-61, ``KubeSchedulerProfile`` with ``effective_plugins``
:64-105, ``KubeSchedulerConfiguration.from_dict`` :108-173, ``load_config``
:176, ``build_plugins_for_profile`` :195, ``_construct`` :212,
``scheduler_from_config`` :265), itself after
pkg/scheduler/apis/config/types.go:41-196, v1beta3/default_plugins.go:32-51
and types_pluginargs.go.

Profiles, plugin enable / disable with weights and the typed args of the
plugin set, parsed exactly as the reference parses them; the effective
plugin lists and weights equal the reference's.  ``scheduler_from_config``
builds a ``TorchScheduler`` with one framework per profile on ``device``
(``"cuda"`` unless the caller asks for the CPU).

The reference's two faults are kept bit for bit, so that a profile built
from a configuration schedules as the reference's does (ROADMAP Queue C):
SelectorSpread is constructed without the store (it finds no selector, and
every node scores 100), and RequestedToCapacityRatio's ``shape`` argument
is not passed on (the plugin keeps its default shape).

On the port: ``nodeAxisSharding`` is parsed and validated as in the
reference, and ``"on"`` or a device count above 1 raises
NotImplementedError at ``scheduler_from_config`` (node-axis sharding over
several GPUs is ROADMAP Queue A item 11); the volume plugins, which the
port carries as pass-through halves only, raise naming Queue A item 8c.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

from .. import plugins as P
from ..framework.interface import PluginWithWeight

DEFAULT_SCHEDULER_NAME = "default-scheduler"

# default enablement + weights: apis/config/v1beta3/default_plugins.go:32-51
DEFAULT_PLUGIN_ORDER = [
    ("NodeUnschedulable", 0),
    ("NodeName", 0),
    ("TaintToleration", 3),
    ("NodeAffinity", 2),
    ("NodePorts", 0),
    ("NodeResourcesFit", 1),
    ("PodTopologySpread", 2),
    ("InterPodAffinity", 2),
    ("NodeResourcesBalancedAllocation", 1),
    ("ImageLocality", 1),
]

# the reference's volume plugin names (the cloud-specific limit plugins map
# onto NodeVolumeLimits there): not ported as live plugins yet
VOLUME_PLUGINS = ("VolumeBinding", "VolumeZone", "VolumeRestrictions", "NodeVolumeLimits",
                  "EBSLimits", "GCEPDLimits", "AzureDiskLimits")


@dataclass
class PluginEnable:
    name: str
    weight: Optional[int] = None


@dataclass
class PluginSet:
    enabled: List[PluginEnable] = field(default_factory=list)
    disabled: List[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> "PluginSet":
        if not d:
            return cls()
        return cls(
            enabled=[PluginEnable(e["name"], e.get("weight"))
                     for e in d.get("enabled") or []],
            disabled=[e["name"] for e in d.get("disabled") or []],
        )


@dataclass
class KubeSchedulerProfile:
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    plugins: Dict[str, PluginSet] = field(default_factory=dict)  # per extension point
    plugin_config: Dict[str, Dict[str, Any]] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Mapping) -> "KubeSchedulerProfile":
        plugins = {point: PluginSet.from_dict(ps)
                   for point, ps in (d.get("plugins") or {}).items()}
        plugin_config = {pc["name"]: pc.get("args") or {}
                         for pc in d.get("pluginConfig") or []}
        return cls(scheduler_name=d.get("schedulerName", DEFAULT_SCHEDULER_NAME),
                   plugins=plugins, plugin_config=plugin_config)

    def effective_plugins(self) -> List[PluginEnable]:
        """Default set, minus disabled, plus explicitly enabled (with
        weights): the multipoint merge of v1beta3 defaulting — "*" in
        disabled wipes the defaults; explicit enables append or override."""
        multi = self.plugins.get("multiPoint", PluginSet())
        score = self.plugins.get("score", PluginSet())
        disabled = set(multi.disabled) | set(score.disabled)
        out: List[PluginEnable] = []
        if "*" not in disabled:
            for name, weight in DEFAULT_PLUGIN_ORDER:
                if name not in disabled:
                    out.append(PluginEnable(name, weight))
        for e in list(multi.enabled) + list(score.enabled):
            existing = next((x for x in out if x.name == e.name), None)
            if existing is None:
                out.append(PluginEnable(e.name, e.weight))
            elif e.weight is not None:
                existing.weight = e.weight
        return out


@dataclass
class KubeSchedulerConfiguration:
    profiles: List[KubeSchedulerProfile] = field(default_factory=list)
    parallelism: int = 16  # types.go:53 (kept for compatibility: the device path is dense)
    percentage_of_nodes_to_score: int = 0  # types.go:70 (kept for compatibility)
    pod_initial_backoff_seconds: float = 1.0
    pod_max_backoff_seconds: float = 10.0
    # node-axis sharding of the device path (the reference's own knob):
    # "auto" | "on" | "off" | a device count; on the port only a single
    # device ("auto", "off", 0 or 1) runs
    node_axis_sharding: object = "auto"
    # the micro-bucket policy's attempt-latency target (TorchScheduler
    # latency_target_ms); None = off
    latency_target_ms: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Mapping) -> "KubeSchedulerConfiguration":
        api = d.get("apiVersion", "")
        if api and not api.startswith("kubescheduler.config.k8s.io/"):
            raise ValueError(f"unsupported apiVersion {api}")
        profiles = [KubeSchedulerProfile.from_dict(p) for p in d.get("profiles") or []]
        if not profiles:
            profiles = [KubeSchedulerProfile()]
        sharding = d.get("nodeAxisSharding", "auto")
        if not (sharding in ("auto", "on", "off", True, False) or isinstance(sharding, int)):
            raise ValueError(f"unsupported nodeAxisSharding {sharding!r}")
        if (isinstance(sharding, int) and not isinstance(sharding, bool)
                and sharding > 1 and sharding & (sharding - 1)):
            raise ValueError(
                f"nodeAxisSharding {sharding} is not a power of two (the "
                "node-axis mesh requires a power-of-two device count)")
        lt = d.get("latencyTargetMs")
        if lt is not None:
            lt = float(lt)
            if lt < 0:
                raise ValueError(f"latencyTargetMs must be >= 0, got {lt}")
            if lt == 0:
                lt = None  # 0 = explicit off, same as absent
        return cls(
            profiles=profiles,
            parallelism=int(d.get("parallelism", 16)),
            percentage_of_nodes_to_score=int(d.get("percentageOfNodesToScore", 0)),
            pod_initial_backoff_seconds=float(d.get("podInitialBackoffSeconds", 1)),
            pod_max_backoff_seconds=float(d.get("podMaxBackoffSeconds", 10)),
            node_axis_sharding=sharding,
            latency_target_ms=lt,
        )

    def profile(self, scheduler_name: str = DEFAULT_SCHEDULER_NAME) -> KubeSchedulerProfile:
        for p in self.profiles:
            if p.scheduler_name == scheduler_name:
                return p
        return self.profiles[0]


def load_config(source) -> KubeSchedulerConfiguration:
    """A dict, a YAML (else JSON) string, or a file path."""
    if isinstance(source, Mapping):
        return KubeSchedulerConfiguration.from_dict(source)
    text = source
    if isinstance(source, str) and "\n" not in source \
            and source.endswith((".yaml", ".yml", ".json")):
        with open(source) as f:
            text = f.read()
    try:
        import yaml  # type: ignore

        data = yaml.safe_load(text)
    except ImportError:  # no yaml: JSON
        import json

        data = json.loads(text)
    return KubeSchedulerConfiguration.from_dict(data or {})


def build_plugins_for_profile(profile: KubeSchedulerProfile, domain_cap: int,
                              extended_index=None,
                              num_resource_dims: int = 8) -> List[PluginWithWeight]:
    """The profile's plugin set with its typed args (types_pluginargs.go);
    a name the port has no plugin for is skipped, as in the reference."""
    out: List[PluginWithWeight] = []
    for e in profile.effective_plugins():
        args = profile.plugin_config.get(e.name, {})
        plugin = _construct(e.name, args, domain_cap, extended_index, num_resource_dims)
        if plugin is None:
            continue
        default_w = dict(DEFAULT_PLUGIN_ORDER).get(e.name, 1)
        out.append(PluginWithWeight(plugin, e.weight if e.weight is not None else default_w))
    return out


def _construct(name, args, domain_cap, extended_index, num_dims):
    if name == "NodeResourcesFit":
        strat = args.get("scoringStrategy") or {}
        resources = {r["name"]: r.get("weight", 1)
                     for r in strat.get("resources") or [{"name": "cpu", "weight": 1},
                                                         {"name": "memory", "weight": 1}]}
        # the reference passes no shape (its fault, kept: ROADMAP Queue C)
        return P.FitPlugin(strategy=strat.get("type", "LeastAllocated"), resources=resources,
                           num_resource_dims=num_dims, extended_index=extended_index)
    if name == "NodeResourcesBalancedAllocation":
        resources = {r["name"]: r.get("weight", 1)
                     for r in args.get("resources") or [{"name": "cpu", "weight": 1},
                                                        {"name": "memory", "weight": 1}]}
        return P.BalancedAllocationPlugin(resources=resources, num_resource_dims=num_dims,
                                          extended_index=extended_index)
    if name == "InterPodAffinity":
        return P.InterPodAffinityPlugin(
            domain_cap=domain_cap, hard_pod_affinity_weight=args.get("hardPodAffinityWeight", 1))
    if name == "PodTopologySpread":
        return P.PodTopologySpreadPlugin(domain_cap=domain_cap)
    if name in VOLUME_PLUGINS:
        raise NotImplementedError(
            f"plugin {name}: volume binding is not ported yet (ROADMAP Queue A item 8c)")
    simple = {
        "TaintToleration": P.TaintTolerationPlugin,
        "NodeAffinity": P.NodeAffinityPlugin,
        "NodeName": P.NodeNamePlugin,
        "NodePorts": P.NodePortsPlugin,
        "NodeUnschedulable": P.NodeUnschedulablePlugin,
        "ImageLocality": P.ImageLocalityPlugin,
        # built without the store, as the reference builds it (ROADMAP Queue C)
        "SelectorSpread": P.SelectorSpreadPlugin,
    }
    ctor = simple.get(name)
    return ctor() if ctor else None


def scheduler_from_config(store, cfg: KubeSchedulerConfiguration, device="cuda", **kwargs):
    """A TorchScheduler from a KubeSchedulerConfiguration: every profile
    becomes a framework keyed by its schedulerName (profile.NewMap,
    profile/profile.go:48); the queue's backoff knobs and the latency
    target carry over.  ``device`` as every entry point: ``"cuda"`` unless
    the caller asks for the CPU."""
    from ..scheduler import TorchScheduler

    sharding = cfg.node_axis_sharding
    if sharding is True or sharding == "on" or (
            isinstance(sharding, int) and not isinstance(sharding, bool) and sharding > 1):
        raise NotImplementedError(
            f"nodeAxisSharding {sharding!r}: node-axis sharding over several GPUs is not "
            "ported yet (ROADMAP Queue A item 11)")
    profiles = {p.scheduler_name: (lambda d, _p=p: build_plugins_for_profile(_p, domain_cap=d))
                for p in cfg.profiles}
    kwargs.setdefault("latency_target_ms", cfg.latency_target_ms)
    return TorchScheduler(store, profiles=profiles, device=device,
                          pod_initial_backoff=cfg.pod_initial_backoff_seconds,
                          pod_max_backoff=cfg.pod_max_backoff_seconds, **kwargs)
