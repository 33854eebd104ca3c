"""The default plugin set as batched tensor programs (plain torch).

Reference: pkg/scheduler/framework/plugins/ (registry.go:47-81).  Filter
returns ``bool[B, N]``, Score ``float32[B, N]``.  The volume plugins,
whose live content is outside this slice, keep only their pass-through
halves (plugins/passthrough.py); Coscheduling lives in gang/coscheduling.py
and DynamicResources in dra/plugin.py.
"""

from .noderesources import FitPlugin, BalancedAllocationPlugin  # noqa: F401
from .tainttoleration import TaintTolerationPlugin  # noqa: F401
from .nodeaffinity import NodeAffinityPlugin  # noqa: F401
from .trivial import (  # noqa: F401
    NodeNamePlugin,
    NodePortsPlugin,
    NodeUnschedulablePlugin,
    ImageLocalityPlugin,
)
from .passthrough import (  # noqa: F401
    NodeVolumeLimitsPlugin,
    VolumeBindingPlugin,
    VolumeRestrictionsPlugin,
    VolumeZonePlugin,
)
from .podtopologyspread import PodTopologySpreadPlugin  # noqa: F401
from .interpodaffinity import InterPodAffinityPlugin  # noqa: F401
