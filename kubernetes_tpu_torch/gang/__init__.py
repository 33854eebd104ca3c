"""Gang scheduling: PodGroup-driven all-or-nothing placement.

Reference: the JAX package's gang/ (after sigs.k8s.io/scheduler-plugins
pkg/coscheduling: the PodGroup CRD and the Coscheduling plugin's
QueueSort / PreFilter / Permit / PostBind / Unreserve chain).  Layers:

  - ``GangDirectory`` (directory.py): the shared host-side runtime — group
    membership from store watch events, quorum PreFilter, Permit
    all-or-nothing release / timeout, phase writes, the gang counters.
  - ``CoschedulingPlugin`` (coscheduling.py): the framework plugin shell
    (QueueSort less, host Permit / Reserve / Unreserve / PostBind hooks,
    and the anchor-slice score through K21).
  - ``gang_all_or_nothing`` (device.py): the in-batch mask through K20 —
    every member of a gang with any unplaced member is withdrawn, so
    partial placements never reach binding.
"""

from .coscheduling import CoschedulingPlugin
from .device import gang_all_or_nothing
from .directory import (
    DEFAULT_GANG_TIMEOUT_SECONDS,
    POD_GROUP_LABEL,
    SLICE_LABEL,
    GangDirectory,
)

__all__ = [
    "CoschedulingPlugin",
    "DEFAULT_GANG_TIMEOUT_SECONDS",
    "GangDirectory",
    "POD_GROUP_LABEL",
    "SLICE_LABEL",
    "gang_all_or_nothing",
]
