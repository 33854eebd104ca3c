"""Dynamic Resource Allocation: named TPU-device claims.

Reference: the JAX package's dra/ (after
pkg/scheduler/framework/plugins/dynamicresources and the resource.k8s.io
API group: ResourceClaim / ResourceSlice structured parameters).  Pods
reference ResourceClaims that the scheduler resolves to SPECIFIC named
devices (a concrete chip on a concrete host in a concrete slice) out of
per-node ResourceSlice inventories.  Layers:

  - ``api.py``: the DRA kinds (copies of the reference's);
  - ``index.py``: ``DraIndex``, the store-fed inventory and allocation
    ledger that projects per-node chip totals into the encoder's claim
    planes (a copy of the reference's);
  - ``controller.py``: ``ResourceClaimController``, template stamping and
    the repair arm (a copy of the reference's);
  - ``plugin.py``: the live ``DynamicResourcesPlugin`` — its filter, score
    and device assume through K24–K26, Reserve / Unreserve / PreBind on
    the host.
"""

from .api import (  # noqa: F401
    CLAIM_ALLOCATED,
    CLAIM_PENDING,
    CLAIM_RESERVED,
    Device,
    DeviceClass,
    DeviceRequest,
    ResourceClaim,
    ResourceClaimTemplate,
    ResourceSlice,
)
from .controller import ResourceClaimController  # noqa: F401
from .index import DraIndex  # noqa: F401
from .plugin import DraAux, DynamicResourcesPlugin  # noqa: F401
