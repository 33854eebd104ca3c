"""Resource-dimension layout and unit scaling for device tensors.

Device resource tensors are **int32** in scaled units so fit comparisons are exact
and TPU-native (no float rounding, no emulated int64):

  dim 0: cpu                milli-cores   (int32 max ≈ 2.1M cores)
  dim 1: memory             KiB           (int32 max = 2 TiB per node)
  dim 2: ephemeral-storage  MiB           (int32 max = 2 PiB per node)
  dim 3: pods               count
  dims 4..: extended/scalar resources, unit = 1 (dictionary-assigned slots)

Pod **requests are ceil'd** to the unit and node **allocatable is floor'd**, so the
device filter is conservative: it never admits a pod the exact-integer host oracle
would reject (it can reject a fit within one unit of the boundary — sub-KiB memory
granularity does not occur in practice).

Reference semantics being encoded: the int64 Resource vector of
pkg/scheduler/framework/types.go:416-425.
"""

from __future__ import annotations

from ..api import resource as res

# Base dimension indices.
DIM_CPU = 0
DIM_MEMORY = 1
DIM_EPHEMERAL = 2
DIM_PODS = 3
NUM_BASE_DIMS = 4

_KI = 1024
_MI = 1024 * 1024


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def pow2_round_up(n: int, minimum: int = 1) -> int:
    """Shared device-shape discipline: capacities grow by doubling so XLA
    recompiles O(log n) times (used by encoding, selector compilation, batches)."""
    p = max(minimum, 1)
    while p < n:
        p *= 2
    return p


def resource_to_units(r: res.Resource, num_dims: int, extended_index, ceil: bool):
    """Resource → list[int] of length num_dims in scaled units.

    extended_index: mapping resource-name → dim index (≥ NUM_BASE_DIMS) for scalar
    resources; unknown scalar resources raise KeyError (callers register first).
    """
    div = _ceil_div if ceil else lambda a, b: a // b
    out = [0] * num_dims
    out[DIM_CPU] = r.milli_cpu
    out[DIM_MEMORY] = div(r.memory, _KI)
    out[DIM_EPHEMERAL] = div(r.ephemeral_storage, _MI)
    out[DIM_PODS] = r.allowed_pod_number
    for name, v in r.scalar_resources.items():
        out[extended_index[name]] = v
    return out


def request_to_units(r: res.Resource, num_dims: int, extended_index):
    return resource_to_units(r, num_dims, extended_index, ceil=True)


def allocatable_to_units(r: res.Resource, num_dims: int, extended_index):
    return resource_to_units(r, num_dims, extended_index, ceil=False)
