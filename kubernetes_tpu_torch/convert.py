"""State carried across from the JAX package: numpy arrays → the port's tensors.

The port has no weights; what takes their place is the encoded cluster
state.  These functions take dicts of numpy arrays — what ``np.asarray``
gives for each field of the JAX package's ``DeviceSnapshot``, ``PodBatch``
and ``DynamicState`` — and build the port's structures on a given device,
so the JAX encoder's exact arrays can be fed into the port's runtime and
kernels.  A compiled-selector or term-group field of a PodBatch is itself a
dict of its fields.  Dtypes are kept (bool / int32 / float32).  The
snapshot carries the existing-pod affinity groups (``aff_*``) like every
other field; ``ipa_aux_from_numpy`` carries a prepared InterPodAffinity
aux, ``cosched_aux_from_numpy`` Coscheduling's anchor-slice aux,
``dra_aux_from_numpy`` DynamicResources' claim aux,
``fork_payload_from_numpy`` a what-if fork payload and ``key_from_jax`` a
PRNG key (the scheduler's ``rng_key``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .device import resolve_device
from .dra.plugin import DraAux
from .framework.interface import DynamicState
from .framework.podbatch import AFFINITY_GROUPS, AffinityTermGroup, PodBatch
from .gang.coscheduling import CoschedAux
from .plugins.interpodaffinity import DEFAULT_HARD_POD_AFFINITY_WEIGHT, IPAAux
from .state.encoding import SNAPSHOT_FIELDS, DeviceSnapshot
from .state.selectors import CompiledLabelSelectors, CompiledNodeSelectors
from .whatif.fork import ForkPayload


def _tensor(a, device: torch.device) -> torch.Tensor:
    # a copy: arrays fetched from another framework may be read-only views
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def snapshot_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> DeviceSnapshot:
    """A DeviceSnapshot from the JAX snapshot's fields (by name)."""
    dev = resolve_device(device)
    missing = [k for k in SNAPSHOT_FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"snapshot_from_numpy: missing fields {missing}")
    return DeviceSnapshot(**{k: _tensor(arrays[k], dev) for k in SNAPSHOT_FIELDS})


def dyn_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> DynamicState:
    """A DynamicState from ``{"requested": …, "non_zero": …}``."""
    dev = resolve_device(device)
    return DynamicState(requested=_tensor(arrays["requested"], dev),
                        non_zero=_tensor(arrays["non_zero"], dev))


def _struct(cls, arrays: Mapping, device: torch.device):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in arrays:
            continue
        v = arrays[f.name]
        if f.name == "has_numeric":
            kw[f.name] = bool(v)
        else:
            kw[f.name] = _tensor(v, device)
    return cls(**kw)


_NESTED = {
    "node_selector": CompiledLabelSelectors,
    "node_affinity": CompiledNodeSelectors,
    "tsc_selectors": CompiledLabelSelectors,
}
_GROUPS = ("req_affinity", "req_anti_affinity", "pref_affinity",
           "pref_anti_affinity")
_STATIC = ("has_spread", "has_affinity", "tsc_domain_bucket",
           "ipa_domain_bucket", "group_present")


def batch_from_numpy(arrays: Mapping, device="cuda") -> PodBatch:
    """A PodBatch of tensors from the JAX batch's fields (no pod objects)."""
    dev = resolve_device(device)
    kw = {"pods": []}
    for f in dataclasses.fields(PodBatch):
        name = f.name
        if name == "pods" or name not in arrays:
            continue
        v = arrays[name]
        if name in _NESTED:
            kw[name] = _struct(_NESTED[name], v, dev)
        elif name in _GROUPS:
            g = dict(v)
            g["selectors"] = _struct(CompiledLabelSelectors, g["selectors"], dev)
            kw[name] = AffinityTermGroup(**{
                k: (g[k] if k == "selectors" else _tensor(g[k], dev))
                for k in ("valid", "topo_key", "weight", "ns_ids",
                          "all_namespaces", "selectors")})
        elif name in _STATIC:
            kw[name] = v
        else:
            kw[name] = _tensor(v, dev)
    return PodBatch(**kw)


def ipa_aux_from_numpy(arrays: Mapping[str, np.ndarray], batch: PodBatch, depth: int,
                       hard_weight: float = DEFAULT_HARD_POD_AFFINITY_WEIGHT,
                       device="cuda") -> IPAAux:
    """The port's InterPodAffinity aux from the JAX ``IPAAux`` fields (by
    name) and the port's PodBatch they were prepared for (its term groups'
    validity and weights, and ``group_present``), with domain bucket
    ``depth``."""
    dev = resolve_device(device)
    fields = {k: _tensor(arrays[k], dev) for k in IPAAux._fields if k in arrays}
    return IPAAux(
        **fields, depth=int(depth),
        present=tuple(getattr(batch, "group_present", AFFINITY_GROUPS)),
        req_aff_valid=batch.req_affinity.valid.to(dev),
        paff_weight=batch.pref_affinity.weight.to(dev),
        panti_weight=batch.pref_anti_affinity.weight.to(dev),
        hard_weight=float(hard_weight))


def cosched_aux_from_numpy(aux, device="cuda") -> CoschedAux:
    """The port's Coscheduling aux from the JAX plugin's host aux
    ``(slice_dom i32[N], anchor i32[B])`` (what its ``host_prepare`` gives
    and its ``prepare`` passes on), as int32 tensors on ``device``."""
    dev = resolve_device(device)
    slice_dom, anchor = aux
    return CoschedAux(slice_dom=_tensor(np.asarray(slice_dom, dtype=np.int32), dev),
                      anchor=_tensor(np.asarray(anchor, dtype=np.int32), dev))


def dra_aux_from_numpy(host_aux: Mapping[str, np.ndarray], claim_capacity,
                       claim_allocated, device="cuda") -> DraAux:
    """The port's DynamicResources aux from the JAX plugin's host aux
    (``{"demand", "pinned", "blocked"}``, what its ``host_prepare`` gives)
    and the snapshot's claim planes: ``free = capacity − allocated``, as the
    JAX plugin's ``prepare`` computes it."""
    dev = resolve_device(device)
    cap = np.asarray(claim_capacity, dtype=np.int32)
    free = (cap - np.asarray(claim_allocated, dtype=np.int32)).astype(np.int32)
    return DraAux(demand=_tensor(np.asarray(host_aux["demand"], dtype=np.int32), dev),
                  pinned=_tensor(np.asarray(host_aux["pinned"], dtype=np.int32), dev),
                  blocked=_tensor(np.asarray(host_aux["blocked"], dtype=bool), dev),
                  free=_tensor(free, dev), capacity=_tensor(cap, dev))


def fork_payload_from_numpy(payload) -> ForkPayload:
    """The port's ForkPayload from the JAX package's (its fields by name:
    numpy arrays, one fork or K stacked; ``add_vals`` in the encoders'
    common node-array order).  The payload stays on the host, as the
    reference's does; ``apply_fork`` uploads it to the snapshot's device."""

    def arr(a, dtype):
        return None if a is None else np.array(a, dtype=dtype, copy=True, order="C")

    vals = getattr(payload, "add_vals", None)
    return ForkPayload(
        vic_pod_rows=arr(payload.vic_pod_rows, np.int32),
        vic_node_rows=arr(payload.vic_node_rows, np.int32),
        aff_rows=arr(payload.aff_rows, np.int32),
        aff_vals=arr(payload.aff_vals, np.int32),
        del_rows=arr(payload.del_rows, np.int32),
        add_rows=arr(getattr(payload, "add_rows", None), np.int32),
        add_ok=arr(getattr(payload, "add_ok", None), bool),
        add_vals=None if vals is None else tuple(np.array(v, copy=True) for v in vals),
        vic_claim_chips=arr(getattr(payload, "vic_claim_chips", None), np.int32))


def key_from_jax(np_key_data) -> torch.Tensor:
    """A JAX PRNG key's data (``np.asarray(jax.random.PRNGKey(s))`` or
    ``jax.random.key_data(k)``: two uint32 words) → the port's key, a (2,)
    uint32 tensor on the host (``TorchScheduler(rng_key=...)`` and the
    engines' ``key`` take it, as they take a pair of ints)."""
    words = np.asarray(np_key_data, dtype=np.uint32).reshape(2)
    return torch.from_numpy(words.copy())
