"""DeviceSnapshot forks: the counterfactual state a what-if solve runs on.

Reference: the JAX package's whatif/fork.py (``ForkSpec`` :44,
``ForkPayload`` :54, ``apply_fork`` :73-129, ``ForkedEncoderView``
:132-189, ``stack_payloads`` :192-214), itself after cluster-autoscaler's
simulator snapshot (simulator/clustersnapshot) and DryRunPreemption's
cloned NodeInfos: a COPY of cluster state with a hypothetical change
applied, never committed back.  Three capabilities compose in one fork:

  - victim-mask: scheduled pods invalidated, their request vectors
    subtracted from their hosts, their claim chips released, and their
    (anti)affinity term-count contributions subtracted from ``aff_counts``
    — the state the encoder reaches after a real eviction;
  - node-add: template node rows (pre-encoded by the engine into scratch
    encoder rows, then rolled back) activated in the fork;
  - node-remove: host rows invalidated.

On the device a fork set is two kernels (kernels/fork.py): K31
``fork_add_rows`` writes each fork's template rows into its own copy of the
twenty node arrays, K30 ``fork_masks`` builds every fork's validity,
requested, non-zero, affinity-count and claim planes.  ``apply_forks``
builds K forks with one launch of each; ``apply_fork`` is one fork.  The
payload groups are fixed-shape with −1 row padding; a pad is a no-op.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api import objects as v1
from ..kernels.fork import fork_add_rows, fork_masks
from ..state.encoding import NODE_ARRAYS as _NODE_ARRAYS


@dataclass
class ForkSpec:
    """One candidate plan, host-side: what to change before the solve."""

    victims: List[v1.Pod] = field(default_factory=list)
    add_nodes: List[v1.Node] = field(default_factory=list)
    remove_nodes: List[str] = field(default_factory=list)
    note: str = ""  # plan label for logs


class ForkPayload(NamedTuple):
    """Host-side fork arguments (numpy): one fork, or K forks stacked along
    a leading axis (``stack_payloads``).  ``add_vals`` is aligned with the
    encoder's node arrays; the add group is None when no fork of the set
    adds nodes, and ``vic_claim_chips`` is None when no victim holds chips."""

    vic_pod_rows: np.ndarray  # i32[V] (−1 pad)
    vic_node_rows: np.ndarray  # i32[V]
    aff_rows: np.ndarray  # i32[A] (−1 pad) victim term-group rows
    aff_vals: np.ndarray  # i32[A] domain value per contribution
    del_rows: np.ndarray  # i32[D] (−1 pad) node rows to invalidate
    add_rows: object = None  # i32[M] | None — scratch rows to activate
    add_ok: object = None  # bool[M] | None
    add_vals: object = None  # tuple[np.ndarray[M, ...]] | None
    vic_claim_chips: object = None  # i32[V] | None


def _t(a, dev, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dev) if dtype is None else t.to(dev).to(dtype)


def apply_forks(dsnap, p: ForkPayload) -> List:
    """K stacked payloads (leading axis K) applied to the live
    DeviceSnapshot → K forked DeviceSnapshots, built with one K31 launch
    (when the set adds nodes) and one K30 launch.  The live snapshot is
    not modified: a what-if is never committed back."""
    dev = dsnap.device
    k = int(np.shape(p.vic_pod_rows)[0])
    node = {name: getattr(dsnap, name) for name in _NODE_ARRAYS}
    # --- node-add: each fork's template rows in its own node arrays (K31)
    if p.add_rows is not None:
        vals = [_t(v, dev, node[name].dtype) for name, v in zip(_NODE_ARRAYS, p.add_vals)]
        outs = fork_add_rows([node[name] for name in _NODE_ARRAYS],
                             _t(p.add_rows, dev, torch.int32), _t(p.add_ok, dev, torch.bool),
                             vals)
        node = dict(zip(_NODE_ARRAYS, outs))
    # --- node-remove, victim-mask, affinity mask, claim release (K30)
    chips = None if p.vic_claim_chips is None else _t(p.vic_claim_chips, dev, torch.int32)
    nv, pv, req, nz, aff, claim = fork_masks(
        node["node_valid"], node["requested"], node["non_zero_requested"],
        node["claim_allocated"], dsnap.pod_valid, dsnap.pod_request, dsnap.pod_non_zero,
        dsnap.aff_counts, *(_t(a, dev, torch.int32) for a in (
            p.vic_pod_rows, p.vic_node_rows, p.aff_rows, p.aff_vals, p.del_rows)),
        vic_claim_chips=chips)
    forks = []
    for i in range(k):
        upd = {}
        if p.add_rows is not None:
            upd.update({name: node[name][i] for name in _NODE_ARRAYS})
        upd.update(node_valid=nv[i], pod_valid=pv[i], requested=req[i],
                   non_zero_requested=nz[i], aff_counts=aff[i])
        if claim is not None:
            upd["claim_allocated"] = claim[i]
        forks.append(dataclasses.replace(dsnap, **upd))
    return forks


def apply_fork(dsnap, p: ForkPayload):
    """One fork payload applied to a DeviceSnapshot (the reference's
    apply_fork) → the forked DeviceSnapshot."""
    return apply_forks(dsnap, stack_payloads([p]))[0]


class ForkedEncoderView:
    """Read-only encoder facade with one fork applied to the HOST mirrors —
    handed to ``host_prepare`` so host-side plugin state (the Coscheduling
    anchor-slice plane's free-capacity scan: ``gang/directory.py`` host_aux
    and _best_free_slice) sees the same counterfactual the device fork
    encodes.  Everything else delegates to the live encoder.

    Fidelity note (node-add forks, as in the reference): added template
    nodes are visible in the mirrors here, but store-derived host state
    (the gang slice-domain plane reads Node objects from the store) cannot
    see nodes that do not exist yet."""

    def __init__(self, encoder, vic_rows: Sequence[Tuple[int, int]],
                 del_rows: Sequence[int],
                 add_rows: Sequence[int],
                 add_captured: Optional[Dict[int, dict]] = None,
                 vic_claim_chips: Optional[Sequence[int]] = None):
        self._enc = encoder
        requested = encoder.requested.copy()
        non_zero = encoder.non_zero_requested.copy()
        pod_valid = encoder.pod_valid.copy()
        node_valid = encoder.node_valid.copy()
        allocatable = encoder.allocatable
        if add_rows:
            allocatable = allocatable.copy()
            for row in add_rows:
                cap = (add_captured or {}).get(row)
                node_valid[row] = True
                if cap is not None:
                    allocatable[row] = cap["allocatable"]
                    requested[row] = cap["requested"]
                    non_zero[row] = cap["non_zero_requested"]
        for pr, nr in vic_rows:
            requested[nr] -= encoder.pod_request[pr]
            non_zero[nr] -= encoder.pod_non_zero[pr]
            pod_valid[pr] = False
        for row in del_rows:
            node_valid[row] = False
        # victims release their allocated chips in the mirror too, so host
        # readers (the gang free-chip slice scan) match the device fork
        claim_allocated = encoder.claim_allocated
        if vic_claim_chips is not None and any(vic_claim_chips):
            claim_allocated = claim_allocated.copy()
            for (_pr, nr), chips in zip(vic_rows, vic_claim_chips):
                claim_allocated[nr] -= chips
        self.requested = requested
        self.non_zero_requested = non_zero
        self.pod_valid = pod_valid
        self.node_valid = node_valid
        self.allocatable = allocatable
        self.claim_allocated = claim_allocated

    def __getattr__(self, name):
        return getattr(self._enc, name)


def stack_payloads(payloads: Sequence[ForkPayload]) -> ForkPayload:
    """K same-shape payloads → one payload with a leading K axis."""
    first = payloads[0]
    if first.add_rows is None:
        add_rows = add_ok = add_vals = None
    else:
        add_rows = np.stack([p.add_rows for p in payloads])
        add_ok = np.stack([p.add_ok for p in payloads])
        add_vals = tuple(
            np.stack([p.add_vals[i] for p in payloads])
            for i in range(len(first.add_vals))
        )
    return ForkPayload(
        vic_pod_rows=np.stack([p.vic_pod_rows for p in payloads]),
        vic_node_rows=np.stack([p.vic_node_rows for p in payloads]),
        aff_rows=np.stack([p.aff_rows for p in payloads]),
        aff_vals=np.stack([p.aff_vals for p in payloads]),
        del_rows=np.stack([p.del_rows for p in payloads]),
        add_rows=add_rows, add_ok=add_ok, add_vals=add_vals,
        vic_claim_chips=(
            None if first.vic_claim_chips is None
            else np.stack([p.vic_claim_chips for p in payloads])),
    )
