"""Per-domain count tables: gather and scatter over dictionary-encoded
topology domains (plain torch).

Reference: the JAX package's ops/segment.py (:27-97).  The scheduling
programs keep per-domain tables ``[..., D+1]`` (a domain is one value of a
topology key, compacted by the encoder; the last slot D is the trash slot
of nodes without the key) and need:

  * gather:  ``out[..., n] = table[..., dom[..., n]]``   (counts per node)
  * scatter: ``table[..., dom[..., n]] += vals[..., n]`` (counts per domain)

The reference contracts against a one-hot of the domain index because
minor-axis gathers and scatters lower to serial loops on a TPU.  A GPU has
native gathers and atomic scatter-adds, so these are ``torch.gather`` and
``Tensor.scatter_add_`` — no ``[..., N, D]`` one-hot is ever built.  The
reference returns float32 from its einsums; integer tables stay integer
here (the same values: its counts are exact in float32 below 2^24, and
``check_count_bound`` holds the port's tables to that bound).

These are the plain versions the spread kernels (kernels/spread.py) are
held against.
"""

from __future__ import annotations

import torch

# float32 represents every integer up to 2^24 exactly: the reference keeps
# its domain counts in float32 einsums, so a count past this bound would
# round there
EXACT_COUNT_BOUND = 1 << 24


def _broadcast(a: torch.Tensor, b: torch.Tensor):
    """Broadcast the leading (all but the last) dims of ``a`` and ``b``."""
    lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    return (a.expand(*lead, a.shape[-1]), b.expand(*lead, b.shape[-1]))


def domain_gather(table: torch.Tensor, dom: torch.Tensor) -> torch.Tensor:
    """``out[..., n] = table[..., dom[..., n]]`` — ``dom`` in [0, D]."""
    table, dom = _broadcast(table, dom)
    return torch.gather(table, -1, dom.long())


def domain_scatter_add(vals: torch.Tensor, dom: torch.Tensor, depth: int) -> torch.Tensor:
    """``out[..., d] = Σ_n vals[..., n] · (dom[..., n] == d)`` — [..., depth],
    in ``vals``' dtype (bool values count as int32)."""
    if vals.dtype == torch.bool:
        vals = vals.to(torch.int32)
    vals, dom = _broadcast(vals, dom)
    out = torch.zeros(vals.shape[:-1] + (depth,), dtype=vals.dtype, device=vals.device)
    return out.scatter_add_(-1, dom.long(), vals)


def domain_any(mask: torch.Tensor, dom: torch.Tensor, depth: int) -> torch.Tensor:
    """``out[..., d] = any_n(mask[..., n] & dom[..., n] == d)`` — bool[..., depth]."""
    return domain_scatter_add(mask, dom, depth) > 0


def point_scatter_add(table: torch.Tensor, dom_at: torch.Tensor,
                      inc: torch.Tensor) -> torch.Tensor:
    """``table[..., dom_at[...]] += inc[...]`` for one index per row (out of
    place, like the reference)."""
    return table.scatter_add(-1, dom_at.long()[..., None],
                             inc.to(table.dtype)[..., None])


def check_count_bound(max_count: int) -> None:
    """Raise unless every count a table can reach (``max_count``, known from
    shapes: the pods that can be counted) stays below 2^24, where the
    reference's float32 counts stop being exact.  A bound from shapes needs
    no read of the device."""
    if max_count >= EXACT_COUNT_BOUND:
        raise OverflowError(
            f"domain counts may reach {max_count} >= 2^24: the reference's "
            "float32 counts are not exact there")
