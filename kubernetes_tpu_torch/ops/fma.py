"""A float32 fused multiply-add in plain torch.

XLA:CPU contracts ``a + b · c`` into one fused multiply-add inside an
elementwise fusion (jnp.interp's ``fp[i−1] + (delta / dx) · df``,
SelectorSpread's zone blend), so the port's plain versions round those
sums once, as ``__fmaf_rn`` does on the card.
"""

from __future__ import annotations

import torch


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` for float32 tensors, rounded once to float32 (a fused
    multiply-add; ``__fmaf_rn`` on the card).  The product is exact in
    float64; the sum is ``s + e`` exactly (TwoSum), and the float32 rounding
    of ``s`` is correct except where ``s`` lies halfway between two float32
    values, where the sign of ``e`` decides."""
    p = a.double() * b.double()
    cd = c.double()
    s = cd + p
    bb = s - cd
    e = (cd - (s - bb)) + (p - bb)
    r = s.float()
    rd = r.double()
    nb = torch.where(s > rd, torch.nextafter(r, torch.full_like(r, float("inf"))),
                     torch.nextafter(r, torch.full_like(r, float("-inf"))))
    tie = (s != rd) & (2.0 * s == rd + nb.double())
    return torch.where(tie & (e != 0) & ((e > 0) == (nb > r)), nb, r)
