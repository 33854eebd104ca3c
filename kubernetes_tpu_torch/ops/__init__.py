"""Tensor primitives shared by the plugins (plain torch)."""

from .segment import (  # noqa: F401
    domain_any,
    domain_gather,
    domain_scatter_add,
    point_scatter_add,
)
