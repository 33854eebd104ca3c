"""The shared eviction gate (the JAX package's descheduler/evictions.py).

The rest of the JAX package's descheduler — the planner, the policies and
the controller loop — is ROADMAP Queue A item 9b; the port has only the gate
that preemption's victim deletes pass through.
"""

from .evictions import EvictionAPI, EvictionResult

__all__ = ["EvictionAPI", "EvictionResult"]
