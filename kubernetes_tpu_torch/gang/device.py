"""Device-side gang pass: the in-batch all-or-nothing mask (K20).

Reference: the JAX package's gang/device.py gang_all_or_nothing (:17), run
inside the fused cycle after the assignment engine.  The kernel and its
plain version live in kernels/gang.py; on a CUDA tensor the call launches
K20, on a CPU tensor it takes the plain version.
"""

from ..kernels.gang import gang_all_or_nothing  # noqa: F401

__all__ = ["gang_all_or_nothing"]
