"""Preemption's dry-run primitives (the JAX package's whatif/dryrun.py).

The JAX package's whatif/ also holds the counterfactual fork engine
(fork.py, engine.py: ROADMAP Queue A item 9b, Queue B B16); the port has
only the dry run that preemption runs.
"""

from .dryrun import PRIORITY_LEVEL_CAP, candidate_mask_device, sweep_and_rank

__all__ = ["PRIORITY_LEVEL_CAP", "candidate_mask_device", "sweep_and_rank"]
