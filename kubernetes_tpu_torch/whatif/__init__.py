"""Counterfactuals: the fork-and-resolve engine and preemption's dry run.

Reference: the JAX package's whatif/ (its ``__init__`` :1-36).  Layers:

  fork.py   — ForkSpec / ForkPayload, ``apply_fork`` / ``apply_forks`` on
              K30 + K31 (kernels/fork.py), the host ForkedEncoderView
  engine.py — WhatIfEngine: queue-order staging, fork payload build, the
              scheduler's own engine routing, K solves
  dryrun.py — preemption's batched dry-run primitives
              (candidate_mask_device, sweep_and_rank)

Consumers: descheduler/planner.py (WhatIfPlanner), autoscaler/controller.py
(scale-up and scale-down simulations), preemption.py (the dry run).
"""

from .dryrun import PRIORITY_LEVEL_CAP, candidate_mask_device, sweep_and_rank
from .engine import Prediction, WhatIfEngine
from .fork import (
    ForkedEncoderView,
    ForkPayload,
    ForkSpec,
    apply_fork,
    apply_forks,
    stack_payloads,
)

__all__ = [
    "PRIORITY_LEVEL_CAP",
    "candidate_mask_device",
    "sweep_and_rank",
    "Prediction",
    "WhatIfEngine",
    "ForkPayload",
    "ForkSpec",
    "ForkedEncoderView",
    "apply_fork",
    "apply_forks",
    "stack_payloads",
]
