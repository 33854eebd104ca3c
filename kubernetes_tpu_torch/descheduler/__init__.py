"""Descheduler: the PDB-aware eviction gate, the what-if defragmentation
planner and the policy controller loop.

Reference: the JAX package's descheduler/ (its ``__init__`` :1-42).  Layers:

  evictions.py  — the single gate every pod-killing path goes through
                  (the Eviction subresource's PDB check)
  planner.py    — counterfactual batched assignment over a forked
                  DeviceSnapshot (the whatif engine, one solve per plan)
  policies.py   — slice defragmentation / spread-violation repair / node
                  drain candidate enumeration
  controller.py — the rate-limited propose → score → apply loop

The CLI's ``drain`` and the apiserver's eviction subresource are not
ported (ROADMAP Queue A item 10).
"""

from .controller import DeschedulerController, ScoredPlan
from .evictions import EvictionAPI, EvictionResult
from .planner import Prediction, WhatIfPlanner
from .policies import (
    DRAIN_ANNOTATION,
    CandidatePlan,
    NodeDrainPolicy,
    PolicyContext,
    SliceDefragmentation,
    SpreadViolationRepair,
    clone_for_replacement,
    default_policies,
)

__all__ = [
    "DeschedulerController",
    "ScoredPlan",
    "EvictionAPI",
    "EvictionResult",
    "Prediction",
    "WhatIfPlanner",
    "DRAIN_ANNOTATION",
    "CandidatePlan",
    "NodeDrainPolicy",
    "PolicyContext",
    "SliceDefragmentation",
    "SpreadViolationRepair",
    "clone_for_replacement",
    "default_policies",
]
