"""The descheduler's what-if planner: a thin shell over the whatif engine.

Reference: the JAX package's descheduler/planner.py (``WhatIfPlanner``
:37-62).  The fork-and-resolve machinery lives in ``whatif/`` — one engine
shared with the cluster autoscaler — and ``WhatIfPlanner`` keeps the
descheduler-facing contract on top of it.

Parity contract: the engine re-runs the scheduler's assignment semantics
over a fork that matches what the encoder holds once the victims are
really evicted, so the predicted placements equal the scheduler's actual
post-eviction bindings — provided the cluster does not change in between
and the planner runs while the scheduler is quiescent (the controller runs
between cycles and flushes the pipeline first).  Affinity-carrying victims
are supported: the fork masks their term-count contributions.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..api import objects as v1
from ..whatif import ForkSpec, Prediction, WhatIfEngine

__all__ = ["Prediction", "WhatIfPlanner"]


class WhatIfPlanner:
    """Counterfactual solver bound to a live TorchScheduler.  ``durations``
    holds each trusted solve's seconds on the scheduler's clock (the
    reference's ``descheduler_planner_duration``)."""

    def __init__(self, scheduler):
        self.sched = scheduler
        self.engine = WhatIfEngine(scheduler)
        self.durations: List[float] = []

    def order_pending(self, pods: Sequence[v1.Pod]) -> List[v1.Pod]:
        """The queue's pop order (gang-cohesive priority sort)."""
        return self.engine.order_pending(pods)

    def predict(self, pending: Sequence[v1.Pod],
                victims: Sequence[v1.Pod]) -> Optional[Prediction]:
        """One batched pod × node solve: where would ``pending`` land if
        ``victims`` were evicted?  None when the solve cannot be trusted
        (batch overflow, in-flight pipelined work) — "no plan", never "no
        fit"."""
        t0 = self.sched.clock()
        pred = self.engine.evaluate_one(pending, ForkSpec(
            victims=list(victims), note="descheduler"))
        if pred is not None:
            self.durations.append(max(self.sched.clock() - t0, 0.0))
        return pred
