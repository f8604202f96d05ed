"""Static analysis of Segment plans: the plan verifier.

:func:`verify_plan` proves a :class:`~repro_torch.api.plan.SegmentPlan`'s
schedule against the named invariant catalog (``INVARIANTS``) and returns
typed :class:`Finding` records; it is the planner's soundness check behind
``plan_matmul(verify=...)`` and ``execute_plan(verify=...)``.  The rest of
``repro.analysis`` reads TPU kernel IR and has no counterpart here.

Layering: this package imports ``repro_torch.core`` only.
``repro_torch.api`` sits above it, and ``core.schedule`` reaches down
lazily for the shared :func:`check_lane_accum`.
"""
from .invariants import (INVARIANTS, Finding, PlanVerificationError,
                         VerifyResult, check_lane_accum,
                         check_scale_agreement, check_traffic_agreement,
                         verify_plan)

__all__ = [
    "INVARIANTS", "Finding", "PlanVerificationError", "VerifyResult",
    "check_lane_accum", "check_scale_agreement", "check_traffic_agreement",
    "verify_plan",
]
