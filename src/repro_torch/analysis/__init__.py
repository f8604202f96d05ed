"""Static analysis of Segment plans: the plan verifier.

:func:`verify_plan` proves a :class:`~repro_torch.api.plan.SegmentPlan`'s
schedule against the named invariant catalog (``INVARIANTS``) and returns
typed :class:`Finding` records; it is the planner's soundness check behind
``plan_matmul(verify=...)`` and ``execute_plan(verify=...)``.
:mod:`.budget` prices each plan's kernel launches in shared memory and
refuses one over the SM's limit (``plan_matmul(vmem_limit_bytes=...)``).
The rest of ``repro.analysis`` reads TPU kernel IR and has no counterpart
here.

Layering: :mod:`.invariants` imports ``repro_torch.core`` only, and
:mod:`.budget` the SpMM wrapper's tile rules besides.
``repro_torch.api`` sits above it, and ``core.schedule`` reaches down
lazily for the shared :func:`check_lane_accum`.
"""
from .budget import (DEFAULT_VMEM_LIMIT_BYTES, VmemBudgetError,
                     check_plan_vmem, plan_vmem_bytes, spgemm_vmem_bytes,
                     spmm_vmem_bytes)
from .invariants import (INVARIANTS, Finding, PlanVerificationError,
                         VerifyResult, check_lane_accum,
                         check_scale_agreement, check_traffic_agreement,
                         verify_plan)

__all__ = [
    "DEFAULT_VMEM_LIMIT_BYTES", "VmemBudgetError", "check_plan_vmem",
    "plan_vmem_bytes", "spgemm_vmem_bytes", "spmm_vmem_bytes",
    "INVARIANTS", "Finding", "PlanVerificationError", "VerifyResult",
    "check_lane_accum", "check_scale_agreement", "check_traffic_agreement",
    "verify_plan",
]
