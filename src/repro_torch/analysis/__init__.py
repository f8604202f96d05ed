"""Static analysis of Segment plans, and the kernel analyzers.

:func:`verify_plan` proves a :class:`~repro_torch.api.plan.SegmentPlan`'s
schedule against the named invariant catalog (``INVARIANTS``) and returns
typed :class:`Finding` records; it is the planner's soundness check behind
``plan_matmul(verify=...)`` and ``execute_plan(verify=...)``.
:mod:`.budget` prices each plan's kernel launches in shared memory and
refuses one over the SM's limit (``plan_matmul(vmem_limit_bytes=...)``).

The kernel analyzers are ``repro.analysis``' rules restated over the event
log of a checked build of the CUDA kernels (``csrc/check.cuh``):
:mod:`.trace` decodes a launch's log, :mod:`.ranges` (``index-range``),
:mod:`.races` (``parallel-race``, ``ring-slot-war``, ``sem-balance``),
:mod:`.order` (``ORDER_RULES``) and :mod:`.budget` (``vmem-budget``)
check it, and :mod:`.jaxpr_lint` runs them (:func:`analyze_callable`,
:func:`analyze_shipped_kernels`, ``python -m
repro_torch.analysis.jaxpr_lint``).  Dynamic, like ``racecheck``: clean
over the launches run; they need the card.

Layering: :mod:`.invariants` imports ``repro_torch.core`` only, and
:mod:`.budget` the SpMM wrapper's tile rules besides; the analyzers import
``repro_torch.kernels`` lazily, where they run kernels.
``repro_torch.api`` sits above it, and ``core.schedule`` reaches down
lazily for the shared :func:`check_lane_accum`.
"""
from .budget import (DEFAULT_VMEM_LIMIT_BYTES, VmemBudgetError,
                     check_plan_vmem, check_vmem_budget, kernel_vmem_bytes,
                     plan_vmem_bytes, spgemm_vmem_bytes, spmm_vmem_bytes)
from .invariants import (INVARIANTS, Finding, PlanVerificationError,
                         VerifyResult, check_lane_accum,
                         check_scale_agreement, check_traffic_agreement,
                         verify_plan)
from .jaxpr_lint import (RULES, CheckUnavailableError, LintFinding,
                         analyze_callable, analyze_shipped_kernels)
from .order import (ORDER_RULES, check_cross_pass_war, check_dma_priority,
                    check_order, check_prefetch_raw, check_sem_carryover)
from .races import (ANALYZER_RULES, check_parallel_races, check_ring_war,
                    check_sem_balance)
from .ranges import check_ranges
from .trace import Launch, Operand, Ring, trace_from_log

__all__ = [
    "DEFAULT_VMEM_LIMIT_BYTES", "VmemBudgetError", "check_plan_vmem",
    "check_vmem_budget", "kernel_vmem_bytes", "plan_vmem_bytes",
    "spgemm_vmem_bytes", "spmm_vmem_bytes",
    "INVARIANTS", "Finding", "PlanVerificationError", "VerifyResult",
    "check_lane_accum", "check_scale_agreement", "check_traffic_agreement",
    "verify_plan",
    "RULES", "CheckUnavailableError", "LintFinding", "analyze_callable",
    "analyze_shipped_kernels",
    "ANALYZER_RULES", "check_ranges", "check_parallel_races",
    "check_ring_war", "check_sem_balance",
    "ORDER_RULES", "check_order", "check_cross_pass_war",
    "check_sem_carryover", "check_prefetch_raw", "check_dma_priority",
    "Launch", "Operand", "Ring", "trace_from_log",
]
