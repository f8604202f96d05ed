"""``repro_torch.api`` — plan, execute and apply Segment-dataflow sparse
matmuls.

    from repro_torch import api

    plan = api.plan_matmul(A, x.shape, policy="segment")   # SpMM (cached)
    y = plan(x)                                            # execute
    gplan = api.plan_matmul(A, B, quantize="int8")         # SpGEMM, B a BSR
    c_blocks = gplan()                # (n_c_blocks, bm, bn) at gplan.c_brow/c_bcol
    api.plan_matmul(A, B, verify="full")   # the plan verifier, once a template
"""
from repro_torch.analysis.invariants import (Finding, PlanVerificationError,
                                             VerifyResult, verify_plan)
from repro_torch.core.formats import (QUANT_DTYPES, QuantizedBlocks,
                                      dequantize_blocks, quant_error_bound,
                                      quantize_blocks)
from repro_torch.core.policies import (SchedulePolicy, available_policies,
                                       get_policy, register_policy,
                                       unregister_policy)

from .backends import (BACKENDS, available_backends, default_backend,
                       resolve_backend, resolve_device, set_default_backend,
                       use_backend)
from .executor import apply_plan, execute_plan, pick_bn
from .plan import SPGEMM, SPMM, SegmentPlan
from .planner import (clear_plan_cache, pattern_fingerprint, plan_cache_stats,
                      plan_matmul)

__all__ = [
    "SegmentPlan", "SPMM", "SPGEMM",
    "plan_matmul", "execute_plan", "apply_plan", "pick_bn",
    "clear_plan_cache", "plan_cache_stats", "pattern_fingerprint",
    "verify_plan", "Finding", "VerifyResult", "PlanVerificationError",
    "QUANT_DTYPES", "QuantizedBlocks", "quantize_blocks",
    "dequantize_blocks", "quant_error_bound",
    "SchedulePolicy", "register_policy", "unregister_policy", "get_policy",
    "available_policies",
    "BACKENDS", "available_backends", "default_backend",
    "set_default_backend", "resolve_backend", "resolve_device",
    "use_backend",
]
