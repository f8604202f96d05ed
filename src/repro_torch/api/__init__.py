"""``repro_torch.api`` — plan, execute and apply Segment-dataflow SpMMs.

    from repro_torch import api

    plan = api.plan_matmul(A, x.shape, policy="segment")   # build (cached)
    y = plan(x)                                            # execute
"""
from repro_torch.core.policies import (SchedulePolicy, available_policies,
                                       get_policy, register_policy,
                                       unregister_policy)

from .backends import (BACKENDS, default_backend, resolve_backend,
                       resolve_device, use_backend)
from .executor import apply_plan, execute_plan, pick_bn
from .plan import SPMM, SegmentPlan
from .planner import (clear_plan_cache, pattern_fingerprint, plan_cache_stats,
                      plan_matmul)

__all__ = [
    "SegmentPlan", "SPMM",
    "plan_matmul", "execute_plan", "apply_plan", "pick_bn",
    "clear_plan_cache", "plan_cache_stats", "pattern_fingerprint",
    "SchedulePolicy", "register_policy", "unregister_policy", "get_policy",
    "available_policies",
    "BACKENDS", "default_backend", "resolve_backend", "resolve_device",
    "use_backend",
]
