"""Schedule-policy registry: dataflows as a pluggable configuration space.

A copy of ``repro.core.policies``.  A policy is a named pair of ordering
functions, one for SpMM work items and one for SpGEMM triples.  The
built-ins (``segment``, ``gustavson``, ``outer``) are registered by
:mod:`repro_torch.core.schedule` where their orderings are defined.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

# (m, k) per-item block coordinates -> permutation of item indices
SpmmOrderFn = Callable[[np.ndarray, np.ndarray], np.ndarray]
# (m, n, k, c) per-triple coordinates + C slot -> permutation of triple indices
SpgemmOrderFn = Callable[[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
                         np.ndarray]
# kind ("spmm"/"spgemm") + keyword coordinate/tile args -> traffic dict | None
CostHintFn = Callable[..., Optional[dict]]


@dataclasses.dataclass(frozen=True)
class SchedulePolicy:
    """A named work-item ordering for both Segment kernels.

    ``supports_fold`` marks policies whose output runs may be split by
    temporal folding; ``serial`` is a monotone registration number that
    plan caches key on, so a re-registered name is never served another
    definition's schedule.  ``cost_hint`` is an optional closed-form
    traffic estimator (see ``repro.core.policies``).
    """

    name: str
    spmm_order: SpmmOrderFn
    spgemm_order: SpgemmOrderFn
    supports_fold: bool = False
    description: str = ""
    serial: int = 0
    cost_hint: Optional[CostHintFn] = None


_REGISTRY: Dict[str, SchedulePolicy] = {}
_SERIAL = 0


def register_policy(name: str, *, spmm_order: SpmmOrderFn,
                    spgemm_order: SpgemmOrderFn, supports_fold: bool = False,
                    description: str = "",
                    cost_hint: Optional[CostHintFn] = None,
                    overwrite: bool = False) -> SchedulePolicy:
    """Register a schedule policy under ``name``.

    Raises ``ValueError`` on duplicate names unless ``overwrite=True``.
    ``"auto"`` is reserved for the planner's dataflow-selection mode.
    """
    if not name or not isinstance(name, str):
        raise ValueError(f"policy name must be a non-empty string, got {name!r}")
    if name == "auto":
        raise ValueError("policy name 'auto' is reserved for "
                         "plan_matmul(policy='auto') dataflow selection")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"policy {name!r} is already registered "
                         f"(pass overwrite=True to replace it)")
    global _SERIAL
    _SERIAL += 1
    policy = SchedulePolicy(name=name, spmm_order=spmm_order,
                            spgemm_order=spgemm_order,
                            supports_fold=supports_fold,
                            description=description, serial=_SERIAL,
                            cost_hint=cost_hint)
    _REGISTRY[name] = policy
    return policy


def unregister_policy(name: str) -> None:
    """Remove a policy (primarily for tests registering throwaway policies)."""
    _REGISTRY.pop(name, None)


def get_policy(name: str) -> SchedulePolicy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; available: {available_policies()}"
        ) from None


def available_policies() -> Tuple[str, ...]:
    """Registered policy names, registration order (built-ins first)."""
    return tuple(_REGISTRY)
