"""``repro_torch.tune`` — analytical schedule search and dataflow selection
(the port of ``repro.tune``).

Given a sparsity pattern, :func:`autotune_matmul` sweeps the planner's knob
grid against a cost model — no candidate executes — and returns a ranked,
statically verified winner whose knobs :func:`repro_torch.api.plan_matmul`
re-enters with (``policy="auto"`` does exactly that).  The default
objective, ``"cuda"``, prices the work the H100's kernels do with models
fitted on the card (:data:`DEFAULT_CUDA`); an explicit :class:`CostModel`
prices as ``repro`` does.  See :mod:`.search` and :mod:`.cost`.

This package imports :mod:`repro_torch.api`; the API layer imports the
tuner lazily inside ``plan_matmul``, so plain planning never pays for it.
"""
from .cost import DEFAULT_CUDA, CostModel, calibrate
from .search import (Candidate, Scored, SearchSpace, TuneResult,
                     autotune_matmul, select_schedule)

__all__ = [
    "CostModel", "calibrate", "DEFAULT_CUDA",
    "Candidate", "Scored", "SearchSpace", "TuneResult",
    "autotune_matmul", "select_schedule",
]
