"""``SegmentPlan`` — a frozen schedule + block values for one sparse matmul.

The torch counterpart of ``repro.api.plan.SegmentPlan``: the same static
(aux) fields and the same tensor (leaf) fields, so a plan of this package
can be compared leaf by leaf with the JAX one.  One field is added:
``run_offsets``, the owner-run offsets the CUDA kernel launches one thread
block per run from (derived once per plan by the planner).  Only SpMM plans
are built so far; the SpGEMM leaves stay ``None``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

SPMM = "spmm"

@dataclasses.dataclass(frozen=True, eq=False)
class SegmentPlan:
    """Frozen Segment schedule + block values.

    ``kind == "spmm"``: ``lhs_blocks`` are the A tiles in original BSR
    storage order; the lane-major schedule addresses them through
    ``slot_idx``.  Calling the plan with a dense ``(K, N)`` right-hand side
    returns the dense ``(M, N)`` product.
    """

    # --- static aux data ---
    kind: str
    policy: str
    block_shape: Tuple[int, int]
    grid: Tuple[int, int]
    rhs_grid: Optional[Tuple[int, int]]
    n_out_blocks: int
    traffic_items: Tuple[Tuple[str, float], ...]
    fingerprint: str
    backend: Optional[str] = None
    n_lanes: int = 1
    unroll: int = 1
    transpose_lhs: bool = False
    block_dtype: str = "fp32"
    out_dtype: Optional[str] = None               # dtype name | None=float32
    has_pads: bool = True
    pipeline: bool = True
    bn_hint: Optional[int] = None
    prefetch: Optional[str] = None

    # --- tensor leaves (None where not applicable) ---
    lhs_blocks: Optional[torch.Tensor] = None
    rhs_blocks: Optional[torch.Tensor] = None
    lhs_scales: Optional[torch.Tensor] = None
    rhs_scales: Optional[torch.Tensor] = None
    m_idx: Optional[torch.Tensor] = None
    k_idx: Optional[torch.Tensor] = None
    a_idx: Optional[torch.Tensor] = None
    b_idx: Optional[torch.Tensor] = None
    c_idx: Optional[torch.Tensor] = None
    slot_idx: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None
    seg_start: Optional[torch.Tensor] = None
    seg_write: Optional[torch.Tensor] = None
    accum_prev: Optional[torch.Tensor] = None
    a_fetch: Optional[torch.Tensor] = None
    b_fetch: Optional[torch.Tensor] = None
    a_slot: Optional[torch.Tensor] = None
    b_slot: Optional[torch.Tensor] = None
    row_mask: Optional[torch.Tensor] = None
    a_brow: Optional[torch.Tensor] = None
    a_bcol: Optional[torch.Tensor] = None
    b_brow: Optional[torch.Tensor] = None
    b_bcol: Optional[torch.Tensor] = None
    c_brow_arr: Optional[torch.Tensor] = None
    c_bcol_arr: Optional[torch.Tensor] = None
    grad_plan: Optional["SegmentPlan"] = None
    # added by the port: (n_runs + 1,) int32 owner-run offsets
    run_offsets: Optional[torch.Tensor] = None

    @property
    def n_items(self) -> int:
        """Padded schedule length (``n_lanes * lane_len``, pads included)."""
        return int(self.seg_start.shape[0])

    @property
    def n_blocks(self) -> int:
        """Number of stored lhs blocks (original BSR order)."""
        src = self.lhs_blocks if self.lhs_blocks is not None else self.a_brow
        return int(src.shape[0])

    @property
    def n_runs(self) -> int:
        """Owner runs: output block rows that receive work."""
        return int(self.run_offsets.shape[0]) - 1

    @property
    def grid_m(self) -> int:
        return self.grid[0]

    @property
    def grid_k(self) -> int:
        return self.grid[1]

    def replace(self, **kw) -> "SegmentPlan":
        return dataclasses.replace(self, **kw)

    def with_values(self, lhs_blocks: torch.Tensor) -> "SegmentPlan":
        """Same schedule, new block values (in the plan's storage order)."""
        if (self.lhs_blocks is not None
                and lhs_blocks.shape != self.lhs_blocks.shape):
            raise ValueError(f"lhs_blocks has shape {tuple(lhs_blocks.shape)}, "
                             f"expected {tuple(self.lhs_blocks.shape)}")
        return dataclasses.replace(self, lhs_blocks=lhs_blocks)

    def __call__(self, rhs: torch.Tensor, *, bn: Optional[int] = None,
                 backend: Optional[str] = None, out_dtype=None) -> torch.Tensor:
        """``plan(b_dense)`` → dense ``(M, N)``."""
        from . import executor  # executor imports this module
        return executor.execute_plan(self, rhs, bn=bn, backend=backend,
                                     out_dtype=out_dtype)
