"""``SegmentPlan`` — a frozen schedule + block values for one sparse matmul.

The torch counterpart of ``repro.api.plan.SegmentPlan``: the same static
(aux) fields and the same tensor (leaf) fields, so a plan of this package
can be compared leaf by leaf with the JAX one.  Fields are added, each
derived once per plan by the planner: ``run_offsets``, the owner-run
offsets the one-block-per-run CUDA kernels launch from (over ``m_idx`` for
SpMM plans, over ``c_idx`` for SpGEMM plans); for SpMM plans,
``chunk_offsets``, those runs cut into the chunks the folded SpMM kernel
launches one thread block per chunk from; for SpGEMM plans, ``tc_runs``
and ``tc_steps``, the work table the tensor-core SpGEMM kernel walks
(``kernels.segment_spgemm.work_table``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.formats import QUANT_DTYPES, quant_base_dtype

SPMM = "spmm"
SPGEMM = "spgemm"

@dataclasses.dataclass(frozen=True, eq=False)
class SegmentPlan:
    """Frozen Segment schedule + block values.

    ``kind == "spmm"``: ``lhs_blocks`` are the A tiles in original BSR
    storage order; the lane-major schedule addresses them through
    ``slot_idx``.  Calling the plan with a dense ``(K, N)`` right-hand side
    returns the dense ``(M, N)`` product.

    ``kind == "spgemm"``: ``lhs_blocks``/``rhs_blocks`` are the A/B tiles in
    original BSR order (fp32, or a quantized payload beside
    ``lhs_scales``/``rhs_scales``), ``a_idx``/``b_idx``/``c_idx`` map
    schedule items to block slots, and calling the plan with no argument
    returns the ``(n_out_blocks, bm, bn)`` C blocks at the symbolic pattern
    (``c_brow``/``c_bcol``).
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
    # added by the port: (n_runs + 1,) int32 owner-run offsets; (SpMM)
    # the (n_chunks, 4) int32 chunk table of kernels.segment_spmm.
    # chunk_offsets; (SpGEMM) the (n_runs + 1,) run offsets and (n_steps, 5)
    # steps of kernels.segment_spgemm.work_table
    run_offsets: Optional[torch.Tensor] = None
    chunk_offsets: Optional[torch.Tensor] = None
    tc_runs: Optional[torch.Tensor] = None
    tc_steps: Optional[torch.Tensor] = None

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
        """Owner runs: output block rows (SpMM) or C blocks (SpGEMM) that
        receive work."""
        return int(self.run_offsets.shape[0]) - 1

    @property
    def grid_m(self) -> int:
        return self.grid[0]

    @property
    def grid_k(self) -> int:
        return self.grid[1]

    @property
    def n_c_blocks(self) -> int:
        if self.kind != SPGEMM:
            raise AttributeError("n_c_blocks is only defined for spgemm plans")
        return self.n_out_blocks

    @property
    def c_brow(self) -> np.ndarray:
        """Symbolic C pattern rows (spgemm), as host numpy."""
        return self.c_brow_arr.cpu().numpy()

    @property
    def c_bcol(self) -> np.ndarray:
        return self.c_bcol_arr.cpu().numpy()

    @property
    def quantized(self) -> bool:
        """True when block values are stored as a quantized payload."""
        return self.block_dtype != "fp32"

    def replace(self, **kw) -> "SegmentPlan":
        return dataclasses.replace(self, **kw)

    def with_values(self, lhs_blocks: torch.Tensor,
                    rhs_blocks: Optional[torch.Tensor] = None, *,
                    lhs_scales: Optional[torch.Tensor] = None,
                    rhs_scales: Optional[torch.Tensor] = None
                    ) -> "SegmentPlan":
        """Same schedule, new block values (in the plan's storage order).
        Quantized plans take the payload and, optionally, new scales
        (``None`` keeps the plan's)."""
        kw: Dict[str, Any] = {}
        for name, new in (("lhs_blocks", lhs_blocks),
                          ("rhs_blocks", rhs_blocks)):
            if new is None:
                continue
            old = getattr(self, name)
            if old is not None and new.shape != old.shape:
                raise ValueError(f"{name} has shape {tuple(new.shape)}, "
                                 f"expected {tuple(old.shape)}")
            self._check_value_dtype(name, new)
            kw[name] = new
        if lhs_scales is not None:
            kw["lhs_scales"] = lhs_scales
        if rhs_scales is not None:
            kw["rhs_scales"] = rhs_scales
        return dataclasses.replace(self, **kw)

    def _check_value_dtype(self, name: str, blocks: torch.Tensor) -> None:
        """New block values must match the plan's storage format: scales
        applied to fp32 values, or a raw payload read as fp32, would be
        wrong in a way no shape check catches."""
        got = blocks.dtype
        if self.quantized:
            expect = QUANT_DTYPES[quant_base_dtype(self.block_dtype)]
            if got != expect:
                raise ValueError(
                    f"{name} has dtype {got}, but this plan stores "
                    f"{self.block_dtype} payloads ({expect}): quantize the "
                    f"values (repro_torch.core.formats.quantize_blocks) or "
                    f"use the fp32 plan of this pattern")
        elif got in QUANT_DTYPES.values():
            raise ValueError(
                f"{name} has quantized payload dtype {got}, but this plan "
                f"stores fp32 blocks: build it with plan_matmul(..., "
                f"quantize=...) to carry the matching scales")

    def __call__(self, rhs: Optional[torch.Tensor] = None, *,
                 bn: Optional[int] = None, backend: Optional[str] = None,
                 out_dtype=None) -> torch.Tensor:
        """``plan(b_dense)`` → dense ``(M, N)`` (spmm); ``plan()`` → the
        ``(n_out_blocks, bm, bn)`` C blocks (spgemm)."""
        from . import executor  # executor imports this module
        return executor.execute_plan(self, rhs, bn=bn, backend=backend,
                                     out_dtype=out_dtype)
