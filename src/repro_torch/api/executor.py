"""Plan execution: backend dispatch and the differentiable matmul entry.

``execute_plan`` runs a :class:`~repro_torch.api.plan.SegmentPlan` on the
``"cuda"`` backend (the Segment SpMM or SpGEMM kernel; their plain versions
for CPU tensors) or the ``"reference"`` backend (the dense oracles).
``apply_plan`` is the entry the sparse layers call: a
``torch.autograd.Function`` around the SpMM whose backward runs ``dx = Wᵀ @
dy`` in the kernel's ``transpose_lhs`` mode and the block SDDMM for ``dW``.
A quantized plan's int8/fp8 payload is frozen inference storage: its dx
runs through the grad plan on the same payload and scales, and it gets no
gradient of its own.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.segment_spgemm import segment_spgemm
from repro_torch.kernels.segment_spmm import segment_spmm

from .backends import resolve_backend
from .plan import SPGEMM, SPMM, SegmentPlan


def pick_bn(n: int, bn: int) -> Tuple[int, int]:
    """Normalize the N-tile width for an ``(…, N)`` right-hand side.

    Returns ``(bn_eff, pad)`` with ``(n + pad) % bn_eff == 0``: the largest
    divisor of ``n`` that is ≤ ``bn`` when it is at least half the request
    (or the full width up to 128), else the requested width and zero-padding.
    Kept for API parity with ``repro``: the CUDA kernel masks the ragged N
    edge itself, so the executor neither pads B nor calls this.
    """
    bn = max(1, min(bn, n))
    if n % bn == 0:
        return bn, 0
    div = max(d for d in range(1, bn + 1) if n % d == 0)
    if div >= max(bn // 2, min(128, n)):
        return div, 0
    return bn, (-n) % bn


def _resolve_bn(plan: SegmentPlan, bn: Optional[int]) -> int:
    """Explicit argument > the plan's ``bn_hint`` > 512."""
    if bn is not None:
        return bn
    return int(plan.bn_hint) if plan.bn_hint else 512


def _run_spmm(plan: SegmentPlan, x: torch.Tensor, *, blocks: torch.Tensor,
              scales: Optional[torch.Tensor], backend: str, bn: int,
              out_dtype: torch.dtype) -> torch.Tensor:
    """``BSR(blocks) @ x`` under ``plan``'s schedule; ``bn`` caps the
    kernel's N tile (the kernel masks a ragged N edge).

    ``blocks`` are always the stored tiles (BSR storage order), with their
    ``scales`` when they are a quantized payload; a ``transpose_lhs`` plan
    (the backward schedule) contracts them along their row axis instead of
    copying a transposed array."""
    gm, gk = plan.grid
    bm, bk = blocks.shape[1], blocks.shape[2]
    contract_blk = bm if plan.transpose_lhs else bk
    if x.ndim != 2 or x.shape[0] != gk * contract_blk:
        raise ValueError(f"rhs must be (K={gk * contract_blk}, N) dense, got "
                         f"{tuple(x.shape)}")
    if backend == "reference":
        if plan.transpose_lhs:
            # a_brow/a_bcol describe the forward storage, whose grid is the
            # plan's grid reversed
            out = ref.spmm_ref(blocks, plan.a_brow, plan.a_bcol, gk, gm, x,
                               transpose_lhs=True, scales=scales)
        else:
            out = ref.spmm_ref(blocks, plan.a_brow, plan.a_bcol, gm, gk, x,
                               scales=scales)
        return out.to(out_dtype)
    out = segment_spmm(
        blocks, plan.slot_idx, plan.m_idx, plan.k_idx,
        plan.seg_start, plan.seg_write, plan.accum_prev, plan.valid, x,
        grid_m=gm, n_lanes=plan.n_lanes, bn=bn, unroll=plan.unroll,
        transpose_lhs=plan.transpose_lhs, out_dtype=out_dtype,
        a_scales=scales, prefetch=plan.prefetch, runs=plan.run_offsets,
        chunks=plan.chunk_offsets)
    if plan.n_runs < gm:
        # block rows no item visits are never written by the kernel
        live = torch.repeat_interleave(plan.row_mask > 0,
                                       plan.block_shape[0])[:, None]
        out = torch.where(live, out, torch.zeros((), dtype=out.dtype,
                                                 device=out.device))
    return out


def _run_spgemm(plan: SegmentPlan, *, backend: str,
                out_dtype: torch.dtype) -> torch.Tensor:
    """The ``(n_out_blocks, bm, bn)`` C blocks of an spgemm plan."""
    if plan.n_out_blocks == 0:
        # no A column meets a B row: the symbolic C is empty, nothing runs
        bm = plan.block_shape[0]
        bn = plan.rhs_blocks.shape[2]
        return torch.zeros((0, bm, bn), dtype=out_dtype,
                           device=plan.lhs_blocks.device)
    if backend == "reference":
        out = ref.spgemm_ref(
            plan.lhs_blocks, plan.a_brow, plan.a_bcol, plan.grid,
            plan.rhs_blocks, plan.b_brow, plan.b_bcol, plan.rhs_grid,
            plan.c_brow_arr, plan.c_bcol_arr,
            a_scales=plan.lhs_scales, b_scales=plan.rhs_scales)
        return out.to(out_dtype)
    return segment_spgemm(
        plan.lhs_blocks, plan.rhs_blocks, plan.a_idx, plan.b_idx, plan.c_idx,
        plan.seg_start, plan.seg_write, plan.accum_prev, plan.valid,
        n_c_blocks=plan.n_out_blocks, n_lanes=plan.n_lanes,
        unroll=plan.unroll, out_dtype=out_dtype, a_scales=plan.lhs_scales,
        b_scales=plan.rhs_scales, prefetch=plan.prefetch,
        runs=plan.run_offsets, work=(plan.tc_runs, plan.tc_steps))


def _out_dtype(plan: SegmentPlan, out_dtype) -> torch.dtype:
    """Explicit argument > ``plan.out_dtype`` > float32."""
    if out_dtype is None:
        out_dtype = plan.out_dtype
    if out_dtype is None:
        return torch.float32
    if isinstance(out_dtype, torch.dtype):
        return out_dtype
    return getattr(torch, str(out_dtype))


def execute_plan(plan: SegmentPlan, rhs: Optional[torch.Tensor] = None, *,
                 bn: Optional[int] = None, backend: Optional[str] = None,
                 out_dtype=None) -> torch.Tensor:
    """Forward-only plan execution (``plan(...)`` delegates here): an spmm
    plan takes the dense rhs, an spgemm plan none (B is in the plan).

    Backend: explicit argument > ``plan.backend`` > the process default.
    Accumulation is always fp32; ``out_dtype`` only sets the written tiles.
    """
    backend = resolve_backend(backend if backend is not None else plan.backend)
    out_dtype = _out_dtype(plan, out_dtype)
    if plan.kind == SPMM:
        if rhs is None:
            raise ValueError("spmm plan needs a dense right-hand side")
        return _run_spmm(plan, rhs, blocks=plan.lhs_blocks,
                         scales=plan.lhs_scales, backend=backend,
                         bn=_resolve_bn(plan, bn), out_dtype=out_dtype)
    if plan.kind == SPGEMM:
        if rhs is not None:
            raise ValueError("spgemm plan takes no right-hand side (B is "
                             "frozen into the plan)")
        return _run_spgemm(plan, backend=backend, out_dtype=out_dtype)
    raise ValueError(f"unknown plan kind {plan.kind!r}")


def _block_sddmm(plan: SegmentPlan, dy: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """``dW[s] = dy[brow_s·bm:(brow_s+1)·bm] @ x[bcol_s·bk:(bcol_s+1)·bk]ᵀ``
    for every stored block ``s``, in fp32: the weight gradient sampled at
    the pattern, in the plan's storage order."""
    bm, bk = plan.block_shape
    gm, gk = plan.grid
    dyb = dy.float().reshape(gm, bm, -1)[plan.a_brow.long()]
    xb = x.float().reshape(gk, bk, -1)[plan.a_bcol.long()]
    return torch.bmm(dyb, xb.transpose(1, 2))


class _Apply(torch.autograd.Function):
    """``y = W @ x`` with ``W``'s blocks as a differentiable input (fp32
    plans; a quantized payload and its scales get no gradient)."""

    @staticmethod
    def forward(ctx, x, blocks, scales, plan, backend, bn):
        ctx.save_for_backward(x, blocks, scales)
        ctx.plan, ctx.backend, ctx.bn = plan, backend, bn
        out = _run_spmm(plan, x, blocks=blocks, scales=scales,
                        backend=backend, bn=bn, out_dtype=torch.float32)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, blocks, scales = ctx.saved_tensors
        plan = ctx.plan
        g = plan.grad_plan
        if g is None:
            raise ValueError("plan was built without with_grad=True; no "
                             "transposed schedule is available for the "
                             "backward pass — rebuild it with "
                             "plan_matmul(..., with_grad=True)")
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the kernel reads dy (a bf16 transposed view in the sparse FFN)
            # by stride and converts on load, as dy.astype(f32) does in
            # repro; the grad plan addresses the forward payload and scales
            dx = _run_spmm(g, dy, blocks=blocks, scales=scales,
                           backend=ctx.backend, bn=ctx.bn,
                           out_dtype=torch.float32).to(x.dtype)
        if ctx.needs_input_grad[1] and not plan.quantized:
            dw = _block_sddmm(plan, dy, x).to(blocks.dtype)
        return dx, dw, None, None, None, None


def apply_plan(plan: SegmentPlan, x: torch.Tensor, *,
               blocks: Optional[torch.Tensor] = None,
               scales: Optional[torch.Tensor] = None,
               bn: Optional[int] = None,
               backend: Optional[str] = None) -> torch.Tensor:
    """Differentiable ``y = W @ x`` for an spmm plan (``x``: ``(K, N)``);
    the output has ``x``'s dtype, accumulation is fp32.  ``blocks``
    (default ``plan.lhs_blocks``) are W's values in the plan's storage
    order, so layers that share a plan pass their own without copying it;
    on a quantized plan they are a payload of the plan's dtype and come
    with their ``scales`` (default ``plan.lhs_scales``, with the plan's own
    blocks only).

    Gradients flow to ``x`` (in ``x``'s dtype) and, on an fp32 plan, to
    ``blocks`` (in their dtype), never to the plan or to a quantized
    payload.  The backward pass needs the plan's ``grad_plan``
    (``plan_matmul(..., with_grad=True)``) and raises ``ValueError``
    without it; it runs on the backend resolved here."""
    if plan.kind != SPMM:
        raise ValueError("apply_plan supports spmm plans")
    if blocks is None:
        if scales is not None:
            raise ValueError("scales come with the blocks they scale; pass "
                             "both or neither")
        blocks, scales = plan.lhs_blocks, plan.lhs_scales
    else:
        if blocks.shape != plan.lhs_blocks.shape:
            raise ValueError(f"blocks has shape {tuple(blocks.shape)}, "
                             f"expected {tuple(plan.lhs_blocks.shape)}")
        plan._check_value_dtype("blocks", blocks)
        if plan.quantized and scales is None:
            raise ValueError(f"blocks of a {plan.block_dtype} plan need "
                             f"their scales")
    backend = resolve_backend(backend if backend is not None else plan.backend)
    return _Apply.apply(x, blocks, scales, plan, backend,
                        _resolve_bn(plan, bn))
