"""Sparse-weight linear layers backed by the Segment SpMM kernel.

``SparseLinear`` holds a :class:`~repro_torch.api.SegmentPlan` (built with
``with_grad=True``, as in ``repro``) and its trainable blocks, in original
BSR storage order, as a parameter.  The forward computes ``x @ Wᵀ`` as
``W @ xᵀ`` through :func:`repro_torch.api.apply_plan`; ``xᵀ`` is a
transposed view that the kernel reads by stride, with no copy.  The sparse
path accumulates in fp32 and returns the activation dtype.

Several layers can share one plan (one pruning pattern for every layer of
a model): :meth:`SparseLinear.like` makes a layer with the same plan and
its own blocks.

For serving, :meth:`SparseLinear.quantize` / :meth:`SparseMLP.quantize`
freeze the blocks into int8/fp8 payloads with fp32 scales (per block, or
per block row in the ``*.rowwise`` modes), as ``repro``'s do: the plan is
rebuilt over the same pattern with ``quantize=``, the kernel dequantizes at
its fp32 accumulator, and the payload and scales are buffers, not
parameters (x-gradients still flow).
"""
from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from repro_torch.api import SegmentPlan, apply_plan, plan_matmul
from repro_torch.core.formats import BSR, QUANT_DTYPES, quantize_blocks
from repro_torch.sharding.tensor_parallel import NO_TP, TP, copy_in

Seed = Union[int, np.random.Generator]


class SparseLinear(nn.Module):
    """W (d_out × d_in) block-sparse; forward maps (T, d_in) → (T, d_out).

    fp32 blocks are a parameter; a quantized layer (``scales`` given) holds
    its payload ``blocks`` and fp32 ``scales`` as buffers."""

    def __init__(self, plan: SegmentPlan, d_out: int, d_in: int,
                 blocks: torch.Tensor,
                 scales: Optional[torch.Tensor] = None):
        super().__init__()
        self.plan = plan
        self.d_out, self.d_in = d_out, d_in
        if scales is None:
            self.blocks = nn.Parameter(blocks)
        else:
            self.register_buffer("blocks", blocks)
        # None on fp32 layers (then absent from the state dict)
        self.register_buffer("scales", scales)

    @property
    def quantized(self) -> bool:
        return self.plan.quantized

    @staticmethod
    def from_pattern(w: BSR, *, policy: str = "segment",
                     device=None) -> "SparseLinear":
        """Layer over the pattern of ``w``, with ``w``'s values."""
        d_out, d_in = w.shape
        bm, bk = w.block_shape
        if d_in % bk or d_out % bm:
            raise ValueError(f"d_in={d_in} and d_out={d_out} must be "
                             f"multiples of the block {w.block_shape}: the "
                             f"Segment grid is exact")
        plan = plan_matmul(w, policy=policy, with_grad=True, device=device)
        return SparseLinear(plan, d_out, d_in, plan.lhs_blocks)

    @staticmethod
    def create(seed: Seed, d_in: int, d_out: int, *, block: int = 64,
               density: float = 0.25, policy: str = "segment",
               device=None) -> "SparseLinear":
        """Random pattern and values from ``seed`` (an int or a numpy
        Generator, drawn from in order)."""
        if d_in % block or d_out % block:
            raise ValueError(f"d_in={d_in} and d_out={d_out} must be "
                             f"multiples of block={block}")
        rng = np.random.default_rng(seed)
        w = BSR.random(rng, (d_out, d_in), (block, block), density)
        return SparseLinear.from_pattern(w, policy=policy, device=device)

    def like(self) -> "SparseLinear":
        """A layer with this layer's plan and its own (uninitialized)
        blocks (and scales, when quantized)."""
        scales = None if self.scales is None else torch.empty_like(
            self.scales)
        return SparseLinear(self.plan, self.d_out, self.d_in,
                            torch.empty_like(self.blocks), scales)

    @torch.no_grad()
    def quantize(self, mode: str = "int8") -> "SparseLinear":
        """A quantized inference copy of this layer (``repro``'s
        ``SparseLinear.quantize``): the blocks become a ``mode`` payload
        and scales, quantized on their device, in the same storage order.

        The plan is rebuilt over the same pattern with ``quantize=mode``
        and ``with_grad=True``, carrying the source plan's policy, lanes,
        unroll, backend, ``pipeline`` and ``bn_hint`` (layers of one
        pattern hit one cached template and share its schedule leaves).
        ``fold_len`` is not recorded on a plan, so a fold-built plan (any
        ``accum_prev`` set) raises rather than silently re-planning without
        the fold; so does a layer that is already quantized."""
        if self.quantized or self.blocks.dtype in QUANT_DTYPES.values():
            raise ValueError(
                f"layer is already quantized ({self.plan.block_dtype}): "
                f"re-quantizing would read the payload as fp32 weights and "
                f"drop its scales; quantize from the fp32 layer")
        if bool(self.plan.accum_prev.any()):
            raise ValueError(
                "cannot quantize a layer built from a fold_len plan: the fold "
                "length is not recorded on the plan, so re-planning would "
                "silently drop the fold schedule; build the fp32 layer "
                "without fold_len, or re-plan with plan_matmul(..., "
                "fold_len=..., quantize=...)")
        src = self.plan
        w = BSR((self.d_out, self.d_in), src.block_shape,
                src.a_brow.cpu().numpy(), src.a_bcol.cpu().numpy(),
                quantize_blocks(self.blocks.detach(), mode))
        plan = plan_matmul(w, policy=src.policy, with_grad=True,
                           quantize=mode, n_lanes=src.n_lanes,
                           unroll=src.unroll, backend=src.backend,
                           pipeline=src.pipeline, bn_hint=src.bn_hint,
                           device=self.blocks.device)
        return SparseLinear(plan, self.d_out, self.d_in, plan.lhs_blocks,
                            plan.lhs_scales)

    def init_(self, gen: torch.Generator) -> None:
        self.blocks.normal_(generator=gen).mul_(1.0 / math.sqrt(self.d_in))

    def forward(self, x2d: torch.Tensor, seq: TP = NO_TP) -> torch.Tensor:
        """x2d: (T, d_in) → (T, d_out), in x2d's dtype.  ``seq``: the rows
        are this rank's share of the sequence, so the blocks' gradient is
        summed over the ranks."""
        return apply_plan(self.plan, x2d.T, blocks=copy_in(self.blocks, seq),
                          scales=self.scales).T


class SparseMLP(nn.Module):
    """SwiGLU MLP with block-sparse up/gate/down projections.  On a mesh
    it is replicated along ``model`` (every rank runs every block), as
    ``repro``'s rules replicate the blocks: the schedule indexes the whole
    block list.  Under sequence parallelism (``seq``) it runs on this
    rank's rows of T, so each SpMM sees N = B·T / tp."""

    def __init__(self, up: SparseLinear, gate: SparseLinear,
                 down: SparseLinear):
        super().__init__()
        self.up, self.gate, self.down = up, gate, down

    @staticmethod
    def create(seed: Seed, d_model: int, d_ff: int, *, block: int = 64,
               density: float = 0.25, device=None) -> "SparseMLP":
        """Three random patterns drawn in order (up, gate, down) from one
        numpy Generator seeded with ``seed``."""
        rng = np.random.default_rng(seed)
        kw = dict(block=block, density=density, device=device)
        return SparseMLP(SparseLinear.create(rng, d_model, d_ff, **kw),
                         SparseLinear.create(rng, d_model, d_ff, **kw),
                         SparseLinear.create(rng, d_ff, d_model, **kw))

    def like(self) -> "SparseMLP":
        """Same three plans, fresh blocks."""
        return SparseMLP(self.up.like(), self.gate.like(), self.down.like())

    def quantize(self, mode: str = "int8") -> "SparseMLP":
        """Quantized inference copy of the MLP (all three projections)."""
        return SparseMLP(self.up.quantize(mode), self.gate.quantize(mode),
                         self.down.quantize(mode))

    def forward(self, x: torch.Tensor, seq: TP = NO_TP) -> torch.Tensor:
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        h = (torch.nn.functional.silu(self.gate(x2, seq))
             * self.up(x2, seq))
        y = self.down(h.to(x.dtype), seq)
        return y.reshape(*shape[:-1], -1).to(x.dtype)
