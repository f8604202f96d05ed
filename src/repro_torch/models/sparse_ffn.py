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
"""
from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch
from torch import nn

from repro_torch.api import SegmentPlan, apply_plan, plan_matmul
from repro_torch.core.formats import BSR

Seed = Union[int, np.random.Generator]


class SparseLinear(nn.Module):
    """W (d_out × d_in) block-sparse; forward maps (T, d_in) → (T, d_out)."""

    def __init__(self, plan: SegmentPlan, d_out: int, d_in: int,
                 blocks: torch.Tensor):
        super().__init__()
        self.plan = plan
        self.d_out, self.d_in = d_out, d_in
        self.blocks = nn.Parameter(blocks)

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
        blocks."""
        return SparseLinear(self.plan, self.d_out, self.d_in,
                            torch.empty_like(self.blocks))

    def init_(self, gen: torch.Generator) -> None:
        self.blocks.normal_(generator=gen).mul_(1.0 / math.sqrt(self.d_in))

    def forward(self, x2d: torch.Tensor) -> torch.Tensor:
        """x2d: (T, d_in) → (T, d_out), in x2d's dtype."""
        return apply_plan(self.plan, x2d.T, blocks=self.blocks).T


class SparseMLP(nn.Module):
    """SwiGLU MLP with block-sparse up/gate/down projections."""

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        h = (torch.nn.functional.silu(self.gate(x2)) * self.up(x2))
        y = self.down(h.to(x.dtype))
        return y.reshape(*shape[:-1], -1).to(x.dtype)
