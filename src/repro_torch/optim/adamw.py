"""AdamW with global-norm gradient clipping, following ``repro.optim.adamw``
formula for formula (not ``torch.optim.AdamW``'s defaults): b2 = 0.95, the
weight decay applied to every parameter inside the update, ``eps`` added
outside ``sqrt(v̂)``, moments kept in ``state_dtype`` and all arithmetic in
fp32.

Unlike the JAX version, which returns new arrays, :meth:`AdamW.update`
updates the parameters and the moments in place: at full width the
parameters, gradients and both moments already take four copies of the
model, and a fifth would not fit on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .schedule import Schedule


@dataclasses.dataclass
class AdamWState:
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def _ema_(buf: torch.Tensor, new: torch.Tensor, beta: float) -> torch.Tensor:
    """``buf ← beta·buf + (1 − beta)·new`` in fp32, stored in ``buf``'s
    dtype; returns the stored value in fp32."""
    if buf.dtype == torch.float32:
        return buf.mul_(beta).add_(new, alpha=1 - beta)
    buf.copy_(buf.float().mul_(beta).add_(new, alpha=1 - beta))
    return buf.float()


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Schedule                       # step → lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: torch.dtype = torch.float32   # bf16: low-memory moments

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        def zeros():
            return {k: torch.zeros_like(p, dtype=self.state_dtype)
                    for k, p in params.items()}
        return AdamWState(step=0, m=zeros(), v=zeros())

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
               params: Mapping[str, torch.Tensor],
               grad_norm: Optional[torch.Tensor] = None) -> Dict[str, object]:
        """One step, in place on ``params``, ``state.m`` and ``state.v``
        (``state.step`` advances).  ``grad_norm``: the pre-clip global norm
        when the caller computed it (over shards of the gradients that
        other ranks hold too); by default the norm of ``grads``.  Returns
        ``{"grad_norm": the pre-clip global norm (a device scalar), "lr":
        the step's rate}``."""
        step = state.step + 1
        if grad_norm is None:
            norms = torch.stack([torch.linalg.vector_norm(
                g, dtype=torch.float32) for g in grads.values()])
            grad_norm = torch.linalg.vector_norm(norms)
        gnorm = grad_norm
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(step))
        bc2 = float(f32(1) - f32(self.b2) ** f32(step))
        lr = self.lr(step)
        for k, p in params.items():
            g = grads[k].float() * scale
            m = _ema_(state.m[k], g, self.b1)
            v = _ema_(state.v[k], g.mul_(g), self.b2)
            delta = m.div(bc1).div_(v.div(bc2).sqrt_().add_(self.eps))
            delta.add_(p.float(), alpha=self.weight_decay)
            if p.dtype == torch.float32:
                p.sub_(delta, alpha=lr)
            else:
                p.copy_(p.float().sub_(delta, alpha=lr))
        state.step = step
        return {"grad_norm": gnorm, "lr": lr}
