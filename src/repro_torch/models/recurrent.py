"""The RG-LRU recurrent block of Griffin / RecurrentGemma (the port of
``repro.models.recurrent``'s ``rglru_block_*``).

``in_x``/``in_g`` project the input; ``xb`` goes through a width-4
depthwise causal conv, then the gates ``a_gate(xb)``/``x_gate(xb)`` and the
recurrence ``h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (σ(x_gate_t) ⊙ xb_t)``
run fused in the ``rg_lru`` kernel (:mod:`repro_torch.kernels.rg_lru`; its
plain version for CPU tensors, ``repro``'s oracle on the ``"reference"``
backend), and ``out`` projects ``h ⊙ gelu(gb)``.  Decode carries the
conv's last 3 inputs (activation dtype) and h (fp32) as state.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.api.backends import default_backend
from repro_torch.kernels import ref
from repro_torch.kernels.rg_lru import rg_lru

from . import layers

CONV_W = 4

State = Dict[str, torch.Tensor]


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width 4.  x: (B, T, D), w: (4, D); state:
    (B, 3, D) trailing inputs of the previous call (zeros when ``None``).
    The four products are taken in x's dtype and summed from i = 0, as
    ``repro`` sums them.  Returns ``(y, new state)``."""
    b, t, d = x.shape
    if state is None:
        state = torch.zeros((b, CONV_W - 1, d), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    wd = w.to(x.dtype)
    y = xp[:, :t] * wd[0]
    for i in range(1, CONV_W):
        y = y + xp[:, i:i + t] * wd[i]
    return y, xp[:, -(CONV_W - 1):]


def rglru_scan(xb, ag, xg, a_param, h0, c: float = 8.0):
    """Gates and recurrence over (B, T, D) operands from h0 (B, D) fp32:
    the ``rg_lru`` kernel over the whole call (``ct=T``), or ``repro``'s
    oracle in fp32 on the ``"reference"`` backend.  Returns ``(out in xb's
    dtype, h_T fp32)``."""
    if default_backend() == "reference":
        out, h = ref.rg_lru_ref(xb.float(), ag.float(), xg.float(),
                                a_param.float(), h0, c=c)
        return out.to(xb.dtype), h
    return rg_lru(xb, ag, xg, a_param, h0, ct=xb.shape[1], c=c)


class RGLRUBlock(nn.Module):
    """Parameters under ``repro``'s names: ``in_x``, ``in_g``, ``conv`` (4,
    D), ``a_gate``, ``x_gate``, ``a_param`` (D,), ``out``."""

    def __init__(self, d_model: int, *, device=None):
        super().__init__()
        d = d_model
        self.in_x = layers.Dense(d, d, device=device)
        self.in_g = layers.Dense(d, d, device=device)
        self.conv = nn.Parameter(torch.empty(CONV_W, d, device=device))
        self.a_gate = layers.Dense(d, d, device=device)
        self.x_gate = layers.Dense(d, d, device=device)
        self.a_param = nn.Parameter(torch.empty(d, device=device))
        self.out = layers.Dense(d, d, device=device)

    def init_(self, gen: torch.Generator) -> None:
        """conv ~ N(0, 0.2²), a_param ~ U(0.5, 2) (the projections are
        :class:`~repro_torch.models.layers.Dense` and draw their own)."""
        self.conv.normal_(generator=gen).mul_(0.2)
        self.a_param.uniform_(0.5, 2.0, generator=gen)

    def forward(self, x: torch.Tensor, state: Optional[State] = None,
                c: float = 8.0) -> Tuple[torch.Tensor, State]:
        """x: (B, T, D); state: dict(conv, h) for decode.  Returns
        ``(out, new state)``."""
        xb = self.in_x(x)
        gb = self.in_g(x)
        xb, conv = causal_conv(xb, self.conv,
                               None if state is None else state["conv"])
        h0 = (state["h"] if state is not None else
              torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32,
                          device=x.device))
        hs, h_t = rglru_scan(xb, self.a_gate(xb), self.x_gate(xb),
                             self.a_param, h0, c)
        return self.out(hs * layers.gelu(gb)), {"conv": conv, "h": h_t}


def rglru_block_state(b: int, d_model: int, dtype=torch.float32,
                      device=None) -> State:
    """Zero decode state: conv (B, 3, D) in the activation dtype, h (B, D)
    fp32."""
    return {"conv": torch.zeros((b, CONV_W - 1, d_model), dtype=dtype,
                                device=device),
            "h": torch.zeros((b, d_model), dtype=torch.float32,
                             device=device)}
