"""Mixture-of-Experts layer (the port of ``repro.models.moe``).

Routing is per batch row: the router (fp32) picks ``top_k`` experts a
token; for each of the k choices, a row's tokens sort by expert (a stable
sort, as ``jnp.argsort`` is), the c-th token of expert e lands in slot
``e * cap + c`` of a ``(B, E, cap, D)`` buffer, and a token past its
expert's capacity ``cap = ceil(T * capacity_factor / E)`` (T of the call)
is dropped.  The expert FFN is a batched SwiGLU over the buffers
(``torch.einsum``, the expert stacks cast to the activation dtype on every
call, as ``repro`` computes it outside any Pallas kernel), so gradients
flow through it.  Each token gathers its expert's row back and weighs it
by the softmax of its top-k logits.  The Switch load-balance loss
``E · Σ_e mean_prob_e · share_of_first_choices_e`` is taken over every
token.  On a mesh the experts are not split: every rank along ``model``
computes the whole layer on full tensors (expert parallelism is not
ported; ``Transformer.tp_gathered`` names each such layer).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import layers


class MoE(nn.Module):
    """``router`` (D → E, fp32 logits) and the expert stacks ``gate``/``up``
    (E, D, d_ff) and ``down`` (E, d_ff, D), under ``repro``'s names; run by
    :func:`moe_apply`."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, *,
                 device=None):
        super().__init__()
        self.router = layers.Dense(d_model, n_experts, device=device)
        self.gate = nn.Parameter(torch.empty(n_experts, d_model, d_ff,
                                             device=device))
        self.up = nn.Parameter(torch.empty(n_experts, d_model, d_ff,
                                           device=device))
        self.down = nn.Parameter(torch.empty(n_experts, d_ff, d_model,
                                             device=device))

    def init_(self, gen: torch.Generator) -> None:
        """gate, up ~ N(0, 1/D); down ~ N(0, 1/d_ff) (the router draws its
        own)."""
        d_model, d_ff = self.gate.shape[1:]
        self.gate.normal_(generator=gen).mul_(1.0 / math.sqrt(d_model))
        self.up.normal_(generator=gen).mul_(1.0 / math.sqrt(d_model))
        self.down.normal_(generator=gen).mul_(1.0 / math.sqrt(d_ff))


def capacity(t: int, n_exp: int, capacity_factor: float) -> int:
    """Slots per expert and row for a call over T tokens."""
    return max(1, int(math.ceil(t * capacity_factor / n_exp)))


def dispatch_batched(x: torch.Tensor, expert: torch.Tensor, n_exp: int,
                     cap: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row expert dispatch.  x: (B, T, D); expert: (B, T) int.

    Returns ``(buf (B, E, cap, D), slot (B, T), keep (B, T))``: buf[b, e, c]
    holds the c-th token of row b routed to expert e (zeros past each
    expert's count); ``slot`` is a token's index into the flat ``E * cap``
    axis, ``E * cap`` (the trash slot) for a dropped token."""
    b, t, d = x.shape
    order = torch.argsort(expert, dim=-1, stable=True)
    sorted_e = torch.gather(expert, -1, order).contiguous()
    pos_in_e = (torch.arange(t, device=x.device)
                - torch.searchsorted(sorted_e, sorted_e, side="left"))
    keep_sorted = pos_in_e < cap
    slot_sorted = torch.where(keep_sorted, sorted_e * cap + pos_in_e,
                              n_exp * cap)
    x_sorted = torch.gather(x, 1, order[..., None].expand(b, t, d))
    src = torch.where(keep_sorted[..., None], x_sorted,
                      torch.zeros((), dtype=x.dtype, device=x.device))
    buf = torch.zeros((b, n_exp * cap + 1, d), dtype=x.dtype,
                      device=x.device).scatter(
        1, slot_sorted[..., None].expand(b, t, d), src)
    # undo the sort, so slot and keep index the tokens' own positions
    inv = torch.argsort(order, dim=-1)
    slot = torch.gather(slot_sorted, -1, inv)
    keep = torch.gather(keep_sorted, -1, inv)
    return buf[:, :-1].reshape(b, n_exp, cap, d), slot, keep


def moe_apply(moe: MoE, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) → ``(out (B, T, D) in x's dtype, aux loss, fp32)``."""
    b, t, d = x.shape
    n_exp = moe.router.w.shape[1]
    cap = capacity(t, n_exp, capacity_factor)
    logits = moe.router(x.float())                                # (B,T,E)
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(logits, top_k, dim=-1)
    gates = torch.softmax(top_vals, dim=-1)                       # (B,T,k)

    # Switch-style load-balance loss over every token's first choice
    me = probs.reshape(-1, n_exp).mean(dim=0)
    # the first choices' counts per expert (a scatter, not bincount: its
    # output shape does not depend on the values, so a fake tensor traces)
    first = top_idx[..., 0].reshape(-1)
    ce = torch.zeros(n_exp, dtype=torch.float32, device=x.device).index_add_(
        0, first, torch.ones(first.shape, device=x.device)) / (b * t)
    aux = n_exp * torch.sum(me * ce)

    w_gate, w_up, w_down = (w.to(x.dtype) for w in
                            (moe.gate, moe.up, moe.down))
    out = torch.zeros((b, t, d), dtype=torch.float32, device=x.device)
    for j in range(top_k):
        buf, slot, keep = dispatch_batched(x, top_idx[..., j], n_exp, cap)
        h = (F.silu(torch.einsum("becd,edf->becf", buf, w_gate))
             * torch.einsum("becd,edf->becf", buf, w_up))
        y = torch.einsum("becf,efd->becd", h, w_down).reshape(
            b, n_exp * cap, d)
        idx = slot.clamp_max(n_exp * cap - 1)
        vals = torch.gather(y, 1, idx[..., None].expand(b, t, d))
        y_tok = torch.where(keep[..., None], vals,
                            torch.zeros((), dtype=y.dtype, device=y.device))
        out = out + y_tok.float() * gates[..., j][..., None]
    return out.to(x.dtype), aux
