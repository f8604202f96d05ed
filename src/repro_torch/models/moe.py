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
token of the microbatch: on a mesh that splits the rows over dp ranks
(``MoE.dp``, set by ``Transformer.zero3_``) the two per-expert means are
averaged over those ranks when gradients are recorded, as ``repro``
takes them over its global batch (a forward without gradients, which
reads no aux loss, keeps its rank's own).

Expert parallelism (:meth:`MoE.tensor_parallel_`): on a mesh the expert
stacks split over the ``model`` ranks, experts ``[r·E/tp, (r+1)·E/tp)`` on
rank r, as ``repro``'s rules shard them (``P(model, ...)``).  The router
stays whole (its top-k reads every expert's logit) and routes on every
rank alike, with the global E and capacity; each rank runs its experts'
slice of the dispatch buffers, each token takes the row of a choice that
falls in this rank's experts (else 0), and the fp32 outputs are summed
over ``model`` before the cast.  With at most two choices a token, at most
two nonzero terms meet in that sum, so the split layer's forward equals
the unsplit one's.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding.tensor_parallel import (NO_TP, TP,
                                                  TensorParallelError,
                                                  all_mean, copy_in, gather,
                                                  local, seq_exit)

from . import layers


class MoE(nn.Module):
    """``router`` (D → E, fp32 logits) and the expert stacks ``gate``/``up``
    (E, D, d_ff) and ``down`` (E, d_ff, D), under ``repro``'s names; run by
    :func:`moe_apply`.  After :meth:`tensor_parallel_` the stacks hold
    this rank's ``E / tp`` experts."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, *,
                 device=None):
        super().__init__()
        self.n_experts = n_experts
        self.router = layers.Dense(d_model, n_experts, device=device)
        self.gate = nn.Parameter(torch.empty(n_experts, d_model, d_ff,
                                             device=device))
        self.up = nn.Parameter(torch.empty(n_experts, d_model, d_ff,
                                           device=device))
        self.down = nn.Parameter(torch.empty(n_experts, d_ff, d_model,
                                             device=device))
        self.tp = NO_TP
        #: ``(group, size)`` of each dp axis the batch rows split over
        self.dp: tuple = ()
        #: ``{param name: (its dim local on model, its full shape)}``
        self.tp_local: dict = {}

    def tensor_parallel_(self, tp: TP) -> None:
        """Keep this rank's experts of ``gate``, ``up`` and ``down``;
        raises :class:`TensorParallelError` when the experts do not split
        over the ranks (the layer then computes whole)."""
        if not tp.on:
            return
        if self.n_experts % tp.size:
            raise TensorParallelError(
                f"{self.n_experts} experts do not split over {tp.size} "
                f"model ranks")
        for name in ("gate", "up", "down"):
            w = getattr(self, name)
            self.tp_local[name] = (0, tuple(w.shape))
            setattr(self, name,
                    nn.Parameter(local(w.detach(), 0, tp).clone()))
        self.tp = tp

    def expert_span(self) -> Tuple[int, int]:
        """This rank's experts ``[lo, hi)`` (all of them unsplit)."""
        return self.tp.span(self.n_experts) if self.tp.on \
            else (0, self.n_experts)

    def init_(self, gen: torch.Generator) -> None:
        """gate, up ~ N(0, 1/D); down ~ N(0, 1/d_ff) (the router draws its
        own); a split layer draws the full stacks and keeps its experts."""
        d_model, d_ff = self.gate.shape[1:]
        for name, fan_in in (("gate", d_model), ("up", d_model),
                             ("down", d_ff)):
            w = getattr(self, name)
            if name in self.tp_local:
                full = torch.empty(self.tp_local[name][1], device=w.device)
                full.normal_(generator=gen).mul_(1.0 / math.sqrt(fan_in))
                w.copy_(local(full, 0, self.tp))
            else:
                w.normal_(generator=gen).mul_(1.0 / math.sqrt(fan_in))


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
              capacity_factor: float = 1.25, seq: TP = NO_TP
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) → ``(out (B, T, D) in x's dtype, aux loss, fp32)``.

    On a split layer the routing (logits, gates, aux) runs on ``x`` alike
    on every rank; the experts read ``copy_in(x)`` and the gate weights
    through ``copy_in`` too, so the backward sums over ``model`` what each
    rank's experts contribute to dx and to the gates, and the router's
    gradient is the same on every rank.  ``seq``: ``x`` and ``out`` are
    this rank's rows of T; a row routes over all of T, so the rows are
    all-gathered first (every rank then routes alike: the backward keeps
    this rank's rows) and the output is reduce-scattered along T."""
    if seq.on:
        x = gather(x, 1, seq)
    b, t, d = x.shape
    n_exp = moe.n_experts
    tp = moe.tp
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
    if torch.is_grad_enabled():          # over the whole microbatch
        me, ce = all_mean(me, moe.dp), all_mean(ce, moe.dp)
    aux = n_exp * torch.sum(me * ce)

    xe, gates = copy_in(x, tp), copy_in(gates, tp)
    lo, hi = moe.expert_span()
    n_loc = hi - lo
    # only this rank's experts are cast to the activation dtype
    w_gate, w_up, w_down = (w.to(x.dtype) for w in
                            (moe.gate, moe.up, moe.down))
    bufs, slots, keeps = [], [], []
    for j in range(top_k):
        buf, slot, keep = dispatch_batched(xe, top_idx[..., j], n_exp, cap)
        if n_loc < n_exp:                # this rank's experts' rows
            buf = buf[:, lo:hi]
            slot = slot - lo * cap
            keep = keep & (slot >= 0) & (slot < n_loc * cap)
        bufs.append(buf)
        slots.append(slot)
        keeps.append(keep)
    # every choice's rows in one product a weight: each weight's gradient
    # is made once, not summed over the choices in buffers of its size
    buf = bufs[0] if top_k == 1 else torch.cat(bufs, dim=2)
    h = (F.silu(torch.einsum("becd,edf->becf", buf, w_gate))
         * torch.einsum("becd,edf->becf", buf, w_up))
    y_all = torch.einsum("becf,efd->becd", h, w_down)   # (B, E, k·cap, D)
    out = torch.zeros((b, t, d), dtype=torch.float32, device=x.device)
    for j, (slot, keep) in enumerate(zip(slots, keeps)):
        y = y_all[:, :, j * cap:(j + 1) * cap].reshape(b, n_loc * cap, d)
        idx = slot.clamp(0, n_loc * cap - 1)
        vals = torch.gather(y, 1, idx[..., None].expand(b, t, d))
        y_tok = torch.where(keep[..., None], vals,
                            torch.zeros((), dtype=y.dtype, device=y.device))
        out = out + y_tok.float() * gates[..., j][..., None]
    return seq_exit(out, tp, seq).to(x.dtype), aux
