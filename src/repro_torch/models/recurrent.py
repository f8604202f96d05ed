"""The recurrent blocks (the port of ``repro.models.recurrent``): the RG-LRU
block of Griffin / RecurrentGemma and RWKV-6's (Finch) time mix and
channel mix.

RG-LRU:
``in_x``/``in_g`` project the input; ``xb`` goes through a width-4
depthwise causal conv, then the gates ``a_gate(xb)``/``x_gate(xb)`` and the
recurrence ``h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (σ(x_gate_t) ⊙ xb_t)``
run fused in the ``rg_lru`` kernel (:mod:`repro_torch.kernels.rg_lru`; its
plain version for CPU tensors, ``repro``'s oracle on the ``"reference"``
backend), and ``out`` projects ``h ⊙ gelu(gb)``.  Decode carries the
conv's last 3 inputs (activation dtype) and h (fp32) as state.  Under
autograd the kernel's backward is a kernel too (``rg_lru_bwd``); the
``"reference"`` backend's oracle is differentiated by torch, step by step.
:meth:`RGLRUBlock.tensor_parallel_` splits the block's channels over the
mesh's ``model`` axis.

RWKV-6 (:class:`RWKVBlock`): a token shift mixes each input with the one
before it (``mix``, five rows: r, k, v, w, g), the decay is data-dependent
(``w_bias + tanh(x_w @ w_lora_a) @ w_lora_b`` in fp32, then
``-softplus``), and the wkv recurrence over a per-head (hd × hd) fp32 state
S is :func:`repro_torch.kernels.ref.rwkv6_ref`, a torch loop over T (the
counterpart of ``repro``'s ``lax.scan``; neither package has a kernel for
it).  The channel mix is a token-shifted squared-ReLU MLP.  Decode carries
the two shifts (activation dtype) and S as state, so one call over T tokens
equals T calls of one token.  :meth:`RWKVBlock.tensor_parallel_` splits the
time mix by heads and the channel mix by hidden units over ``model``, as
``repro``'s rules lay the layer out; S then holds this rank's heads.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.api.backends import default_backend
from repro_torch.kernels import ref
from repro_torch.kernels.rg_lru import rg_lru
from repro_torch.sharding.tensor_parallel import (NO_TP, TP, copy_in, gather,
                                                  local, seq_enter, seq_exit)

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
    D), ``a_gate``, ``x_gate``, ``a_param`` (D,), ``out``.

    After :meth:`tensor_parallel_` the block runs this rank's ``D / tp``
    channels: ``in_x``/``in_g`` column-parallel, ``conv`` and ``a_param``
    kept whole and sliced to the channels (their gradient summed over the
    ranks), ``xb`` all-gathered along ``model`` once for ``a_gate`` and
    ``x_gate`` (column-parallel: dense (D, D) gates read every channel;
    its backward reduce-scatters), the ``rg_lru`` kernel over (B, T, D /
    tp), ``out`` row-parallel then all-reduced.  The decode state is then
    this rank's channels.  Under sequence parallelism (``seq``) the input
    and output are this rank's rows of T; the scan reads every row, so the
    block all-gathers T on entry and reduce-scatters T on exit (or, left
    whole, keeps its rows of the output)."""

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
        self.tp = NO_TP

    def tensor_parallel_(self, tp: TP) -> None:
        if not tp.on:
            return
        tp.span(self.a_param.shape[0])       # raises unless D splits
        for dense in (self.in_x, self.in_g, self.a_gate, self.x_gate):
            dense.tensor_parallel_(tp, "col")
        self.out.tensor_parallel_(tp, "row")
        self.tp = tp

    def init_(self, gen: torch.Generator) -> None:
        """conv ~ N(0, 0.2²), a_param ~ U(0.5, 2) (the projections are
        :class:`~repro_torch.models.layers.Dense` and draw their own)."""
        self.conv.normal_(generator=gen).mul_(0.2)
        self.a_param.uniform_(0.5, 2.0, generator=gen)

    def forward(self, x: torch.Tensor, state: Optional[State] = None,
                c: float = 8.0, seq: TP = NO_TP
                ) -> Tuple[torch.Tensor, State]:
        """x: (B, T, D); state: dict(conv, h) for decode.  Returns
        ``(out, new state)``."""
        tp = self.tp
        x = seq_enter(x, tp, seq)
        xb = self.in_x(x)
        gb = self.in_g(x)
        conv, a_param = self.conv, self.a_param
        if tp.on:
            conv = local(copy_in(conv, tp), 1, tp)
            a_param = local(copy_in(a_param, tp), 0, tp)
        xb, conv_state = causal_conv(
            xb, conv, None if state is None else state["conv"])
        h0 = (state["h"] if state is not None else
              torch.zeros((x.shape[0], xb.shape[2]), dtype=torch.float32,
                          device=x.device))
        xg = gather(xb, -1, tp, grad="sum")
        hs, h_t = rglru_scan(xb, self.a_gate(xg), self.x_gate(xg), a_param,
                             h0, c)
        out = seq_exit(self.out(hs * layers.gelu(gb)), tp, seq)
        return out, {"conv": conv_state, "h": h_t}


def rglru_block_state(b: int, d_model: int, dtype=torch.float32,
                      device=None) -> State:
    """Zero decode state: conv (B, 3, D) in the activation dtype, h (B, D)
    fp32."""
    return {"conv": torch.zeros((b, CONV_W - 1, d_model), dtype=dtype,
                                device=device),
            "h": torch.zeros((b, d_model), dtype=torch.float32,
                             device=device)}


# ---------------------------------------------------------------------------
# RWKV-6 (Finch) time mix + channel mix
# ---------------------------------------------------------------------------


def token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """shifted[t] = x[t-1], ``prev`` (B, D) at t = 0.  x: (B, T, D)."""
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _mixed(x, xs, mix):
    """``x ⊙ mix + xs ⊙ (1 - mix)`` in x's dtype, as ``repro`` rounds it."""
    return x * mix + xs * (1 - mix)


class RWKVBlock(nn.Module):
    """RWKV-6 time mix and channel mix of one layer, parameters under
    ``repro``'s names: ``mix`` (5, D), ``wr``/``wk``/``wv``/``wg``/``wo``,
    ``w_lora_a`` (D, lora), ``w_lora_b`` (lora, D), ``w_bias`` (D,), ``u``
    (H, hd), ``ln_x``, ``cm_mix`` (2, D), ``cm_k`` (D → d_ff), ``cm_v``
    (d_ff → D); lora is ``max(32, D // 16)`` wide.

    After :meth:`tensor_parallel_` the block runs this rank's ``H / tp``
    heads in the time mix and ``d_ff / tp`` hidden units in the channel
    mix (``repro``'s rules: ``wr``/``wk``/``wv``/``wg`` and ``cm_k``
    column-parallel, ``wo`` and ``cm_v`` row-parallel, ``w_lora_b``'s D
    columns on ``model``).  ``w_lora_b`` is held as this rank's columns
    (``tp_local`` dim 1, which ZeRO-3's shardings take from
    ``Transformer.tp_local_params``), so the data-dependent decay is this
    rank's channels with no collective.  ``mix``, ``cm_mix`` and
    ``w_lora_a`` are kept whole and feed rank-local compute, and ``u``,
    ``w_bias`` and ``ln_x.scale`` are kept whole and read as this rank's
    heads or channels: each is read through ``copy_in``, so its gradient
    is summed over ``model`` once, as are the input and the input shift
    states' (``seq_enter``, ``copy_in``).  ``ln_x`` normalizes over all D
    channels: its sum of squares is all-reduced (``RMSNorm(tp=)``).  The
    token shifts act on the full (replicated) input, so the ``shift``
    states stay (B, D) on every rank; S is (B, H / tp, hd, hd)."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, *,
                 device=None):
        super().__init__()
        d = d_model
        self.n_heads = n_heads
        lora = max(32, d // 16)
        self.mix = nn.Parameter(torch.empty(5, d, device=device))
        self.wr = layers.Dense(d, d, device=device)
        self.wk = layers.Dense(d, d, device=device)
        self.wv = layers.Dense(d, d, device=device)
        self.wg = layers.Dense(d, d, device=device)
        self.w_lora_a = nn.Parameter(torch.empty(d, lora, device=device))
        self.w_lora_b = nn.Parameter(torch.empty(lora, d, device=device))
        self.w_bias = nn.Parameter(torch.empty(d, device=device))
        self.u = nn.Parameter(torch.empty(n_heads, d // n_heads,
                                          device=device))
        self.wo = layers.Dense(d, d, device=device)
        self.ln_x = layers.RMSNorm(d, device=device)
        self.cm_mix = nn.Parameter(torch.empty(2, d, device=device))
        self.cm_k = layers.Dense(d, d_ff, device=device)
        self.cm_v = layers.Dense(d_ff, d, device=device)
        self.tp = NO_TP
        #: ``{param name: (its dim local on model, its full shape)}``
        self.tp_local: dict = {}

    def tensor_parallel_(self, tp: TP) -> None:
        """Split over ``tp``'s ranks (see the class docstring); raises
        ``TensorParallelError`` unless the heads and d_ff split evenly."""
        if not tp.on:
            return
        tp.span(self.n_heads)                # raises unless H splits
        tp.span(self.cm_k.w.shape[1])        # and d_ff
        for dense in (self.wr, self.wk, self.wv, self.wg, self.cm_k):
            dense.tensor_parallel_(tp, "col")
        for dense in (self.wo, self.cm_v):
            dense.tensor_parallel_(tp, "row")
        shape = tuple(self.w_lora_b.shape)
        self.w_lora_b = nn.Parameter(
            local(self.w_lora_b.detach(), 1, tp).clone())
        self.tp_local = {"w_lora_b": (1, shape)}
        self.tp = tp

    def init_(self, gen: torch.Generator) -> None:
        """mix, cm_mix ~ U(0, 1); lora ~ N(0, 0.01²); w_bias = -4 (a slow
        decay); u ~ N(0, 0.1²) (the projections draw their own).  A split
        ``w_lora_b`` is drawn whole and this rank's columns kept, so a
        split block holds one process's values."""
        self.mix.uniform_(0.0, 1.0, generator=gen)
        self.w_lora_a.normal_(generator=gen).mul_(0.01)
        if self.tp_local:
            full = torch.empty(self.tp_local["w_lora_b"][1],
                               device=self.w_lora_b.device)
            full.normal_(generator=gen).mul_(0.01)
            self.w_lora_b.copy_(local(full, 1, self.tp))
        else:
            self.w_lora_b.normal_(generator=gen).mul_(0.01)
        self.w_bias.fill_(-4.0)
        self.u.normal_(generator=gen).mul_(0.1)
        self.cm_mix.uniform_(0.0, 1.0, generator=gen)


def rwkv_time_mix(block: RWKVBlock, x: torch.Tensor, state: State,
                  seq: TP = NO_TP) -> Tuple[torch.Tensor, State]:
    """x: (B, T, D); state: dict(shift (B, D), S (B, H, hd, hd) fp32; this
    rank's heads on a split block).  ``seq``: x is this rank's rows of T
    (gathered on entry, the output reduce-scattered back to them).
    Returns ``(out, {"shift", "S"})``."""
    tp = block.tp
    x = seq_enter(x, tp, seq)
    b, t, _ = x.shape
    hd = block.u.shape[1]
    xs = token_shift(x, copy_in(state["shift"], tp))
    mix = copy_in(block.mix, tp).to(x.dtype)
    r = block.wr(_mixed(x, xs, mix[0]))
    h = r.shape[-1] // hd                    # this rank's heads
    r = r.reshape(b, t, h, hd)
    k = block.wk(_mixed(x, xs, mix[1])).reshape(b, t, h, hd)
    v = block.wv(_mixed(x, xs, mix[2])).reshape(b, t, h, hd)
    g = block.wg(_mixed(x, xs, mix[4]))
    w_bias, u = block.w_bias, block.u
    if tp.on:
        w_bias = local(copy_in(w_bias, tp), 0, tp)
        u = local(copy_in(u, tp), 0, tp)
    # data-dependent decay in (0, 1): exp(-softplus(w_raw)), in fp32
    w_raw = (w_bias.float()
             + torch.tanh(_mixed(x, xs, mix[3]).float()
                          @ copy_in(block.w_lora_a, tp).float())
             @ block.w_lora_b.float())
    log_w = -ref.softplus(w_raw).reshape(b, t, h, hd)
    outs, s_t = ref.rwkv6_ref(r, k, v, log_w, u, state["S"])
    outs = outs.reshape(b, t, h * hd).to(x.dtype)
    out = block.wo(block.ln_x(outs, tp=tp) * F.silu(g))
    return seq_exit(out, tp, seq), {"shift": x[:, -1], "S": s_t}


def rwkv_channel_mix(block: RWKVBlock, x: torch.Tensor,
                     shift: torch.Tensor, seq: TP = NO_TP
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The token-shifted squared-ReLU MLP; ``shift`` (B, D) is its state
    (``seq`` as in :func:`rwkv_time_mix`).  Returns ``(out, new
    shift)``."""
    tp = block.tp
    x = seq_enter(x, tp, seq)
    xs = token_shift(x, copy_in(shift, tp))
    xk = _mixed(x, xs, copy_in(block.cm_mix, tp).to(x.dtype)[0])
    out = block.cm_v(torch.square(F.relu(block.cm_k(xk))))
    return seq_exit(out, tp, seq), x[:, -1]


def rwkv_block_state(b: int, d_model: int, n_heads: int,
                     dtype=torch.float32, device=None,
                     tp: TP = NO_TP) -> State:
    """Zero decode state: ``shift``/``cm_shift`` (B, D) in the activation
    dtype, ``S`` (B, H / tp, hd, hd) fp32 (``tp``: a split block's
    ranks)."""
    hd = d_model // n_heads
    return {"shift": torch.zeros((b, d_model), dtype=dtype, device=device),
            "S": torch.zeros((b, n_heads // tp.size, hd, hd),
                             dtype=torch.float32, device=device),
            "cm_shift": torch.zeros((b, d_model), dtype=dtype,
                                    device=device)}
