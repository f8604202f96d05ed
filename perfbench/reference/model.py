"""The plain reference: the configuration's transformer in float32 PyTorch,
with TF32 off, from the weights that :mod:`perfbench.inputs` draws.

It imports nothing of the program.  Each layer follows the published
equations (pre-norm RMSNorm, rotary GQA attention, SwiGLU), the
block-sparse FFN as a dense matrix that is zero outside the pattern's
blocks, and the MoE as top-k routing over the router's logits, gates by a
softmax over the k chosen logits, at the port's capacity rule: in a
segment of ``T`` tokens (a training row, a prefill chunk, one decoded
token) each of the k choices keeps, for each expert, the first
``ceil(T * capacity_factor / E)`` tokens in position order, and a token
past that gets nothing from that choice.

``prec="fp8"`` is the control: every matrix product takes its operands
rounded to float8 e4m3 with one scale a tensor (its largest magnitude at
448), and in a backward pass the gradients that leave a product are
rounded the same way; everything else stays float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.inputs import FFN_PROJ, Arch, ffn_shapes

Weights = Dict[str, torch.Tensor]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.detach().abs().amax().float().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g)


def _operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    return _Fp8.apply(x) if prec == "fp8" else x


def mm(a: torch.Tensor, b: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    """``a @ b`` in float32 (TF32 off), or with float8 operands."""
    return _operand(a, prec) @ _operand(b, prec)


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rotary(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, D), pos (T,): the rotate-half form, frequencies
    ``theta ** (-2i / D)``."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, device=x.device,
                                    dtype=torch.float32) / half)
    ang = pos.float()[:, None] * freqs
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(a: Arch, w: Weights, i: int, x: torch.Tensor,
              prec: str) -> torch.Tensor:
    """Causal GQA attention of layer ``i`` over x (B, T, D)."""
    p = f"layers.{i}.attn."
    b, t, _ = x.shape
    hd, rep = a.head_dim, a.n_heads // a.n_kv
    pos = torch.arange(t, device=x.device)
    q = rotary(mm(x, w[p + "wq.w"], prec).view(b, t, a.n_heads, hd), pos,
               a.rope_theta)
    k = rotary(mm(x, w[p + "wk.w"], prec).view(b, t, a.n_kv, hd), pos,
               a.rope_theta)
    v = mm(x, w[p + "wv.w"], prec).view(b, t, a.n_kv, hd)
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)      # (B, H, T, D)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    s = mm(q, k.transpose(-1, -2), prec) / math.sqrt(hd)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = mm(torch.softmax(s, dim=-1), v, prec)                 # (B, H, T, D)
    o = o.transpose(1, 2).reshape(b, t, a.n_heads * hd)
    return mm(o, w[p + "wo.w"], prec)


def dense_ffn_weight(a: Arch, blocks: torch.Tensor, pattern,
                     proj: str) -> torch.Tensor:
    """The (d_out, d_in) matrix of a block-sparse projection: its blocks at
    the pattern's cells, zeros elsewhere."""
    m, k = ffn_shapes(a)[proj]
    bs = a.ffn_block
    brow, bcol = pattern[proj]
    grid = blocks.new_zeros(m // bs, k // bs, bs, bs).index_put(
        (brow, bcol), blocks)
    return grid.permute(0, 2, 1, 3).reshape(m, k)


def ffn(a: Arch, w: Weights, i: int, x: torch.Tensor, pattern,
        prec: str) -> torch.Tensor:
    p = f"layers.{i}.mlp."
    if a.ffn_block_sparse:
        up, gate, down = (dense_ffn_weight(a, w[p + f"{n}.blocks"], pattern,
                                           n).T for n in FFN_PROJ)
    else:
        up, gate, down = (w[p + f"{n}.w"] for n in FFN_PROJ)
    return mm(F.silu(mm(x, gate, prec)) * mm(x, up, prec), down, prec)


def moe(a: Arch, w: Weights, i: int, x: torch.Tensor,
        segments: Sequence[tuple], prec: str):
    """x (B, T, D); ``segments``: ``(start, length, width)`` spans of T,
    each routed as one call of ``width`` tokens (its capacity) of which the
    first ``length`` are these.  Returns ``(out, aux)``."""
    p = f"layers.{i}.moe."
    b, t, d = x.shape
    e, k = a.n_experts, a.top_k
    logits = mm(x, w[p + "router.w"], prec)                 # (B, T, E)
    probs = torch.softmax(logits, dim=-1)
    top_v, top_i = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(top_v, dim=-1)
    first = F.one_hot(top_i[..., 0], e).float()
    aux = e * (probs.reshape(-1, e).mean(0) * first.reshape(-1, e).mean(0)
               ).sum()
    keep = torch.zeros(b, t, k, dtype=torch.bool, device=x.device)
    for start, length, width in segments:
        cap = max(1, math.ceil(width * a.capacity_factor / e))
        sel = top_i[:, start:start + length]                 # (B, L, k)
        onehot = F.one_hot(sel, e)                          # (B, L, k, E)
        rank = onehot.cumsum(dim=1) - 1                     # place in expert
        mine = (rank * onehot).sum(-1)                      # (B, L, k)
        keep[:, start:start + length] = mine < cap
    out = torch.zeros_like(x)
    xf = x.reshape(b * t, d)
    for ex in range(e):
        hit = (top_i == ex) & keep                           # (B, T, k)
        rows, choice = hit.reshape(b * t, k).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = xf[rows]
        h = F.silu(mm(xe, w[p + "gate"][ex], prec)) * mm(
            xe, w[p + "up"][ex], prec)
        y = mm(h, w[p + "down"][ex], prec)
        g = gates.reshape(b * t, k)[rows, choice]
        out = out.reshape(b * t, d).index_add(0, rows, y * g[:, None]
                                              ).reshape(b, t, d)
    return out, aux


def block(a: Arch, w: Weights, i: int, x: torch.Tensor, pattern,
          segments, prec: str):
    p = f"layers.{i}."
    x = x + attention(a, w, i, rms_norm(x, w[p + "norm1.scale"], a.norm_eps),
                      prec)
    h = rms_norm(x, w[p + "norm2.scale"], a.norm_eps)
    if a.family == "moe":
        y, aux = moe(a, w, i, h, segments, prec)
    else:
        y, aux = ffn(a, w, i, h, pattern, prec), x.new_zeros(())
    return x + y, aux


def head_table(a: Arch, w: Weights) -> torch.Tensor:
    return w["embed.table" if a.tie_embeddings else "lm_head.table"]


def hidden(a: Arch, w: Weights, tokens: torch.Tensor, pattern=None,
           segments=None, prec: str = "fp32", remat: bool = False):
    """tokens (B, T) → (final-normed hidden (B, T, D), summed aux loss);
    ``remat``: each block rematerialized in the backward pass, so only
    block inputs are kept (the reference's blocks)."""
    x = w["embed.table"][tokens]
    if segments is None:
        segments = [(0, tokens.shape[1], tokens.shape[1])]
    aux = x.new_zeros(())
    for i in range(a.n_layers):
        if remat:
            x, a_i = checkpoint(block, a, w, i, x, pattern, segments, prec,
                                use_reentrant=False)
        else:
            x, a_i = block(a, w, i, x, pattern, segments, prec)
        aux = aux + a_i
    return rms_norm(x, w["final_norm.scale"], a.norm_eps), aux


def loss(a: Arch, w: Weights, tokens, targets, pattern=None,
         prec: str = "fp32") -> torch.Tensor:
    """Mean next-token cross entropy over every position (the padded
    vocabulary's logits included, as the model computes them), plus
    0.01 times the MoE's load-balance loss."""
    h, aux = hidden(a, w, tokens, pattern, prec=prec, remat=True)
    logits = mm(h, head_table(a, w).T, prec)
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, targets[..., None])[..., 0]
    return nll.mean() + 0.01 * aux


@torch.no_grad()
def served_logits(a: Arch, w: Weights, prompt: torch.Tensor,
                  served: torch.Tensor, chunks: List[int], pattern=None,
                  prec: str = "fp32") -> torch.Tensor:
    """The logits (len(served), padded vocab) that predict each served
    token of one request: the prompt (1-D) prefilled in ``chunks`` (bucket
    widths; the MoE's capacity segments), then the served tokens but the
    last, each its own segment of one token."""
    n_p = prompt.numel()
    seq = torch.cat([prompt, served[:-1]])[None]
    segments, done = [], 0
    for c in chunks:
        segments.append((done, min(c, n_p - done), c))
        done += c
    segments += [(n_p + j, 1, 1) for j in range(served.numel() - 1)]
    h, _ = hidden(a, w, seq, pattern, segments, prec)
    return mm(h[0, n_p - 1:], head_table(a, w).T, prec)
