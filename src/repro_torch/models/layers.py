"""Core neural layers in torch (the parts of ``repro.models.layers`` that
the dense decoder family serves with).

Plain tensor functions mirror the jnp ones one for one; small
``nn.Module``s hold the parameters under the same names as the JAX param
dicts (``w``, ``b``, ``scale``, ``table``), so a JAX checkpoint maps onto
them key for key.  Activations run in the model dtype (bf16 for serving)
with fp32 norms, softmax and attention accumulation, as in ``repro``.

Unlike JAX, the KV cache is updated in place: :func:`kv_cache_write` writes
into the cache tensors it is given, which saves a copy of the whole cache
per step.  The sharding hints of ``repro`` (``act_constrain``) have no
meaning on one device and are dropped.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

Pos = Union[int, torch.Tensor]


def dense_apply(w: torch.Tensor, x: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w`` with the weight cast to the activation dtype (as
    ``repro.models.layers.dense_apply`` does)."""
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 device=None):
        super().__init__()
        self.d_in = d_in
        self.w = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.b = (nn.Parameter(torch.empty(d_out, device=device))
                  if bias else None)

    def init_(self, gen: torch.Generator) -> None:
        self.w.normal_(generator=gen).mul_(1.0 / math.sqrt(self.d_in))
        if self.b is not None:
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_apply(self.w, x, self.b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))

    def init_(self, gen: torch.Generator) -> None:
        self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        return rmsnorm(x, self.scale, eps)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (..., T, H, D) rotated along D with positions (..., T)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs          # (..., T, half)
    cos = torch.cos(angles)[..., None, :]                  # (..., T, 1, half)
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def _per_row(v: Pos, b: int, device) -> torch.Tensor:
    """A shared scalar or a per-row ``(B,)`` vector, as ``(B,)`` int64."""
    return torch.as_tensor(v, device=device).long().expand(b)


def chunked_attention(q, k, v, *, causal=True, window=None, q_offset: Pos = 0,
                      kv_len: Optional[Pos] = None, chunk=1024):
    """q: (B, Tq, H, D); k/v: (B, Tk, Hkv, D) → (B, Tq, H, D).

    Online softmax over KV chunks, fp32 accumulation.  ``q_offset`` is the
    absolute position of q[0] and ``kv_len`` masks padded keys; both take a
    shared scalar or a per-row ``(B,)`` vector.
    """
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    dev = q.device
    kv_len = _per_row(tk if kv_len is None else kv_len, b, dev)
    chunk = min(chunk, tk)
    qf = q.float() * (1.0 / math.sqrt(d))
    q_pos = _per_row(q_offset, b, dev)[:, None] + torch.arange(tq, device=dev)
    m = torch.full((b, h, tq), -1e30, device=dev)
    l = torch.zeros((b, h, tq), device=dev)
    acc = torch.zeros((b, h, tq, d), device=dev)
    for c0 in range(0, tk, chunk):
        k_c, v_c = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        width = k_c.shape[1]
        if rep > 1:
            k_c = k_c.repeat_interleave(rep, dim=2)
            v_c = v_c.repeat_interleave(rep, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_c.float())
        k_pos = c0 + torch.arange(width, device=dev)
        mask = k_pos[None, None, :] < kv_len[:, None, None]   # (B, 1, C)
        if causal:
            mask = mask & (k_pos[None, None, :] <= q_pos[..., None])
        if window is not None:
            mask = mask & (k_pos[None, None, :] > q_pos[..., None] - window)
        s = torch.where(mask[:, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                    v_c.float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _decode_mask(b, tq, tk, *, q_offset: Pos, kv_len: Pos, causal, window,
                 device):
    """(B, Tq, Tk) validity mask; ``q_offset``/``kv_len`` may be shared
    scalars or per-row ``(B,)`` vectors."""
    q_pos = (_per_row(q_offset, b, device)[:, None]
             + torch.arange(tq, device=device))
    k_pos = torch.arange(tk, device=device)
    mask = k_pos[None, None, :] < _per_row(kv_len, b, device)[:, None, None]
    if causal:
        mask = mask & (k_pos[None, None, :] <= q_pos[..., None])
    if window is not None:
        mask = mask & (k_pos[None, None, :] > q_pos[..., None] - window)
    return mask


def _direct_attention(q, k, v, *, q_offset: Pos, kv_len: Pos, causal,
                      window):
    """Unchunked masked attention (decode path, Tq ≤ 8).  Products of the
    cache-dtype operands are summed in fp32, as JAX's
    ``preferred_element_type=float32`` does."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(k.dtype).float(),
                     k.float()) / math.sqrt(d)
    mask = _decode_mask(b, tq, tk, q_offset=q_offset, kv_len=kv_len,
                        causal=causal, window=window, device=q.device)
    s = torch.where(mask[:, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def kv_cache_write(buf: torch.Tensor, new: torch.Tensor, pos: Pos) -> None:
    """Write ``new`` (B, t, …) into ``buf`` (B, T, …) in place at time
    offset ``pos``: a shared scalar or a per-row ``(B,)`` vector."""
    t = new.shape[1]
    if isinstance(pos, int) or pos.ndim == 0:
        p = int(pos)
        buf[:, p:p + t] = new
        return
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    cols = pos.long()[:, None] + torch.arange(t, device=buf.device)
    buf[rows, cols] = new


class Attention(nn.Module):
    """GQA self-attention with RoPE and an optional in-place KV cache."""

    def __init__(self, d_model, n_heads, n_kv, head_dim, *, qkv_bias=False,
                 device=None):
        super().__init__()
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, head_dim
        self.wq = Dense(d_model, n_heads * head_dim, bias=qkv_bias,
                        device=device)
        self.wk = Dense(d_model, n_kv * head_dim, bias=qkv_bias, device=device)
        self.wv = Dense(d_model, n_kv * head_dim, bias=qkv_bias, device=device)
        self.wo = Dense(n_heads * head_dim, d_model, device=device)

    def forward(self, x, *, positions, rope_theta=10000.0, cache=None,
                cache_pos: Pos = 0, chunk=1024, window=None):
        """``cache``: optional ``(k, v)`` of (B, T_max, n_kv, hd), written in
        place at ``cache_pos`` (shared scalar or per-row ``(B,)``); the
        queries then attend over the whole cache, masked to each row's own
        valid length.  Without a cache: causal attention over ``x``."""
        b, t, _ = x.shape
        q = self.wq(x).reshape(b, t, self.n_heads, self.head_dim)
        k = self.wk(x).reshape(b, t, self.n_kv, self.head_dim)
        v = self.wv(x).reshape(b, t, self.n_kv, self.head_dim)
        if rope_theta:
            q = rope(q, positions, rope_theta)
            k = rope(k, positions, rope_theta)
        if cache is not None:
            ck, cv = cache
            kv_cache_write(ck, k.to(ck.dtype), cache_pos)
            kv_cache_write(cv, v.to(cv.dtype), cache_pos)
            kv_len = cache_pos + t
            if t <= 8:
                out = _direct_attention(q, ck, cv, q_offset=cache_pos,
                                        kv_len=kv_len, causal=True,
                                        window=window)
            else:
                out = chunked_attention(q, ck, cv, causal=True, window=window,
                                        q_offset=cache_pos, kv_len=kv_len,
                                        chunk=chunk)
        else:
            out = chunked_attention(q, k, v, causal=True, window=window,
                                    q_offset=0, chunk=chunk)
        return self.wo(out.reshape(b, t, self.n_heads * self.head_dim))


class SwiGLU(nn.Module):
    """Dense SwiGLU MLP (``ffn_block_sparse=False``)."""

    def __init__(self, d_model, d_ff, *, device=None):
        super().__init__()
        self.up = Dense(d_model, d_ff, device=device)
        self.gate = Dense(d_model, d_ff, device=device)
        self.down = Dense(d_ff, d_model, device=device)

    def forward(self, x):
        return self.down(torch.nn.functional.silu(self.gate(x)) * self.up(x))


class Embedding(nn.Module):
    """Token table ``(vocab, d)``; also the tied or untied LM head."""

    def __init__(self, vocab, d_model, *, device=None):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d_model, device=device))

    def init_(self, gen: torch.Generator) -> None:
        self.table.normal_(generator=gen).mul_(0.02)

    def forward(self, tokens):
        return self.table[tokens]


def lm_head_apply(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied or untied head: x (B,T,D) @ table^T → (B,T,V)."""
    return x @ table.to(x.dtype).T


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL in fp32 (``mask``: optional (B, T) weights; the mean
    is then over their sum, at least 1)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = lse - true_logit
    if mask is not None:
        nll = nll * mask
        return nll.sum() / mask.sum().clamp_min(1)
    return nll.mean()
