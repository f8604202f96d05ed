"""Core neural layers in torch (the port of ``repro.models.layers``).

Plain tensor functions mirror the jnp ones one for one; small
``nn.Module``s hold the parameters under the same names as the JAX param
dicts (``w``, ``b``, ``scale``, ``table``), so a JAX checkpoint maps onto
them key for key.  Activations run in the model dtype (bf16 for serving)
with fp32 norms, softmax and attention accumulation, as in ``repro``.

Unlike JAX, the KV cache is updated in place: :func:`kv_cache_write` writes
into the cache tensors it is given, which saves a copy of the whole cache
per step.  An int8 KV cache (``kv_cache_dtype="int8"``) stores keys and
values with symmetric per-position, per-head fp32 scales, and attention
factors the scales out of both products (:func:`_direct_attention_q8`), as
``repro`` does.  Local attention (the hybrid family) decodes over a ring
buffer of ``window`` slots (:func:`ring_cache_write`,
:func:`ring_decode_attention`), and without a cache runs on the
``flash_attention`` kernel through :func:`repro_torch.kernels.ops.flash_mha`
(the ``"reference"`` backend keeps ``repro``'s :func:`chunked_attention`),
which records gradients through the kernel's backward pass.
``repro``'s sharding hints (``act_constrain``) become computed tensor
parallelism on the mesh's ``model`` axis
(:mod:`repro_torch.sharding.tensor_parallel`): ``tensor_parallel_(tp)``
turns :class:`Attention` (this rank's query heads and the KV heads they
read; ``wq``/``wk``/``wv`` column-parallel, ``wo`` row-parallel),
:class:`SwiGLU` (``gate``/``up`` column-, ``down`` row-parallel) and
:class:`Embedding` (vocab-parallel lookup and head; the logits stay split
over the vocabulary) into modules over local shards with explicit
collectives.  A module left as built (one rank, or a module outside that
list) computes on full tensors.  Under sequence parallelism (``seq=``, the
model's ``model`` axis when ``cfg.seq_shard`` splits the residual stream's
T) each module's forward takes and returns this rank's rows of T
(:func:`~repro_torch.sharding.tensor_parallel.seq_enter` /
``seq_exit``).  On a split model an attention decodes over a KV cache
split on time over the ranks that hold its KV heads (``kv_shard=``, the
model's KV group): each rank writes and attends over its positions (its
ring slots, for local attention), and the softmax's max and sum and the
P·V products are reduced over the group.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.api.backends import default_backend
from repro_torch.kernels.ops import flash_mha
from repro_torch.sharding.tensor_parallel import (NO_TP, TP,
                                                  TensorParallelError,
                                                  all_reduce, copy_in, gather,
                                                  gather_full, local,
                                                  reduce_stat,
                                                  seq_enter, seq_exit,
                                                  vocab_embed)

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
    """``x @ w (+ b)``.  After :meth:`tensor_parallel_` ``w`` is this
    rank's columns (``"col"``: the output split over ``model``; a bias is
    kept whole and sliced in the forward) or rows (``"row"``: a partial
    sum the caller reduces)."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 device=None):
        super().__init__()
        self.d_in = d_in
        self.w = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.b = (nn.Parameter(torch.empty(d_out, device=device))
                  if bias else None)
        self.tp, self.split = NO_TP, None
        #: ``{param name: (its dim local on model, its full shape)}``
        self.tp_local: dict = {}

    def tensor_parallel_(self, tp: TP, split: str) -> None:
        """Keep this rank's slice of ``w``: its columns (``"col"``) or
        rows (``"row"``)."""
        if not tp.on:
            return
        if split == "row" and self.b is not None:
            raise TensorParallelError("a row-parallel Dense has no bias")
        dim = 1 if split == "col" else 0
        shape = tuple(self.w.shape)
        self.w = nn.Parameter(local(self.w.detach(), dim, tp).clone())
        self.tp, self.split = tp, split
        self.tp_local = {"w": (dim, shape)}

    def init_(self, gen: torch.Generator) -> None:
        if self.tp_local:          # the full draw, then this rank's slice
            dim, shape = self.tp_local["w"]
            full = torch.empty(shape, device=self.w.device)
            full.normal_(generator=gen).mul_(1.0 / math.sqrt(self.d_in))
            self.w.copy_(local(full, dim, self.tp))
        else:
            self.w.normal_(generator=gen).mul_(1.0 / math.sqrt(self.d_in))
        if self.b is not None:
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.b
        if b is not None and self.split == "col":     # this rank's outputs'
            b = local(copy_in(b, self.tp), 0, self.tp)
        return dense_apply(self.w, x, b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6, tp: TP = NO_TP) -> torch.Tensor:
    """``tp``: the last axis of ``x`` (and ``scale``) is this rank's share
    of the channels; their sum of squares is summed over ``model``
    (:func:`~repro_torch.sharding.tensor_parallel.reduce_stat`) and
    divided by the full width."""
    xf = x.float()
    var = reduce_stat((xf * xf).sum(dim=-1, keepdim=True),
                      tp) / (xf.shape[-1] * tp.size)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))

    def init_(self, gen: torch.Generator) -> None:
        self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor, eps: float = 1e-6,
                seq: TP = NO_TP, tp: TP = NO_TP) -> torch.Tensor:
        """``seq``: ``x`` holds this rank's rows of T, so the scale's
        gradient is summed over the ranks.  ``tp``: ``x`` holds this
        rank's share of the channels (RWKV-6's ``ln_x`` over heads split
        on ``model``): the scale is read as its slice, its gradient summed
        over the ranks, and the mean square is taken over every rank's
        channels."""
        if tp.on:
            return rmsnorm(x, local(copy_in(self.scale, tp), 0, tp), eps, tp)
        return rmsnorm(x, copy_in(self.scale, seq), eps)


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
    if isinstance(v, int):
        return torch.full((b,), v, dtype=torch.long, device=device)
    return torch.as_tensor(v, device=device).long().expand(b)


def chunked_attention(q, k, v, *, causal=True, window=None, q_offset: Pos = 0,
                      kv_len: Optional[Pos] = None, chunk=1024,
                      shard: TP = NO_TP):
    """q: (B, Tq, H, D); k/v: (B, Tk, Hkv, D) → (B, Tq, H, D).

    Online softmax over KV chunks, fp32 accumulation.  ``q_offset`` is the
    absolute position of q[0] and ``kv_len`` masks padded keys; both take a
    shared scalar or a per-row ``(B,)`` vector.  ``shard``: k/v are this
    rank's positions ``[rank·Tk, (rank+1)·Tk)`` of a cache split on time;
    the ranks' running max, sum and products are combined over its ranks.
    """
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    dev = q.device
    k0 = shard.rank * tk
    kv_len = _per_row(k0 + tk if kv_len is None else kv_len, b, dev)
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
        k_pos = k0 + c0 + torch.arange(width, device=dev)
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
    if shard.on:
        # a shard with no live key for a row holds m = -1e30: its terms
        # scale by exp(-1e30 - max) = 0
        m_all = all_reduce(m, shard, "max")
        alpha = torch.exp(m - m_all)
        l = all_reduce(l * alpha, shard)
        acc = all_reduce(acc * alpha[..., None], shard)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _decode_mask(b, tq, tk, *, q_offset: Pos, kv_len: Pos, causal, window,
                 device, k_offset: int = 0):
    """(B, Tq, Tk) validity mask; ``q_offset``/``kv_len`` may be shared
    scalars or per-row ``(B,)`` vectors; ``k_offset``: the absolute
    position of the first key (a shard of a cache split on time)."""
    q_pos = (_per_row(q_offset, b, device)[:, None]
             + torch.arange(tq, device=device))
    k_pos = k_offset + torch.arange(tk, device=device)
    mask = k_pos[None, None, :] < _per_row(kv_len, b, device)[:, None, None]
    if causal:
        mask = mask & (k_pos[None, None, :] <= q_pos[..., None])
    if window is not None:
        mask = mask & (k_pos[None, None, :] > q_pos[..., None] - window)
    return mask


def _softmax(s: torch.Tensor, shard: TP) -> torch.Tensor:
    """Softmax over the last axis; with ``shard`` on, over every rank's
    keys: the max and the sum of ``exp`` all-reduced over its ranks, as
    ``repro``'s compiled softmax reduces scores sharded on T
    (``act_constrain(s, "scores_t")``).  A rank whose keys a row masks
    (-1e30) adds ``exp(-1e30 - max)`` = 0."""
    if not shard.on:
        return torch.softmax(s, dim=-1)
    m = all_reduce(s.amax(dim=-1, keepdim=True), shard, "max")
    e = torch.exp(s - m)
    return e / all_reduce(e.sum(dim=-1, keepdim=True), shard)


def _direct_attention(q, k, v, *, q_offset: Pos, kv_len: Pos, causal,
                      window, shard: TP = NO_TP):
    """Unchunked masked attention (decode path, Tq ≤ 8).  Products of the
    cache-dtype operands are summed in fp32, as JAX's
    ``preferred_element_type=float32`` does.  ``shard``: k/v are this
    rank's positions of a cache split on time (:func:`_softmax`; the P·V
    products summed over its ranks)."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(k.dtype).float(),
                     k.float()) / math.sqrt(d)
    mask = _decode_mask(b, tq, tk, q_offset=q_offset, kv_len=kv_len,
                        causal=causal, window=window, device=q.device,
                        k_offset=shard.rank * tk)
    s = torch.where(mask[:, None], s, -1e30)
    p = _softmax(s, shard)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return all_reduce(out, shard).to(q.dtype)


def _direct_attention_q8(q, kq, ks, vq, vs, *, q_offset: Pos, kv_len: Pos,
                         causal, window, shard: TP = NO_TP):
    """Decode attention over an int8 KV cache with factored scales.

    q: (B, t, H, D); kq/vq: (B, T, Hkv, D) int8; ks/vs: (B, T, Hkv) fp32.
    ``s = (q·kqᵀ) ⊙ ks`` and ``out = (p ⊙ vs)·vq``: the int8 values feed the
    products as bf16 (exact) with fp32 sums, as ``repro``'s bf16 einsums
    with ``preferred_element_type=float32`` do; no dequantized copy of the
    cache is made.  ``shard`` as in :func:`_direct_attention`."""
    b, tq, h, d = q.shape
    tk, hkv = kq.shape[1], kq.shape[2]
    rep = h // hkv
    if rep > 1:
        kq = kq.repeat_interleave(rep, dim=2)
        vq = vq.repeat_interleave(rep, dim=2)
        ks = ks.repeat_interleave(rep, dim=2)
        vs = vs.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.bfloat16().float(),
                     kq.float()) / math.sqrt(d)
    s = s * ks.permute(0, 2, 1)[:, :, None, :]       # column-wise dequant
    mask = _decode_mask(b, tq, tk, q_offset=q_offset, kv_len=kv_len,
                        causal=causal, window=window, device=q.device,
                        k_offset=shard.rank * tk)
    s = torch.where(mask[:, None], s, -1e30)
    p = _softmax(s, shard)
    p = p * vs.permute(0, 2, 1)[:, :, None, :]        # v scales folded into p
    out = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), vq.float())
    return all_reduce(out, shard).to(q.dtype)


def _quantize_kv(x: torch.Tensor):
    """Symmetric int8 quantization over the last axis (head_dim): returns
    the int8 values and the fp32 scales (absmax / 127, at least 1e-8)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def ring_decode_attention(q, ck, cv, k_pos, pos, window, shard: TP = NO_TP):
    """Attention over a ring-buffer KV cache.

    q: (B, Tq, H, D); ck/cv: (B, W, Hkv, D); k_pos: (B, W) absolute position
    held by each ring slot (per row: continuous batching); pos: (B,)
    absolute position of q[:, 0].  Each query attends only to the slots in
    its own (q_pos - window, q_pos]: causal within a multi-token write, and
    slots that still hold an earlier occupant's keys (ahead of this row's
    timeline, or negative) are masked out.  ``shard``: ck/cv/k_pos are this
    rank's slots of a ring split over its ranks (:func:`ring_cache_write`):
    the softmax's max and sum and the P·V products are reduced over them
    (:func:`_softmax`); a rank with no valid slot for a row adds 0."""
    b, tq, h, d = q.shape
    rep = h // ck.shape[2]
    if rep > 1:
        ck = ck.repeat_interleave(rep, dim=2)
        cv = cv.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ck.float()) / math.sqrt(d)
    q_pos = pos[:, None] + torch.arange(tq, device=q.device)      # (B, Tq)
    kp, qp = k_pos[:, None, :], q_pos[..., None]
    valid = (kp <= qp) & (kp > qp - window) & (kp >= 0)            # (B, Tq, W)
    s = torch.where(valid[:, None], s, -1e30)
    p = _softmax(s, shard)
    out = torch.einsum("bhqk,bkhd->bqhd", p, cv.float())
    return all_reduce(out, shard).to(q.dtype)


def ring_cache_write(ck: torch.Tensor, cv: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, pos: Pos,
                     shard: TP = NO_TP) -> torch.Tensor:
    """Scatter each of the t new keys and values (B, t, Hkv, D) into ring
    slot ``(pos + i) mod W`` of ``ck``/``cv`` (B, W, Hkv, D), in place, with
    per-row positions and writes that wrap around the ring.  Returns k_pos
    (B, W): the absolute position each slot holds after the write.

    ``shard``: ``ck``/``cv`` (B, W / g, Hkv, D) are rank r's slots
    ``[r·W/g, (r+1)·W/g)`` of a ring of W split over g ranks; of the new
    keys (at most W) only those whose slot it owns are written, and k_pos
    covers its slots."""
    b, t = k.shape[:2]
    wl = ck.shape[1]
    w = wl * shard.size
    dev = ck.device
    pos_v = _per_row(pos, b, dev)
    slots = shard.rank * wl + torch.arange(wl, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    if not shard.on:
        slot = (pos_v[:, None] + torch.arange(t, device=dev)) % w
        ck[rows, slot] = k.to(ck.dtype)
        cv[rows, slot] = v.to(cv.dtype)
    else:
        if t > w:
            raise ValueError(f"a ring of {w} slots takes at most {w} new "
                             f"keys a call, got {t}")
        # the new key (if any) each owned slot takes: key i lands on slot
        # (pos + i) mod W, at most one a slot; a gather, not a scatter,
        # so that keys outside this rank's slots write nothing
        i = (slots[None, :] - pos_v[:, None]) % w                 # (B, W/g)
        new = (i < t)[..., None, None]
        i = i.clamp_max(t - 1)
        ck.copy_(torch.where(new, k.to(ck.dtype)[rows, i], ck))
        cv.copy_(torch.where(new, v.to(cv.dtype)[rows, i], cv))
    last = (pos_v + (t - 1))[:, None]
    return last - (last - slots) % w


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


def kv_cache_shard_write(buf: torch.Tensor, new: torch.Tensor, pos: Pos,
                         start: int) -> None:
    """:func:`kv_cache_write` into a shard of a cache split on time:
    ``buf`` (B, L, …) holds positions ``[start, start + L)``, and of the
    new tokens at ``pos`` (shared or per-row) only those in that range are
    written, in place; a chunk may straddle the shard's edges."""
    t, span = new.shape[1], buf.shape[1]
    if isinstance(pos, int) or pos.ndim == 0:
        p = int(pos) - start
        lo, hi = max(p, 0), min(p + t, span)
        if lo < hi:
            buf[:, lo:hi] = new[:, lo - p:hi - p]
        return
    if t > span:                 # pieces of at most L tokens
        for i in range(0, t, span):
            kv_cache_shard_write(buf, new[:, i:i + span], pos + i, start)
        return
    dev = buf.device
    rows = torch.arange(buf.shape[0], device=dev)[:, None]
    cols = pos.long()[:, None] - start + torch.arange(t, device=dev)
    inside = ((cols >= 0) & (cols < span)).reshape(
        *cols.shape, *(1,) * (new.ndim - 2))
    # t <= L consecutive positions fall on distinct slots mod L: a token
    # outside the shard rewrites its slot's own value
    cols = cols % span
    buf[rows, cols] = torch.where(inside, new, buf[rows, cols])


class Attention(nn.Module):
    """GQA self-attention with RoPE and an optional in-place KV cache;
    bidirectional (``causal=False``) or cross attention (``kv_ctx``).

    After :meth:`tensor_parallel_` it runs this rank's ``n_heads / tp``
    query heads against the KV heads they read (``kv_span``, global
    indices): ``wq`` column-parallel, ``wo`` row-parallel then all-reduced;
    ``wk``/``wv`` column-parallel when the KV heads split over the ranks,
    else gathered along ``model`` in the forward (their stored shard may be
    part of a head) and sliced to ``kv_span``, their gradient summed back
    by the gather's reduce-scatter.  ``n_heads``/``n_kv`` are then the
    local counts, which a KV cache holds."""

    def __init__(self, d_model, n_heads, n_kv, head_dim, *, qkv_bias=False,
                 device=None):
        super().__init__()
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, head_dim
        self.wq = Dense(d_model, n_heads * head_dim, bias=qkv_bias,
                        device=device)
        self.wk = Dense(d_model, n_kv * head_dim, bias=qkv_bias, device=device)
        self.wv = Dense(d_model, n_kv * head_dim, bias=qkv_bias, device=device)
        self.wo = Dense(n_heads * head_dim, d_model, device=device)
        self.tp = NO_TP
        self.kv_span = (0, n_kv)
        self.kv_gather = False

    def tensor_parallel_(self, tp: TP) -> None:
        """Keep this rank's heads (see the class docstring); raises
        :class:`TensorParallelError` when the query heads do not split over
        the ranks or a rank's heads would read KV heads in unequal
        groups."""
        if not tp.on:
            return
        h, kv, hd = self.n_heads, self.n_kv, self.head_dim
        if h % tp.size:
            raise TensorParallelError(
                f"{h} query heads do not split over {tp.size} model ranks")
        rep, mine = h // kv, h // tp.size
        if mine % rep and rep % mine:
            raise TensorParallelError(
                f"{mine} query heads a rank read KV groups of {rep} "
                f"unevenly")
        lo, hi = tp.span(h)
        self.kv_span = (lo // rep, (hi - 1) // rep + 1)
        self.kv_gather = kv % tp.size != 0
        self.wq.tensor_parallel_(tp, "col")
        self.wo.tensor_parallel_(tp, "row")
        for w in (self.wk, self.wv):
            # stored as the rules shard it, where model divides it
            if (kv * hd) % tp.size == 0:
                w.tensor_parallel_(tp, "col")
        self.tp = tp
        self.n_heads, self.n_kv = mine, self.kv_span[1] - self.kv_span[0]

    def _kv(self, dense: Dense, src: torch.Tensor) -> torch.Tensor:
        """``src`` through ``wk`` or ``wv``: the columns of ``kv_span``."""
        if not self.kv_gather:
            return dense(src)
        tp, hd = self.tp, self.head_dim
        lo, hi = self.kv_span[0] * hd, self.kv_span[1] * hd
        w = (gather(dense.w, 1, tp, grad="sum") if dense.tp_local
             else copy_in(dense.w, tp))
        b = None if dense.b is None else copy_in(dense.b, tp)[lo:hi]
        return dense_apply(w[:, lo:hi], src, b)

    def forward(self, x, *, positions, rope_theta=10000.0, cache=None,
                cache_pos: Pos = 0, chunk=1024, window=None, ring=False,
                causal=True, kv_ctx: Optional[torch.Tensor] = None,
                seq: TP = NO_TP, kv_shard: TP = NO_TP):
        """``cache``: optional dict of ``k``/``v`` (B, T_max, n_kv, hd),
        written in place at ``cache_pos`` (shared scalar or per-row
        ``(B,)``); the queries then attend over the whole cache, masked to
        each row's own valid length.  An int8 cache also holds ``k_s``/
        ``v_s`` (B, T_max, n_kv) scales and takes at most 8 queries at a
        time.  ``ring``: the cache is a ring of W slots (local attention;
        at most W new tokens a call).  Without a cache: attention over
        ``x`` (causal unless ``causal=False``), within ``window`` when it is
        given (then on the ``flash_attention`` kernel, except on the
        ``"reference"`` backend).  ``kv_ctx`` (B, Tk, D): cross attention,
        keys and values projected from it, no rope and no mask.

        ``seq``: ``x`` and the output are this rank's rows of T (sequence
        parallelism; ``positions`` cover the whole sequence).
        ``kv_shard``: the cache holds this rank's positions ``[rank·L,
        (rank+1)·L)`` of a timeline split over ``kv_shard``'s ranks (those
        that hold these KV heads), or for a ring its slots ``[rank·W/g,
        (rank+1)·W/g)`` of W: the new keys land on the ranks that hold
        their positions (slots) and the attention is reduced over the
        ranks.  Where those ranks run different query heads (an attention
        split by heads with fewer KV heads than ranks), each attends with
        all of the group's queries (gathered) over its share and keeps its
        own heads of the reduced output."""
        x = seq_enter(x, self.tp, seq)
        b, t, _ = x.shape
        src = x if kv_ctx is None else copy_in(kv_ctx, self.tp)
        q = self.wq(x).reshape(b, t, self.n_heads, self.head_dim)
        k = self._kv(self.wk, src).reshape(b, src.shape[1], self.n_kv,
                                           self.head_dim)
        v = self._kv(self.wv, src).reshape(b, src.shape[1], self.n_kv,
                                           self.head_dim)
        if kv_ctx is None and rope_theta:
            q = rope(q, positions, rope_theta)
            k = rope(k, positions, rope_theta)
        grouped = cache is not None and kv_shard.on and self.tp.on
        if grouped:
            q = gather_full(q, 2, kv_shard)
        if cache is not None and ring:
            k_pos = ring_cache_write(cache["k"], cache["v"], k, v, cache_pos,
                                     kv_shard)
            w = cache["k"].shape[1] * kv_shard.size
            out = ring_decode_attention(
                q, cache["k"], cache["v"], k_pos,
                _per_row(cache_pos, b, x.device), window or w,
                shard=kv_shard)
        elif cache is not None and "k_s" in cache:
            if t > 8:
                # a named error, not an assert (asserts vanish under -O)
                raise ValueError(
                    f"int8 KV cache path supports decode-sized queries "
                    f"(t <= 8), got t={t}; chunk the prefill (Engine does "
                    f"this via prefill_buckets) or use the bf16 cache for "
                    f"long queries")
            write = self._writer(cache["k"], kv_shard)
            for name, val in (("k", k), ("v", v)):
                qv, scale = _quantize_kv(val)
                write(cache[name], qv, cache_pos)
                write(cache[name + "_s"], scale, cache_pos)
            out = _direct_attention_q8(
                q, cache["k"], cache["k_s"], cache["v"], cache["v_s"],
                q_offset=cache_pos, kv_len=cache_pos + t, causal=causal,
                window=window, shard=kv_shard)
        elif cache is not None:
            ck, cv = cache["k"], cache["v"]
            write = self._writer(ck, kv_shard)
            write(ck, k.to(ck.dtype), cache_pos)
            write(cv, v.to(cv.dtype), cache_pos)
            kv_len = cache_pos + t
            if t <= 8:
                out = _direct_attention(q, ck, cv, q_offset=cache_pos,
                                        kv_len=kv_len, causal=causal,
                                        window=window, shard=kv_shard)
            else:
                out = chunked_attention(q, ck, cv, causal=causal,
                                        window=window,
                                        q_offset=cache_pos, kv_len=kv_len,
                                        chunk=chunk, shard=kv_shard)
        elif window is not None and default_backend() != "reference":
            out = flash_mha(q, k, v, causal=True, window=window)
        else:
            out = chunked_attention(q, k, v,
                                    causal=causal and kv_ctx is None,
                                    window=window, q_offset=0, chunk=chunk)
        if grouped:
            out = local(out, 2, kv_shard)
        return seq_exit(
            self.wo(out.reshape(b, t, self.n_heads * self.head_dim)),
            self.tp, seq)

    @staticmethod
    def _writer(buf: torch.Tensor, kv_shard: TP):
        """The cache write: whole, or into this rank's time shard."""
        if not kv_shard.on:
            return kv_cache_write
        start = kv_shard.rank * buf.shape[1]
        return lambda b, new, pos: kv_cache_shard_write(b, new, pos, start)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is the erf form)."""
    return F.gelu(x, approximate="tanh")


class SwiGLU(nn.Module):
    """Dense SwiGLU MLP (``ffn_block_sparse=False``); after
    :meth:`tensor_parallel_` over this rank's ``d_ff / tp`` hidden units."""

    def __init__(self, d_model, d_ff, *, device=None):
        super().__init__()
        self.up = Dense(d_model, d_ff, device=device)
        self.gate = Dense(d_model, d_ff, device=device)
        self.down = Dense(d_ff, d_model, device=device)
        self.tp = NO_TP

    def tensor_parallel_(self, tp: TP) -> None:
        """``gate``/``up`` column-parallel, ``down`` row-parallel."""
        if not tp.on:
            return
        tp.span(self.down.d_in)             # raises unless d_ff splits
        self.up.tensor_parallel_(tp, "col")
        self.gate.tensor_parallel_(tp, "col")
        self.down.tensor_parallel_(tp, "row")
        self.tp = tp

    def forward(self, x, seq: TP = NO_TP):
        """``seq``: ``x`` and the output are this rank's rows of T."""
        x = seq_enter(x, self.tp, seq)
        return seq_exit(self.down(F.silu(self.gate(x)) * self.up(x)),
                        self.tp, seq)


class Embedding(nn.Module):
    """Token table ``(vocab, d)``; also the tied or untied LM head.  After
    :meth:`tensor_parallel_` the table is this rank's ``vocab / tp`` rows:
    the lookup sums the ranks' rows, the head gives this rank's logits."""

    def __init__(self, vocab, d_model, *, device=None):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d_model, device=device))
        self.tp = NO_TP
        self.tp_local: dict = {}

    def tensor_parallel_(self, tp: TP) -> None:
        if not tp.on:
            return
        shape = tuple(self.table.shape)
        self.table = nn.Parameter(local(self.table.detach(), 0, tp).clone())
        self.tp = tp
        self.tp_local = {"table": (0, shape)}

    def init_(self, gen: torch.Generator) -> None:
        if self.tp_local:          # the full draw, then this rank's rows
            full = torch.empty(self.tp_local["table"][1],
                               device=self.table.device)
            full.normal_(generator=gen).mul_(0.02)
            self.table.copy_(local(full, 0, self.tp))
        else:
            self.table.normal_(generator=gen).mul_(0.02)

    def forward(self, tokens, seq: TP = NO_TP):
        """``seq``: this rank's rows of T (B, T / tp, D): the split
        lookup's sum reduce-scattered along T, or a whole table's rows of
        this rank's tokens (its gradient summed over the ranks)."""
        if not seq.on:
            return vocab_embed(self.table, tokens, self.tp)
        if self.tp.on:
            return vocab_embed(self.table, tokens, self.tp, seq=True)
        return copy_in(self.table, seq)[local(tokens, 1, seq)]

    def head(self, x: torch.Tensor, seq: TP = NO_TP) -> torch.Tensor:
        """x (B, T, D) → this rank's logits (B, T, vocab / tp); ``seq``:
        ``x`` is this rank's rows of T, all-gathered first."""
        return lm_head_apply(self.table, seq_enter(x, self.tp, seq))


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
