"""Public wrappers around the port's kernels (the port of
``repro.kernels.ops``): GQA flash attention, the RG-LRU scan and the MoE
FFN, each on its hand-written Hopper kernel for CUDA tensors and on the
kernel's plain version for CPU tensors.  The shapes, the padding and every
contract (output dtypes, capacity, dropped tokens) are ``repro``'s.
:func:`flash_mha` and :func:`rg_lru_scan` record gradients: their kernels'
autograd Functions run backward kernels of their own, and ``stack_heads``'
pads and reshapes are plain torch under autograd (padded rows and keys
get zero gradient).

:func:`plan_spmm` / :func:`plan_spgemm` remain, as in ``repro``, thin
deprecation shims that delegate to :func:`repro_torch.api.plan_matmul`;
``SpmmPlan``/``SpgemmPlan`` are aliases of :class:`SegmentPlan`.
``repro``'s ``interpret=`` argument and ``INTERPRET`` global have no
counterpart: the tensors' device picks the path.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.api.plan import SegmentPlan
from repro_torch.api.planner import plan_matmul
from repro_torch.core.formats import BSR
from . import ref
from .flash_attention import flash_attention
from .moe_gemm import build_moe_chunks, moe_gemm
from .rg_lru import rg_lru

# Deprecated aliases — both old plan classes are now the one SegmentPlan.
SpmmPlan = SegmentPlan
SpgemmPlan = SegmentPlan


def _deprecated(old: str) -> None:
    warnings.warn(f"repro_torch.kernels.ops.{old} is deprecated; use "
                  f"repro_torch.api.plan_matmul", DeprecationWarning,
                  stacklevel=3)


def plan_spmm(a: BSR, policy: str = "segment", n_cols_hint: int = 1024,
              fold_len: Optional[int] = None, device=None) -> SegmentPlan:
    """Deprecated shim for :func:`repro_torch.api.plan_matmul` (SpMM)."""
    _deprecated("plan_spmm")
    return plan_matmul(a, policy=policy, n_cols_hint=n_cols_hint,
                       fold_len=fold_len, device=device)


def plan_spgemm(a: BSR, b: BSR, policy: str = "segment",
                fold_len: Optional[int] = None, device=None) -> SegmentPlan:
    """Deprecated shim for :func:`repro_torch.api.plan_matmul` (SpGEMM)."""
    _deprecated("plan_spgemm")
    return plan_matmul(a, b, policy=policy, fold_len=fold_len, device=device)


# ---------------------------------------------------------------------------
# Attention / recurrences / MoE
# ---------------------------------------------------------------------------


def stack_heads(q, k, v, *, bq: int = 128, bkv: int = 128):
    """``flash_mha``'s layout for the kernel: ``(qh, kh, vh, kwargs)`` with
    the ``rep = H/Hkv`` query heads of one KV head stacked along the q axis
    (each padded to ``bq_eff`` rows), K/V per KV head padded to ``bkv_eff``
    keys, and the ``flash_attention`` keywords that go with them."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    # pad Tq/Tk (at the end) to block multiples; real queries keep their
    # absolute positions via the explicit offset, padded keys are masked by
    # kv_len, padded query rows are sliced off.
    bq_eff = min(bq, max(8, 1 << max(tq - 1, 0).bit_length()))
    bkv_eff = min(bkv, max(128, 1 << max(tk - 1, 0).bit_length()))
    pad_q = (-tq) % bq_eff
    pad_k = (-tk) % bkv_eff
    tq_pad = tq + pad_q
    kh = k.permute(0, 2, 1, 3).reshape(b * hkv, tk, d)
    vh = v.permute(0, 2, 1, 3).reshape(b * hkv, tk, d)
    if pad_k:
        kh = F.pad(kh, (0, 0, 0, pad_k))
        vh = F.pad(vh, (0, 0, 0, pad_k))
    # (B, Tq, H, D) → (B, Hkv, rep, Tq_pad, D) → (B·Hkv, rep·Tq_pad, D):
    # head h maps to KV head h // rep (jnp.repeat / repeat_interleave)
    qh = q.permute(0, 2, 1, 3).reshape(b, hkv, rep, tq, d)
    if pad_q:
        qh = F.pad(qh, (0, 0, 0, pad_q))
    qh = qh.reshape(b * hkv, rep * tq_pad, d)
    kwargs = dict(offset=tk - tq, kv_len=tk, bq=bq_eff, bkv=bkv_eff,
                  q_period=tq_pad if rep > 1 else None)
    return qh.contiguous(), kh.contiguous(), vh.contiguous(), kwargs


def flash_mha(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              bq: int = 128, bkv: int = 128) -> torch.Tensor:
    """GQA flash attention. q: (B, Tq, H, D), k/v: (B, Tk, Hkv, D); returns
    (B, Tq, H, D) in q's dtype.

    Grouped queries are folded into the q axis — the ``rep = H/Hkv`` query
    heads of one KV head run as ``rep`` stacked ``Tq``-long groups against a
    single K/V copy (``q_period`` position wrap in the kernel), so each K/V
    head is read once instead of ``rep`` times.
    """
    b, tq, h, d = q.shape
    hkv = k.shape[2]
    qh, kh, vh, kw = stack_heads(q, k, v, bq=bq, bkv=bkv)
    out = flash_attention(qh, kh, vh, causal=causal, window=window, **kw)
    tq_pad = qh.shape[1] // (h // hkv)
    out = out.reshape(b, hkv, h // hkv, tq_pad, d)[:, :, :, :tq]
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, h, d)


def rg_lru_scan(x, a_gate, x_gate, a_param, h0=None, *, ct: int = 128):
    """RG-LRU over x/a_gate/x_gate (B, T, D) with a_param (D,) and h0 (B, D)
    (zeros when ``None``).  Returns ``(out in x's dtype, h_T fp32)``."""
    if h0 is None:
        h0 = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32,
                         device=x.device)
    return rg_lru(x, a_gate, x_gate, a_param, h0, ct=min(ct, x.shape[1]))


def moe_apply(x, w_up, w_down, router_logits, *, top_k: int = 1,
              chunk_rows: int = 128, capacity_factor: float = 1.25,
              activation=F.silu) -> torch.Tensor:
    """Full MoE FFN: route → Segment-sort → grouped GEMMs → unsort-combine.

    x: (T, d_model); w_up: (E, d_model, d_ff); w_down: (E, d_ff, d_model).
    Returns (T, d_model) in fp32.  Each expert takes at most ``cap_rows``
    tokens per routing slot (:func:`build_moe_chunks`); the rest are
    dropped for that slot.

    Both grouped GEMMs get each chunk's count of kept tokens as
    ``live_rows``, counted on the device (``scatter_add_``, clamped to
    ``cap_rows``: no host sync), so chunks and halves of chunks that hold
    no token read no weights.  The up GEMM's rows past the counts are zero
    either way; the down GEMM's come out zero instead of ``activation(0) @
    w_down``, and they are never gathered back, so the result is the same.
    """
    t, d_model = x.shape
    n_exp = w_up.shape[0]
    top_vals, top_idx = torch.topk(router_logits, top_k)        # (T, top_k)
    gates = torch.softmax(top_vals, dim=-1)
    out = torch.zeros((t, d_model), dtype=torch.float32, device=x.device)
    for j in range(top_k):
        order, slot, chunk_expert, keep, _, cap_rows = build_moe_chunks(
            top_idx[:, j], n_exp, chunk_rows, capacity_factor)
        cap_total = n_exp * cap_rows
        # kept tokens per expert, then per chunk: expert e's chunks hold
        # rows p * chunk_rows .. of its min(count, cap_rows) tokens
        counts = torch.zeros(n_exp, dtype=torch.int32, device=x.device)
        counts.scatter_add_(0, top_idx[:, j], torch.ones(
            t, dtype=torch.int32, device=x.device))
        start = torch.arange(0, cap_rows, chunk_rows, dtype=torch.int32,
                             device=x.device)
        live = (counts.clamp(max=cap_rows)[:, None] - start).clamp(
            0, chunk_rows).reshape(-1)
        # scatter tokens (sorted by expert) into the padded chunk buffer;
        # dropped tokens land on the trash row which is cut before the GEMM
        buf = torch.zeros((cap_total + 1, d_model), dtype=x.dtype,
                          device=x.device)
        buf[slot] = torch.where(keep[:, None], x[order], 0)
        buf = buf[:-1]
        h = moe_gemm(buf, w_up, chunk_expert, chunk_rows=chunk_rows,
                     live_rows=live)
        h = activation(h).to(x.dtype)
        y = moe_gemm(h, w_down, chunk_expert, chunk_rows=chunk_rows,
                     live_rows=live)
        # gather back: sorted position s ↔ original token order[s]
        vals = torch.where(keep[:, None],
                           y[torch.clamp(slot, max=cap_total - 1)], 0.0)
        y_tok = torch.zeros((t, d_model), dtype=torch.float32,
                            device=x.device)
        y_tok[order] = vals
        out = out + y_tok * gates[:, j][:, None]
    return out


__all__ = [
    "SpmmPlan", "SpgemmPlan", "plan_spmm", "plan_spgemm", "stack_heads",
    "flash_mha", "rg_lru_scan", "moe_apply", "ref",
]
