"""Fused attention with an online softmax (flash attention): causal,
local-window and ``kv_len`` masks, fully masked KV tiles skipped, grouped
queries through the ``q_period`` position wrap.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention`` with a
CUDA kernel written for Hopper, ``src/repro_torch/csrc/flash_attention.cu``;
the design and its bound are noted at the top of that source.
:func:`flash_attention` launches the kernel for CUDA tensors and runs
:func:`flash_attention_plain` for CPU tensors.  Both keep ``repro``'s
masking exactly: a masked key of a live ``(bq, bkv)`` tile scores the
finite ``-1e30``, a key of a dead tile takes no part, so even a row with no
unmasked key gives ``repro``'s answer.  The arguments are checked, and
``repro``'s ``ValueError``s raised, on every device.

Layout: q (BH, Tq, D), k/v (BH, Tk, D); GQA head grouping is resolved in
:func:`repro_torch.kernels.ops.flash_mha`.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build

_SOURCE = "flash_attention.cu"
_DTYPES = (torch.float32, torch.bfloat16)
_MASKED = -1e30          # repro's finite "minus infinity"
#: score elements per chunk of rows in the plain version (bounds its
#: transients: the scores, the masks and the weights of one chunk)
PLAIN_CHUNK = 1 << 27


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention.argtypes = (
            [p] * 4 + [i] * 4 + [ctypes.c_float, i, i, ll, ll] + [i] * 6
            + [p])
        lib.flash_attention.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _tile_masks(tq, tk, *, causal, window, offset, kv_len, bq, bkv,
                period, rows, device):
    """For query rows ``rows`` of the stacked q axis: ``live`` (the key's
    TPU kv tile is live for the row's TPU q tile) and ``mask`` (the key is
    unmasked for the row), both (len(rows), tk) bool."""
    pos = offset + rows % period
    q_lo = offset + (rows // bq * bq) % period
    keys = torch.arange(tk, device=device)
    k_lo = keys // bkv * bkv
    live = (k_lo < kv_len)[None, :].expand(rows.shape[0], tk)
    mask = (keys < kv_len)[None, :].expand(rows.shape[0], tk)
    if causal:
        live = live & (k_lo[None, :] <= (q_lo + bq - 1)[:, None])
        mask = mask & (keys[None, :] <= pos[:, None])
    if window is not None:
        live = live & ((k_lo + bkv - 1)[None, :] > (q_lo - window)[:, None])
        mask = mask & (keys[None, :] > (pos - window)[:, None])
    return live, mask


def flash_attention_plain(q, k, v, *, causal: bool, window: Optional[int],
                          offset: int, kv_len: int, bq: int, bkv: int,
                          q_period: Optional[int], out_dtype,
                          chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """The kernel's plain torch version: for a chunk of query rows at a
    time, fp32 scores ``(q · k) * scale``, masked keys of live TPU tiles
    set to ``-1e30`` and keys of dead tiles dropped, one softmax without
    the normalisation, ``P V / max(l, 1e-30)``.  Arguments as resolved by
    :func:`flash_attention`; ``chunk`` (score elements a chunk) sets the
    rows a chunk, so a test can run several chunks at a small size."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    period = tq if q_period is None else q_period
    scale = 1.0 / math.sqrt(d)
    out = torch.empty((bh, tq, d), dtype=out_dtype, device=q.device)
    kf, vf = k.float(), v.float()
    step = max(1, chunk // max(bh * tk, 1))
    for lo in range(0, tq, step):
        rows = torch.arange(lo, min(lo + step, tq), device=q.device)
        live, mask = _tile_masks(tq, tk, causal=causal, window=window,
                                 offset=offset, kv_len=kv_len, bq=bq,
                                 bkv=bkv, period=period, rows=rows,
                                 device=q.device)
        s = torch.einsum("bqd,bkd->bqk", q[:, lo:lo + rows.shape[0]].float(),
                         kf) * scale
        s = torch.where(mask, s, _MASKED)
        s = torch.where(live, s, -math.inf)
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(m == -math.inf, 0.0, m)     # a row with no live key
        pe = torch.exp(s - m)
        den = torch.clamp(pe.sum(dim=-1, keepdim=True), min=1e-30)
        out[:, lo:lo + rows.shape[0]] = torch.bmm(pe, vf) / den
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, offset: Optional[int] = None,
                    kv_len: Optional[int] = None, bq: int = 128,
                    bkv: int = 128, q_period: Optional[int] = None,
                    out_dtype=None) -> torch.Tensor:
    """q: (BH, Tq, D); k/v: (BH, Tk, D). Returns (BH, Tq, D).

    ``offset``: absolute position of q[0] (default Tk - Tq: queries are the
    final positions of the context).  ``kv_len``: number of live keys
    (positions ≥ kv_len are padding and masked out).  ``q_period``: the q
    axis holds several stacked query groups of this length sharing the K/V
    rows (GQA grouping — positions repeat every ``q_period`` rows; must be
    a multiple of ``bq``).  ``bq``/``bkv`` are the TPU kernel's tiles: they
    decide which tiles are skipped, hence the answer for a row whose live
    tiles hold only masked keys.  ``out_dtype`` defaults to q's dtype.
    """
    bh, tq, d = q.shape
    tk = k.shape[1]
    bq = min(bq, tq)
    bkv = min(bkv, tk)
    if tq % bq or tk % bkv:
        raise ValueError(f"Tq={tq}/Tk={tk} must be multiples of the tile "
                         f"sizes bq={bq}/bkv={bkv}")
    if q_period is not None and (q_period % bq or tq % q_period):
        raise ValueError(f"q_period={q_period} must be a multiple of bq={bq} "
                         f"and divide Tq={tq}")
    offset = (tk - (tq if q_period is None else q_period)) \
        if offset is None else offset
    kv_len = tk if kv_len is None else kv_len
    out_dtype = out_dtype or q.dtype
    kw = dict(causal=causal, window=window, offset=offset, kv_len=kv_len,
              bq=bq, bkv=bkv, q_period=q_period, out_dtype=out_dtype)
    device = q.device
    if device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    if device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{device}")
    return _launch(q, k, v, **kw)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _launch(q, k, v, *, causal, window, offset, kv_len, bq, bkv, q_period,
            out_dtype):
    bh, tq, d = q.shape
    tk = k.shape[1]
    device = q.device
    if d % 8 or d > 256:
        raise NotImplementedError(
            f"flash_attention: the CUDA kernel takes head dims that are "
            f"multiples of 8 up to 256, got D={d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(
            f"flash_attention: the CUDA kernel takes q, k and v of one dtype "
            f"out of {_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if out_dtype not in _DTYPES:
        raise NotImplementedError(f"flash_attention: out_dtype must be one "
                                  f"of {_DTYPES}, got {out_dtype}")
    if tuple(k.shape) != (bh, tk, d) or tuple(v.shape) != (bh, tk, d):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must both be {(bh, tk, d)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != device:
            raise ValueError(f"flash_attention: all operands must be on "
                             f"{device}, got {name} on {t.device}")
    # the kernel's 16-byte cp.async copies need contiguous, aligned rows: a
    # strided or offset view is copied, as on the CPU any layout is taken
    q, k, v = (_aligned(t) for t in (q, k, v))
    if bh > 65535:
        raise NotImplementedError(f"flash_attention: the CUDA grid takes at "
                                  f"most 65535 (batch, head) rows, got {bh}")
    out = torch.empty((bh, tq, d), dtype=out_dtype, device=device)
    lib = _lib()
    rc = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, tq, tk,
        d, 1.0 / math.sqrt(d), int(causal), int(window is not None),
        0 if window is None else int(window), int(offset), int(kv_len), bq,
        bkv, tq if q_period is None else q_period,
        int(q.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.flash_attention_error_string(rc).decode()}")
    flash_attention.launches += 1
    return out


#: Kernel launches since the count was last set to 0 (only
#: :func:`flash_attention` on CUDA tensors adds to it).
flash_attention.launches = 0
