"""Fused attention with an online softmax (flash attention): causal,
local-window and ``kv_len`` masks, fully masked KV tiles skipped, grouped
queries through the ``q_period`` position wrap.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention`` with
CUDA kernels written for Hopper, ``src/repro_torch/csrc/flash_attention.cu``
(the design and the bounds are noted at the top of that source), on three
paths that :func:`choose_path` picks per call from the shapes:

- ``"splitkv"``: calls whose q tiles do not fill the card (decode).  The
  KV axis is cut into splits of ``split_keys`` keys, one thread block a
  split on the CUDA cores, and the last block of each (bh, q tile) adds
  the fp32 partials in split order (:func:`split_plan`).
- ``"tc"``: the rest with a head dim that is a multiple of 16 (prefill,
  the local block).  Q·Kᵀ and P·V on ``wgmma`` over the exact bf16 split
  of fp32 operands (:func:`split_bf16x3`), the products with part indices
  ``i + j <= 2`` (:func:`tc_passes`).
- ``"simt"``: the rest (head dims that are multiples of 8 only): one
  block walks all of Tk on the CUDA cores.

:func:`flash_attention` launches the chosen kernel for CUDA tensors and
runs :func:`flash_attention_plain` for CPU tensors.  All keep ``repro``'s
masking exactly: a masked key of a live ``(bq, bkv)`` tile scores the
finite ``-1e30``, a key of a dead tile takes no part, so even a row with no
unmasked key gives ``repro``'s answer.  q, k and v may each be fp32 or
bf16 (the kernels convert on load, as ``repro`` casts each to fp32).  The
arguments are checked, and ``repro``'s ``ValueError``s raised, on every
device.

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

#: the CUDA paths, in the order :func:`choose_path` prefers them
PATHS = ("splitkv", "tc", "simt")
#: the card's streaming multiprocessors (H100 SXM), the default of the
#: dispatch functions; the wrapper passes the device's own count
SMS = 132
#: ``"splitkv"`` takes a call whose simt grid has fewer (bh, q tile)
#: blocks than this many per SM and more keys than stacked query rows (set
#: by chip_smoke.py's [attn-crossover] sweep: a T = 256 prefill, 128
#: blocks of 1024 rows over 256 keys, ran faster on the other paths)
SPLITKV_MAX_BLOCKS_PER_SM = 1.0
#: blocks per SM that :func:`split_plan` aims the split grid at
SPLIT_BLOCKS_PER_SM = 4
#: the fewest keys a split walks, and the unit of ``split_keys``
SPLIT_MIN_KEYS = 256
SPLIT_UNIT = 64


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention.argtypes = (
            [p] * 4 + [i] * 8 + [ctypes.c_float, i, i, ll, ll] + [i] * 6
            + [p] * 4)
        lib.flash_attention.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def simt_rows(tq: int) -> int:
    """Query rows of one block of the CUDA-core kernel (``"simt"`` and
    ``"splitkv"``): 32 when the whole q axis fits, else 64."""
    return 32 if tq <= 32 else 64


def split_plan(bh: int, tq: int, tk: int, sms: int = SMS):
    """``(n_splits, split_keys)`` of the ``"splitkv"`` path: split ``s``
    walks keys ``[s * split_keys, (s + 1) * split_keys)``.  Enough splits
    that the grid holds :data:`SPLIT_BLOCKS_PER_SM` blocks an SM, at least
    2 and at most one per :data:`SPLIT_MIN_KEYS` keys; ``split_keys`` is a
    multiple of :data:`SPLIT_UNIT` (a split may end inside a TPU tile).
    A plain function of the shapes."""
    blocks = bh * -(-tq // simt_rows(tq))
    want = -(-SPLIT_BLOCKS_PER_SM * sms // blocks)
    n = max(2, min(want, -(-tk // SPLIT_MIN_KEYS)))
    split_keys = -(-(-(-tk // n)) // SPLIT_UNIT) * SPLIT_UNIT
    return -(-tk // split_keys), split_keys


def paths_for(bh: int, tq: int, tk: int, d: int, dtypes=()) -> tuple:
    """The CUDA paths that can take a call, in :data:`PATHS` order; empty
    when none can (a head dim that is not a multiple of 8 or is above 256,
    or an operand dtype other than fp32 and bf16).  ``"tc"`` needs a head
    dim that is a multiple of 16 (``wgmma``'s bf16 step), ``"splitkv"``
    more keys than one :data:`SPLIT_UNIT`."""
    if d < 8 or d % 8 or d > 256 or any(t not in _DTYPES for t in dtypes):
        return ()
    return tuple(p for p, ok in (("splitkv", tk > SPLIT_UNIT),
                                 ("tc", d % 16 == 0), ("simt", True)) if ok)


def choose_path(bh: int, tq: int, tk: int, d: int, q_dtype=torch.float32,
                k_dtype=torch.float32, v_dtype=torch.float32,
                sms: int = SMS) -> Optional[str]:
    """The kernel a CUDA call runs on (``None`` when no path takes it):
    ``"splitkv"`` when the CUDA-core kernel's (bh, q tile) blocks number
    fewer than :data:`SPLITKV_MAX_BLOCKS_PER_SM` per SM and the keys
    outnumber the stacked query rows (decode, a short chunk over a long
    context), else ``"tc"`` where the head dim allows, else ``"simt"``.
    A plain function of the shapes and the dtypes (which decide only
    whether a path can take the call)."""
    able = paths_for(bh, tq, tk, d, (q_dtype, k_dtype, v_dtype))
    if not able:
        return None
    blocks = bh * -(-tq // simt_rows(tq))
    if ("splitkv" in able and blocks < SPLITKV_MAX_BLOCKS_PER_SM * sms
            and tk > tq):
        return "splitkv"
    return next(p for p in able if p != "splitkv")


def tc_passes(parts_a: int, parts_b: int) -> tuple:
    """The ``"tc"`` path's products of an operand split into ``parts_a``
    parts with one split into ``parts_b`` (3 for fp32, 1 for bf16): the
    pairs ``(i, j)`` with ``i + j <= 2``, smallest first, as the kernel
    runs them (six for fp32 × fp32, three for P × bf16 V, one for bf16
    Q·Kᵀ)."""
    order = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
    return tuple((i, j) for i, j in order if i < parts_a and j < parts_b)


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
                    out_dtype=None, path: Optional[str] = None
                    ) -> torch.Tensor:
    """q: (BH, Tq, D); k/v: (BH, Tk, D). Returns (BH, Tq, D).

    ``offset``: absolute position of q[0] (default Tk - Tq: queries are the
    final positions of the context).  ``kv_len``: number of live keys
    (positions ≥ kv_len are padding and masked out).  ``q_period``: the q
    axis holds several stacked query groups of this length sharing the K/V
    rows (GQA grouping — positions repeat every ``q_period`` rows; must be
    a multiple of ``bq``).  ``bq``/``bkv`` are the TPU kernel's tiles: they
    decide which tiles are skipped, hence the answer for a row whose live
    tiles hold only masked keys.  ``out_dtype`` defaults to q's dtype.
    ``path`` forces one of :func:`paths_for`'s paths on the card (checked
    on every device; the CPU runs the plain version whatever the path);
    ``None`` takes :func:`choose_path`'s.
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
    able = paths_for(bh, tq, tk, d, (q.dtype, k.dtype, v.dtype))
    if path is not None and path not in able:
        raise ValueError(f"flash_attention: path={path!r} cannot take this "
                         f"call; paths that can: {able}")
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
    return _launch(q, k, v, path=path, **kw)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


#: the split path's arrival counters, one int32 buffer per device, grown as
#: needed; the last block of each (bh, q tile) sets its counter back to 0,
#: so a buffer is zeroed only when it is made.  Launches on one device
#: share it, so they must not run concurrently: the port launches every
#: kernel on the current stream.
_COUNTERS: dict = {}
_SMS: dict = {}
_PATH_CODE = {"simt": 0, "splitkv": 1, "tc": 2}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1 << 12), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _sms(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _launch(q, k, v, *, causal, window, offset, kv_len, bq, bkv, q_period,
            out_dtype, path):
    bh, tq, d = q.shape
    tk = k.shape[1]
    device = q.device
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
    if path is None:
        path = choose_path(bh, tq, tk, d, q.dtype, k.dtype, v.dtype,
                           sms=_sms(device))
    if path is None:
        raise NotImplementedError(
            f"flash_attention: the CUDA kernels take head dims that are "
            f"multiples of 8 up to 256 and fp32 or bf16 q, k and v, got "
            f"D={d}, {q.dtype}, {k.dtype}, {v.dtype}")
    # the kernels' 16-byte copies and TMA need contiguous, aligned rows: a
    # strided or offset view is copied, as on the CPU any layout is taken
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty((bh, tq, d), dtype=out_dtype, device=device)
    work = counters = parts = None
    split_keys = 0
    if path == "splitkv":
        rows = simt_rows(tq)
        n_qt = -(-tq // rows)
        n_splits, split_keys = split_plan(bh, tq, tk, sms=_sms(device))
        work = torch.empty(bh * n_qt * n_splits * rows * (d + 2),
                           dtype=torch.float32, device=device)
        counters = _counters(device, bh * n_qt)
    elif path == "tc" and torch.float32 in (q.dtype, k.dtype, v.dtype):
        # the three bf16 parts of each operand (a bf16 operand of a mixed
        # call: itself and two zero parts), written by the split pre-pass
        parts = torch.empty(3 * (q.numel() + k.numel() + v.numel()),
                            dtype=torch.bfloat16, device=device)
    lib = _lib()
    bf = torch.bfloat16
    rc = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == bf), int(k.dtype == bf), int(v.dtype == bf),
        int(out_dtype == bf), bh, tq, tk, d, 1.0 / math.sqrt(d), int(causal),
        int(window is not None), 0 if window is None else int(window),
        int(offset), int(kv_len), bq, bkv,
        tq if q_period is None else q_period, _PATH_CODE[path], split_keys,
        None if work is None else work.data_ptr(),
        None if counters is None else counters.data_ptr(),
        None if parts is None else parts.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed ({path}): "
                           f"{lib.flash_attention_error_string(rc).decode()}")
    flash_attention.launches += 1
    if path == "splitkv":
        flash_attention.splitkv_launches += 1
    elif path == "tc":
        flash_attention.tc_launches += 1
    else:
        flash_attention.simt_launches += 1
    return out

#: Calls that launched a kernel since the count was last set to 0 (only
#: :func:`flash_attention` on CUDA tensors adds to it): one a call, and one
#: in the count of the path that ran (a ``"tc"`` call with fp32 operands
#: also launches the split pre-pass, part of the same call).
flash_attention.launches = 0
flash_attention.splitkv_launches = 0
flash_attention.tc_launches = 0
flash_attention.simt_launches = 0
