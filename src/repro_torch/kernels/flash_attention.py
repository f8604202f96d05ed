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

Gradients: when autograd records a call (grad mode on and q, k or v
requiring grad), :func:`flash_attention` runs through
:class:`FlashAttentionFunction`.  Its forward is the same launch on the same
path, which also writes each row's softmax statistics (the final max m and
sum l; log-sum-exp m + log l); its backward is :func:`flash_attention_bwd`:
the kernels of ``src/repro_torch/csrc/flash_attention_bwd.cu`` for CUDA
tensors (no Pallas kernel has them: ``repro`` takes ``jax.grad`` of its jnp
``chunked_attention``), the dense masked-softmax formula
:func:`flash_attention_bwd_plain` for CPU tensors.  The backward has two
paths, which :func:`choose_bwd_path` picks from D, as the forward's
``"tc"`` set is picked: ``"tc"`` (``wgmma`` fed by a TMA ring; fp32
operands over their exact bf16 split, :func:`tc_passes`; a KV-outer dK/dV
pass over row ranges, :func:`bwd_splits`, and a Q-outer dQ pass that
recomputes S and dP; its shape per dtype in :func:`bwd_tc_layout`) for
head dims that are multiples of 16, ``"simt"`` (fp32 on the CUDA cores)
for the rest.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional

import torch

from . import build
from .fake import aligned_like, copies
from .fake import sms as _fake_sms

_SOURCE = "flash_attention.cu"
_BWD_SOURCE = "flash_attention_bwd.cu"
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
#: the backward kernels' paths, in the order :func:`choose_bwd_path`
#: prefers them
BWD_PATHS = ("tc", "simt")
#: blocks per SM that the ``"tc"`` backward's dK/dV grid aims at
#: (:func:`bwd_splits`; one block fills an SM's shared memory)
BWD_BLOCKS_PER_SM = 4
#: the fewest keys a split walks, and the unit of ``split_keys``
SPLIT_MIN_KEYS = 256
SPLIT_UNIT = 64


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention.argtypes = (
            [p] * 4 + [i] * 8 + [ctypes.c_float, i, i, ll, ll] + [i] * 6
            + [p] * 5)
        lib.flash_attention.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load(_BWD_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        bwd_argtypes(lib)
    return lib


def bwd_argtypes(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the C signatures of a library built from
    ``csrc/flash_attention_bwd.cu`` (or a copy of it); returns ``lib``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_bwd.argtypes = (
        [p] * 10 + [i] * 8 + [ctypes.c_float, i, i, ll, ll] + [i] * 6
        + [p] * 4)
    lib.flash_attention_bwd.restype = i
    lib.flash_attention_bwd_error_string.argtypes = [i]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
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
                          chunk: int = PLAIN_CHUNK, stats: bool = False):
    """The kernel's plain torch version: for a chunk of query rows at a
    time, fp32 scores ``(q · k) * scale``, masked keys of live TPU tiles
    set to ``-1e30`` and keys of dead tiles dropped, one softmax without
    the normalisation, ``P V / max(l, 1e-30)``.  Arguments as resolved by
    :func:`flash_attention`; ``chunk`` (score elements a chunk) sets the
    rows a chunk, so a test can run several chunks at a small size.  With
    ``stats`` it returns ``(out, stats)``: each row's max m and sum l,
    ``(BH, Tq, 2)`` fp32, as the backward pass reads them."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    period = tq if q_period is None else q_period
    scale = 1.0 / math.sqrt(d)
    out = torch.empty((bh, tq, d), dtype=out_dtype, device=q.device)
    st = torch.empty((bh, tq, 2), dtype=torch.float32, device=q.device)
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
        l_sum = pe.sum(dim=-1, keepdim=True)
        out[:, lo:lo + rows.shape[0]] = torch.bmm(pe, vf) / torch.clamp(
            l_sum, min=1e-30)
        st[:, lo:lo + rows.shape[0]] = torch.cat([m, l_sum], dim=-1)
    return (out, st) if stats else out


def flash_attention_bwd_plain(q, k, v, out, dout, stats, *, causal: bool,
                              window: Optional[int], offset: int, kv_len: int,
                              bq: int, bkv: int, q_period: Optional[int],
                              chunk: int = PLAIN_CHUNK,
                              p_dtype: torch.dtype = torch.float32):
    """The backward kernels' plain torch version, the dense masked-softmax
    formula in fp32 for a chunk of query rows at a time: ``P = exp(s - m) /
    max(l, 1e-30)`` from the forward's row statistics (``stats``, ``(BH, Tq,
    2)``), ``delta = rowsum(dO ∘ O)``, ``dS = P ∘ (dO Vᵀ - delta)`` on the
    unmasked keys of live tiles (0 elsewhere: the forward's ``-1e30`` does
    not depend on q or k), ``dV = Pᵀ dO``, ``dK = scale dSᵀ Q``, ``dQ =
    scale dS K``.  Arguments as :func:`flash_attention_plain` takes them;
    ``p_dtype`` rounds P and dS before the last three products (bf16: one
    bf16 part, the function a bf16 SDPA backward computes, not this one;
    chip_smoke.py holds the kernels' error below its).  Returns ``(dq, dk,
    dv)`` in q's, k's and v's dtypes."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    period = tq if q_period is None else q_period
    scale = 1.0 / math.sqrt(d)
    kf, vf = k.float(), v.float()
    delta = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
    dq = torch.empty((bh, tq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((bh, tk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((bh, tk, d), dtype=torch.float32, device=q.device)
    step = max(1, chunk // max(bh * tk, 1))
    for lo in range(0, tq, step):
        rows = torch.arange(lo, min(lo + step, tq), device=q.device)
        hi = lo + rows.shape[0]
        live, mask = _tile_masks(tq, tk, causal=causal, window=window,
                                 offset=offset, kv_len=kv_len, bq=bq,
                                 bkv=bkv, period=period, rows=rows,
                                 device=q.device)
        qc, doc = q[:, lo:hi].float(), dout[:, lo:hi].float()
        s = torch.einsum("bqd,bkd->bqk", qc, kf) * scale
        s = torch.where(mask, s, _MASKED)
        s = torch.where(live, s, -math.inf)
        m, l_sum = stats[:, lo:hi, 0:1], stats[:, lo:hi, 1:2]
        p = torch.exp(s - m) / torch.clamp(l_sum, min=1e-30)
        dp = torch.einsum("bqd,bkd->bqk", doc, vf)
        ds = torch.where(live & mask, p * (dp - delta[:, lo:hi]), 0.0)
        if p_dtype != torch.float32:
            p, ds = p.to(p_dtype).float(), ds.to(p_dtype).float()
        dv += torch.bmm(p.transpose(1, 2), doc)
        dk += torch.bmm(ds.transpose(1, 2), qc) * scale
        dq[:, lo:hi] = torch.bmm(ds, kf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
              bq=bq, bkv=bkv, q_period=q_period)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, kw, out_dtype, path)
    return _forward(q, k, v, kw, out_dtype, path)


def _forward(q, k, v, kw, out_dtype, path, stats=False):
    res = flash_attention_op(q, k, v, kw["causal"], kw["window"],
                             kw["offset"], kw["kv_len"], kw["bq"], kw["bkv"],
                             kw["q_period"], out_dtype, stats, path)
    return (res[0], res[1]) if stats else res[0]


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: Optional[int], offset: int,
                       kv_len: int, bq: int, bkv: int,
                       q_period: Optional[int], out_dtype: torch.dtype,
                       stats: bool, path: Optional[str]
                       ) -> List[torch.Tensor]:
    """The operator :func:`flash_attention` calls once its arguments are
    resolved: ``[out, (row statistics with stats), *scratch]``.  The launch
    for CUDA tensors, the plain version for CPU tensors, the fake rule
    (:func:`launch_allocations`) for fake and meta tensors."""
    raise NotImplementedError(f"flash_attention has no kernel for "
                              f"{q.device}")


@flash_attention_op.register_kernel("cpu")
def _fwd_cpu(q, k, v, causal, window, offset, kv_len, bq, bkv, q_period,
             out_dtype, stats, path):
    res = flash_attention_plain(q, k, v, causal=causal, window=window,
                                offset=offset, kv_len=kv_len, bq=bq, bkv=bkv,
                                q_period=q_period, out_dtype=out_dtype,
                                stats=stats)
    return list(res) if stats else [res]


@flash_attention_op.register_kernel("cuda")
def _fwd_cuda(q, k, v, causal, window, offset, kv_len, bq, bkv, q_period,
              out_dtype, stats, path):
    return _launch(q, k, v, causal=causal, window=window, offset=offset,
                   kv_len=kv_len, bq=bq, bkv=bkv, q_period=q_period,
                   out_dtype=out_dtype, path=path, stats=stats)


@flash_attention_op.register_fake
def _fwd_fake(q, k, v, causal, window, offset, kv_len, bq, bkv, q_period,
              out_dtype, stats, path):
    bh, tq, d = q.shape
    if q.device.type != "cuda":
        out = [torch.empty((bh, tq, d), dtype=out_dtype, device=q.device)]
        if stats:
            out.append(torch.empty((bh, tq, 2), dtype=torch.float32,
                                   device=q.device))
        return out
    return launch_allocations(q, k, v, out_dtype, stats, path)


def launch_allocations(q, k, v, out_dtype, stats, path):
    """What one forward launch on the card allocates, as fake tensors on
    q's device: out, the row statistics (with ``stats``), the copies of q,
    k or v that are not contiguous and 16-byte aligned, then the path's
    scratch: ``"splitkv"``'s fp32 partials, or ``"tc"``'s three bf16 parts
    of each operand when one of them is fp32.  The split path's arrival
    counters are one persistent int32 buffer a device (at least 16 KB, made
    by the first launch that needs it), not a per-call allocation."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    device = q.device
    path = _check_launch(q, k, v, out_dtype, path, _fake_sms(device))
    ops = [aligned_like(t) for t in (q, k, v)]
    out = [torch.empty((bh, tq, d), dtype=out_dtype, device=device)]
    if stats:
        out.append(torch.empty((bh, tq, 2), dtype=torch.float32,
                               device=device))
    out += copies(zip(ops, (q, k, v)))
    if path == "splitkv":
        rows = simt_rows(tq)
        n_splits, _ = split_plan(bh, tq, tk, sms=_fake_sms(device))
        out.append(torch.empty(bh * -(-tq // rows) * n_splits * rows
                               * (d + 2), dtype=torch.float32, device=device))
    elif path == "tc" and torch.float32 in (q.dtype, k.dtype, v.dtype):
        out.append(torch.empty(3 * (q.numel() + k.numel() + v.numel()),
                               dtype=torch.bfloat16, device=device))
    return out


class FlashAttentionFunction(torch.autograd.Function):
    """:func:`flash_attention` under autograd: the forward launch (or plain
    version) with each row's statistics written beside the output, and
    :func:`flash_attention_bwd` for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, kw, out_dtype, path):
        out, stats = _forward(q, k, v, kw, out_dtype, path, stats=True)
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, stats = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, stats, **ctx.kw)
        return dq, dk, dv, None, None, None


def bwd_paths_for(d: int, dtypes=()) -> tuple:
    """The backward's CUDA paths that can take a call with head dim ``d``
    and operand dtypes ``dtypes`` (q, k, v, out), in :data:`BWD_PATHS`
    order: ``"tc"`` for head dims that are multiples of 16 (``wgmma``'s
    bf16 step), in any mix of fp32 and bf16; ``"simt"`` for head dims that
    are multiples of 8 up to 256."""
    if d < 8 or d % 8 or d > 256 or any(t not in _DTYPES for t in dtypes):
        return ()
    return ("tc", "simt") if d % 16 == 0 else ("simt",)


def choose_bwd_path(d: int, dtypes=()) -> Optional[str]:
    """The backward path a CUDA call runs on: the first of
    :func:`bwd_paths_for`'s (``None`` when none takes it)."""
    able = bwd_paths_for(d, dtypes)
    return able[0] if able else None


def bwd_tc_layout(d: int, dtypes=()) -> dict:
    """The ``"tc"`` backward's shape for a call, which sizes
    :func:`bwd_splits`' grid; :func:`flash_attention_bwd` passes it to the
    kernel, which refuses a layout that is not its ``Cfg``'s.  ``parts`` of
    each operand (1 when q, k, v and out are all bf16, else 3: the exact
    split of fp32), ``p_parts`` of P and dS (2, or 3 with fp32 operands),
    ``wgs`` consumer warpgroups a block (they share its 64 resident keys or
    rows and take the live streamed tiles in turn), ``rows`` of a streamed
    tile, ``groups`` of dK/dV columns (128 columns a group above D = 128;
    the dQ pass takes all of D in one)."""
    parts = 1 if all(t == torch.bfloat16 for t in dtypes) else 3
    dmax = 64 if d <= 64 else 128 if d <= 128 else 256
    return dict(parts=parts, p_parts=2 if parts == 1 else 3,
                wgs=2 if parts == 1 else 1, rows=64 if parts == 1 else 32,
                groups=dmax // 128 if dmax > 128 else 1)


def bwd_splits(bh: int, tq: int, tk: int, d: int, dtypes=(),
               sms: int = SMS) -> int:
    """Ranges of row tiles the ``"tc"`` backward's dK/dV pass cuts the
    stacked q axis into, so that its grid (bh x blocks of 64 keys x column
    groups, :func:`bwd_tc_layout`) holds :data:`BWD_BLOCKS_PER_SM` blocks
    an SM; never more ranges than row tiles.  Each range writes an fp32
    partial, added in range order."""
    lay = bwd_tc_layout(d, dtypes)
    kv_blocks = bh * -(-tk // 64) * lay["groups"]
    return max(1, min(-(-tq // lay["rows"]),
                      -(-BWD_BLOCKS_PER_SM * sms // kv_blocks)))


def flash_attention_bwd(q, k, v, out, dout, stats, *, causal: bool,
                        window: Optional[int], offset: int, kv_len: int,
                        bq: int, bkv: int, q_period: Optional[int],
                        path: Optional[str] = None):
    """Gradients ``(dq, dk, dv)`` (in q's, k's and v's dtypes) of one
    :func:`flash_attention` call, given its output ``out``, the output's
    gradient ``dout`` and the row statistics ``stats`` ``(BH, Tq, 2)`` that
    its forward wrote; the masks as resolved by :func:`flash_attention`.
    The kernels of ``csrc/flash_attention_bwd.cu`` for CUDA tensors, on
    ``path`` (one of :func:`bwd_paths_for`'s; ``None`` takes
    :func:`choose_bwd_path`'s; checked on every device): one call is one
    count of ``flash_attention_bwd.launches`` and of its path's
    (``tc_launches``, ``simt_launches``): the row sums, the KV-outer dK/dV
    pass and the Q-outer dQ pass (on ``"tc"`` also the split of fp32
    operands and the sum of the row ranges' partials).  The plain version
    for CPU tensors."""
    d = q.shape[-1]
    dtypes = (q.dtype, k.dtype, v.dtype, out.dtype)
    if path is not None and path not in bwd_paths_for(d, dtypes):
        raise ValueError(f"flash_attention_bwd: path={path!r} cannot take "
                         f"this call; paths that can: "
                         f"{bwd_paths_for(d, dtypes)}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, "
                         f"got {q.device}")
    res = flash_attention_bwd_op(q, k, v, out, dout, stats, causal, window,
                                 offset, kv_len, bq, bkv, q_period, path)
    return res[0], res[1], res[2]


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           out: torch.Tensor, dout: torch.Tensor,
                           stats: torch.Tensor, causal: bool,
                           window: Optional[int], offset: int, kv_len: int,
                           bq: int, bkv: int, q_period: Optional[int],
                           path: Optional[str]) -> List[torch.Tensor]:
    """The operator :func:`flash_attention_bwd` calls: ``[dq, dk, dv,
    *scratch]``.  The launch for CUDA tensors, the plain version for CPU
    tensors, the fake rule (:func:`bwd_launch_allocations`) for fake and
    meta tensors."""
    raise NotImplementedError(f"flash_attention_bwd has no kernel for "
                              f"{q.device}")


@flash_attention_bwd_op.register_kernel("cpu")
def _bwd_cpu(q, k, v, out, dout, stats, causal, window, offset, kv_len, bq,
             bkv, q_period, path):
    return list(flash_attention_bwd_plain(
        q, k, v, out, dout, stats, causal=causal, window=window,
        offset=offset, kv_len=kv_len, bq=bq, bkv=bkv, q_period=q_period))


@flash_attention_bwd_op.register_kernel("cuda")
def _bwd_cuda(q, k, v, out, dout, stats, causal, window, offset, kv_len, bq,
              bkv, q_period, path):
    return _bwd_launch(q, k, v, out, dout, stats, causal=causal,
                       window=window, offset=offset, kv_len=kv_len, bq=bq,
                       bkv=bkv, q_period=q_period, path=path)


@flash_attention_bwd_op.register_fake
def _bwd_fake(q, k, v, out, dout, stats, causal, window, offset, kv_len, bq,
              bkv, q_period, path):
    if q.device.type != "cuda":
        return [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                for t in (q, k, v)]
    return bwd_launch_allocations(q, k, v, out, dout, stats, path)


def _check_bwd_launch(q, k, v, out, dout, stats, path) -> str:
    """Raise what the backward launch raises; returns its path."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    for name, t, shape in (("k", k, (bh, tk, d)), ("v", v, (bh, tk, d)),
                           ("out", out, (bh, tq, d)),
                           ("dout", dout, (bh, tq, d)),
                           ("stats", stats, (bh, tq, 2))):
        if tuple(t.shape) != shape:
            raise ValueError(f"flash_attention_bwd: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != q.device:
            raise ValueError(f"flash_attention_bwd: all operands must be on "
                             f"{q.device}, got {name} on {t.device}")
    dtypes = (q.dtype, k.dtype, v.dtype, out.dtype)
    path = path or choose_bwd_path(d, dtypes)
    if path is None:
        raise NotImplementedError(
            f"flash_attention_bwd: the CUDA kernels take head dims that are "
            f"multiples of 8 up to 256 and fp32 or bf16 q, k, v and out, got "
            f"D={d}, {q.dtype}, {k.dtype}, {v.dtype}, {out.dtype}")
    return path


def bwd_launch_allocations(q, k, v, out, dout, stats, path):
    """What one backward launch on the card allocates, as fake tensors on
    q's device: dq, dk, dv, the copies of operands that are not
    contiguous and aligned (dout also when it is not in out's dtype, the
    statistics when not contiguous fp32), each row's ``info``, the row
    ranges' fp32 partials (``"tc"`` with more than one range) and the
    three bf16 parts of q, k, v and dout (``"tc"`` with an fp32
    operand)."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    device = q.device
    path = _check_bwd_launch(q, k, v, out, dout, stats, path)
    dtypes = (q.dtype, k.dtype, v.dtype, out.dtype)
    ops = [aligned_like(t) for t in (q, k, v, out)]
    d_cast = (dout if dout.dtype == out.dtype else
              torch.empty(dout.shape, dtype=out.dtype, device=device))
    d_al = aligned_like(d_cast)
    st = (stats if stats.dtype == torch.float32 and stats.is_contiguous()
          else torch.empty(stats.shape, dtype=torch.float32, device=device))
    res = [torch.empty(t.shape, dtype=t.dtype, device=device)
           for t in ops[:3]]
    res += copies(zip(ops, (q, k, v, out)))
    res += [t for t in {id(x): x for x in (d_cast, d_al)}.values()
            if t is not dout]
    res += copies([(st, stats)])
    res.append(torch.empty((bh, tq, 4), dtype=torch.float32, device=device))
    lay = bwd_tc_layout(d, dtypes) if path == "tc" else None
    n_split = (bwd_splits(bh, tq, tk, d, dtypes, _fake_sms(device))
               if path == "tc" else 1)
    if n_split > 1:
        res.append(torch.empty(2 * n_split * bh * tk * d,
                               dtype=torch.float32, device=device))
    if lay is not None and lay["parts"] == 3:
        res.append(torch.empty(3 * 2 * (q.numel() + k.numel()),
                               dtype=torch.bfloat16, device=device))
    return res


def _bwd_launch(q, k, v, out, dout, stats, *, causal, window, offset,
                kv_len, bq, bkv, q_period, path) -> List[torch.Tensor]:
    """One backward launch: ``[dq, dk, dv, *scratch]``
    (:func:`bwd_launch_allocations`)."""
    path = _check_bwd_launch(q, k, v, out, dout, stats, path)
    bh, tq, d = q.shape
    tk = k.shape[1]
    dtypes = (q.dtype, k.dtype, v.dtype, out.dtype)
    src = (q, k, v, out, dout, stats)
    q, k, v, out = (_aligned(t) for t in (q, k, v, out))
    d_cast = dout.to(out.dtype)
    dout = _aligned(d_cast)
    stats = stats.float().contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    scratch = copies(zip((q, k, v, out), src[:4]))
    scratch += [t for t in {id(x): x for x in (d_cast, dout)}.values()
                if t is not src[4]]
    scratch += copies([(stats, src[5])])
    # each row's (m, l, delta, 0), written by the first launch
    info = torch.empty((bh, tq, 4), dtype=torch.float32, device=q.device)
    lay = bwd_tc_layout(d, dtypes) if path == "tc" else None
    n_split = (bwd_splits(bh, tq, tk, d, dtypes, _sms(q.device))
               if path == "tc" else 1)
    part = (torch.empty(2 * n_split * bh * tk * d, dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    # the three bf16 parts of q, k, v and dout (a bf16 operand of a mixed
    # call: itself and two zero parts), written by the split pre-pass
    parts = (torch.empty(3 * 2 * (q.numel() + k.numel()),
                         dtype=torch.bfloat16, device=q.device)
             if lay is not None and lay["parts"] == 3 else None)
    layout = (ctypes.c_int * 5)(*(lay[k] for k in _LAYOUT_KEYS)) if lay \
        else None
    lib = _bwd_lib()
    bf = torch.bfloat16
    rc = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), stats.data_ptr(), info.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), int(q.dtype == bf), int(k.dtype == bf),
        int(v.dtype == bf), int(out.dtype == bf), bh, tq, tk, d,
        1.0 / math.sqrt(d), int(causal), int(window is not None),
        0 if window is None else int(window), int(offset), int(kv_len), bq,
        bkv, tq if q_period is None else q_period, int(path == "tc"),
        n_split, layout, None if part is None else part.data_ptr(),
        None if parts is None else parts.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed ({path}): "
                           f"{lib.flash_attention_bwd_error_string(rc).decode()}")
    flash_attention_bwd.launches += 1
    setattr(flash_attention_bwd, f"{path}_launches",
            getattr(flash_attention_bwd, f"{path}_launches") + 1)
    return [dq, dk, dv, *scratch, info,
            *(t for t in (part, parts) if t is not None)]


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
#: :func:`bwd_tc_layout`'s values in the order the backward library checks
#: them against its ``Cfg``
_LAYOUT_KEYS = ("parts", "p_parts", "wgs", "rows", "groups")


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


def _check_launch(q, k, v, out_dtype, path, sms) -> str:
    """Raise what the forward launch raises; returns its path."""
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
                           sms=sms)
    if path is None:
        raise NotImplementedError(
            f"flash_attention: the CUDA kernels take head dims that are "
            f"multiples of 8 up to 256 and fp32 or bf16 q, k and v, got "
            f"D={d}, {q.dtype}, {k.dtype}, {v.dtype}")
    return path


def _launch(q, k, v, *, causal, window, offset, kv_len, bq, bkv, q_period,
            out_dtype, path, stats=False) -> List[torch.Tensor]:
    """One forward launch: ``[out, (st), *scratch]``
    (:func:`launch_allocations`)."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    device = q.device
    path = _check_launch(q, k, v, out_dtype, path, _sms(device))
    # the kernels' 16-byte copies and TMA need contiguous, aligned rows: a
    # strided or offset view is copied, as on the CPU any layout is taken
    src = (q, k, v)
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty((bh, tq, d), dtype=out_dtype, device=device)
    st = (torch.empty((bh, tq, 2), dtype=torch.float32, device=device)
          if stats else None)
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
        None if st is None else st.data_ptr(),
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
    return ([out] + ([st] if stats else []) + copies(zip((q, k, v), src))
            + [t for t in (work, parts) if t is not None])

#: Calls that launched a kernel since the count was last set to 0 (only
#: :func:`flash_attention` on CUDA tensors adds to it): one a call, and one
#: in the count of the path that ran (a ``"tc"`` call with fp32 operands
#: also launches the split pre-pass, part of the same call).
flash_attention.launches = 0
flash_attention.splitkv_launches = 0
flash_attention.tc_launches = 0
flash_attention.simt_launches = 0
#: Backward calls that launched the backward kernels since the count was
#: last set to 0, all and per path (only :func:`flash_attention_bwd` on
#: CUDA tensors adds to them; one a call).
flash_attention_bwd.launches = 0
flash_attention_bwd.tc_launches = 0
flash_attention_bwd.simt_launches = 0
