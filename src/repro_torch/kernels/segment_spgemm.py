"""Segment-scheduled BSR × BSR matmul (the numeric SpGEMM phase): the C
blocks of ``BSR(A) @ BSR(B)`` at the symbolic pattern.

Replaces ``src/repro/kernels/segment_spgemm.py::segment_spgemm`` (fp32
blocks, and int8 / fp8-e4m3 payloads with per-block or rowwise fp32 scales
on both operands) with a CUDA kernel written for Hopper,
``src/repro_torch/csrc/segment_spgemm.cu``; the design and its bound are
noted at the top of that source.  :func:`segment_spgemm` launches the
kernel for CUDA tensors and runs :func:`segment_spgemm_plain` for CPU
tensors.  It takes the plan's lane-major triple arrays as they are, plus
the owner-run offsets of ``c_idx`` (:func:`~repro_torch.kernels.
segment_spmm.run_offsets`) that give the kernel one thread block per C
block.

``prefetch="cross_pass"`` is accepted and changes nothing: the SpGEMM grid
has no N-tile pass axis, so in ``repro`` too it is the drained schedule.
The TPU kernel's fetch flags and ring slots describe TPU DMA timing and
change no result; this kernel does not read them.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ref
from .segment_spmm import validate_schedule_args

_SOURCE = "segment_spgemm.cu"
_BLOCKS = (32, 64)
_PAYLOADS = {torch.float32: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
_OUT_DTYPES = (torch.float32, torch.bfloat16)
#: items per batched product in the plain version (bounds its transients:
#: two gathered 64×64 fp32 tiles and their product, 48 KB an item)
PLAIN_CHUNK = 8192


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.segment_spgemm.argtypes = [p] * 13 + [i] * 5 + [p]
        lib.segment_spgemm.restype = i
        lib.segment_spgemm_error_string.argtypes = [i]
        lib.segment_spgemm_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def segment_spgemm_plain(a_blocks, b_blocks, a_idx, b_idx, c_idx, valid, *,
                         n_c_blocks: int, a_scales=None, b_scales=None,
                         out_dtype=torch.float32,
                         chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """The kernel's plain torch version: dequantize both operands as
    :func:`~repro_torch.kernels.ref.dequant_blocks_ref` does, then, ``chunk``
    items at a time, gather each item's A and B tile, zero the pads, one
    batched fp32 matmul, ``index_add_`` into C by ``c_idx``.  For a planned
    schedule this equals the kernel's result up to fp32 rounding order."""
    a = ref.dequant_blocks_ref(a_blocks, a_scales)
    b = ref.dequant_blocks_ref(b_blocks, b_scales)
    out = torch.zeros((n_c_blocks, a.shape[1], b.shape[2]),
                      dtype=torch.float32, device=a.device)
    for lo in range(0, a_idx.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        contrib = torch.bmm(a[a_idx[sl].long()], b[b_idx[sl].long()])
        contrib = torch.where(valid[sl].bool()[:, None, None], contrib, 0.0)
        out.index_add_(0, c_idx[sl].long(), contrib)
    return out.to(out_dtype)


def _check_scales(name, scales, blocks, rows):
    if scales is not None and tuple(scales.shape) not in (
            (blocks.shape[0],), (blocks.shape[0], rows)):
        raise ValueError(
            f"{name} has shape {tuple(scales.shape)}, expected one fp32 "
            f"scale per stored block ({blocks.shape[0]},) or per block row "
            f"({blocks.shape[0]}, {rows})")


def segment_spgemm(a_blocks, b_blocks, a_idx, b_idx, c_idx, seg_start,
                   seg_write, accum_prev, valid, *, n_c_blocks: int,
                   n_lanes: int = 1, unroll: int = 1,
                   out_dtype=torch.float32, a_scales=None, b_scales=None,
                   prefetch: Optional[str] = None,
                   runs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The C blocks of ``BSR(A) @ BSR(B)`` under a lane-major Segment
    triple schedule.

    Args:
      a_blocks: ``(na, bm, bk)`` A tiles in BSR storage order: fp32, or an
        int8 / fp8-e4m3 payload with ``a_scales``.
      b_blocks: ``(nb, bk, bn)`` B tiles, likewise with ``b_scales``.
      a_idx/b_idx/c_idx: ``(n_items,)`` int32 triple → block-slot maps.
      seg_start/seg_write/accum_prev/valid: ``(n_items,)`` int32 flags.
      n_c_blocks: number of symbolic C blocks.
      n_lanes/unroll: the schedule's lane count and unroll (validated).
      out_dtype: fp32 or bf16; accumulation is always fp32.
      a_scales/b_scales: fp32 scales, per block (``(na,)`` / ``(nb,)``,
        applied to each item's product) or per block row (``(na, bm)`` /
        ``(nb, bk)``, applied to the tiles before the product).
      prefetch: ``None`` or ``"cross_pass"`` (no effect here).
      runs: the plan's owner-run offsets over ``c_idx`` on the device;
        required for CUDA tensors, unused by the plain version.

    Returns ``(n_c_blocks, bm, bn)``, ordered as the symbolic pattern.
    """
    if prefetch not in (None, "cross_pass"):
        raise ValueError(f"prefetch={prefetch!r}: expected None or "
                         f"'cross_pass'")
    n_items = seg_start.shape[0]
    bm, bk = a_blocks.shape[1:]
    bn = b_blocks.shape[2]
    if b_blocks.shape[1] != bk:
        raise ValueError(
            f"contraction blocks disagree: a_blocks "
            f"{tuple(a_blocks.shape)} contracts over bk={bk} but b_blocks "
            f"{tuple(b_blocks.shape)} has row blocks of "
            f"{b_blocks.shape[1]}; A tiles are (bm, bk), so B tiles must be "
            f"(bk, bn)")
    if n_c_blocks < 1 and n_items > 0:
        raise ValueError(
            f"n_c_blocks={n_c_blocks} with a non-empty schedule "
            f"(n_items={n_items}): every schedule item accumulates into a "
            f"symbolic C block (an empty symbolic C returns before the "
            f"kernel, in the executor)")
    _check_scales("a_scales", a_scales, a_blocks, bm)
    _check_scales("b_scales", b_scales, b_blocks, bk)
    validate_schedule_args(
        n_items, n_lanes, unroll,
        {"a_idx": a_idx, "b_idx": b_idx, "c_idx": c_idx,
         "seg_write": seg_write, "accum_prev": accum_prev, "valid": valid})
    device = a_blocks.device
    if device.type == "cpu":
        return segment_spgemm_plain(a_blocks, b_blocks, a_idx, b_idx, c_idx,
                                    valid, n_c_blocks=n_c_blocks,
                                    a_scales=a_scales, b_scales=b_scales,
                                    out_dtype=out_dtype)
    if device.type != "cuda":
        raise ValueError(f"segment_spgemm runs on cuda or cpu tensors, got "
                         f"{device}")
    return _launch(a_blocks, b_blocks, a_idx, b_idx, c_idx, seg_start,
                   seg_write, accum_prev, valid, n_c_blocks, out_dtype,
                   a_scales, b_scales, runs)


def _scale_mode(a_blocks, b_blocks, a_scales, b_scales) -> int:
    """0 (fp32 tiles), 1 (per-block scales) or 2 (rowwise) for the kernel;
    raises ``NotImplementedError`` on the combinations it does not take."""
    pa, pb = a_blocks.dtype, b_blocks.dtype
    if pa not in _PAYLOADS or pa != pb:
        raise NotImplementedError(
            f"segment_spgemm: the CUDA kernel takes A and B of one dtype "
            f"out of {tuple(_PAYLOADS)}, got {pa} and {pb}")
    if pa == torch.float32:
        if a_scales is not None or b_scales is not None:
            raise NotImplementedError("segment_spgemm: the CUDA kernel takes "
                                      "scales only beside int8/fp8 payloads")
        return 0
    if a_scales is None or b_scales is None or a_scales.ndim != b_scales.ndim:
        raise NotImplementedError(
            "segment_spgemm: the CUDA kernel takes int8/fp8 payloads with "
            "scales on both operands, both per block or both rowwise")
    return a_scales.ndim


def _launch(a_blocks, b_blocks, a_idx, b_idx, c_idx, seg_start, seg_write,
            accum_prev, valid, n_c_blocks, out_dtype, a_scales, b_scales,
            runs) -> torch.Tensor:
    _, bm, bk = a_blocks.shape
    bn = b_blocks.shape[2]
    device = a_blocks.device
    if not bm == bk == bn or bm not in _BLOCKS:
        raise NotImplementedError(
            f"segment_spgemm: the CUDA kernel takes square {_BLOCKS} tiles "
            f"on both sides, got A {(bm, bk)} and B {(bk, bn)}")
    mode = _scale_mode(a_blocks, b_blocks, a_scales, b_scales)
    if out_dtype not in _OUT_DTYPES:
        raise NotImplementedError(f"segment_spgemm: out_dtype must be one of "
                                  f"{_OUT_DTYPES}, got {out_dtype}")
    for t in (a_blocks, b_blocks):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("segment_spgemm: a_blocks and b_blocks must be "
                             "contiguous and 16-byte aligned")
    scales = tuple(s for s in (a_scales, b_scales) if s is not None)
    for s in scales:
        if s.dtype != torch.float32 or not s.is_contiguous():
            raise ValueError("segment_spgemm: scales must be contiguous fp32")
    sched = (a_idx, b_idx, c_idx, seg_start, seg_write, accum_prev, valid)
    for t in (b_blocks,) + scales + sched:
        if t.device != device:
            raise ValueError(f"segment_spgemm: all operands must be on "
                             f"{device}, got one on {t.device}")
    for t in sched:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("segment_spgemm: schedule arrays must be "
                             "contiguous int32")
    if runs is None or runs.device != device or runs.dtype != torch.int32:
        raise ValueError("segment_spgemm: CUDA tensors need the plan's owner-"
                         f"run offsets (plan.run_offsets) as int32 on {device}")
    out = torch.empty((n_c_blocks, bm, bn), dtype=out_dtype, device=device)
    n_runs = runs.shape[0] - 1
    if n_runs == 0:
        return out.zero_()
    lib = _lib()
    rc = lib.segment_spgemm(
        a_blocks.data_ptr(), b_blocks.data_ptr(), out.data_ptr(),
        a_scales.data_ptr() if a_scales is not None else None,
        b_scales.data_ptr() if b_scales is not None else None,
        *(t.data_ptr() for t in sched), runs.data_ptr(), n_runs, bm,
        _PAYLOADS[a_blocks.dtype], mode, int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_spgemm launch failed: "
                           f"{lib.segment_spgemm_error_string(rc).decode()}")
    segment_spgemm.launches += 1
    if mode:
        segment_spgemm.quantized_launches += 1
    return out


#: Kernel launches since the count was last set to 0 (only
#: :func:`segment_spgemm` on CUDA tensors adds to it) ...
segment_spgemm.launches = 0
#: ... and, of those, the launches on int8/fp8 payloads.
segment_spgemm.quantized_launches = 0
