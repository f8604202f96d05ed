"""Segment-scheduled BSR × BSR matmul (the numeric SpGEMM phase): the C
blocks of ``BSR(A) @ BSR(B)`` at the symbolic pattern.

Replaces ``src/repro/kernels/segment_spgemm.py::segment_spgemm`` (fp32
blocks, and int8 / fp8-e4m3 payloads with per-block or rowwise fp32 scales
on both operands) with two CUDA kernels written for Hopper;
:func:`choose_path` picks one per call, before the launch, from the tile
shapes, the storage mode and the output dtype alone:

- ``"tc"`` (``csrc/segment_spgemm_tc.cu``): 64×64 tiles on both sides, in
  every storage mode.  ``wgmma`` over the exact bf16 split of fp32 tiles
  (six passes), one pass for a per-block-scaled payload, three for a
  rowwise one (A's row scales come out of the product, B is dequantized
  and split); persistent blocks take the owner runs of the plan's work
  table (:func:`work_table`: runs in Z-order over C, each item one row)
  from a counter, so the runs in flight share their tiles in L2.
- ``"simt"`` (``csrc/segment_spgemm.cu``, one thread block per owner run,
  fp32 on the CUDA cores): what ``"tc"`` does not take, 32×32 and
  non-square tiles (each of bm, bk, bn 32 or 64).

The designs and their bounds are noted at the top of the two sources.
:func:`segment_spgemm` launches the chosen kernel for CUDA tensors, runs
:func:`segment_spgemm_plain` for CPU tensors and its fake rule
(:func:`launch_allocations`) for fake and meta ones.  It takes the plan's
lane-major triple arrays as they are, plus the owner-run offsets of
``c_idx`` (:func:`~repro_torch.kernels.segment_spmm.run_offsets`, for
``"simt"``) and the work table (for ``"tc"``) that the planner derives
once per plan.

``prefetch="cross_pass"`` is accepted and changes nothing: the SpGEMM grid
has no N-tile pass axis, so in ``repro`` too it is the drained schedule.
The TPU kernel's fetch flags and ring slots describe TPU DMA timing and
change no result; these kernels do not read them.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import build, ref
from .fake import addr
from .segment_spmm import validate_schedule_args

_SOURCE = "segment_spgemm.cu"
_TC_SOURCE = "segment_spgemm_tc.cu"
_BLOCKS = (32, 64)
#: the paths :func:`choose_path` returns
PATHS = ("tc", "simt")
#: a work-table row's flag bits
FLAG_VALID, FLAG_START, FLAG_PREV, FLAG_WRITE = 1, 2, 4, 8
_PAYLOADS = {torch.float32: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
_OUT_DTYPES = (torch.float32, torch.bfloat16)
#: items per batched product in the plain version (bounds its transients:
#: two gathered 64×64 fp32 tiles and their product, 48 KB an item)
PLAIN_CHUNK = 8192


def _lib(source: str = _SOURCE) -> ctypes.CDLL:
    lib = build.load(source)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        if source == _SOURCE:
            lib.segment_spgemm.argtypes = [p] * 13 + [i] * 7 + [p]
            lib.segment_spgemm.restype = i
            err = lib.segment_spgemm_error_string
        else:
            lib.segment_spgemm_tc.argtypes = [p] * 8 + [i] * 4 + [p]
            lib.segment_spgemm_tc.restype = i
            err = lib.segment_spgemm_tc_error_string
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _morton(row: np.ndarray, col: np.ndarray) -> np.ndarray:
    """Z-order keys of (row, col) pairs: the bits of the two interleaved,
    column bit lowest."""
    key = np.zeros(row.shape, dtype=np.int64)
    for bit in range(31):
        key |= ((col >> bit) & 1) << (2 * bit)
        key |= ((row >> bit) & 1) << (2 * bit + 1)
    return key


def work_table(a_idx, b_idx, c_idx, valid, seg_start, seg_write,
               accum_prev, runs, c_brow, c_bcol
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The tensor-core path's work table of a lane-major SpGEMM schedule.

    The owner runs (``runs``, from :func:`~repro_torch.kernels.segment_spmm.
    run_offsets`; one C block each) are put in Z-order over their C blocks'
    (row, column) (``c_brow[c_idx]``, ``c_bcol[c_idx]``): the kernel's
    blocks take runs in this order, so the runs in flight on the card cover
    a compact patch of C and share their A and B tiles in L2.  Each run
    keeps its items in schedule order, one row of the table each; pad
    items without flags are dropped (they change nothing).

    Returns ``(run_steps, steps)``: ``(n_runs + 1,)`` int32 offsets of each
    run's rows in ``steps``, in Z-order, and ``(n_steps, 5)`` int32 rows
    ``(A tile, item, B tile, C block, flags)``, all a step needs in one
    load: the A tile is -1 for an item that is not valid, and the flags are
    :data:`FLAG_VALID` | :data:`FLAG_START` | :data:`FLAG_PREV` |
    :data:`FLAG_WRITE`.
    """
    runs = np.asarray(runs, dtype=np.int64).reshape(-1)
    c = np.asarray(c_idx, dtype=np.int64).reshape(-1)
    ok = np.asarray(valid).reshape(-1) != 0
    flags = (ok * FLAG_VALID
             + (np.asarray(seg_start).reshape(-1) != 0) * FLAG_START
             + (np.asarray(accum_prev).reshape(-1) != 0) * FLAG_PREV
             + (np.asarray(seg_write).reshape(-1) != 0) * FLAG_WRITE)
    n_runs = runs.size - 1
    if n_runs <= 0:
        return np.zeros(1, np.int32), np.zeros((0, 5), np.int32)
    first = c[runs[:-1]]
    order = np.argsort(_morton(np.asarray(c_brow, dtype=np.int64)[first],
                               np.asarray(c_bcol, dtype=np.int64)[first]),
                       kind="stable")
    # the kept items of each run, runs in Z-order, items in schedule order
    lo, hi = runs[:-1][order], runs[1:][order]
    span = np.repeat(lo - np.concatenate(([0], np.cumsum(hi - lo)[:-1])),
                     hi - lo)
    items = np.arange(span.size) + span
    keep = flags[items] != 0
    items = items[keep]
    counts = np.bincount(np.repeat(np.arange(n_runs), hi - lo)[keep],
                         minlength=n_runs)
    steps = np.stack([np.where(ok[items], np.asarray(a_idx).reshape(-1)[items],
                               -1),
                      items, np.asarray(b_idx).reshape(-1)[items], c[items],
                      flags[items]], axis=1).astype(np.int32)
    run_steps = np.concatenate(([0], np.cumsum(counts))).astype(np.int32)
    return run_steps, steps


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


def storage_mode(a_dtype, b_dtype, a_scales_ndim: Optional[int],
                 b_scales_ndim: Optional[int]) -> Optional[int]:
    """The kernels' storage mode: 0 (fp32 tiles, no scales), 1 (int8/fp8
    payloads, one scale per block on both sides) or 2 (one scale per block
    row on both sides); ``None`` for a pairing no kernel takes (mixed
    payload dtypes, scales beside fp32 tiles, a payload without scales on
    both sides, per-block scales on one side and rowwise on the other)."""
    if a_dtype not in _PAYLOADS or a_dtype != b_dtype:
        return None
    if a_dtype == torch.float32:
        return 0 if a_scales_ndim is None and b_scales_ndim is None else None
    if a_scales_ndim is None or a_scales_ndim != b_scales_ndim:
        return None
    return a_scales_ndim


def paths_for(bm: int, bk: int, bn: int, mode: Optional[int],
              out_dtype) -> tuple:
    """The paths whose kernels can take a call, in :data:`PATHS` order:
    both for 64×64 tiles, ``"simt"`` alone for other tiles of 32 or 64 on
    each side, none for other tiles, a ``mode`` of ``None``
    (:func:`storage_mode`) or an output dtype other than fp32 and bf16."""
    if (mode is None or out_dtype not in _OUT_DTYPES
            or any(x not in _BLOCKS for x in (bm, bk, bn))):
        return ()
    return PATHS if bm == bk == bn == 64 else ("simt",)


def choose_path(bm: int, bk: int, bn: int, mode: Optional[int],
                out_dtype) -> str:
    """The kernel a CUDA call runs on: the first of :func:`paths_for`
    (``"tc"`` for 64×64 tiles, else ``"simt"``).  A plain function of the
    tile shapes, the storage mode and the output dtype; raises
    ``NotImplementedError`` when no path takes the call."""
    able = paths_for(bm, bk, bn, mode, out_dtype)
    if able:
        return able[0]
    if mode is None:
        raise NotImplementedError(
            "segment_spgemm: the CUDA kernels take A and B of one dtype out "
            f"of {tuple(_PAYLOADS)}: fp32 without scales, or int8/fp8 "
            "payloads with scales on both operands, both per block or both "
            "rowwise")
    if out_dtype not in _OUT_DTYPES:
        raise NotImplementedError(f"segment_spgemm: out_dtype must be one of "
                                  f"{_OUT_DTYPES}, got {out_dtype}")
    raise NotImplementedError(
        f"segment_spgemm: the CUDA kernels take tiles of {_BLOCKS} on each "
        f"side, got A {(bm, bk)} and B {(bk, bn)}")


def segment_spgemm(a_blocks, b_blocks, a_idx, b_idx, c_idx, seg_start,
                   seg_write, accum_prev, valid, *, n_c_blocks: int,
                   n_lanes: int = 1, unroll: int = 1,
                   out_dtype=torch.float32, a_scales=None, b_scales=None,
                   prefetch: Optional[str] = None,
                   runs: Optional[torch.Tensor] = None,
                   work: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   path: Optional[str] = None) -> torch.Tensor:
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
        required for CUDA tensors on ``"simt"``, unused by the plain version.
      work: the plan's work table ``(run_steps, steps)``
        (:func:`work_table`) on the device; required for CUDA tensors on
        ``"tc"``.
      path: ``None`` (:func:`choose_path`) or a path of :func:`paths_for`
        to force (checked on every device; the CPU runs the plain version
        whatever the path).

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
    if path is not None:
        mode = storage_mode(a_blocks.dtype, b_blocks.dtype,
                            None if a_scales is None else a_scales.ndim,
                            None if b_scales is None else b_scales.ndim)
        able = paths_for(bm, bk, bn, mode, out_dtype)
        if path not in able:
            raise ValueError(f"path={path!r}: this call can take {able}")
    device = a_blocks.device
    if device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"segment_spgemm runs on cuda or cpu tensors, got "
                         f"{device}")
    work_runs, work_steps = work if work is not None else (None, None)
    return segment_spgemm_op(a_blocks, b_blocks, a_idx, b_idx, c_idx,
                             seg_start, seg_write, accum_prev, valid,
                             a_scales, b_scales, runs, work_runs, work_steps,
                             n_c_blocks, out_dtype, path)[0]


@torch.library.custom_op("repro_torch::segment_spgemm", mutates_args=())
def segment_spgemm_op(a_blocks: torch.Tensor, b_blocks: torch.Tensor,
                      a_idx: torch.Tensor, b_idx: torch.Tensor,
                      c_idx: torch.Tensor, seg_start: torch.Tensor,
                      seg_write: torch.Tensor, accum_prev: torch.Tensor,
                      valid: torch.Tensor, a_scales: Optional[torch.Tensor],
                      b_scales: Optional[torch.Tensor],
                      runs: Optional[torch.Tensor],
                      work_runs: Optional[torch.Tensor],
                      work_steps: Optional[torch.Tensor], n_c_blocks: int,
                      out_dtype: torch.dtype,
                      path: Optional[str]) -> List[torch.Tensor]:
    """The operator :func:`segment_spgemm` calls once its arguments are
    checked: ``[C, *scratch]`` (``"tc"``'s run counter).  The launch for
    CUDA tensors, the plain version for CPU tensors, the fake rule
    (:func:`launch_allocations`) for fake and meta tensors."""
    raise NotImplementedError(f"segment_spgemm has no kernel for "
                              f"{a_blocks.device}")


@segment_spgemm_op.register_kernel("cpu")
def _spgemm_cpu(a_blocks, b_blocks, a_idx, b_idx, c_idx, seg_start,
                seg_write, accum_prev, valid, a_scales, b_scales, runs,
                work_runs, work_steps, n_c_blocks, out_dtype, path):
    return [segment_spgemm_plain(a_blocks, b_blocks, a_idx, b_idx, c_idx,
                                 valid, n_c_blocks=n_c_blocks,
                                 a_scales=a_scales, b_scales=b_scales,
                                 out_dtype=out_dtype)]


@segment_spgemm_op.register_kernel("cuda")
def _spgemm_cuda(a_blocks, b_blocks, a_idx, b_idx, c_idx, seg_start,
                 seg_write, accum_prev, valid, a_scales, b_scales, runs,
                 work_runs, work_steps, n_c_blocks, out_dtype, path):
    return _launch(a_blocks, b_blocks, a_idx, b_idx, c_idx, seg_start,
                   seg_write, accum_prev, valid, n_c_blocks, out_dtype,
                   a_scales, b_scales, runs, (work_runs, work_steps), path)


@segment_spgemm_op.register_fake
def _spgemm_fake(a_blocks, b_blocks, a_idx, b_idx, c_idx, seg_start,
                 seg_write, accum_prev, valid, a_scales, b_scales, runs,
                 work_runs, work_steps, n_c_blocks, out_dtype, path):
    """What the launch on ``a_blocks``' device allocates: C, and on
    ``"tc"`` its run counter (:func:`launch_allocations`)."""
    device = a_blocks.device
    shape = (n_c_blocks, a_blocks.shape[1], b_blocks.shape[2])
    if device.type != "cuda":
        return [torch.empty(shape, dtype=out_dtype, device=device)]
    path, n_runs = _check_launch(
        a_blocks, b_blocks, a_idx, b_idx, c_idx, seg_start, seg_write,
        accum_prev, valid, out_dtype, a_scales, b_scales, runs,
        (work_runs, work_steps), path)
    return [torch.empty(s, dtype=dt, device=device)
            for s, dt in launch_allocations(n_c_blocks, shape[1:], out_dtype,
                                            path, n_runs)]


def launch_allocations(n_c_blocks: int, tile: Tuple[int, int], out_dtype,
                       path: str, n_runs: int) -> list:
    """``[(shape, dtype), ...]`` of what one launch allocates, C first:
    ``(n_c_blocks, bm, bn)`` in ``out_dtype``, and on ``"tc"`` (with a run
    to take) the one int32 counter its blocks take runs from."""
    allocs = [((n_c_blocks, *tile), out_dtype)]
    if path == "tc" and n_runs:
        allocs.append(((1,), torch.int32))
    return allocs


def _check_launch(a_blocks, b_blocks, a_idx, b_idx, c_idx, seg_start,
                  seg_write, accum_prev, valid, out_dtype, a_scales,
                  b_scales, runs, work, path) -> Tuple[str, int]:
    """Raise what the launch raises on these operands; returns the path it
    takes and its number of owner runs."""
    _, bm, bk = a_blocks.shape
    bn = b_blocks.shape[2]
    device = a_blocks.device
    mode = storage_mode(a_blocks.dtype, b_blocks.dtype,
                        None if a_scales is None else a_scales.ndim,
                        None if b_scales is None else b_scales.ndim)
    if path is None:
        path = choose_path(bm, bk, bn, mode, out_dtype)
    for t in (a_blocks, b_blocks):
        if not t.is_contiguous() or addr(t) % 16:
            raise ValueError("segment_spgemm: a_blocks and b_blocks must be "
                             "contiguous and 16-byte aligned")
    scales = tuple(s for s in (a_scales, b_scales) if s is not None)
    for s in scales:
        if (s.dtype != torch.float32 or not s.is_contiguous()
                or addr(s) % 16):
            raise ValueError("segment_spgemm: scales must be contiguous, "
                             "16-byte aligned fp32")
    sched = (a_idx, b_idx, c_idx, seg_start, seg_write, accum_prev, valid)
    table = (runs,) if path == "simt" else tuple(work or (None, None))
    for t in (b_blocks,) + scales + sched:
        if t.device != device:
            raise ValueError(f"segment_spgemm: all operands must be on "
                             f"{device}, got one on {t.device}")
    for t in sched:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("segment_spgemm: schedule arrays must be "
                             "contiguous int32")
    for t in table:
        if (t is None or t.device != device or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise ValueError(
                f"segment_spgemm: CUDA tensors on {path!r} need the plan's "
                + ("owner-run offsets (plan.run_offsets)" if path == "simt"
                   else "work table (plan.tc_runs, plan.tc_steps)")
                + f" as contiguous int32 on {device}")
    if path == "tc" and (table[1].ndim != 2 or table[1].shape[1] != 5):
        raise ValueError(f"segment_spgemm: work table steps of shape "
                         f"{tuple(table[1].shape)}, expected (n_steps, 5)")
    return path, table[0].shape[0] - 1


def _launch(a_blocks, b_blocks, a_idx, b_idx, c_idx, seg_start, seg_write,
            accum_prev, valid, n_c_blocks, out_dtype, a_scales, b_scales,
            runs, work, path) -> List[torch.Tensor]:
    """One launch: ``[C, *scratch]`` (:func:`launch_allocations`)."""
    path, n_runs = _check_launch(
        a_blocks, b_blocks, a_idx, b_idx, c_idx, seg_start, seg_write,
        accum_prev, valid, out_dtype, a_scales, b_scales, runs, work, path)
    _, bm, bk = a_blocks.shape
    bn = b_blocks.shape[2]
    device = a_blocks.device
    mode = storage_mode(a_blocks.dtype, b_blocks.dtype,
                        None if a_scales is None else a_scales.ndim,
                        None if b_scales is None else b_scales.ndim)
    sched = (a_idx, b_idx, c_idx, seg_start, seg_write, accum_prev, valid)
    out = torch.empty((n_c_blocks, bm, bn), dtype=out_dtype, device=device)
    if n_runs == 0:
        return [out.zero_()]
    a_s = a_scales.data_ptr() if a_scales is not None else None
    b_s = b_scales.data_ptr() if b_scales is not None else None
    stream = torch.cuda.current_stream(device).cuda_stream
    c_bf16 = int(out_dtype == torch.bfloat16)
    if path == "simt":
        lib = _lib()
        rc = lib.segment_spgemm(
            a_blocks.data_ptr(), b_blocks.data_ptr(), out.data_ptr(), a_s,
            b_s, *(t.data_ptr() for t in sched), runs.data_ptr(), n_runs,
            bm, bk, bn, _PAYLOADS[a_blocks.dtype], mode, c_bf16, stream)
        err = lib.segment_spgemm_error_string
        scratch = []
    else:
        run_steps, steps = work
        lib = _lib(_TC_SOURCE)
        # the counter the kernel's blocks take runs from
        next_run = torch.zeros(1, dtype=torch.int32, device=device)
        rc = lib.segment_spgemm_tc(
            a_blocks.data_ptr(), b_blocks.data_ptr(), out.data_ptr(), a_s,
            b_s, run_steps.data_ptr(), steps.data_ptr(), next_run.data_ptr(),
            n_runs, _PAYLOADS[a_blocks.dtype], mode, c_bf16, stream)
        err = lib.segment_spgemm_tc_error_string
        scratch = [next_run]
    if rc != 0:
        raise RuntimeError(f"segment_spgemm ({path}) launch failed: "
                           f"{err(rc).decode()}")
    segment_spgemm.launches += 1
    if mode:
        segment_spgemm.quantized_launches += 1
    if path == "tc":
        segment_spgemm.tc_launches += 1
    else:
        segment_spgemm.simt_launches += 1
    return [out] + scratch


#: Kernel launches since the count was last set to 0 (only
#: :func:`segment_spgemm` on CUDA tensors adds to it) ...
segment_spgemm.launches = 0
#: ... of those, the launches on int8/fp8 payloads ...
segment_spgemm.quantized_launches = 0
#: ... and the launches on each path
segment_spgemm.tc_launches = 0
segment_spgemm.simt_launches = 0
