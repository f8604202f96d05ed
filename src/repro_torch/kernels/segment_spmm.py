"""Segment-scheduled block-sparse × dense matmul: ``C = BSR(A) @ B``, or
``C = BSR(A)ᵀ @ B`` in the ``transpose_lhs`` mode (the backward pass).

Replaces ``src/repro/kernels/segment_spmm.py::segment_spmm`` (forward and
``transpose_lhs`` modes, fp32 blocks) with a CUDA kernel written for Hopper,
``src/repro_torch/csrc/segment_spmm.cu``; the design and its bound are noted
at the top of that source.  :func:`segment_spmm` launches the kernel for
CUDA tensors and runs :func:`segment_spmm_plain` for CPU tensors.  It takes
the plan's lane-major schedule arrays as they are, plus the owner-run
offsets (:func:`run_offsets`) that give the kernel one thread block per
output block row.

In the ``transpose_lhs`` mode the schedule is a backward plan's (the
planner's ``grad_plan``): its ``slot_idx`` addresses the forward weight
storage and each stored tile is contracted along its row axis, so ``dx =
Wᵀ @ dy`` reads the forward blocks with no transposed copy.

B is read by stride: the sparse FFN passes ``x.T`` (and the backward pass
``dy``), transposed views that the kernel reads without a copy.  Layouts
without a unit stride raise.

Not ported yet (ROADMAP): quantized payloads (``a_scales``) and the TPU's
``prefetch="cross_pass"`` DMA timing.  They raise ``NotImplementedError``.
The TPU kernel's fetch flags and ring slots
(``a_fetch``/``b_fetch``/``a_slot``/``b_slot``) and its ``pipeline`` switch
describe TPU DMA timing and change no result; this kernel does not read
them.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import build

_SOURCE = "segment_spmm.cu"
_TILES = (4, 8, 16, 32)
_BLOCKS = (32, 64)
_B_DTYPES = (torch.float32, torch.bfloat16)
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.segment_spmm.argtypes = [p] * 11 + [i, i, i, ll, ll, i, i, i, i,
                                                p]
        lib.segment_spmm.restype = i
        lib.segment_spmm_error_string.argtypes = [i]
        lib.segment_spmm_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def run_offsets(m_idx: np.ndarray, n_lanes: int) -> np.ndarray:
    """Offsets of the owner runs in a lane-major schedule: a run starts at
    every lane start and wherever the output block row changes.

    Returns ``(n_runs + 1,)`` int32.  Raises ``ValueError`` when a block row
    appears in two runs: two thread blocks would then race on its C tile.
    The planner keeps every owner in one contiguous run
    (``core.schedule.partition_lanes``), so planned schedules never raise.
    """
    m = np.asarray(m_idx).reshape(-1)
    n = m.size
    if n == 0:
        return np.zeros(1, dtype=np.int32)
    if n % n_lanes:
        raise ValueError(f"n_items={n} is not divisible by n_lanes={n_lanes}")
    start = np.ones(n, dtype=bool)
    start[1:] = m[1:] != m[:-1]
    start[::n // n_lanes] = True
    starts = np.nonzero(start)[0]
    if np.unique(m[starts]).size != starts.size:
        raise ValueError(
            "an output block row appears in two non-contiguous runs of the "
            "schedule; the CUDA kernel gives each run its own thread block, "
            "which would race on that row's C tile")
    return np.append(starts, n).astype(np.int32)


def validate_schedule_args(n_items, n_lanes, unroll, arrays):
    """Schedule-array shape checks shared with ``repro``'s kernel."""
    for name, arr in arrays.items():
        if arr is None:
            continue
        if tuple(arr.shape) != (n_items,):
            raise ValueError(
                f"{name} has shape {tuple(arr.shape)}, expected ({n_items},) "
                f"to match the schedule's n_items (seg_start length)")
    if n_items % n_lanes != 0:
        raise ValueError(f"n_items={n_items} is not divisible by "
                         f"n_lanes={n_lanes}; lanes must be equal length "
                         f"(pad via partition_lanes)")
    if (n_items // n_lanes) % unroll != 0:
        raise ValueError(f"lane length {n_items // n_lanes} is not divisible "
                         f"by unroll={unroll}")


def _tile_n(n: int, bn: int) -> int:
    """Widest supported N tile that is no wider than ``bn`` and than N
    rounded up to a power of two."""
    cap = min(bn, 1 << max(0, (n - 1).bit_length()))
    return max([t for t in _TILES if t <= cap] or [_TILES[0]])


def segment_spmm_plain(a_blocks, slot_idx, m_idx, k_idx, valid, b_dense, *,
                       grid_m: int, transpose_lhs: bool = False,
                       out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's plain torch version: gather each item's A tile
    (transposed in the ``transpose_lhs`` mode) and B row-block, one batched
    fp32 matmul, zero the pad items, ``index_add_`` into C by block row.
    For a planned schedule (every owner's segments summed once into its
    tile) this equals the kernel's result up to fp32 summation order; rows
    no item visits come out zero."""
    a = a_blocks[slot_idx.long()].float()
    if transpose_lhs:
        a = a.transpose(1, 2)
    _, out_blk, contract_blk = a.shape
    k_dim, n = b_dense.shape
    b = b_dense.float().reshape(k_dim // contract_blk, contract_blk,
                                n)[k_idx.long()]
    contrib = torch.bmm(a, b)
    contrib = torch.where(valid.bool()[:, None, None], contrib, 0.0)
    out = torch.zeros((grid_m, out_blk, n), dtype=torch.float32,
                      device=b_dense.device)
    out.index_add_(0, m_idx.long(), contrib)
    return out.reshape(grid_m * out_blk, n).to(out_dtype)


def segment_spmm(a_blocks, slot_idx, m_idx, k_idx, seg_start, seg_write,
                 accum_prev, valid, b_dense, *, grid_m: int, n_lanes: int = 1,
                 bn: int = 512, unroll: int = 1, transpose_lhs: bool = False,
                 out_dtype=torch.float32, a_scales=None,
                 prefetch: Optional[str] = None,
                 runs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``C = BSR(A) @ B`` (or ``BSR(A)ᵀ @ B`` with ``transpose_lhs``) under a
    lane-major Segment schedule.

    Args:
      a_blocks: ``(n_blocks, bm, bk)`` fp32 A tiles in BSR storage order
        (the forward storage in both modes).
      slot_idx/m_idx/k_idx: ``(n_items,)`` int32 per-item block slot and
        block coordinates, lane-major.
      seg_start/seg_write/accum_prev/valid: ``(n_items,)`` int32 flags.
      b_dense: ``(K, N)`` fp32 or bf16, any layout with a unit stride; K
        is a multiple of the contraction block (``bk``, or ``bm`` with
        ``transpose_lhs``).
      grid_m: number of output block rows.
      n_lanes/unroll: the schedule's lane count and unroll (validated).
      bn: widest N tile to use (the kernel picks 4..32).
      transpose_lhs: contract each stored tile along its row axis.
      out_dtype: fp32 or bf16; accumulation is always fp32.
      runs: the plan's owner-run offsets (:func:`run_offsets`, derived
        once per plan by the planner) on the device; required for CUDA
        tensors, unused by the plain version.

    Returns the ``(grid_m*bm, N)`` product (``(grid_m*bk, N)`` with
    ``transpose_lhs``).  Block rows that no item visits are left unwritten
    by the kernel (the executor zeroes them).
    """
    if a_scales is not None:
        raise NotImplementedError(
            "segment_spmm: quantized payloads are not ported yet; see "
            "ROADMAP 'quantized serving'")
    if prefetch not in (None, "cross_pass"):
        raise ValueError(f"prefetch={prefetch!r}: expected None or 'cross_pass'")
    if prefetch is not None:
        raise NotImplementedError(
            "segment_spmm: prefetch='cross_pass' is a TPU DMA-timing mode "
            "with identical results; plan without it")
    _, bm, bk = a_blocks.shape
    contract_blk = bm if transpose_lhs else bk
    k_dim, n = b_dense.shape
    if k_dim % contract_blk:
        raise ValueError(f"rhs K={k_dim} is not a multiple of the "
                         f"contraction block {contract_blk}")
    validate_schedule_args(
        seg_start.shape[0], n_lanes, unroll,
        {"slot_idx": slot_idx, "m_idx": m_idx, "k_idx": k_idx,
         "seg_write": seg_write, "accum_prev": accum_prev, "valid": valid})
    if b_dense.device.type == "cpu":
        return segment_spmm_plain(a_blocks, slot_idx, m_idx, k_idx, valid,
                                  b_dense, grid_m=grid_m,
                                  transpose_lhs=transpose_lhs,
                                  out_dtype=out_dtype)
    if b_dense.device.type != "cuda":
        raise ValueError(f"segment_spmm runs on cuda or cpu tensors, got "
                         f"{b_dense.device}")
    return _launch(a_blocks, slot_idx, m_idx, k_idx, seg_start, seg_write,
                   accum_prev, valid, b_dense, grid_m, bn, transpose_lhs,
                   out_dtype, runs)


def _launch(a_blocks, slot_idx, m_idx, k_idx, seg_start, seg_write,
            accum_prev, valid, b_dense, grid_m, bn, transpose_lhs, out_dtype,
            runs) -> torch.Tensor:
    _, bm, bk = a_blocks.shape
    k_dim, n = b_dense.shape
    device = b_dense.device
    if bm != bk or bm not in _BLOCKS:
        raise NotImplementedError(
            f"segment_spmm: the CUDA kernel takes square {_BLOCKS} blocks, "
            f"got {(bm, bk)}")
    if a_blocks.dtype != torch.float32:
        raise NotImplementedError(
            f"segment_spmm: the CUDA kernel takes fp32 blocks, got "
            f"{a_blocks.dtype}")
    if b_dense.dtype not in _B_DTYPES or out_dtype not in _OUT_DTYPES:
        raise NotImplementedError(
            f"segment_spmm: B must be one of {_B_DTYPES} and out_dtype one "
            f"of {_OUT_DTYPES}, got {b_dense.dtype} and {out_dtype}")
    sbk, sbn = b_dense.stride()
    if 1 not in (sbk, sbn) and n > 1 and k_dim > 1:
        raise ValueError(
            f"segment_spmm: B needs a unit stride on one axis, got strides "
            f"{(sbk, sbn)}; pass a contiguous tensor or its transpose")
    if not a_blocks.is_contiguous() or a_blocks.data_ptr() % 16:
        raise ValueError("segment_spmm: a_blocks must be contiguous and "
                         "16-byte aligned")
    sched = (slot_idx, m_idx, k_idx, seg_start, seg_write, accum_prev, valid)
    for t in (a_blocks,) + sched:
        if t.device != device:
            raise ValueError(f"segment_spmm: all operands must be on "
                             f"{device}, got one on {t.device}")
    for t in sched:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("segment_spmm: schedule arrays must be "
                             "contiguous int32")
    if runs is None or runs.device != device or runs.dtype != torch.int32:
        raise ValueError("segment_spmm: CUDA tensors need the plan's owner-"
                         f"run offsets (plan.run_offsets) as int32 on {device}")
    # square blocks: the output tile has bm rows in either mode
    out = torch.empty((grid_m * bm, n), dtype=out_dtype, device=device)
    n_runs = runs.shape[0] - 1
    if n_runs == 0 or n == 0:
        return out.zero_()
    if n_runs > 65535:
        raise ValueError(f"segment_spmm: {n_runs} owner runs exceed the "
                         f"65535 thread-block rows of one launch")
    lib = _lib()
    rc = lib.segment_spmm(
        a_blocks.data_ptr(), b_dense.data_ptr(), out.data_ptr(),
        *(t.data_ptr() for t in sched), runs.data_ptr(), n_runs, bm, n,
        sbk, sbn, _tile_n(n, bn), int(transpose_lhs),
        int(b_dense.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_spmm launch failed: "
                           f"{lib.segment_spmm_error_string(rc).decode()}")
    segment_spmm.launches += 1
    if transpose_lhs:
        segment_spmm.transposed_launches += 1
    return out


#: Kernel launches since the count was last set to 0, in both modes (only
#: :func:`segment_spmm` on CUDA tensors adds to it) ...
segment_spmm.launches = 0
#: ... and, of those, the launches in the ``transpose_lhs`` mode.
segment_spmm.transposed_launches = 0
