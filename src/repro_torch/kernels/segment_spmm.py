"""Segment-scheduled block-sparse × dense matmul: ``C = BSR(A) @ B``, or
``C = BSR(A)ᵀ @ B`` in the ``transpose_lhs`` mode (the backward pass).

Replaces ``src/repro/kernels/segment_spmm.py::segment_spmm`` (forward and
``transpose_lhs`` modes; fp32 blocks, and int8 / fp8-e4m3 payloads with
per-block or rowwise fp32 scales) with three CUDA kernels written for
Hopper; :func:`choose_path` picks one per call, before the launch, from the
shapes, dtypes, strides and alignment alone:

- ``"tc"`` (``csrc/segment_spmm_tc.cu``): 64×64 blocks, bf16 B with TMA's
  16-byte stride and base rule, N ≥ :data:`TC_MIN_N` (prefill and training
  widths).  Each stored tile is split exactly into three bf16 tiles
  (:func:`split_bf16x3`; one for a per-block-scaled payload) and multiplied
  on the tensor cores (``wgmma``), each item's product promoted into an
  fp32 accumulator, under the plan's flags.
- ``"split"`` (``csrc/segment_spmm.cu``, the folded kernel): 64×64 blocks,
  bf16 B, every other N (decode widths).  Each owner run is cut into the
  plan's chunks (:func:`chunk_offsets`), one thread block per (N tile,
  chunk) sums its items on the CUDA cores, and the last block of a run to
  finish adds the chunks' fp32 partials in chunk order and writes C.
- ``"simt"`` (``csrc/segment_spmm.cu``, one thread block per owner run):
  what neither takes, fp32 B and 32×32 blocks.

The designs and their bounds are noted at the top of the two sources.
:func:`segment_spmm` launches the chosen kernel for CUDA tensors and runs
:func:`segment_spmm_plain` for CPU tensors.  It takes the plan's
lane-major schedule arrays as they are, plus the owner-run offsets
(:func:`run_offsets`) and the chunk table (:func:`chunk_offsets`) that the
planner derives once per plan.

In the ``transpose_lhs`` mode the schedule is a backward plan's (the
planner's ``grad_plan``): its ``slot_idx`` addresses the forward weight
storage and each stored tile is contracted along its row axis, so ``dx =
Wᵀ @ dy`` reads the forward blocks with no transposed copy.

B is read by stride: the sparse FFN passes ``x.T`` (and the backward pass
``dy``), transposed views that the kernels read without a copy.  Layouts
without a unit stride raise.

A quantized payload (``a_scales`` given) keeps ``repro``'s order of
operations: rowwise scales dequantize each tile row before the product, a
per-block scale multiplies each item's fp32 product.  The kernels take
scales only beside an int8/fp8 payload and a payload only with its scales;
other pairings raise ``NotImplementedError`` on every device, so the CPU
and the card accept the same calls.

``prefetch="cross_pass"`` is read and changes no result: on the TPU it
only issues the next N-tile pass's first DMA early, and ``repro``'s results
match the drained schedule bit for bit, so these kernels run such a plan as
the drained one, in every mode (forward, ``transpose_lhs``, quantized).
The TPU kernel's fetch flags and ring slots (``a_fetch``/``b_fetch``/
``a_slot``/``b_slot``) and its ``pipeline`` switch describe TPU DMA timing
and change no result; these kernels do not read them.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np
import torch

from . import build
from .fake import addr

_SOURCE = "segment_spmm.cu"
_TC_SOURCE = "segment_spmm_tc.cu"
_TILES = (4, 8, 16, 32)
_SPLIT_TILES = (4, 8, 16)
_BLOCKS = (32, 64)
_B_DTYPES = (torch.float32, torch.bfloat16)
_OUT_DTYPES = (torch.float32, torch.bfloat16)
#: the kernel's payload codes (fp32 blocks, int8, fp8-e4m3)
_PAYLOADS = {torch.float32: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
#: items per chunk of an owner run on the split path: granite-3-8b's FFN
#: runs of 16 and 50 items give 400-448 chunks at N = 4, 3-3.4 thread
#: blocks an SM of the H100's 132, all resident in one wave
CHUNK_ITEMS = 8
#: narrowest N the tensor-core path takes (below it the split path runs):
#: chip_smoke.py's [crossover] on an H100 finds, over granite-3-8b's up,
#: down and up-dx calls, the split path faster in sum at N = 16 and the
#: tensor cores at N = 32 (all three from 64 on)
TC_MIN_N = 32
#: the paths :func:`choose_path` returns
PATHS = ("tc", "split", "simt")


def _lib(source: str = _SOURCE) -> ctypes.CDLL:
    lib = build.load(source)
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if source == _SOURCE:
            lib.segment_spmm.argtypes = [p] * 12 + [i, i, i, ll, ll] + [
                i] * 6 + [p]
            lib.segment_spmm.restype = i
            lib.segment_spmm_split.argtypes = [p] * 14 + [
                i, i, i, ll, ll] + [i] * 4 + [p]
            lib.segment_spmm_split.restype = i
            err = lib.segment_spmm_error_string
        else:
            lib.segment_spmm_tc.argtypes = [p] * 12 + [i, i, i, ll, ll] + [
                i] * 4 + [p]
            lib.segment_spmm_tc.restype = i
            err = lib.segment_spmm_tc_error_string
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
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


def chunk_offsets(runs: np.ndarray, c: int = CHUNK_ITEMS) -> np.ndarray:
    """The split path's chunk table: each owner run (``runs``, from
    :func:`run_offsets`) cut in schedule order into chunks of at most ``c``
    items, the last one shorter.

    Returns ``(n_chunks, 4)`` int32 rows ``(first item, last item + 1,
    index of its run's first chunk, chunks in its run)``: a chunk never
    crosses a run boundary, a run's chunks are consecutive rows that cover
    it in order, and a run of at most ``c`` items is one chunk.
    """
    if c < 1:
        raise ValueError(f"chunk length must be >= 1, got {c}")
    runs = np.asarray(runs, dtype=np.int64).reshape(-1)
    lens = np.diff(runs)
    counts = -(-lens // c)                         # ceil(len / c)
    first = np.concatenate(([0], np.cumsum(counts)[:-1])).astype(np.int64)
    run_of = np.repeat(np.arange(lens.size), counts)
    k = np.arange(run_of.size) - first[run_of]     # chunk index in its run
    lo = runs[:-1][run_of] + k * c
    hi = np.minimum(lo + c, runs[1:][run_of])
    return np.stack([lo, hi, first[run_of], counts[run_of]],
                    axis=1).astype(np.int32).reshape(-1, 4)


def paths_for(b_dtype: torch.dtype, bm: int, bk: int, strides,
              b_ptr: int) -> tuple:
    """The paths whose kernels can take a call, in :data:`PATHS` order.

    The folded and tensor-core kernels are built for 64×64 blocks and bf16
    B; the tensor-core one also needs what TMA needs: a unit stride on one
    of B's axes, the other a multiple of 16 bytes, and a 16-byte-aligned
    base.  The one-block-per-run kernel takes what they do not (fp32 B,
    32×32 blocks).  Every path takes every N, payload, scale mode and
    both modes.  ``strides`` are B's ``(K, N)`` strides in elements.
    """
    if bm != 64 or bk != 64 or b_dtype != torch.bfloat16:
        return ("simt",)
    sbk, sbn = strides
    tma_ok = b_ptr % 16 == 0 and ((sbk == 1 and sbn % 8 == 0)
                                  or (sbn == 1 and sbk % 8 == 0))
    return ("tc", "split") if tma_ok else ("split",)


def choose_path(n: int, b_dtype: torch.dtype, bm: int, bk: int, strides,
                b_ptr: int) -> str:
    """The kernel a CUDA call runs on: ``"tc"`` from N = :data:`TC_MIN_N`
    where the tensor-core kernel can take it, else the first of
    :func:`paths_for` that remains (``"split"`` or ``"simt"``).

    A plain function of N, B's dtype, the block shape, B's strides and base
    address; the payload and the mode do not enter.
    """
    able = paths_for(b_dtype, bm, bk, strides, b_ptr)
    if able[0] == "tc" and n < TC_MIN_N:
        return able[1]
    return able[0]


def split_bf16x3(a: torch.Tensor):
    """The tensor-core path's exact split of fp32 values into three bf16
    values, ``hi = bf16(a)``, ``mid = bf16(a - hi)``, ``lo = bf16(a - hi -
    mid)`` (round to nearest even each time), with ``hi + mid + lo == a``
    exactly: each residual is exact in fp32, ``a - hi`` has at most 16
    significant bits and ``a - hi - mid`` at most 8, and bf16 has fp32's
    exponent range (exact for 2**-103 <= |a| < 2**127 and for 0: below,
    ``lo``'s last bits fall under bf16's subnormal spacing, 2**-133).
    int8 and e4m3 values are exact in bf16, so for them ``mid == lo ==
    0``."""
    a = a.float()
    hi = a.bfloat16()
    r = a - hi.float()
    mid = r.bfloat16()
    lo = (r - mid.float()).bfloat16()
    return hi, mid, lo


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
                       out_dtype=torch.float32,
                       a_scales=None) -> torch.Tensor:
    """The kernel's plain torch version: gather each item's A tile
    (dequantized by its rowwise scales, then transposed in the
    ``transpose_lhs`` mode) and B row-block, one batched fp32 matmul, each
    item's product times its per-block scale, zero the pad items,
    ``index_add_`` into C by block row.  For a planned schedule (every
    owner's segments summed once into its tile) this equals the kernel's
    result up to fp32 summation order; rows no item visits come out zero."""
    slots = slot_idx.long()
    a = a_blocks[slots].float()
    if a_scales is not None and a_scales.ndim == 2:
        a = a * a_scales[slots][:, :, None]
    if transpose_lhs:
        a = a.transpose(1, 2)
    _, out_blk, contract_blk = a.shape
    k_dim, n = b_dense.shape
    b = b_dense.float().reshape(k_dim // contract_blk, contract_blk,
                                n)[k_idx.long()]
    contrib = torch.bmm(a, b)
    if a_scales is not None and a_scales.ndim == 1:
        contrib = contrib * a_scales[slots][:, None, None]
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
                 runs: Optional[torch.Tensor] = None,
                 chunks: Optional[torch.Tensor] = None,
                 path: Optional[str] = None) -> torch.Tensor:
    """``C = BSR(A) @ B`` (or ``BSR(A)ᵀ @ B`` with ``transpose_lhs``) under a
    lane-major Segment schedule.

    Args:
      a_blocks: ``(n_blocks, bm, bk)`` A tiles in BSR storage order (the
        forward storage in both modes): fp32, or an int8 / fp8-e4m3
        payload with ``a_scales``.
      slot_idx/m_idx/k_idx: ``(n_items,)`` int32 per-item block slot and
        block coordinates, lane-major.
      seg_start/seg_write/accum_prev/valid: ``(n_items,)`` int32 flags.
      b_dense: ``(K, N)`` fp32 or bf16, any layout with a unit stride; K
        is a multiple of the contraction block (``bk``, or ``bm`` with
        ``transpose_lhs``).
      grid_m: number of output block rows.
      n_lanes/unroll: the schedule's lane count and unroll (validated).
      bn: widest N tile of the ``"simt"`` path (it picks 4..32).
      transpose_lhs: contract each stored tile along its row axis.
      out_dtype: fp32 or bf16; accumulation is always fp32.
      a_scales: the payload's fp32 scales, ``(n_blocks,)`` (one per block,
        applied to each item's product) or ``(n_blocks, bm)`` (one per
        stored block row, applied to the tile before the product).
      prefetch: ``None`` or ``"cross_pass"`` (a TPU DMA timing: runs as
        the drained schedule).
      runs: the plan's owner-run offsets (:func:`run_offsets`, derived
        once per plan by the planner) on the device; required for CUDA
        tensors, unused by the plain version.
      chunks: the plan's chunk table (:func:`chunk_offsets` of ``runs``)
        on the device; required for CUDA tensors on the split path.
      path: ``None`` (:func:`choose_path` decides) or one of
        :data:`PATHS`, which must be able to take the call; CPU tensors
        run the plain version whatever the path.

    Returns the ``(grid_m*bm, N)`` product (``(grid_m*bk, N)`` with
    ``transpose_lhs``).  Block rows that no item visits are left unwritten
    by the kernels (the executor zeroes them).
    """
    if prefetch not in (None, "cross_pass"):
        raise ValueError(f"prefetch={prefetch!r}: expected None or 'cross_pass'")
    _check_payload(a_blocks, a_scales)
    n_blocks, bm, bk = a_blocks.shape
    if a_scales is not None and tuple(a_scales.shape) not in (
            (n_blocks,), (n_blocks, bm)):
        raise ValueError(
            f"a_scales has shape {tuple(a_scales.shape)}, expected one fp32 "
            f"scale per stored block ({n_blocks},) or per block row "
            f"({n_blocks}, {bm})")
    contract_blk = bm if transpose_lhs else bk
    k_dim, n = b_dense.shape
    if k_dim % contract_blk:
        raise ValueError(f"rhs K={k_dim} is not a multiple of the "
                         f"contraction block {contract_blk}")
    validate_schedule_args(
        seg_start.shape[0], n_lanes, unroll,
        {"slot_idx": slot_idx, "m_idx": m_idx, "k_idx": k_idx,
         "seg_write": seg_write, "accum_prev": accum_prev, "valid": valid})
    if path is not None:
        # checked on every device, so the CPU and the card take the same
        # calls
        if path not in PATHS:
            raise ValueError(f"path={path!r}: expected None or one of "
                             f"{PATHS}")
        able = paths_for(b_dense.dtype, bm, bk, b_dense.stride(),
                         addr(b_dense))
        if path not in able:
            raise ValueError(f"segment_spmm: path={path!r} cannot take this "
                             f"call; it can run on {able}")
    if b_dense.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"segment_spmm runs on cuda or cpu tensors, got "
                         f"{b_dense.device}")
    return segment_spmm_op(a_blocks, a_scales, slot_idx, m_idx, k_idx,
                           seg_start, seg_write, accum_prev, valid, b_dense,
                           runs, chunks, grid_m, bn, transpose_lhs,
                           out_dtype, path)[0]


@torch.library.custom_op("repro_torch::segment_spmm", mutates_args=())
def segment_spmm_op(a_blocks: torch.Tensor, a_scales: Optional[torch.Tensor],
                    slot_idx: torch.Tensor, m_idx: torch.Tensor,
                    k_idx: torch.Tensor, seg_start: torch.Tensor,
                    seg_write: torch.Tensor, accum_prev: torch.Tensor,
                    valid: torch.Tensor, b_dense: torch.Tensor,
                    runs: Optional[torch.Tensor],
                    chunks: Optional[torch.Tensor], grid_m: int, bn: int,
                    transpose_lhs: bool, out_dtype: torch.dtype,
                    path: Optional[str]) -> List[torch.Tensor]:
    """The operator :func:`segment_spmm` calls once its arguments are
    checked: ``[C, *scratch]`` (the split path's fp32 partials).  The
    launch for CUDA tensors, the plain version for CPU tensors, the fake
    rule for fake and meta tensors."""
    raise NotImplementedError(f"segment_spmm has no kernel for "
                              f"{b_dense.device}")


@segment_spmm_op.register_kernel("cpu")
def _spmm_cpu(a_blocks, a_scales, slot_idx, m_idx, k_idx, seg_start,
              seg_write, accum_prev, valid, b_dense, runs, chunks, grid_m,
              bn, transpose_lhs, out_dtype, path):
    return [segment_spmm_plain(a_blocks, slot_idx, m_idx, k_idx, valid,
                               b_dense, grid_m=grid_m,
                               transpose_lhs=transpose_lhs,
                               out_dtype=out_dtype, a_scales=a_scales)]


@segment_spmm_op.register_kernel("cuda")
def _spmm_cuda(a_blocks, a_scales, slot_idx, m_idx, k_idx, seg_start,
               seg_write, accum_prev, valid, b_dense, runs, chunks, grid_m,
               bn, transpose_lhs, out_dtype, path):
    return _launch(a_blocks, a_scales, slot_idx, m_idx, k_idx, seg_start,
                   seg_write, accum_prev, valid, b_dense, grid_m, bn,
                   transpose_lhs, out_dtype, runs, chunks, path)


@segment_spmm_op.register_fake
def _spmm_fake(a_blocks, a_scales, slot_idx, m_idx, k_idx, seg_start,
               seg_write, accum_prev, valid, b_dense, runs, chunks, grid_m,
               bn, transpose_lhs, out_dtype, path):
    """What the launch on ``b_dense``'s device allocates: C, and on the
    split path its partials (:func:`launch_allocations`)."""
    _, bm, _ = a_blocks.shape
    device = b_dense.device
    if device.type != "cuda":
        return [torch.empty((grid_m * bm, b_dense.shape[1]), dtype=out_dtype,
                            device=device)]
    _check_launch(a_blocks, a_scales, slot_idx, m_idx, k_idx, seg_start,
                  seg_write, accum_prev, valid, b_dense, out_dtype, runs,
                  chunks, path)
    return [torch.empty(shape, dtype=dt, device=device)
            for shape, dt in launch_allocations(
                a_blocks, b_dense, grid_m, out_dtype, runs, chunks, path)]


def launch_allocations(a_blocks, b_dense, grid_m, out_dtype, runs, chunks,
                       path):
    """``[(shape, dtype), ...]`` of what one launch allocates, C first:
    ``(grid_m·bm, N)`` in ``out_dtype``, and on the split path the fp32
    partials of every (chunk, N tile).  The arrival counters are one
    persistent int32 buffer a device (at least 16 KB, made by the first
    split launch of the process), not a per-call allocation."""
    _, bm, bk = a_blocks.shape
    n = b_dense.shape[1]
    allocs = [((grid_m * bm, n), out_dtype)]
    n_runs = runs.shape[0] - 1
    if n_runs == 0 or n == 0:
        return allocs
    if path is None:
        path = choose_path(n, b_dense.dtype, bm, bk, b_dense.stride(),
                           addr(b_dense))
    if path == "split":
        tile_n = _split_tile_n(n)
        work = chunks.shape[0] * -(-n // tile_n) * bm * tile_n
        allocs.append(((work,), torch.float32))
    return allocs


def _check_payload(a_blocks, a_scales) -> None:
    """The block dtype and the scales must come as the kernel takes them:
    fp32 blocks alone, or an int8/fp8 payload with its scales."""
    if a_blocks.dtype not in _PAYLOADS:
        raise NotImplementedError(
            f"segment_spmm: blocks must be one of {tuple(_PAYLOADS)}, got "
            f"{a_blocks.dtype}")
    if a_blocks.dtype == torch.float32 and a_scales is not None:
        raise NotImplementedError(
            "segment_spmm: scales go with int8/fp8 payloads only; fp32 "
            "blocks carry their values")
    if a_blocks.dtype != torch.float32 and a_scales is None:
        raise NotImplementedError(
            f"segment_spmm: a {a_blocks.dtype} payload needs its scales "
            f"(a_scales); it is never read as fp32 values")


#: the split kernel's arrival counters, one int32 buffer per device, grown
#: as needed; the last block of a run sets its counter back to 0, so a
#: buffer is zeroed only when it is made.  Launches on one device share it,
#: so they must not run concurrently: the port launches every kernel on
#: the current stream.
_COUNTERS: dict = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1 << 12), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _check_launch(a_blocks, a_scales, slot_idx, m_idx, k_idx, seg_start,
                  seg_write, accum_prev, valid, b_dense, out_dtype, runs,
                  chunks, path) -> str:
    """Raise what the launch raises on these operands; returns the path
    it takes."""
    _, bm, bk = a_blocks.shape
    k_dim, n = b_dense.shape
    device = b_dense.device
    if bm != bk or bm not in _BLOCKS:
        raise NotImplementedError(
            f"segment_spmm: the CUDA kernels take square {_BLOCKS} blocks, "
            f"got {(bm, bk)}")
    if a_scales is not None and (a_scales.dtype != torch.float32
                                 or not a_scales.is_contiguous()):
        raise ValueError(f"segment_spmm: a_scales must be contiguous fp32, "
                         f"got {a_scales.dtype}")
    if b_dense.dtype not in _B_DTYPES or out_dtype not in _OUT_DTYPES:
        raise NotImplementedError(
            f"segment_spmm: B must be one of {_B_DTYPES} and out_dtype one "
            f"of {_OUT_DTYPES}, got {b_dense.dtype} and {out_dtype}")
    sbk, sbn = b_dense.stride()
    if 1 not in (sbk, sbn) and n > 1 and k_dim > 1:
        raise ValueError(
            f"segment_spmm: B needs a unit stride on one axis, got strides "
            f"{(sbk, sbn)}; pass a contiguous tensor or its transpose")
    if not a_blocks.is_contiguous() or addr(a_blocks) % 16:
        raise ValueError("segment_spmm: a_blocks must be contiguous and "
                         "16-byte aligned")
    sched = (slot_idx, m_idx, k_idx, seg_start, seg_write, accum_prev, valid)
    scales = () if a_scales is None else (a_scales,)
    for t in (a_blocks,) + scales + sched:
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
    if path is None:
        path = choose_path(n, b_dense.dtype, bm, bk, (sbk, sbn),
                           addr(b_dense))
    if path == "split" and (chunks is None or chunks.device != device
                            or chunks.dtype != torch.int32
                            or chunks.ndim != 2 or chunks.shape[1] != 4):
        raise ValueError("segment_spmm: the split path needs the plan's "
                         f"chunk table (plan.chunk_offsets) as (n_chunks, 4) "
                         f"int32 on {device}")
    n_runs = runs.shape[0] - 1
    if n_runs > 65535:
        raise ValueError(f"segment_spmm: {n_runs} owner runs exceed the "
                         f"65535 thread-block rows of one launch")
    if path == "split" and chunks.shape[0] > 65535:
        raise ValueError(f"segment_spmm: {chunks.shape[0]} chunks exceed "
                         f"the 65535 thread-block rows of one launch")
    return path


def _launch(a_blocks, a_scales, slot_idx, m_idx, k_idx, seg_start,
            seg_write, accum_prev, valid, b_dense, grid_m, bn, transpose_lhs,
            out_dtype, runs, chunks, path) -> List[torch.Tensor]:
    """One launch: ``[C, *scratch]`` (:func:`launch_allocations`)."""
    path = _check_launch(a_blocks, a_scales, slot_idx, m_idx, k_idx,
                         seg_start, seg_write, accum_prev, valid, b_dense,
                         out_dtype, runs, chunks, path)
    _, bm, bk = a_blocks.shape
    k_dim, n = b_dense.shape
    sbk, sbn = b_dense.stride()
    device = b_dense.device
    sched = (slot_idx, m_idx, k_idx, seg_start, seg_write, accum_prev, valid)
    # square blocks: the output tile has bm rows in either mode
    out = torch.empty((grid_m * bm, n), dtype=out_dtype, device=device)
    n_runs = runs.shape[0] - 1
    if n_runs == 0 or n == 0:
        return [out.zero_()]
    # 1-byte payloads cross as raw bytes (an fp8 tensor as its uint8 view);
    # 0 = no scales, 1 = per block, 2 = per block row
    scale_mode = 0 if a_scales is None else a_scales.ndim
    common = (a_blocks.data_ptr(),
              a_scales.data_ptr() if a_scales is not None else None,
              b_dense.data_ptr(), out.data_ptr(),
              *(t.data_ptr() for t in sched))
    flags = (int(transpose_lhs), _PAYLOADS[a_blocks.dtype], scale_mode)
    c_bf16 = int(out_dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(device).cuda_stream
    if path == "tc":
        lib = _lib(_TC_SOURCE)
        rc = lib.segment_spmm_tc(*common, runs.data_ptr(), n_runs, k_dim, n,
                                 sbk, sbn, *flags, c_bf16, stream)
        err = lib.segment_spmm_tc_error_string
    elif path == "split":
        lib = _lib()
        tile_n = _split_tile_n(n)
        n_chunks = chunks.shape[0]
        n_tiles = -(-n // tile_n)
        # fp32 partials of every (chunk, N tile); the last block of a run
        # to finish adds its run's, in chunk order
        work = torch.empty(n_chunks * n_tiles * bm * tile_n,
                           dtype=torch.float32, device=device)
        counters = _counters(device, n_chunks * n_tiles)
        rc = lib.segment_spmm_split(
            *common, chunks.data_ptr(), work.data_ptr(),
            counters.data_ptr(), n_chunks, n, tile_n, sbk, sbn, *flags,
            c_bf16, stream)
        err = lib.segment_spmm_error_string
    else:
        lib = _lib()
        rc = lib.segment_spmm(
            *common, runs.data_ptr(), n_runs, bm, n, sbk, sbn,
            _tile_n(n, bn), *flags, int(b_dense.dtype == torch.bfloat16),
            c_bf16, stream)
        err = lib.segment_spmm_error_string
    if rc != 0:
        raise RuntimeError(f"segment_spmm ({path}) launch failed: "
                           f"{err(rc).decode()}")
    segment_spmm.launches += 1
    if path == "tc":
        segment_spmm.tensor_core_launches += 1
    elif path == "split":
        segment_spmm.split_launches += 1
    if transpose_lhs:
        segment_spmm.transposed_launches += 1
    if scale_mode:
        segment_spmm.quantized_launches += 1
    return [out] if path != "split" else [out, work]


def _split_tile_n(n: int) -> int:
    """The split path's N tile: N rounded up to 4, 8 or 16 columns."""
    return next((t for t in _SPLIT_TILES if t >= n), _SPLIT_TILES[-1])


#: Kernel launches since the count was last set to 0, on every path and in
#: both modes (only :func:`segment_spmm` on CUDA tensors adds to it) ...
segment_spmm.launches = 0
#: ... of those, the launches on the tensor-core path ...
segment_spmm.tensor_core_launches = 0
#: ... and on the split (folded) path; the rest ran the "simt" kernel ...
segment_spmm.split_launches = 0
#: ... and, on any path, the launches in the ``transpose_lhs`` mode ...
segment_spmm.transposed_launches = 0
#: ... and the launches on int8/fp8 payloads (either mode).
segment_spmm.quantized_launches = 0
