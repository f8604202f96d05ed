"""Segment-scheduled grouped expert GEMM (MoE): chunk ``c`` of
``chunk_rows`` expert-sorted token rows times ``w[chunk_expert[c]]``.

Replaces ``src/repro/kernels/moe_gemm.py::moe_gemm`` with two CUDA kernels
written for Hopper in ``src/repro_torch/csrc/moe_gemm.cu``; the designs and
the bound are noted at the top of that source.  :func:`moe_gemm` picks one
before the launch, by type and shape: bf16 ``x`` and ``w`` with ``d_in``
and ``d_out`` multiples of 8 and 16-byte-aligned bases take the
tensor-core kernel (TMA and ``wgmma``), every other call the SIMT kernel.
It runs :func:`moe_gemm_plain` for CPU tensors, and its fake rule
(:func:`launch_allocations`) for fake and meta ones.  :func:`build_moe_chunks`
is ``repro``'s in-graph SELECTA for MoE (sort tokens by expert, pad each
expert's group to whole chunks), in torch on the tokens' device.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional

import torch

from . import build
from .fake import addr, copies, is_abstract

_SOURCE = "moe_gemm.cu"
_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_gemm.argtypes = [p] * 5 + [i] * 9 + [p]
        lib.moe_gemm.restype = i
        lib.moe_gemm_error_string.argtypes = [i]
        lib.moe_gemm_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def moe_gemm_plain(x_sorted, w, chunk_expert, *, chunk_rows: int = 128,
                   out_dtype=torch.float32, live_rows=None) -> torch.Tensor:
    """The kernel's plain torch version: one fp32 matmul per run of
    consecutive chunks of one expert, with only that expert's weights cast
    to fp32 (never the whole ``w``); with ``live_rows``, the rows of each
    chunk from its count on are zeroed."""
    out = torch.empty((x_sorted.shape[0], w.shape[2]), dtype=out_dtype,
                      device=x_sorted.device)
    experts = chunk_expert.tolist()
    lo = 0
    while lo < len(experts):
        hi = lo
        while hi < len(experts) and experts[hi] == experts[lo]:
            hi += 1
        rows = slice(lo * chunk_rows, hi * chunk_rows)
        out[rows] = x_sorted[rows].float() @ w[experts[lo]].float()
        lo = hi
    if live_rows is not None:
        live = torch.arange(chunk_rows, device=out.device)[None, :] \
            < live_rows.to(out.device)[:, None]
        out = torch.where(live.reshape(-1, 1), out, 0)
    return out


def _check_live_rows(live_rows, n_chunks: int, chunk_rows: int,
                     device) -> None:
    """``live_rows`` is an ``(n_chunks,)`` int32 tensor on the tokens'
    device; on the CPU its counts must lie in ``[0, chunk_rows]`` (on the
    card that check would sync with the host, so the kernel clamps them)."""
    if not isinstance(live_rows, torch.Tensor) \
            or live_rows.dtype != torch.int32:
        got = live_rows.dtype if isinstance(live_rows, torch.Tensor) \
            else type(live_rows).__name__
        raise ValueError(f"live_rows must be an int32 tensor, got {got}")
    if tuple(live_rows.shape) != (n_chunks,):
        raise ValueError(f"live_rows has shape {tuple(live_rows.shape)}, "
                         f"expected one count per chunk ({n_chunks},)")
    if live_rows.device != device:
        raise ValueError(f"live_rows is on {live_rows.device}, the tokens "
                         f"on {device}")
    if device.type == "cpu" and n_chunks and not is_abstract(live_rows) and (
            int(live_rows.min()) < 0 or int(live_rows.max()) > chunk_rows):
        raise ValueError(f"live_rows must lie in [0, chunk_rows="
                         f"{chunk_rows}], got [{int(live_rows.min())}, "
                         f"{int(live_rows.max())}]")


def moe_gemm(x_sorted, w, chunk_expert, *, chunk_rows: int = 128,
             bn: int = 512, out_dtype=torch.float32,
             live_rows=None) -> torch.Tensor:
    """Grouped GEMM over expert-sorted tokens.

    Args:
      x_sorted: (n_chunks * chunk_rows, d_in) tokens sorted by expert and
        padded to whole chunks (invalid rows must be zero).
      w: (E, d_in, d_out) expert weights.
      chunk_expert: (n_chunks,) int32 expert id per chunk.
      bn: the TPU kernel's N tile; validated as ``repro`` does (``d_out``
        must be a multiple of ``min(bn, d_out)``), it changes no result.
      live_rows: ``None`` (every row is computed), or an (n_chunks,) int32
        tensor on the tokens' device: the live rows at the head of each
        chunk.  The rows of a chunk from its count on are written as zeros
        and never multiplied (a tile or 64-row half with no live row reads
        no weight bytes), which is the full product when those rows of
        ``x_sorted`` are zero, as the docstring above asks.
    Returns:
      (n_chunks * chunk_rows, d_out) in ``out_dtype``, in the sorted order.
    """
    t, d_in = x_sorted.shape
    n_chunks = chunk_expert.shape[0]
    if t != n_chunks * chunk_rows:
        raise ValueError(
            f"x_sorted has {t} rows but chunk_expert describes "
            f"{n_chunks} chunks of {chunk_rows} rows — pad the sorted "
            f"tokens to whole chunks")
    e, d_in_w, d_out = w.shape
    if d_in_w != d_in:
        raise ValueError(f"expert weights contract over d_in={d_in_w} but "
                         f"tokens have d_in={d_in}")
    bn = min(bn, d_out)
    if d_out % bn:
        raise ValueError(f"d_out={d_out} must be a multiple of the N tile "
                         f"bn={bn}")
    device = x_sorted.device
    if live_rows is not None:
        _check_live_rows(live_rows, n_chunks, chunk_rows, device)
    if device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"moe_gemm runs on cuda or cpu tensors, got "
                         f"{device}")
    return moe_gemm_op(x_sorted, w, chunk_expert, live_rows, chunk_rows,
                       out_dtype)[0]


@torch.library.custom_op("repro_torch::moe_gemm", mutates_args=())
def moe_gemm_op(x_sorted: torch.Tensor, w: torch.Tensor,
                chunk_expert: torch.Tensor, live_rows: Optional[torch.Tensor],
                chunk_rows: int, out_dtype: torch.dtype) -> List[torch.Tensor]:
    """The operator :func:`moe_gemm` calls once its arguments are checked:
    ``[out, *scratch]`` (the copies the launch makes).  The launch for
    CUDA tensors, the plain version for CPU tensors, the fake rule
    (:func:`launch_allocations`) for fake and meta tensors."""
    raise NotImplementedError(f"moe_gemm has no kernel for "
                              f"{x_sorted.device}")


@moe_gemm_op.register_kernel("cpu")
def _moe_cpu(x_sorted, w, chunk_expert, live_rows, chunk_rows, out_dtype):
    return [moe_gemm_plain(x_sorted, w, chunk_expert, chunk_rows=chunk_rows,
                           out_dtype=out_dtype, live_rows=live_rows)]


@moe_gemm_op.register_kernel("cuda")
def _moe_cuda(x_sorted, w, chunk_expert, live_rows, chunk_rows, out_dtype):
    return _launch(x_sorted, w, chunk_expert, chunk_rows, out_dtype,
                   live_rows)


@moe_gemm_op.register_fake
def _moe_fake(x_sorted, w, chunk_expert, live_rows, chunk_rows, out_dtype):
    if x_sorted.device.type != "cuda":
        return [torch.empty((x_sorted.shape[0], w.shape[2]), dtype=out_dtype,
                            device=x_sorted.device)]
    return launch_allocations(x_sorted, w, chunk_expert, live_rows,
                              out_dtype)[0]


def _operands(x, w, chunk_expert, live_rows, out_dtype):
    """Raise what the launch raises on these operands; returns the
    operands as the kernels read them: row-major, int32 ids (a strided
    view, say a transposed weight, or int64 ids are copied, as on the CPU
    any layout is taken)."""
    device = x.device
    for name, ten in (("x_sorted", x), ("w", w)):
        if ten.dtype not in _DTYPES:
            raise NotImplementedError(f"moe_gemm: the CUDA kernel takes "
                                      f"{name} in {_DTYPES}, got {ten.dtype}")
    if out_dtype not in _DTYPES:
        raise NotImplementedError(f"moe_gemm: out_dtype must be one of "
                                  f"{_DTYPES}, got {out_dtype}")
    if w.device != device or chunk_expert.device != device:
        raise ValueError(f"moe_gemm: all operands must be on {device}")
    if not is_abstract(x):
        return [x.contiguous(), w.contiguous(),
                chunk_expert.to(torch.int32).contiguous(),
                None if live_rows is None else live_rows.contiguous()]
    # fake tensors: a new tensor where the launch makes a copy
    return [None if t is None else
            t if t.is_contiguous() and t.dtype == dt else
            torch.empty(t.shape, dtype=dt, device=device)
            for t, dt in ((x, x.dtype), (w, w.dtype),
                          (chunk_expert, torch.int32),
                          (live_rows, torch.int32))]


def choose_path(x_dtype, w_dtype, d_in: int, d_out: int,
                aligned: bool) -> str:
    """The kernel a CUDA call runs on: ``"tc"`` (tensor cores, TMA and
    ``wgmma``) for bf16 x and w with d_in and d_out multiples of 8 and
    16-byte-aligned bases (TMA's stride and base rule), else ``"simt"``."""
    bf16 = torch.bfloat16
    if x_dtype == bf16 and w_dtype == bf16 and d_in % 8 == 0 \
            and d_out % 8 == 0 and aligned:
        return "tc"
    return "simt"


def launch_allocations(x, w, chunk_expert, live_rows, out_dtype):
    """What one launch allocates, as fake tensors on x's device, and the
    path it takes: ``([out, *copies], path)``.  Both paths allocate the
    same: out, and the copies of operands the kernels cannot read in
    place (not row-major, or int64 expert ids)."""
    xc, wc, ce, lr = _operands(x, w, chunk_expert, live_rows, out_dtype)
    out = torch.empty((x.shape[0], w.shape[2]), dtype=out_dtype,
                      device=x.device)
    path = choose_path(xc.dtype, wc.dtype, w.shape[1], w.shape[2],
                       all(addr(t) % 16 == 0 for t in (xc, wc, out)))
    return ([out] + copies(zip((xc, wc, ce, lr),
                               (x, w, chunk_expert, live_rows))), path)


def _launch(x, w, chunk_expert, chunk_rows, out_dtype, live_rows):
    """One launch: ``[out, *scratch]`` (:func:`launch_allocations`)."""
    device = x.device
    src = (x, w, chunk_expert, live_rows)
    x, w, chunk_expert, live_rows = _operands(*src, out_dtype)
    scratch = copies(zip((x, w, chunk_expert, live_rows), src))
    n_chunks = chunk_expert.shape[0]
    d_in, d_out = w.shape[1], w.shape[2]
    out = torch.empty((x.shape[0], d_out), dtype=out_dtype, device=device)
    if n_chunks == 0:
        return [out] + scratch
    aligned = all(ten.data_ptr() % 16 == 0 for ten in (x, w, out))
    bf16 = torch.bfloat16
    # path 2: the tensor-core kernel; 1 / 0: the SIMT kernel with or
    # without vector loads
    if choose_path(x.dtype, w.dtype, d_in, d_out, aligned) == "tc":
        path = 2
    else:
        path = int(d_in % 4 == 0 and d_out % 4 == 0 and aligned)
    lib = _lib()
    rc = lib.moe_gemm(x.data_ptr(), w.data_ptr(), chunk_expert.data_ptr(),
                      None if live_rows is None else live_rows.data_ptr(),
                      out.data_ptr(), n_chunks, chunk_rows, d_in, d_out,
                      w.shape[0], int(x.dtype == bf16), int(w.dtype == bf16),
                      int(out_dtype == bf16), path,
                      torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_gemm launch failed: "
                           f"{lib.moe_gemm_error_string(rc).decode()}")
    moe_gemm.launches += 1
    if path == 2:
        moe_gemm.tensor_core_launches += 1
    return [out] + scratch


#: Kernel launches since the count was last set to 0 (only :func:`moe_gemm`
#: on CUDA tensors adds to it), either kernel ...
moe_gemm.launches = 0
#: ... and, of those, the launches of the tensor-core kernel.
moe_gemm.tensor_core_launches = 0


def build_moe_chunks(expert_of_token: torch.Tensor, n_experts: int,
                     chunk_rows: int = 128, capacity_factor: float = 1.25):
    """SELECTA for MoE: sort token ids by expert, pad each expert's group to
    whole chunks; returns ``(order, slot, chunk_expert, keep, n_chunks,
    cap_rows)`` as ``repro``'s does, on the tokens' device.

    Shapes depend on T only: ``cap_rows = ceil(T * capacity_factor / E /
    rows) * rows`` per expert and ``n_chunks = E * cap_rows / rows``.
    Overflowing tokens are dropped (``keep`` False, ``slot`` the trash row
    ``E * cap_rows``).  The sort is stable, as ``jnp.argsort``, so the same
    tokens are dropped.
    """
    t = expert_of_token.shape[0]
    device = expert_of_token.device
    cap_rows = int(math.ceil(t * capacity_factor / n_experts / chunk_rows)) \
        * chunk_rows
    chunks_per_e = cap_rows // chunk_rows
    n_chunks = n_experts * chunks_per_e

    order = torch.argsort(expert_of_token, stable=True)
    sorted_e = expert_of_token[order]
    # position of each token within its expert group
    pos_in_e = torch.arange(t, device=device) - torch.searchsorted(
        sorted_e, sorted_e, side="left")
    keep = pos_in_e < cap_rows
    slot = sorted_e.long() * cap_rows + pos_in_e            # destination row
    slot = torch.where(keep, slot, n_experts * cap_rows)    # overflow → trash
    chunk_expert = torch.arange(n_experts, dtype=torch.int32,
                                device=device).repeat_interleave(chunks_per_e)
    return order, slot, chunk_expert, keep, n_chunks, cap_rows
