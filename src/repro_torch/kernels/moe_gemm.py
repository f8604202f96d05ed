"""Segment-scheduled grouped expert GEMM (MoE): chunk ``c`` of
``chunk_rows`` expert-sorted token rows times ``w[chunk_expert[c]]``.

Replaces ``src/repro/kernels/moe_gemm.py::moe_gemm`` with a CUDA kernel
written for Hopper, ``src/repro_torch/csrc/moe_gemm.cu``; the design and
its bound are noted at the top of that source.  :func:`moe_gemm` launches
the kernel for CUDA tensors and runs :func:`moe_gemm_plain` for CPU
tensors.  :func:`build_moe_chunks` is ``repro``'s in-graph SELECTA for
MoE (sort tokens by expert, pad each expert's group to whole chunks), in
torch on the tokens' device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

_SOURCE = "moe_gemm.cu"
_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_gemm.argtypes = [p] * 4 + [i] * 8 + [p]
        lib.moe_gemm.restype = i
        lib.moe_gemm_error_string.argtypes = [i]
        lib.moe_gemm_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def moe_gemm_plain(x_sorted, w, chunk_expert, *, chunk_rows: int = 128,
                   out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's plain torch version: one fp32 matmul per run of
    consecutive chunks of one expert, with only that expert's weights cast
    to fp32 (never the whole ``w``)."""
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
    return out


def moe_gemm(x_sorted, w, chunk_expert, *, chunk_rows: int = 128,
             bn: int = 512, out_dtype=torch.float32) -> torch.Tensor:
    """Grouped GEMM over expert-sorted tokens.

    Args:
      x_sorted: (n_chunks * chunk_rows, d_in) tokens sorted by expert and
        padded to whole chunks (invalid rows must be zero).
      w: (E, d_in, d_out) expert weights.
      chunk_expert: (n_chunks,) int32 expert id per chunk.
      bn: the TPU kernel's N tile; validated as ``repro`` does (``d_out``
        must be a multiple of ``min(bn, d_out)``), it changes no result.
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
    if device.type == "cpu":
        return moe_gemm_plain(x_sorted, w, chunk_expert,
                              chunk_rows=chunk_rows, out_dtype=out_dtype)
    if device.type != "cuda":
        raise ValueError(f"moe_gemm runs on cuda or cpu tensors, got "
                         f"{device}")
    return _launch(x_sorted, w, chunk_expert, chunk_rows, out_dtype)


def _launch(x, w, chunk_expert, chunk_rows, out_dtype):
    device = x.device
    n_chunks = chunk_expert.shape[0]
    d_in, d_out = w.shape[1], w.shape[2]
    for name, ten in (("x_sorted", x), ("w", w)):
        if ten.dtype not in _DTYPES:
            raise NotImplementedError(f"moe_gemm: the CUDA kernel takes "
                                      f"{name} in {_DTYPES}, got {ten.dtype}")
    if out_dtype not in _DTYPES:
        raise NotImplementedError(f"moe_gemm: out_dtype must be one of "
                                  f"{_DTYPES}, got {out_dtype}")
    if w.device != device or chunk_expert.device != device:
        raise ValueError(f"moe_gemm: all operands must be on {device}")
    # the kernel reads row-major operands and int32 expert ids: a strided
    # view (a transposed weight, say) or int64 ids are copied, as on the
    # CPU any layout is taken; alignment only picks the vector loads
    x, w = x.contiguous(), w.contiguous()
    chunk_expert = chunk_expert.to(torch.int32).contiguous()
    out = torch.empty((x.shape[0], d_out), dtype=out_dtype, device=device)
    if n_chunks == 0:
        return out
    vec = int(d_in % 4 == 0 and d_out % 4 == 0 and all(
        ten.data_ptr() % 16 == 0 for ten in (x, w, out)))
    lib = _lib()
    rc = lib.moe_gemm(x.data_ptr(), w.data_ptr(), chunk_expert.data_ptr(),
                      out.data_ptr(), n_chunks, chunk_rows, d_in, d_out,
                      int(x.dtype == torch.bfloat16),
                      int(w.dtype == torch.bfloat16),
                      int(out_dtype == torch.bfloat16), vec,
                      torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_gemm launch failed: "
                           f"{lib.moe_gemm_error_string(rc).decode()}")
    moe_gemm.launches += 1
    return out


#: Kernel launches since the count was last set to 0 (only :func:`moe_gemm`
#: on CUDA tensors adds to it).
moe_gemm.launches = 0


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
