"""RG-LRU linear recurrence (Griffin / RecurrentGemma): fused gates and
scan, ``h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (σ(x_gate_t) ⊙ x_t)``.

Replaces ``src/repro/kernels/rg_lru.py::rg_lru`` with a CUDA kernel written
for Hopper, ``src/repro_torch/csrc/rg_lru.cu``; the design and its bound
are noted at the top of that source.  :func:`rg_lru` launches the kernel
for CUDA tensors and runs :func:`rg_lru_plain` for CPU tensors.  ``ct``
(the TPU kernel's time chunk) changes no result: it is validated as
``repro`` validates it, so the CPU and the card accept the same calls.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from .ref import softplus

_SOURCE = "rg_lru.cu"
_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rg_lru.argtypes = [p] * 7 + [i] * 3 + [ctypes.c_float, i, p]
        lib.rg_lru.restype = i
        lib.rg_lru_error_string.argtypes = [i]
        lib.rg_lru_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def rg_lru_plain(x, a_gate, x_gate, a_param, h0, *, c: float = 8.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain torch version, in its order of operations: every
    input to fp32 first, the gates for all steps at once, then one step of
    the recurrence per time step.  Returns ``(out in x's dtype, h_T fp32)``."""
    neg_c_sp = -c * softplus(a_param.float())
    a = torch.exp(neg_c_sp * torch.sigmoid(a_gate.float()))
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    xb = beta * (torch.sigmoid(x_gate.float()) * x.float())
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    h = h0.float()
    for t in range(x.shape[1]):
        h = a[:, t] * h + xb[:, t]
        out[:, t] = h
    return out, h


def rg_lru(x, a_gate, x_gate, a_param, h0, *, ct: int = 128, c: float = 8.0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x/a_gate/x_gate: (B, T, D); a_param: (D,); h0: (B, D).

    Returns ``(out (B, T, D) in x's dtype, h_T (B, D) fp32)``.  Raises
    ``repro``'s ``ValueError`` when T is not a multiple of ``min(ct, T)``.
    """
    b, t, d = x.shape
    ct = min(ct, t)
    if t % ct:
        raise ValueError(f"sequence length T={t} must be a multiple of the "
                         f"chunk length ct={ct}")
    device = x.device
    if device.type == "cpu":
        return rg_lru_plain(x, a_gate, x_gate, a_param, h0, c=c)
    if device.type != "cuda":
        raise ValueError(f"rg_lru runs on cuda or cpu tensors, got {device}")
    return _launch(x, a_gate, x_gate, a_param, h0, c)


def _launch(x, a_gate, x_gate, a_param, h0, c):
    b, t, d = x.shape
    device = x.device
    if x.dtype not in _DTYPES or a_gate.dtype != x.dtype \
            or x_gate.dtype != x.dtype:
        raise NotImplementedError(
            f"rg_lru: the CUDA kernel takes x, a_gate and x_gate of one "
            f"dtype out of {_DTYPES}, got {x.dtype}, {a_gate.dtype}, "
            f"{x_gate.dtype}")
    for name, ten, shape in (("a_gate", a_gate, (b, t, d)),
                             ("x_gate", x_gate, (b, t, d)),
                             ("a_param", a_param, (d,)), ("h0", h0, (b, d))):
        if tuple(ten.shape) != shape:
            raise ValueError(f"rg_lru: {name} has shape {tuple(ten.shape)}, "
                             f"expected {shape}")
        if ten.device != device:
            raise ValueError(f"rg_lru: all operands must be on {device}, "
                             f"got {name} on {ten.device}")
    # the small per-channel and per-row operands in fp32 (B*D + D values)
    a_param = a_param.float().contiguous()
    h0 = h0.float().contiguous()
    x, a_gate, x_gate = (v.contiguous() for v in (x, a_gate, x_gate))
    out = torch.empty_like(x)
    h_t = torch.empty((b, d), dtype=torch.float32, device=device)
    lib = _lib()
    rc = lib.rg_lru(x.data_ptr(), a_gate.data_ptr(), x_gate.data_ptr(),
                    a_param.data_ptr(), h0.data_ptr(), out.data_ptr(),
                    h_t.data_ptr(), b, t, d, float(c),
                    int(x.dtype == torch.bfloat16),
                    torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rg_lru launch failed: "
                           f"{lib.rg_lru_error_string(rc).decode()}")
    rg_lru.launches += 1
    return out, h_t


#: Kernel launches since the count was last set to 0 (only :func:`rg_lru`
#: on CUDA tensors adds to it).
rg_lru.launches = 0
