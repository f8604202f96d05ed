"""RG-LRU linear recurrence (Griffin / RecurrentGemma): fused gates and
scan, ``h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (σ(x_gate_t) ⊙ x_t)``.

Replaces ``src/repro/kernels/rg_lru.py::rg_lru`` with CUDA kernels written
for Hopper, ``src/repro_torch/csrc/rg_lru.cu`` (the design and its bound are
noted at the top of that source), on two paths that :func:`choose_path`
picks per call from the shapes:

- ``"tile"``: T of :data:`TILE_MIN_T` steps or more, and a D whose rows are
  a multiple of 16 bytes in every operand's dtype (TMA).  One block a
  (batch row, tile of :func:`tile_channels` channels) walks T in tiles of
  ``TILE_ELEMS // Dt`` steps: TMA loads, the gates computed by two
  warpgroups, one scan warp that walks the steps in order.
- ``"simt"``: the rest (decode, short T, other D): one thread a (batch
  row, channel) carries h over all of T.

Both run one gate function and the fused step ``fma(a, h, xb)`` in the
same order, so they agree bit for bit.  :func:`rg_lru` launches the chosen
kernel for CUDA tensors and runs :func:`rg_lru_plain` for CPU tensors.
x, a_gate and x_gate may each be fp32, bf16 or fp16 (each is read in its
own dtype and converted to fp32, as ``repro`` casts each); out is in x's
dtype, h_T in fp32.  ``ct`` (the TPU kernel's time chunk) changes no
result: it is validated as ``repro`` validates it, so the CPU and the
card accept the same calls.

Gradients: when autograd records a call (grad mode on and an operand that
requires grad), :func:`rg_lru` runs through :class:`RGLRUFunction`.  Its
forward launches the same kernel with x in fp32, so that ``out`` is the
recurrence's fp32 h bit for bit (the kernel converts x to fp32 on load
either way), keeps that h for the backward and returns it in x's dtype.
Its backward is :func:`rg_lru_bwd`: the kernels of
``src/repro_torch/csrc/rg_lru_bwd.cu`` for CUDA tensors (no Pallas kernel
has them: ``repro`` takes ``jax.grad`` of its ``lax.scan``), the explicit
reverse walk :func:`rg_lru_bwd_plain` for CPU tensors.  The backward has
two paths, which :func:`choose_bwd_path` picks: ``"tile"`` (TMA-fed tiles
walked last to first, gate warps and one chain warp) wherever TMA can read
the rows, ``"simt"`` for the rest.  They agree bit for bit but for
``da_param``, the same sum taken in another order.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from . import build
from .fake import aligned_like, copies
from .flash_attention import _aligned, _sms
from .ref import softplus

_SOURCE = "rg_lru.cu"
_BWD_SOURCE = "rg_lru_bwd.cu"
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PATH_CODE = {"simt": 0, "tile": 1}

#: the CUDA paths, in the order :func:`choose_path` prefers them
PATHS = ("tile", "simt")
#: the card's streaming multiprocessors (H100 SXM), the default of the
#: dispatch functions; the wrapper passes the device's own count
SMS = 132
#: elements of one ``"tile"`` tile: L time steps x Dt channels
TILE_ELEMS = 1024
#: ``"tile"`` takes calls of at least this many steps (set by chip_smoke.py's
#: [rg_lru-crossover] sweep: at B = 4, D = 4096 ``"simt"`` won at T = 1,
#: 0.0024 against 0.0051 ms, and ``"tile"`` from T = 16, 0.0052 against
#: 0.0054 ms)
TILE_MIN_T = 16


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rg_lru.argtypes = [p] * 7 + [i] * 3 + [ctypes.c_float] + \
            [i] * 5 + [p]
        lib.rg_lru.restype = i
        lib.rg_lru_error_string.argtypes = [i]
        lib.rg_lru_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load(_BWD_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rg_lru_bwd.argtypes = [p] * 14 + [i] * 3 + [ctypes.c_float] + \
            [i] * 5 + [p]
        lib.rg_lru_bwd.restype = i
        lib.rg_lru_bwd_error_string.argtypes = [i]
        lib.rg_lru_bwd_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def tile_channels(b: int, d: int, sms: int = SMS) -> int:
    """Dt, the channels of one ``"tile"`` block: 32 where the grid of (batch
    row, channel tile) blocks still holds twice as many blocks as SMs, else
    16 (a single request at D = 4096: 256 blocks)."""
    return 32 if b * -(-d // 32) >= 2 * sms else 16


def paths_for(d: int, dtypes=()) -> tuple:
    """The CUDA paths that can take a call, in :data:`PATHS` order; empty
    when an operand dtype is not fp32, bf16 or fp16.  ``"tile"`` needs rows
    of D elements that are a multiple of 16 bytes in each of ``dtypes``
    (x, a_gate, x_gate; out takes x's): TMA's row stride."""
    if any(dt not in _DTYPES for dt in dtypes):
        return ()
    tile = all(d * dt.itemsize % 16 == 0 for dt in dtypes)
    return ("tile", "simt") if tile else ("simt",)


def choose_path(b: int, t: int, d: int, x_dtype=torch.float32,
                a_dtype=torch.float32, g_dtype=torch.float32
                ) -> Optional[str]:
    """The kernel a CUDA call runs on (``None`` when no path takes it):
    ``"tile"`` from :data:`TILE_MIN_T` steps where TMA can read the rows,
    else ``"simt"``.  A plain function of the shapes (the dtypes decide
    only whether a path can take the call)."""
    able = paths_for(d, (x_dtype, a_dtype, g_dtype))
    if not able:
        return None
    return "tile" if "tile" in able and t >= TILE_MIN_T else "simt"


def choose_bwd_path(d: int, dtypes=()) -> Optional[str]:
    """The backward kernel a CUDA call runs on (``None`` when no path takes
    it): the first of :func:`paths_for`'s, ``"tile"`` wherever TMA can
    read the rows (dout takes x's dtype, and the forward's fp32 h has rows
    of 4 D bytes, a multiple of 16 wherever x's rows are), at any T
    (chip_smoke.py's short ragged call runs faster on it too: PERF.md
    row 5b)."""
    able = paths_for(d, dtypes)
    return able[0] if able else None


def rg_lru_gates(x, a_gate, x_gate, neg_c_sp):
    """The gate function on fp32 values: ``(a, xb)`` with ``a = exp(neg_c_sp
    * σ(a_gate))`` and ``xb = sqrt(max(1 - a², 1e-12)) * (σ(x_gate) * x)``;
    ``neg_c_sp`` is ``-c * softplus(a_param)`` per channel."""
    a = torch.exp(neg_c_sp * torch.sigmoid(a_gate))
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * (torch.sigmoid(x_gate) * x)


def rg_lru_plain(x, a_gate, x_gate, a_param, h0, *, c: float = 8.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' plain torch version, in their order of operations: every
    input to fp32 first, the gates for all steps at once, then one step of
    the recurrence per time step.  Returns ``(out in x's dtype, h_T fp32)``."""
    neg_c_sp = -c * softplus(a_param.float())
    a, xb = rg_lru_gates(x.float(), a_gate.float(), x_gate.float(), neg_c_sp)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    h = h0.float()
    for t in range(x.shape[1]):
        h = a[:, t] * h + xb[:, t]
        out[:, t] = h
    return out, h


def rg_lru(x, a_gate, x_gate, a_param, h0, *, ct: int = 128, c: float = 8.0,
           path: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x/a_gate/x_gate: (B, T, D); a_param: (D,); h0: (B, D).

    Returns ``(out (B, T, D) in x's dtype, h_T (B, D) fp32)``.  Raises
    ``repro``'s ``ValueError`` when T is not a multiple of ``min(ct, T)``.
    ``path`` forces one of :func:`paths_for`'s paths on the card (checked on
    every device; the CPU runs the plain version whatever the path);
    ``None`` takes :func:`choose_path`'s.
    """
    b, t, d = x.shape
    ct = min(ct, t)
    if t % ct:
        raise ValueError(f"sequence length T={t} must be a multiple of the "
                         f"chunk length ct={ct}")
    if path is not None:
        able = paths_for(d, (x.dtype, a_gate.dtype, x_gate.dtype))
        if path not in able:
            raise ValueError(f"rg_lru: path={path!r} cannot take this call; "
                             f"paths that can: {able}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"rg_lru runs on cuda or cpu tensors, got "
                         f"{x.device}")
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (x, a_gate, x_gate, a_param, h0)):
        return RGLRUFunction.apply(x, a_gate, x_gate, a_param, h0, c, path)
    return _forward(x, a_gate, x_gate, a_param, h0, c, path)


def _forward(x, a_gate, x_gate, a_param, h0, c, path):
    res = rg_lru_op(x, a_gate, x_gate, a_param, h0, c, path)
    return res[0], res[1]


@torch.library.custom_op("repro_torch::rg_lru", mutates_args=())
def rg_lru_op(x: torch.Tensor, a_gate: torch.Tensor, x_gate: torch.Tensor,
              a_param: torch.Tensor, h0: torch.Tensor, c: float,
              path: Optional[str]) -> List[torch.Tensor]:
    """The operator :func:`rg_lru` calls: ``[out, h_T, *scratch]``.  The
    launch for CUDA tensors, the plain version for CPU tensors, the fake
    rule (:func:`launch_allocations`) for fake and meta tensors."""
    raise NotImplementedError(f"rg_lru has no kernel for {x.device}")


@rg_lru_op.register_kernel("cpu")
def _fwd_cpu(x, a_gate, x_gate, a_param, h0, c, path):
    return list(rg_lru_plain(x, a_gate, x_gate, a_param, h0, c=c))


@rg_lru_op.register_kernel("cuda")
def _fwd_cuda(x, a_gate, x_gate, a_param, h0, c, path):
    return _launch(x, a_gate, x_gate, a_param, h0, c, path)


@rg_lru_op.register_fake
def _fwd_fake(x, a_gate, x_gate, a_param, h0, c, path):
    b, _, d = x.shape
    if x.device.type != "cuda":
        return [torch.empty(x.shape, dtype=x.dtype, device=x.device),
                torch.empty((b, d), dtype=torch.float32, device=x.device)]
    return launch_allocations(x, a_gate, x_gate, a_param, h0, path)


def _small_like(t: torch.Tensor) -> torch.Tensor:
    """The fake counterpart of ``t.float().contiguous()``."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return torch.empty(t.shape, dtype=torch.float32, device=t.device)


def launch_allocations(x, a_gate, x_gate, a_param, h0, path):
    """What one forward launch on the card allocates, as fake tensors on
    x's device: out and h_T, then the copies it makes (a_param and h0 when
    not contiguous fp32; x, a_gate, x_gate when not contiguous and 16-byte
    aligned)."""
    _check_launch(x, a_gate, x_gate, a_param, h0, path)
    b, _, d = x.shape
    small = [_small_like(t) for t in (a_param, h0)]
    big = [aligned_like(t) for t in (x, a_gate, x_gate)]
    return ([torch.empty(x.shape, dtype=x.dtype, device=x.device),
             torch.empty((b, d), dtype=torch.float32, device=x.device)]
            + copies(zip(small, (a_param, h0)))
            + copies(zip(big, (x, a_gate, x_gate))))


class RGLRUFunction(torch.autograd.Function):
    """:func:`rg_lru` under autograd: the forward kernel (or plain version)
    run with x in fp32, so its ``out`` is the fp32 h the backward needs (the
    same h as a call with x in its own dtype: the kernel converts x to fp32
    on load), and :func:`rg_lru_bwd` for the backward.  ``out`` is returned
    in x's dtype, ``h_T`` in fp32."""

    @staticmethod
    def forward(ctx, x, a_gate, x_gate, a_param, h0, c, path):
        hs, h_t = _forward(x.float(), a_gate, x_gate, a_param, h0, c, path)
        ctx.save_for_backward(x, a_gate, x_gate, a_param, h0, hs)
        ctx.c = c
        return hs.to(x.dtype), h_t

    @staticmethod
    def backward(ctx, dout, dh_t):
        x, a_gate, x_gate, a_param, h0, hs = ctx.saved_tensors
        b, t, d = x.shape
        if dout is None:
            dout = torch.zeros_like(x)
        if dh_t is None:
            dh_t = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        dx, dag, dxg, dp, dh0 = rg_lru_bwd(x, a_gate, x_gate, a_param, h0, hs,
                                           dout, dh_t, c=ctx.c)
        return (dx, dag, dxg, dp.to(a_param.dtype), dh0.to(h0.dtype), None,
                None)


def rg_lru_bwd_gates(a_gate, x_gate, neg_c_sp):
    """The backward's gate values on fp32 inputs: ``(s, a, i)`` with ``s =
    σ(a_gate)``, ``a = exp(neg_c_sp * s)``, ``i = σ(x_gate)``."""
    sg = torch.sigmoid(a_gate)
    return sg, torch.exp(neg_c_sp * sg), torch.sigmoid(x_gate)


def rg_lru_bwd_elems(g, x, sg, a, ig, hprev, neg_c_sp):
    """Each element's gradients from its ``g`` (the reverse chain's value),
    ``x``, the gates and ``h_{t-1}``, all fp32: ``(dx, dx_gate, da_gate,
    das)``, ``das`` the element's ``da_param`` term ``dA a s``.  Through
    ``max(1 - a², 1e-12)`` the derivative is 0 on the clamped side, as
    ``jax.grad`` gives it."""
    one_m = 1.0 - a * a
    beta = torch.sqrt(torch.clamp(one_m, min=1e-12))
    dbeta = torch.where(one_m > 1e-12, -a / beta, torch.zeros_like(a))
    d_a = g * hprev + g * ig * x * dbeta
    das = d_a * a * sg
    dx = g * beta * ig
    dxg = g * beta * x * ig * (1.0 - ig)
    dag = das * neg_c_sp * (1.0 - sg)
    return dx, dxg, dag, das


def rg_lru_bwd_plain(x, a_gate, x_gate, a_param, h0, hs, dout, dh_t, *,
                     c: float = 8.0):
    """The backward kernels' plain torch version, all in fp32: the gates
    again (:func:`rg_lru_bwd_gates`), then an explicit reverse walk ``g_t =
    dout_t + a_{t+1} g_{t+1}`` (``g_{T-1} = dout_{T-1} + dh_T``), then each
    element's gradient from g, the forward's fp32 h (``hs``) and the gates
    (:func:`rg_lru_bwd_elems`).  ``da_param`` is summed over T per (batch
    row, channel), then over the rows in order.  Returns ``(dx in x's
    dtype, da_gate in a_gate's, dx_gate in x_gate's, da_param (D,) fp32,
    dh0 (B, D) fp32)``."""
    p = a_param.float()
    neg_c_sp = -c * softplus(p)
    xf = x.float()
    sg, a, ig = rg_lru_bwd_gates(a_gate.float(), x_gate.float(), neg_c_sp)
    hprev = torch.cat([h0.float()[:, None], hs[:, :-1].float()], dim=1)
    do = dout.float()
    g = torch.empty_like(xf)
    carry = dh_t.float()
    for t in reversed(range(x.shape[1])):
        g[:, t] = do[:, t] + carry
        carry = a[:, t] * g[:, t]
    dx, dxg, dag, das = rg_lru_bwd_elems(g, xf, sg, a, ig, hprev, neg_c_sp)
    dp = -c * torch.sigmoid(p) * das.sum(dim=1).sum(dim=0)
    return (dx.to(x.dtype), dag.to(a_gate.dtype), dxg.to(x_gate.dtype), dp,
            carry)


def rg_lru_bwd(x, a_gate, x_gate, a_param, h0, hs, dout, dh_t, *,
               c: float = 8.0, path: Optional[str] = None):
    """Gradients of :func:`rg_lru` given the forward's fp32 h (``hs``, (B,
    T, D)), ``dout`` (B, T, D) and ``dh_t`` (B, D): ``(dx in x's dtype,
    da_gate in a_gate's, dx_gate in x_gate's, da_param (D,) fp32, dh0 (B,
    D) fp32)``.  The kernels of ``csrc/rg_lru_bwd.cu`` for CUDA tensors, on
    ``path`` (one of :func:`paths_for`'s, checked on every device;
    ``None`` takes :func:`choose_bwd_path`'s), counted in
    ``rg_lru_bwd.launches`` and the path's ``tile_launches`` /
    ``simt_launches``; :func:`rg_lru_bwd_plain` for CPU tensors."""
    if path is not None:
        able = paths_for(x.shape[-1], (x.dtype, a_gate.dtype, x_gate.dtype))
        if path not in able:
            raise ValueError(f"rg_lru_bwd: path={path!r} cannot take this "
                             f"call; paths that can: {able}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"rg_lru_bwd runs on cuda or cpu tensors, got "
                         f"{x.device}")
    res = rg_lru_bwd_op(x, a_gate, x_gate, a_param, h0, hs, dout, dh_t, c,
                        path)
    return tuple(res[:5])


@torch.library.custom_op("repro_torch::rg_lru_bwd", mutates_args=())
def rg_lru_bwd_op(x: torch.Tensor, a_gate: torch.Tensor,
                  x_gate: torch.Tensor, a_param: torch.Tensor,
                  h0: torch.Tensor, hs: torch.Tensor, dout: torch.Tensor,
                  dh_t: torch.Tensor, c: float, path: Optional[str]
                  ) -> List[torch.Tensor]:
    """The operator :func:`rg_lru_bwd` calls: ``[dx, da_gate, dx_gate,
    da_param, dh0, *scratch]``.  The launch for CUDA tensors, the plain
    version for CPU tensors, the fake rule
    (:func:`bwd_launch_allocations`) for fake and meta tensors."""
    raise NotImplementedError(f"rg_lru_bwd has no kernel for {x.device}")


@rg_lru_bwd_op.register_kernel("cpu")
def _bwd_cpu(x, a_gate, x_gate, a_param, h0, hs, dout, dh_t, c, path):
    return list(rg_lru_bwd_plain(x, a_gate, x_gate, a_param, h0, hs, dout,
                                 dh_t, c=c))


@rg_lru_bwd_op.register_kernel("cuda")
def _bwd_cuda(x, a_gate, x_gate, a_param, h0, hs, dout, dh_t, c, path):
    return _bwd_launch(x, a_gate, x_gate, a_param, h0, hs, dout, dh_t, c,
                       path)


@rg_lru_bwd_op.register_fake
def _bwd_fake(x, a_gate, x_gate, a_param, h0, hs, dout, dh_t, c, path):
    if x.device.type == "cuda":
        return bwd_launch_allocations(x, a_gate, x_gate, a_param, h0, hs,
                                      dout, dh_t, path)
    b, _, d = x.shape
    return ([torch.empty(t.shape, dtype=t.dtype, device=t.device)
             for t in (x, a_gate, x_gate)]
            + [torch.empty((d,), dtype=torch.float32, device=x.device),
               torch.empty((b, d), dtype=torch.float32, device=x.device)])


def bwd_launch_allocations(x, a_gate, x_gate, a_param, h0, hs, dout, dh_t,
                           path):
    """What one backward launch on the card allocates, as fake tensors on
    x's device: dx, da_gate, dx_gate, da_param and dh0, the copies it
    makes of its operands (dout in x's dtype, hs in fp32, each contiguous
    and aligned; h0, dh_t and a_param contiguous fp32), and the fp32
    per-row partials of da_param."""
    _check_bwd_launch(x, a_gate, x_gate, a_param, h0, hs, dout, dh_t, path)
    b, _, d = x.shape
    big = [aligned_like(t) for t in (x, a_gate, x_gate)]
    d_cast = (dout if dout.dtype == x.dtype else
              torch.empty(dout.shape, dtype=x.dtype, device=x.device))
    h_cast = (hs if hs.dtype == torch.float32 else
              torch.empty(hs.shape, dtype=torch.float32, device=x.device))
    d_al, h_al = aligned_like(d_cast), aligned_like(h_cast)
    small = [_small_like(t) for t in (h0, dh_t, a_param)]
    res = [torch.empty(t.shape, dtype=t.dtype, device=x.device) for t in big]
    res += [torch.empty((d,), dtype=torch.float32, device=x.device),
            torch.empty((b, d), dtype=torch.float32, device=x.device)]
    res += copies(zip(big, (x, a_gate, x_gate)))
    for pair, src in (((d_cast, d_al), dout), ((h_cast, h_al), hs)):
        res += [t for t in {id(v): v for v in pair}.values() if t is not src]
    res += copies(zip(small, (h0, dh_t, a_param)))
    res.append(torch.empty((b, d), dtype=torch.float32, device=x.device))
    return res


def _check_bwd_launch(x, a_gate, x_gate, a_param, h0, hs, dout, dh_t,
                      path) -> str:
    """Raise what the backward launch raises; returns its path."""
    b, t, d = x.shape
    for name, ten, shape in (("a_gate", a_gate, (b, t, d)),
                             ("x_gate", x_gate, (b, t, d)),
                             ("hs", hs, (b, t, d)), ("dout", dout, (b, t, d)),
                             ("a_param", a_param, (d,)), ("h0", h0, (b, d)),
                             ("dh_t", dh_t, (b, d))):
        if tuple(ten.shape) != shape:
            raise ValueError(f"rg_lru_bwd: {name} has shape "
                             f"{tuple(ten.shape)}, expected {shape}")
        if ten.device != x.device:
            raise ValueError(f"rg_lru_bwd: all operands must be on "
                             f"{x.device}, got {name} on {ten.device}")
    if any(v.dtype not in _DTYPES for v in (x, a_gate, x_gate)):
        raise NotImplementedError(
            f"rg_lru_bwd: the CUDA kernel takes x, a_gate and x_gate each in "
            f"one of {_DTYPES}, got {x.dtype}, {a_gate.dtype}, "
            f"{x_gate.dtype}")
    if path is None:
        path = choose_bwd_path(d, (x.dtype, a_gate.dtype, x_gate.dtype))
    return path


def _bwd_launch(x, a_gate, x_gate, a_param, h0, hs, dout, dh_t, c, path
                ) -> List[torch.Tensor]:
    """One backward launch: ``[dx, da_gate, dx_gate, da_param, dh0,
    *scratch]`` (:func:`bwd_launch_allocations`)."""
    path = _check_bwd_launch(x, a_gate, x_gate, a_param, h0, hs, dout, dh_t,
                             path)
    b, t, d = x.shape
    src = (x, a_gate, x_gate, dout, hs, h0, dh_t, a_param)
    # the (B, T, D) operands contiguous and 16-byte aligned for TMA
    x, a_gate, x_gate = (_aligned(v) for v in (x, a_gate, x_gate))
    d_cast, h_cast = dout.to(x.dtype), hs.float()
    dout, hs = _aligned(d_cast), _aligned(h_cast)
    h0, dh_t, a_param = (v.float().contiguous() for v in (h0, dh_t, a_param))
    scratch = copies(zip((x, a_gate, x_gate), src[:3]))
    for pair, old in (((d_cast, dout), src[3]), ((h_cast, hs), src[4])):
        scratch += [v for v in {id(u): u for u in pair}.values()
                    if v is not old]
    scratch += copies(zip((h0, dh_t, a_param), src[5:]))
    dx = torch.empty_like(x)
    dag = torch.empty_like(a_gate)
    dxg = torch.empty_like(x_gate)
    dp = torch.empty((d,), dtype=torch.float32, device=x.device)
    dh0 = torch.empty((b, d), dtype=torch.float32, device=x.device)
    part = torch.empty((b, d), dtype=torch.float32, device=x.device)
    lib = _bwd_lib()
    rc = lib.rg_lru_bwd(
        x.data_ptr(), a_gate.data_ptr(), x_gate.data_ptr(), dout.data_ptr(),
        hs.data_ptr(), h0.data_ptr(), dh_t.data_ptr(), a_param.data_ptr(),
        dx.data_ptr(), dag.data_ptr(), dxg.data_ptr(), dp.data_ptr(),
        dh0.data_ptr(), part.data_ptr(), b, t, d, float(c),
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[a_gate.dtype],
        _DTYPE_CODE[x_gate.dtype], _PATH_CODE[path],
        tile_channels(b, d, _sms(x.device)) if path == "tile" else 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rg_lru_bwd launch failed on {path}: "
                           f"{lib.rg_lru_bwd_error_string(rc).decode()}")
    rg_lru_bwd.launches += 1
    setattr(rg_lru_bwd, f"{path}_launches",
            getattr(rg_lru_bwd, f"{path}_launches") + 1)
    return [dx, dag, dxg, dp, dh0, *scratch, part]


def _check_launch(x, a_gate, x_gate, a_param, h0, path) -> str:
    """Raise what the forward launch raises; returns its path."""
    b, t, d = x.shape
    device = x.device
    for name, ten, shape in (("a_gate", a_gate, (b, t, d)),
                             ("x_gate", x_gate, (b, t, d)),
                             ("a_param", a_param, (d,)), ("h0", h0, (b, d))):
        if tuple(ten.shape) != shape:
            raise ValueError(f"rg_lru: {name} has shape {tuple(ten.shape)}, "
                             f"expected {shape}")
        if ten.device != device:
            raise ValueError(f"rg_lru: all operands must be on {device}, "
                             f"got {name} on {ten.device}")
    if path is None:
        path = choose_path(b, t, d, x.dtype, a_gate.dtype, x_gate.dtype)
    if path is None:
        raise NotImplementedError(
            f"rg_lru: the CUDA kernels take x, a_gate and x_gate each in one "
            f"of {_DTYPES}, got {x.dtype}, {a_gate.dtype}, {x_gate.dtype}")
    return path


def _launch(x, a_gate, x_gate, a_param, h0, c, path) -> List[torch.Tensor]:
    """One forward launch: ``[out, h_T, *scratch]``
    (:func:`launch_allocations`)."""
    path = _check_launch(x, a_gate, x_gate, a_param, h0, path)
    b, t, d = x.shape
    device = x.device
    src = (a_param, h0, x, a_gate, x_gate)
    # the small per-channel and per-row operands in fp32 (B*D + D values);
    # the (B, T, D) operands contiguous, and 16-byte aligned for TMA (an
    # offset view is copied, as on the CPU any layout is taken)
    a_param = a_param.float().contiguous()
    h0 = h0.float().contiguous()
    x, a_gate, x_gate = (_aligned(v) for v in (x, a_gate, x_gate))
    out = torch.empty_like(x)
    h_t = torch.empty((b, d), dtype=torch.float32, device=device)
    dt = tile_channels(b, d, _sms(device)) if path == "tile" else 0
    lib = _lib()
    rc = lib.rg_lru(x.data_ptr(), a_gate.data_ptr(), x_gate.data_ptr(),
                    a_param.data_ptr(), h0.data_ptr(), out.data_ptr(),
                    h_t.data_ptr(), b, t, d, float(c), _DTYPE_CODE[x.dtype],
                    _DTYPE_CODE[a_gate.dtype], _DTYPE_CODE[x_gate.dtype],
                    _PATH_CODE[path], dt,
                    torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rg_lru launch failed on {path}: "
                           f"{lib.rg_lru_error_string(rc).decode()}")
    rg_lru.launches += 1
    setattr(rg_lru, f"{path}_launches",
            getattr(rg_lru, f"{path}_launches") + 1)
    return [out, h_t] + copies(zip((a_param, h0, x, a_gate, x_gate), src))


#: Kernel launches since the count was last set to 0, all and per path
#: (only :func:`rg_lru` on CUDA tensors adds to them).
rg_lru.launches = 0
rg_lru.tile_launches = 0
rg_lru.simt_launches = 0
#: Backward calls that launched a kernel since the count was last set to
#: 0, all and per path (only :func:`rg_lru_bwd` on CUDA tensors adds to
#: them; one a call).
rg_lru_bwd.launches = 0
rg_lru_bwd.tile_launches = 0
rg_lru_bwd.simt_launches = 0
