"""Static shared-memory budgeting for the Segment kernels' CUDA paths.

The port's counterpart of ``repro.analysis.budget``'s closed forms.  On a
TPU the budget is a core's VMEM; on Hopper it is the dynamic shared memory
one thread block asks for at launch, which may not exceed the SM's opt-in
limit of 232,448 bytes (227 KiB) on an H100.  A plan whose kernel would ask
for more fails at launch; these functions price each launch from its own
parameters, so :func:`check_plan_vmem` refuses such a plan when it is
built, with a named error, before anything runs.

Each ``*_smem_bytes`` function below is the closed form of one launcher's
request, as the CUDA source computes it at compile time, and each equals
the ``extern "C"`` export of that number from its source (``chip_smoke.py``
``[tune]`` compares them on the card for every instantiation):

* :func:`simt_spmm_smem_bytes` — ``smem_bytes<BM, BK, TN, TRANS, PAY>()``,
  the one-block-per-run SpMM kernel (``csrc/segment_spmm.cu``,
  ``segment_spmm_smem_bytes``);
* :func:`split_spmm_smem_bytes` — ``fold::smem_bytes<TN, PAY, SCALE>()``,
  the folded SpMM kernel (same source, ``segment_spmm_split_smem_bytes``);
* :func:`tc_spmm_smem_bytes` — ``Layout<PAY, SCALE, WGS>::kSmem``, the
  SpMM tensor-core kernel (``csrc/segment_spmm_tc.cu``,
  ``segment_spmm_tc_smem_bytes``);
* :func:`simt_spgemm_smem_bytes` — ``smem_bytes<BM, BK, BN, PAY>()``, the
  SpGEMM CUDA-core kernel (``csrc/segment_spgemm.cu``,
  ``segment_spgemm_smem_bytes``);
* :func:`tc_spgemm_smem_bytes` — ``Layout<PAY, SCALE>::kSmem``, the SpGEMM
  tensor-core kernel (``csrc/segment_spgemm_tc.cu``,
  ``segment_spgemm_tc_smem_bytes``).

The names ``repro`` callers use are kept (``DEFAULT_VMEM_LIMIT_BYTES``,
``VmemBudgetError``, ``spmm_vmem_bytes``, ``spgemm_vmem_bytes``,
``plan_vmem_bytes``, ``check_plan_vmem``); they measure an SM's shared
memory, not a TPU's VMEM.  Unlike the TPU's, the card's working set does
not depend on ``unroll`` or ``pipeline`` (the kernels read neither), so
those keywords are accepted and ignored.  Block shapes no CUDA path takes
(16×16, say) are priced with the CUDA-core kernels' formulas, which is what
those kernels would ask for at that shape.

The ``vmem-budget`` rule of the kernel analyzers reads a checked launch:
:func:`kernel_vmem_bytes` is its static shared memory plus its dynamic
request, as the card reports them to the kernel (``%total_smem_size``,
``%dynamic_smem_size``; the dynamic request is the launcher's
``*_smem_bytes`` export, :func:`smem_exports`), and
:func:`check_vmem_budget` flags a launch over the limit.

Rule id: ``vmem-budget``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

from repro_torch.kernels.segment_spmm import TC_MIN_N, _split_tile_n, _tile_n

RULE = "vmem-budget"

#: the H100's opt-in dynamic shared memory of one thread block (227 KiB)
SMEM_OPT_IN = 232448
#: the default of ``vmem_limit_bytes``: the whole opt-in limit
DEFAULT_VMEM_LIMIT_BYTES = SMEM_OPT_IN

#: the kernels' payload codes (``csrc``'s ``enum Payload``) by dtype name,
#: and by a plan's storage name
_PAYLOAD = {"float32": 0, "int8": 1, "float8_e4m3fn": 2}
_PLAN_PAYLOAD = {"fp32": 0, "int8": 1, "fp8": 2}
#: ``enum ScaleMode``: none (fp32 tiles), one per block, one per block row
NONE, BLOCK, ROW = 0, 1, 2
_KB = 1024


class VmemBudgetError(ValueError):
    """A kernel launch's shared memory exceeds the per-block limit."""


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _check_mode(payload: int, scale_mode: int) -> None:
    ok = (scale_mode == NONE if payload == 0
          else payload in (1, 2) and scale_mode in (BLOCK, ROW))
    if not ok:
        raise ValueError(f"no kernel takes payload {payload} with scale mode "
                         f"{scale_mode}")


# ---------------------------------------------------------------------------
# the launchers' closed forms
# ---------------------------------------------------------------------------


def simt_spmm_smem_bytes(bm: int, tile_n: int, trans: bool, payload: int,
                         scale_mode: int, bk: Optional[int] = None) -> int:
    """``segment_spmm.cu``'s ``smem_bytes<BM, BK, TN, TRANS, PAY>()``: a
    3-stage ring of A tiles (fp32 rows padded by 4 floats, or the raw
    payload bytes), one padded fp32 A tile beside a 1-byte payload, and two
    fp32 B buffers of the contraction length × (TN + 1).  The launcher
    instantiates it at BK = BM."""
    _check_mode(payload, scale_mode)
    bk = bm if bk is None else bk
    kc = bm if trans else bk
    f32_tile = 4 * bm * (bk + 4)
    ring = f32_tile if payload == 0 else bm * bk
    a32 = 0 if payload == 0 else f32_tile
    return 3 * ring + a32 + 4 * 2 * kc * (tile_n + 1)


def split_spmm_smem_bytes(tile_n: int, payload: int, scale_mode: int) -> int:
    """``segment_spmm.cu``'s ``fold::smem_bytes<TN, PAY, SCALE>()`` (64×64
    blocks): a 3-stage ring of tiles (rows of 68 floats or 80 payload
    bytes) with their scales, and two fp32 B buffers of 64 rows at a pitch
    of 4 (TN = 4) or TN + 4."""
    _check_mode(payload, scale_mode)
    row = 4 * (64 + 4) if payload == 0 else 64 + 16
    scales = {NONE: 0, BLOCK: 16, ROW: 4 * 64}[scale_mode]
    pitch = 4 if tile_n == 4 else tile_n + 4
    return 3 * (64 * row + scales) + 4 * 2 * 64 * pitch


def tc_spmm_warpgroups(n: int) -> int:
    """Consumer warpgroups of the SpMM tensor-core launch at width ``n``:
    one (a 128-column tile, a deeper ring) up to 128 columns, else two."""
    return 1 if n <= 128 else 2


def tc_spmm_smem_bytes(n: int, payload: int, scale_mode: int) -> int:
    """``segment_spmm_tc.cu``'s ``Layout<PAY, SCALE, WGS>::kSmem``: as many
    1 KiB-aligned stages as fit (at most 6), each a bf16 B slice of 64 ×
    128·WGS, the split tile's parts (3, or 1 for a per-block payload), the
    stored tile and its rowwise scales; plus 1 KiB of alignment and three
    mbarriers a stage."""
    _check_mode(payload, scale_mode)
    tile = 64 * 64 * 2
    b_bytes = 128 * tc_spmm_warpgroups(n) * 64 * 2
    parts = 3 if (payload == 0 or scale_mode == ROW) else 1
    raw = 64 * 64 * (4 if payload == 0 else 1)
    scales = 64 * 4 if scale_mode == ROW else 0
    stage = _ceil_to(b_bytes + parts * tile + raw + scales, _KB)
    stages = min((SMEM_OPT_IN - _KB - 24 * 6) // stage, 6)
    return stages * stage + _KB + 3 * stages * 8


def simt_spgemm_smem_bytes(bm: int, bk: int, bn: int, payload: int,
                           scale_mode: int) -> int:
    """``segment_spgemm.cu``'s ``smem_bytes<BM, BK, BN, PAY>()``: a 3-stage
    ring of fp32 A (rows padded by 4) and B tiles, or of the raw payload
    bytes of both followed by one fp32 A and B tile."""
    _check_mode(payload, scale_mode)
    f32_tiles = 4 * (bm * (bk + 4) + bk * bn)
    if payload == 0:
        return 3 * f32_tiles
    return 3 * (bm * bk + bk * bn) + f32_tiles


def tc_spgemm_pipelines(payload: int, scale_mode: int) -> int:
    """Pipelines a block of the SpGEMM tensor-core kernel runs: two for
    fp32 tiles, four per-block, three rowwise."""
    return 2 if payload == 0 else (4 if scale_mode == BLOCK else 3)


def tc_spgemm_smem_bytes(payload: int, scale_mode: int) -> int:
    """``segment_spgemm_tc.cu``'s ``Layout<PAY, SCALE>::kSmem``: per
    pipeline, A's and B's bf16 parts and a ring of raw slots (as deep as
    fits, at most 8), 1 KiB-aligned, then its metadata (the mbarriers of
    its tile and row rings and 16 work-table rows of 5 ints); plus 1 KiB
    of alignment."""
    _check_mode(payload, scale_mode)
    tile = 64 * 64 * 2
    pipes = tc_spgemm_pipelines(payload, scale_mode)
    meta = (2 * 8 + 2 * 16) * 8 + 16 * 5 * 4
    a_parts = 3 if payload == 0 else 1
    b_parts = 3 if (payload == 0 or scale_mode == ROW) else 1
    slot = 64 * 64 * (4 if payload == 0 else 1) + (
        64 * 4 if scale_mode == ROW else 0)
    split = (a_parts + b_parts) * tile
    fit = ((SMEM_OPT_IN - _KB - pipes * meta) // pipes
           - split) // slot
    pipe = _ceil_to(split + min(fit, 8) * slot, _KB)
    return _KB + pipes * pipe + pipes * meta


# ---------------------------------------------------------------------------
# the paths a plan can take, and their worst launch
# ---------------------------------------------------------------------------

def simt_tile_n(n: int, bn: int) -> int:
    """The CUDA-core SpMM kernel's N tile: the widest of 4..32 no wider
    than ``bn`` and N rounded up to a power of two."""
    return _tile_n(n, bn)


def split_tile_n(n: int) -> int:
    """The folded SpMM kernel's N tile: N rounded up to 4, 8 or 16."""
    return _split_tile_n(n)


def spmm_paths(bm: int, bk: int, n: Optional[int],
               rhs_dtype: Optional[str] = None) -> Tuple[str, ...]:
    """The SpMM paths ``segment_spmm.choose_path`` can send a call of width
    ``n`` to, over every B it may be given: 64×64 blocks take ``"simt"``
    with fp32 B, and with bf16 B ``"tc"`` from ``TC_MIN_N`` where TMA
    can read B and ``"split"`` where it is narrower or TMA cannot; other
    blocks take ``"simt"`` alone.  ``rhs_dtype`` (``"float32"`` or
    ``"bfloat16"``) narrows the set to that B; ``n=None`` means any
    width."""
    if bm != 64 or bk != 64 or rhs_dtype == "float32":
        return ("simt",)
    narrow = n is not None and n < TC_MIN_N
    bf16 = ("split",) if narrow else ("tc", "split")
    return bf16 if rhs_dtype == "bfloat16" else bf16 + ("simt",)


def _mode(payload: int, quantized: bool, rowwise: bool) -> Tuple[int, int]:
    if not quantized or payload == 0:
        return payload, NONE
    return payload, ROW if rowwise else BLOCK


def plan_mode(block_dtype: str) -> Tuple[int, int]:
    """The kernels' ``(payload, scale_mode)`` codes of a plan's storage
    (``"fp32"``, ``"int8"``, ``"fp8"``, ``"int8.rowwise"``,
    ``"fp8.rowwise"``)."""
    return _mode(_PLAN_PAYLOAD[block_dtype.split(".")[0]],
                 block_dtype != "fp32", block_dtype.endswith(".rowwise"))


def spmm_path_smem_bytes(path: str, *, bm: int, bk: int, n: Optional[int],
                         bn: int = 512, transpose_lhs: bool = False,
                         payload: int = 0, scale_mode: int = NONE) -> int:
    """The shared memory the SpMM launch on ``path`` asks for at width
    ``n`` (``None``: the widest tile, the largest request) with the
    executor's N-tile cap ``bn``."""
    if path == "tc":
        return max(tc_spmm_smem_bytes(w, payload, scale_mode)
                   for w in ((n,) if n is not None else (128, 256)))
    if path == "split":
        tile = split_tile_n(n if n is not None else 16)
        return split_spmm_smem_bytes(tile, payload, scale_mode)
    tile = simt_tile_n(n if n is not None else bn, bn)
    return simt_spmm_smem_bytes(bm, tile, transpose_lhs, payload, scale_mode,
                                bk=bk)


def spmm_vmem_bytes(*, bm: int, bk: int, bn: int, unroll: int = 1,
                    transpose_lhs: bool = False, block_dtype="float32",
                    rhs_dtype: Optional[str] = None, out_dtype="float32",
                    quantized: bool = False, rowwise: bool = False,
                    pipelined: bool = True,
                    n_cols: Optional[int] = None) -> int:
    """Shared memory of the largest launch one ``segment_spmm`` call can
    make: the worst of :func:`spmm_path_smem_bytes` over
    :func:`spmm_paths` at ``n_cols`` (``None``: any width).  ``bn`` is the
    executor's N-tile cap (the plan's ``bn_hint`` or 512).  ``unroll``,
    ``pipelined`` and ``out_dtype`` do not change what the card asks for;
    they are taken for ``repro``'s signature."""
    payload, scale = _mode(_PAYLOAD[str(block_dtype)], quantized, rowwise)
    return _spmm_worst(bm, bk, bn, n_cols, rhs_dtype, transpose_lhs,
                       payload, scale)


def _spmm_worst(bm, bk, bn, n_cols, rhs_dtype, transpose_lhs, payload,
                scale) -> int:
    return max(spmm_path_smem_bytes(p, bm=bm, bk=bk, n=n_cols, bn=bn,
                                    transpose_lhs=transpose_lhs,
                                    payload=payload, scale_mode=scale)
               for p in spmm_paths(bm, bk, n_cols, rhs_dtype))


def spgemm_path(bm: int, bk: int, bn: int) -> str:
    """The SpGEMM path ``segment_spgemm.choose_path`` takes for fp32 or
    bf16 C: ``"tc"`` for 64×64 tiles, else ``"simt"``."""
    return "tc" if bm == bk == bn == 64 else "simt"


def spgemm_vmem_bytes(*, bm: int, bk: int, bn: int, unroll: int = 1,
                      block_dtype="float32", rhs_dtype=None,
                      out_dtype="float32", quant_a: bool = False,
                      quant_b: bool = False, rowwise: bool = False,
                      pipelined: bool = True) -> int:
    """Shared memory of the ``segment_spgemm`` launch ``choose_path``
    picks for these tiles (:func:`spgemm_path`).  A quantized SpGEMM
    stores both operands in one mode, so ``quant_a`` decides it."""
    payload, scale = _mode(_PAYLOAD[str(block_dtype)], quant_a or quant_b,
                           rowwise)
    return _spgemm(bm, bk, bn, payload, scale)


def _spgemm(bm, bk, bn, payload, scale) -> int:
    if spgemm_path(bm, bk, bn) == "tc":
        return tc_spgemm_smem_bytes(payload, scale)
    return simt_spgemm_smem_bytes(bm, bk, bn, payload, scale)


def plan_vmem_bytes(plan, *, bn: int = 512, n_cols: Optional[int] = None,
                    pipelined: Optional[bool] = None) -> int:
    """Worst-case shared memory over the launches a ``SegmentPlan`` can
    make through the executor at width ``n_cols`` (``None``: any width):
    every path ``choose_path`` can send the forward call to and, when the
    plan carries a gradient schedule, the transposed call too.  ``bn`` is
    the executor's N-tile cap.  ``pipelined`` is taken for ``repro``'s
    signature and changes nothing."""
    bm, bk = plan.block_shape
    payload, scale = plan_mode(plan.block_dtype)
    if plan.kind == "spgemm":
        bn_g = (plan.rhs_blocks.shape[2] if plan.rhs_blocks is not None
                else bk)
        return _spgemm(bm, bk, int(bn_g), payload, scale)
    total = _spmm_worst(bm, bk, bn, n_cols, None, plan.transpose_lhs,
                        payload, scale)
    if plan.grad_plan is not None:
        total = max(total, plan_vmem_bytes(plan.grad_plan, bn=bn,
                                           n_cols=n_cols))
    return total


def check_plan_vmem(plan, *, bn: int = 512, n_cols: Optional[int] = None,
                    limit: int = DEFAULT_VMEM_LIMIT_BYTES,
                    label: str = "plan") -> int:
    """Raise :class:`VmemBudgetError` when one of the plan's launches
    (:func:`plan_vmem_bytes`) would ask for more than ``limit`` bytes of
    shared memory; returns the computed bytes."""
    total = plan_vmem_bytes(plan, bn=bn, n_cols=n_cols)
    if total > limit:
        bm, bk = plan.block_shape
        raise VmemBudgetError(
            f"{label}: a kernel launch asks for {total} bytes of shared "
            f"memory, over the {limit}-byte limit (block ({bm}, {bk}), "
            f"N {n_cols if n_cols is not None else 'any'}, bn={bn}, "
            f"dtype={plan.block_dtype}); choose a "
            f"smaller block or raise vmem_limit_bytes")
    return total


# ---------------------------------------------------------------------------
# the compiled numbers, and the rule over a checked launch
# ---------------------------------------------------------------------------

#: each launcher's shared-memory export: (source, name, int arguments)
SMEM_EXPORTS = (("segment_spmm.cu", "segment_spmm_smem_bytes", 5),
                ("segment_spmm.cu", "segment_spmm_split_smem_bytes", 3),
                ("segment_spmm_tc.cu", "segment_spmm_tc_smem_bytes", 3),
                ("segment_spgemm.cu", "segment_spgemm_smem_bytes", 5),
                ("segment_spgemm_tc.cu", "segment_spgemm_tc_smem_bytes", 2))


def smem_exports() -> Dict[str, object]:
    """The release libraries' ``*_smem_bytes`` exports, typed, by name:
    the dynamic shared memory each launcher asks for (-1 where it refuses
    the arguments).  Builds the libraries on first use."""
    from repro_torch.kernels import build
    out = {}
    for src, name, n in SMEM_EXPORTS:
        fn = getattr(build.load(src, checked=False), name)
        fn.argtypes = [ctypes.c_int] * n
        fn.restype = ctypes.c_longlong
        out[name] = fn
    return out


def kernel_vmem_bytes(launch) -> Dict[str, int]:
    """Shared memory of one checked launch (an
    :class:`~repro_torch.analysis.trace.Launch`): ``static`` (the compiled
    kernel's), ``dynamic`` (the launch's request) and ``total``."""
    return {"static": int(launch.static_smem),
            "dynamic": int(launch.dynamic_smem),
            "total": int(launch.static_smem + launch.dynamic_smem)}


def check_vmem_budget(launch, vmem_limit: int = DEFAULT_VMEM_LIMIT_BYTES
                      ) -> List:
    """The ``vmem-budget`` rule: a finding when the launch's static and
    dynamic shared memory together exceed ``vmem_limit`` bytes."""
    from .jaxpr_lint import LintFinding
    b = kernel_vmem_bytes(launch)
    if b["total"] <= vmem_limit:
        return []
    return [LintFinding(
        rule=RULE,
        message=(f"shared memory {b['total']} bytes (static {b['static']}, "
                 f"dynamic {b['dynamic']}) exceeds the {vmem_limit}-byte "
                 f"limit"),
        kernel=launch.name)]
