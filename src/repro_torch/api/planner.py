"""``plan_matmul`` — pattern → :class:`SegmentPlan` (a trimmed copy of
``repro.api.planner``).

Planning is host-side numpy work (symbolic phase, ordering, folding, lane
partitioning, finalization) that depends only on the sparsity pattern, so
plans are cached by a pattern fingerprint; realization attaches the block
values (uploaded in BSR storage order, never gathered) and the schedule
leaves on the requested device.

``plan_matmul(A, B_or_shape)`` dispatches on the right-hand side: a ``BSR``
gives a SpGEMM plan (B frozen into the plan; ``quantize=`` stores both
operands as int8/fp8 payloads beside fp32 scales), a dense array, shape or
``N`` an SpMM plan (``quantize=`` stores A as an int8/fp8 payload beside
fp32 scales; its grad plan addresses the same payload and scales).  The
storage dtype is part of the fingerprint, so fp32 and quantized plans of
one pattern are separate cache entries.

``verify=`` runs the plan verifier (:func:`repro_torch.analysis
.verify_plan`) once per cached template, on its host numpy leaves, and the
scale-agreement check on every realized plan, as ``repro`` does.
``vmem_limit_bytes=`` refuses a plan whose kernel launches would ask for
more shared memory than that (:func:`repro_torch.analysis.budget
.check_plan_vmem`), and ``policy="auto"`` hands the knobs to the schedule
search (:mod:`repro_torch.tune`), imported only then.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.analysis.invariants import (PlanVerificationError,
                                             VerifyResult,
                                             check_scale_agreement,
                                             verify_plan)
from repro_torch.core.formats import (BSR, QUANT_DTYPES, QUANT_MODES,
                                      QuantizedBlocks, dtype_name,
                                      quant_base_dtype, quant_is_rowwise,
                                      quantize_blocks)
from repro_torch.core.policies import get_policy
from repro_torch.core.schedule import (PREFETCH_MODES, LaneLayout,
                                       build_spgemm_schedule,
                                       build_spmm_schedule, fetch_flags,
                                       finalize_schedule, lane_select,
                                       lane_traffic_spgemm, lane_traffic_spmm,
                                       partition_lanes)
from repro_torch.kernels.segment_spgemm import work_table
from repro_torch.kernels.segment_spmm import chunk_offsets, run_offsets

from .backends import resolve_backend, resolve_device
from .plan import SPGEMM, SPMM, SegmentPlan


def _freeze_traffic(traffic: dict) -> Tuple[Tuple[str, float], ...]:
    return tuple(sorted(traffic.items()))


def _scale_spmm_traffic(basis: dict, n_cols: int) -> dict:
    """Re-price a unit-N traffic basis for a concrete dense width."""
    out = dict(basis)
    out["b_bytes"] = basis["b_bytes"] * n_cols
    out["c_bytes"] = basis["c_bytes"] * n_cols
    out["total"] = basis["a_bytes"] + out["b_bytes"] + out["c_bytes"]
    return out


def _scale_fetch_bytes(block_dtype: str, rows: int) -> int:
    """fp32 scale bytes a quantized tile fetch brings along: one scalar per
    block, or one per block row in a rowwise mode."""
    return (rows if quant_is_rowwise(block_dtype) else 1) * 4


def _quantize_a_traffic(basis: dict, block_dtype: str, bm: int,
                        bk: int) -> dict:
    """Re-price an SpMM traffic estimate's A bytes for a quantized payload:
    each A fetch moves ``bm·bk`` payload bytes plus its fp32 scales (one per
    block, or ``bm`` in a rowwise mode); B and C stay as they are."""
    if block_dtype == "fp32":
        return basis
    itemsize = QUANT_DTYPES[quant_base_dtype(block_dtype)].itemsize
    out = dict(basis)
    out["a_bytes"] = basis["a_fetches"] * (
        bm * bk * itemsize + _scale_fetch_bytes(block_dtype, bm))
    out["total"] = out["a_bytes"] + out["b_bytes"] + out["c_bytes"]
    return out


def _quantize_spgemm_traffic(traffic: dict, block_dtype: str, bm: int,
                             bk: int, bn: int) -> dict:
    """Re-price an SpGEMM traffic estimate for quantized operands: each A
    or B fetch moves its payload bytes plus its scales (B's rowwise scales
    run over its ``bk`` rows); C stays fp32."""
    if block_dtype == "fp32":
        return traffic
    itemsize = QUANT_DTYPES[quant_base_dtype(block_dtype)].itemsize
    out = dict(traffic)
    out["a_bytes"] = traffic["a_fetches"] * (
        bm * bk * itemsize + _scale_fetch_bytes(block_dtype, bm))
    out["b_bytes"] = traffic["b_fetches"] * (
        bk * bn * itemsize + _scale_fetch_bytes(block_dtype, bk))
    out["total"] = out["a_bytes"] + out["b_bytes"] + out["c_bytes"]
    return out


def _realize_values(blocks, block_dtype: str, device: torch.device
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(payload, scales)`` on ``device`` for a plan's value leaves.

    fp32 plans upload the caller's blocks as they are (scales ``None``).
    Quantized plans take a :class:`QuantizedBlocks` of the plan's mode
    verbatim (weights quantized once, at load time), or fp32 blocks, which
    are quantized here, in storage order, on the device they lie on (numpy
    blocks on the host; a layer's weights re-plan without a host copy)."""
    if isinstance(blocks, QuantizedBlocks):
        if blocks.dtype != block_dtype:
            raise ValueError(
                f"pre-quantized blocks are {blocks.dtype!r} but the plan "
                f"was requested with quantize={block_dtype!r}")
        return blocks.payload.to(device), blocks.scales.to(device)
    blocks = torch.as_tensor(blocks, dtype=torch.float32).detach()
    if block_dtype == "fp32":
        return blocks.to(device), None
    q = quantize_blocks(blocks, block_dtype)
    return q.payload.to(device), q.scales.to(device)


def _bucket_hint(n: Optional[int]) -> Optional[int]:
    """Power-of-two ceiling bucket for the dense-N traffic hint."""
    if n is None:
        return None
    n = int(n)
    return 1 << max(0, (n - 1).bit_length())


def pattern_fingerprint(kind: str, policy_key: str, fold_len: Optional[int],
                        with_grad: bool, *mats: BSR, n_lanes: int = 1,
                        unroll: int = 1, block_dtype: str = "fp32",
                        n_bucket: Optional[int] = None, pipeline: bool = True,
                        bn_hint: Optional[int] = None,
                        prefetch: Optional[str] = None) -> str:
    """Digest of everything the schedule and the cached pricing depend on
    (never block values)."""
    h = hashlib.sha1()
    h.update(f"{kind}|{policy_key}|{fold_len}|{with_grad}"
             f"|lanes={n_lanes}|unroll={unroll}"
             f"|dtype={block_dtype}|nbkt={n_bucket}"
             f"|pipe={pipeline}|bn={bn_hint}|pf={prefetch}".encode())
    for m in mats:
        h.update(np.asarray(m.shape, np.int64).tobytes())
        h.update(np.asarray(m.block_shape, np.int64).tobytes())
        h.update(np.ascontiguousarray(m.brow, np.int64).tobytes())
        h.update(np.ascontiguousarray(m.bcol, np.int64).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class _PlanTemplate:
    """A value-free plan: aux fields and host numpy leaves, plus the
    leaves already uploaded per device."""

    aux: dict
    leaves: Dict[str, np.ndarray]
    traffic_basis: dict
    grad: Optional["_PlanTemplate"] = None
    on_device: Dict[torch.device, dict] = dataclasses.field(default_factory=dict)
    verified_level: Optional[str] = None   # deepest verify_plan run yet

    def host_plan(self) -> SegmentPlan:
        """The value-free plan over the host numpy leaves, as ``repro``'s
        template plan: SpMM traffic is priced per realize, so it records
        none here; SpGEMM traffic is fixed."""
        traffic = (_freeze_traffic(self.traffic_basis)
                   if self.aux["kind"] == SPGEMM else ())
        grad = None if self.grad is None else self.grad.host_plan()
        return SegmentPlan(**self.aux, **self.leaves, traffic_items=traffic,
                           grad_plan=grad)

    def device_leaves(self, device: torch.device) -> dict:
        got = self.on_device.get(device)
        if got is None:
            got = {k: torch.from_numpy(v).to(device)
                   for k, v in self.leaves.items()}
            # leaves made under a FakeTensorMode (the dry run) have no
            # memory: a real call on the same device must not find them
            if not any(is_fake(t) for t in got.values()):
                self.on_device[device] = got
        return got

    def realize(self, values: dict, device: torch.device,
                backend: Optional[str], n_cols: int,
                out_dtype: Optional[str]) -> SegmentPlan:
        """The plan on ``device`` with the value leaves in ``values``
        (``lhs_blocks``, and for SpGEMM ``rhs_blocks`` and the scales)."""
        grad = None
        if self.grad is not None:
            grad = self.grad.realize({}, device, None, n_cols, None)
        # SpGEMM traffic is fixed; SpMM's unit-N basis is priced at n_cols
        traffic = (self.traffic_basis if self.aux["kind"] == SPGEMM
                   else _scale_spmm_traffic(self.traffic_basis, n_cols))
        return SegmentPlan(
            **self.aux, **self.device_leaves(device), **values,
            traffic_items=_freeze_traffic(traffic), grad_plan=grad,
            backend=backend, out_dtype=out_dtype)


_CACHE: Dict[str, _PlanTemplate] = {}
# hits/misses: the template cache; searched/search_cache_hits/
# dataflow_fallbacks: the tuner's counters, added to by repro_torch.tune
_STATS = {"hits": 0, "misses": 0,
          "searched": 0, "search_cache_hits": 0, "dataflow_fallbacks": 0}


def clear_plan_cache() -> None:
    """Drop every cached template (fp32 and quantized entries alike) and
    the :mod:`repro_torch.tune` search cache beside it."""
    import sys
    _CACHE.clear()
    for k in _STATS:
        _STATS[k] = 0
    # only if the tuner was imported: it imports this module, never the
    # other way round
    ts = sys.modules.get("repro_torch.tune.search")
    if ts is not None:
        ts._SEARCH_CACHE.clear()


def plan_cache_stats() -> dict:
    """Hit/miss counters, cache size, and the entries per ``block_dtype``
    (``by_dtype``): quantized plans of a pattern are entries of their own.
    Also the tuner's counters: ``searched`` (searches run),
    ``search_cache_hits`` (searches answered from its cache) and
    ``dataflow_fallbacks`` (times the analytically best dataflow had no
    policy and the tuner fell back to the best dispatchable one)."""
    by_dtype: Dict[str, int] = {}
    for tpl in _CACHE.values():
        d = tpl.aux["block_dtype"]
        by_dtype[d] = by_dtype.get(d, 0) + 1
    return dict(_STATS, size=len(_CACHE), by_dtype=by_dtype)


def _lane_flags(layout: LaneLayout, sched, fin, a_stream: np.ndarray,
                b_stream: np.ndarray, unroll: int) -> dict:
    """The lane-major int32 flag leaves of a built schedule (pads zeroed)
    and the fetch flags and ring slots of its two operand streams (the A
    slots, and the B row-blocks or B slots), on a ring of ``2·unroll``."""
    valid = layout.valid.reshape(-1)
    depth = 2 * unroll
    a_f, a_s = fetch_flags(a_stream, valid, layout.n_lanes, depth=depth)
    b_f, b_s = fetch_flags(b_stream, valid, layout.n_lanes, depth=depth)
    flags = dict(
        seg_start=lane_select(layout, sched.seg_start, zero_pads=True),
        seg_write=lane_select(layout, sched.seg_write, zero_pads=True),
        accum_prev=lane_select(layout, fin.accum_prev, zero_pads=True),
        valid=valid, a_fetch=a_f, b_fetch=b_f, a_slot=a_s, b_slot=b_s)
    return {k: v.astype(np.int32) for k, v in flags.items()}


def _schedule_template(sched, layout: LaneLayout, fin, slots: np.ndarray,
                       bm: int, bk: int, policy: str, fingerprint: str,
                       unroll: int, pipeline: bool, bn_hint: Optional[int],
                       prefetch: Optional[str], a: BSR,
                       transpose_lhs: bool, block_dtype: str) -> _PlanTemplate:
    """Lane-major leaves, fetch schedule and traffic basis of one built
    schedule (the forward plan or its transposed backward twin); the
    backward twin reads the forward storage, so both carry its dtype."""
    lane_m = lane_select(layout, sched.m).astype(np.int32)
    lane_k = lane_select(layout, sched.k).astype(np.int32)
    lane_slot = lane_select(layout, slots).astype(np.int32)
    flags = _lane_flags(layout, sched, fin, lane_slot, lane_k, unroll)
    basis = _quantize_a_traffic(lane_traffic_spmm(
        lane_m, lane_k, flags["seg_start"], flags["valid"], layout.n_lanes,
        bm, bk, 1, unroll=unroll, pipeline=pipeline, prefetch=prefetch),
        block_dtype, bm, bk)
    basis.update(layout.stats)
    runs = run_offsets(lane_m, layout.n_lanes)
    leaves = dict(
        m_idx=lane_m, k_idx=lane_k, slot_idx=lane_slot,
        row_mask=fin.row_mask, a_brow=a.brow.astype(np.int32),
        a_bcol=a.bcol.astype(np.int32), run_offsets=runs,
        chunk_offsets=chunk_offsets(runs), **flags)
    aux = dict(kind=SPMM, policy=policy, block_shape=(bm, bk),
               grid=(sched.n_m_blocks, sched.n_k_blocks), rhs_grid=None,
               n_out_blocks=sched.n_m_blocks, fingerprint=fingerprint,
               block_dtype=block_dtype, n_lanes=layout.n_lanes, unroll=unroll,
               transpose_lhs=transpose_lhs, pipeline=pipeline,
               bn_hint=bn_hint, prefetch=prefetch,
               has_pads=bool(not layout.valid.all()))
    return _PlanTemplate(aux=aux, leaves=leaves, traffic_basis=basis)


def _build_spmm_template(a: BSR, policy: str, fold_len: Optional[int],
                         with_grad: bool, n_lanes: int, unroll: int,
                         fingerprint: str, block_dtype: str, pipeline: bool,
                         bn_hint: Optional[int],
                         prefetch: Optional[str]) -> _PlanTemplate:
    def one(mat: BSR, slots_of, fp: str, transpose_lhs: bool):
        sched = build_spmm_schedule(mat, policy=policy, fold_len=fold_len)
        fin = finalize_schedule(sched.seg_start, sched.m,
                                n_slots=sched.n_m_blocks)
        layout = partition_lanes(sched.m, n_lanes, unroll=unroll,
                                 policy=policy, seg_start=sched.seg_start,
                                 seg_write=sched.seg_write,
                                 accum_prev=fin.accum_prev)
        bm, bk = mat.block_shape
        return _schedule_template(
            sched, layout, fin, slots_of(sched), bm, bk, policy, fp, unroll,
            pipeline, bn_hint, prefetch, a, transpose_lhs, block_dtype)

    tpl = one(a, lambda s: s.a_idx, fingerprint, False)
    if with_grad:
        # Wᵀ: same stored blocks, coordinates swapped and re-sorted row-major;
        # slot_idx addresses the forward storage (transpose_lhs contracts
        # along block rows, so no transposed copy of W exists)
        bm, bk = a.block_shape
        t_order = np.lexsort((a.brow, a.bcol)).astype(np.int64)
        wt = BSR(shape=(a.shape[1], a.shape[0]), block_shape=(bk, bm),
                 brow=a.bcol[t_order].copy(), bcol=a.brow[t_order].copy(),
                 blocks=np.empty((a.nblocks, 1, 1), np.float32))
        tpl.grad = one(wt, lambda s: t_order[s.a_idx.astype(np.int64)],
                       fingerprint + ":grad", True)
    return tpl


def _build_spgemm_template(a: BSR, b: BSR, policy: str,
                           fold_len: Optional[int], n_lanes: int, unroll: int,
                           fingerprint: str, block_dtype: str, pipeline: bool,
                           bn_hint: Optional[int],
                           prefetch: Optional[str]) -> _PlanTemplate:
    sched = build_spgemm_schedule(a, b, policy=policy, fold_len=fold_len)
    fin = finalize_schedule(sched.seg_start, sched.c_idx)
    bm, bk = a.block_shape
    bn = b.block_shape[1]
    layout = partition_lanes(sched.c_idx, n_lanes, unroll=unroll,
                             policy=policy, seg_start=sched.seg_start,
                             seg_write=sched.seg_write,
                             accum_prev=fin.accum_prev)
    lane_a = lane_select(layout, sched.a_idx).astype(np.int32)
    lane_b = lane_select(layout, sched.b_idx).astype(np.int32)
    lane_c = lane_select(layout, sched.c_idx).astype(np.int32)
    flags = _lane_flags(layout, sched, fin, lane_a, lane_b, unroll)
    traffic = _quantize_spgemm_traffic(lane_traffic_spgemm(
        lane_a, lane_b, lane_c, flags["seg_start"], flags["valid"],
        layout.n_lanes, bm, bk, bn, unroll=unroll, pipeline=pipeline,
        prefetch=prefetch), block_dtype, bm, bk, bn)
    traffic.update(layout.stats)
    runs = run_offsets(lane_c, layout.n_lanes)
    tc_runs, tc_steps = work_table(
        lane_a, lane_b, lane_c, flags["valid"], flags["seg_start"],
        flags["seg_write"], flags["accum_prev"], runs, sched.c_brow,
        sched.c_bcol)
    leaves = dict(
        a_idx=lane_a, b_idx=lane_b, c_idx=lane_c,
        a_brow=a.brow.astype(np.int32), a_bcol=a.bcol.astype(np.int32),
        b_brow=b.brow.astype(np.int32), b_bcol=b.bcol.astype(np.int32),
        c_brow_arr=sched.c_brow, c_bcol_arr=sched.c_bcol,
        run_offsets=runs, tc_runs=tc_runs, tc_steps=tc_steps, **flags)
    aux = dict(kind=SPGEMM, policy=policy, block_shape=(bm, bk),
               grid=a.grid, rhs_grid=b.grid, n_out_blocks=sched.n_c_blocks,
               fingerprint=fingerprint, block_dtype=block_dtype,
               n_lanes=layout.n_lanes, unroll=unroll, pipeline=pipeline,
               bn_hint=bn_hint, prefetch=prefetch,
               has_pads=bool(not layout.valid.all()))
    return _PlanTemplate(aux=aux, leaves=leaves, traffic_basis=traffic)


def _resolve_verify(verify) -> Optional[str]:
    """Normalize the ``verify`` knob: None/False off, True → "fast"."""
    if verify is None or verify is False:
        return None
    if verify is True:
        return "fast"
    if verify in ("fast", "full"):
        return verify
    raise ValueError(f"verify must be None/False/True/'fast'/'full', "
                     f"got {verify!r}")


def _rhs_to_hint(a: BSR, b) -> Tuple[Optional[BSR], int]:
    """Normalize ``B_or_shape`` → (BSR | None, n_cols_hint)."""
    if b is None:
        return None, 1024
    if isinstance(b, BSR):
        return b, b.shape[1]
    if isinstance(b, int):
        shape: Tuple[int, ...] = (a.shape[1], b)
    elif isinstance(b, tuple):
        shape = b
    elif hasattr(b, "shape"):
        shape = tuple(b.shape)
    else:
        raise TypeError(f"B_or_shape must be a dense array, shape tuple or "
                        f"int N, got {type(b).__name__}")
    if len(shape) != 2:
        raise ValueError(f"dense rhs must be 2-D (K, N), got shape {shape}")
    if shape[0] != a.shape[1]:
        raise ValueError(f"rhs K={shape[0]} does not match A K={a.shape[1]}")
    return None, int(shape[1])


def plan_matmul(a: BSR, b_or_shape=None, *, policy: str = "segment",
                backend: Optional[str] = None, fold_len: Optional[int] = None,
                with_grad: bool = False, n_cols_hint: Optional[int] = None,
                n_lanes: int = 1, unroll: int = 1, cache: bool = True,
                quantize: Optional[str] = None, out_dtype=None, verify=None,
                vmem_limit_bytes: Optional[int] = None, pipeline: bool = True,
                bn_hint: Optional[int] = None, prefetch: Optional[str] = None,
                device=None) -> SegmentPlan:
    """Plan a Segment-dataflow matmul for the sparsity pattern of ``a``.

    ``b_or_shape`` is a ``BSR`` (SpGEMM: ``plan()`` returns the C blocks at
    the symbolic pattern), or the dense rhs, its ``(K, N)`` shape or ``N``
    (SpMM: only a traffic hint).  The knobs mean what they mean in
    ``repro.api.plan_matmul``: ``policy`` (a registered policy),
    ``fold_len`` (temporal-fold cap), ``with_grad`` (also build the
    transposed schedule; SpMM only), ``n_lanes`` and ``unroll`` (lane
    partitioning), ``n_cols_hint`` (traffic hint), ``quantize``
    (``"int8"``/``"fp8"`` store A, and for SpGEMM B too, as payloads with
    one fp32 scale per block, ``"int8.rowwise"``/``"fp8.rowwise"`` one per
    block row; the SpMM kernel dequantizes at its fp32 accumulator),
    ``out_dtype`` (default output dtype), ``cache`` (the fingerprint
    cache), ``pipeline``/``bn_hint``/``prefetch`` (recorded on the plan;
    the TPU DMA-timing knobs change no result).  ``verify``
    (``True``/``"fast"``: the structural catalog; ``"full"``: also the
    traffic-model recount) verifies each cached template once and checks
    the realized values' scales on every call, raising
    :class:`~repro_torch.analysis.PlanVerificationError` on a finding.
    ``vmem_limit_bytes`` raises
    :class:`~repro_torch.analysis.budget.VmemBudgetError` when a launch
    the plan can make at its N hint (on any path ``choose_path`` can take
    it to, the transposed one too) asks for more shared memory; the
    default, ``None``, checks nothing, and the card's own limit is
    ``DEFAULT_VMEM_LIMIT_BYTES`` (232,448 bytes on an H100).
    ``policy="auto"`` runs :func:`repro_torch.tune.select_schedule` over
    the pattern (explicit ``fold_len``/``n_lanes``/``unroll``/
    ``pipeline``/``bn_hint``/``prefetch`` are pinned) and plans with its
    winner.  It always tunes for ``"cuda"``, the H100's fitted models,
    whatever the device: a plan is the same on either.  (``repro`` tunes
    for its ``"interpret"`` model off the TPU.)  ``device`` places the
    plan's tensors; ``None`` means the card.
    """
    if backend is not None:
        resolve_backend(backend)
    if quantize is not None and quantize not in QUANT_MODES:
        raise ValueError(f"unknown quantize dtype {quantize!r}; "
                         f"available: {QUANT_MODES} or None")
    if prefetch not in PREFETCH_MODES:
        raise ValueError(f"prefetch={prefetch!r} not in {PREFETCH_MODES}")
    if prefetch is not None and not pipeline:
        raise ValueError("prefetch='cross_pass' requires pipeline=True")
    if policy == "auto":
        # the knob search lives in repro_torch.tune, imported only here;
        # explicit knobs become pins the search must keep
        from repro_torch.tune.search import select_schedule
        b0, hint0 = _rhs_to_hint(a, b_or_shape)
        if n_cols_hint is not None:
            hint0 = n_cols_hint
        pins: Dict[str, object] = {}
        if fold_len is not None:
            pins["fold_len"] = fold_len
        if n_lanes != 1:
            pins["n_lanes"] = n_lanes
        if unroll != 1:
            pins["unroll"] = unroll
        if pipeline is not True:
            pins["pipeline"] = pipeline
        if bn_hint is not None:
            pins["bn"] = bn_hint
        if prefetch is not None:
            pins["prefetch"] = prefetch
        # always the card's objective: a plan is the same on either device
        best = select_schedule(a, b0, n_cols_hint=hint0, with_grad=with_grad,
                               quantize=quantize, objective="cuda",
                               vmem_limit_bytes=vmem_limit_bytes, pins=pins,
                               rhs_dtype=getattr(b_or_shape, "dtype", None))
        return plan_matmul(
            a, b_or_shape, policy=best.policy, backend=backend,
            fold_len=best.fold_len, with_grad=with_grad,
            n_cols_hint=n_cols_hint, n_lanes=best.n_lanes,
            unroll=best.unroll, cache=cache, quantize=quantize,
            out_dtype=out_dtype, verify=verify,
            vmem_limit_bytes=vmem_limit_bytes, pipeline=best.pipeline,
            bn_hint=best.bn, prefetch=best.prefetch, device=device)
    pol = get_policy(policy)
    b, hint = _rhs_to_hint(a, b_or_shape)
    if n_cols_hint is not None:
        hint = n_cols_hint
    if b is not None and with_grad:
        raise NotImplementedError("with_grad is only supported for SpMM plans")
    device = resolve_device(device)
    block_dtype = quantize if quantize is not None else "fp32"
    kind = SPGEMM if b is not None else SPMM
    mats = (a, b) if b is not None else (a,)
    key = pattern_fingerprint(kind, f"{policy}#{pol.serial}", fold_len,
                              with_grad, *mats, n_lanes=n_lanes,
                              unroll=unroll, block_dtype=block_dtype,
                              n_bucket=_bucket_hint(hint) if b is None
                              else None,
                              pipeline=pipeline, bn_hint=bn_hint,
                              prefetch=prefetch)
    level = _resolve_verify(verify)
    tpl = _CACHE.get(key) if cache else None
    if tpl is None:
        if kind == SPMM:
            tpl = _build_spmm_template(a, policy, fold_len, with_grad,
                                       n_lanes, unroll, key, block_dtype,
                                       pipeline, bn_hint, prefetch)
        else:
            tpl = _build_spgemm_template(a, b, policy, fold_len, n_lanes,
                                         unroll, key, block_dtype, pipeline,
                                         bn_hint, prefetch)
        _STATS["misses"] += 1
        if cache:
            _CACHE[key] = tpl
    else:
        _STATS["hits"] += 1
    if level is not None:
        covered = ("fast", "full") if level == "fast" else ("full",)
        if tpl.verified_level not in covered:
            # the value-free template, once; remembered on the cache entry
            verify_plan(tpl.host_plan(), level=level).raise_if_findings()
            tpl.verified_level = level
    values = {}
    values["lhs_blocks"], values["lhs_scales"] = _realize_values(
        a.blocks, block_dtype, device)
    if b is not None:
        values["rhs_blocks"], values["rhs_scales"] = _realize_values(
            b.blocks, block_dtype, device)
    plan = tpl.realize(values, device, backend, hint, dtype_name(out_dtype))
    if level is not None:
        # the value leaves are the only per-realize freedom: their dtype
        # and shape agreement, on every call
        findings = check_scale_agreement(plan)
        if findings:
            raise PlanVerificationError(VerifyResult(
                findings=tuple(findings), level=level,
                checked=("scale-agreement",)))
    if vmem_limit_bytes is not None:
        from repro_torch.analysis.budget import check_plan_vmem
        check_plan_vmem(plan, bn=bn_hint or 512,
                        n_cols=hint if kind == SPMM else None,
                        limit=vmem_limit_bytes,
                        label=f"plan_matmul[{kind}]")
    return plan
