"""``plan_matmul`` — pattern → :class:`SegmentPlan` (SpMM half of
``repro.api.planner``).

Planning is host-side numpy work (ordering, folding, lane partitioning,
finalization) that depends only on the sparsity pattern, so plans are cached
by a pattern fingerprint; realization attaches the block values (uploaded
in BSR storage order, never gathered) and the schedule leaves on the
requested device.

Not ported yet, and raising ``NotImplementedError`` (see ROADMAP): a BSR
right-hand side (SpGEMM), ``policy="auto"`` and ``vmem_limit_bytes`` (the
tuner and budget checks), ``verify`` (the plan verifier) and ``quantize``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.formats import BSR
from repro_torch.core.policies import get_policy
from repro_torch.core.schedule import (PREFETCH_MODES, LaneLayout,
                                       build_spmm_schedule, fetch_flags,
                                       finalize_schedule, lane_select,
                                       lane_traffic_spmm, partition_lanes)
from repro_torch.kernels.segment_spmm import run_offsets

from .backends import resolve_backend, resolve_device
from .plan import SPMM, SegmentPlan


def _freeze_traffic(traffic: dict) -> Tuple[Tuple[str, float], ...]:
    return tuple(sorted(traffic.items()))


def _scale_spmm_traffic(basis: dict, n_cols: int) -> dict:
    """Re-price a unit-N traffic basis for a concrete dense width."""
    out = dict(basis)
    out["b_bytes"] = basis["b_bytes"] * n_cols
    out["c_bytes"] = basis["c_bytes"] * n_cols
    out["total"] = basis["a_bytes"] + out["b_bytes"] + out["c_bytes"]
    return out


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

    def device_leaves(self, device: torch.device) -> dict:
        got = self.on_device.get(device)
        if got is None:
            got = {k: torch.from_numpy(v).to(device)
                   for k, v in self.leaves.items()}
            self.on_device[device] = got
        return got

    def realize(self, blocks: Optional[torch.Tensor], device: torch.device,
                backend: Optional[str], n_cols: int,
                out_dtype: Optional[str]) -> SegmentPlan:
        grad = None
        if self.grad is not None:
            grad = self.grad.realize(None, device, None, n_cols, None)
        return SegmentPlan(
            **self.aux, **self.device_leaves(device),
            traffic_items=_freeze_traffic(
                _scale_spmm_traffic(self.traffic_basis, n_cols)),
            lhs_blocks=blocks, grad_plan=grad, backend=backend,
            out_dtype=out_dtype)


_CACHE: Dict[str, _PlanTemplate] = {}
_STATS = {"hits": 0, "misses": 0}


def clear_plan_cache() -> None:
    """Drop every cached template."""
    _CACHE.clear()
    for k in _STATS:
        _STATS[k] = 0


def plan_cache_stats() -> Dict[str, int]:
    """Hit/miss counters + cache size."""
    return dict(_STATS, size=len(_CACHE))


def _schedule_template(sched, layout: LaneLayout, fin, slots: np.ndarray,
                       bm: int, bk: int, policy: str, fingerprint: str,
                       unroll: int, pipeline: bool, bn_hint: Optional[int],
                       prefetch: Optional[str], a: BSR,
                       transpose_lhs: bool) -> _PlanTemplate:
    """Lane-major leaves, fetch schedule and traffic basis of one built
    schedule (the forward plan or its transposed backward twin)."""
    valid = layout.valid.reshape(-1)
    lane_m = lane_select(layout, sched.m).astype(np.int32)
    lane_k = lane_select(layout, sched.k).astype(np.int32)
    lane_slot = lane_select(layout, slots).astype(np.int32)
    flags = dict(
        seg_start=lane_select(layout, sched.seg_start, zero_pads=True),
        seg_write=lane_select(layout, sched.seg_write, zero_pads=True),
        accum_prev=lane_select(layout, fin.accum_prev, zero_pads=True),
        valid=valid.astype(np.int32))
    depth = 2 * unroll
    a_f, a_s = fetch_flags(lane_slot, valid, layout.n_lanes, depth=depth)
    b_f, b_s = fetch_flags(lane_k, valid, layout.n_lanes, depth=depth)
    basis = lane_traffic_spmm(
        lane_m, lane_k, flags["seg_start"], valid, layout.n_lanes, bm, bk, 1,
        unroll=unroll, pipeline=pipeline, prefetch=prefetch)
    basis.update(layout.stats)
    leaves = dict(
        m_idx=lane_m, k_idx=lane_k, slot_idx=lane_slot,
        row_mask=fin.row_mask, a_brow=a.brow.astype(np.int32),
        a_bcol=a.bcol.astype(np.int32),
        a_fetch=a_f, b_fetch=b_f, a_slot=a_s, b_slot=b_s,
        run_offsets=run_offsets(lane_m, layout.n_lanes),
        **{k: v.astype(np.int32) for k, v in flags.items()})
    aux = dict(kind=SPMM, policy=policy, block_shape=(bm, bk),
               grid=(sched.n_m_blocks, sched.n_k_blocks), rhs_grid=None,
               n_out_blocks=sched.n_m_blocks, fingerprint=fingerprint,
               block_dtype="fp32", n_lanes=layout.n_lanes, unroll=unroll,
               transpose_lhs=transpose_lhs, pipeline=pipeline,
               bn_hint=bn_hint, prefetch=prefetch,
               has_pads=bool(not layout.valid.all()))
    return _PlanTemplate(aux=aux, leaves=leaves, traffic_basis=basis)


def _build_spmm_template(a: BSR, policy: str, fold_len: Optional[int],
                         with_grad: bool, n_lanes: int, unroll: int,
                         fingerprint: str, pipeline: bool,
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
            pipeline, bn_hint, prefetch, a, transpose_lhs)

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


def _rhs_to_hint(a: BSR, b) -> int:
    """Normalize ``B_or_shape`` → the dense-N traffic hint."""
    if b is None:
        return 1024
    if isinstance(b, BSR):
        raise NotImplementedError(
            "plan_matmul: SpGEMM (a BSR right-hand side) is not ported yet; "
            "see ROADMAP 'SpGEMM'")
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
    return int(shape[1])


def _dtype_name(dtype) -> Optional[str]:
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def plan_matmul(a: BSR, b_or_shape=None, *, policy: str = "segment",
                backend: Optional[str] = None, fold_len: Optional[int] = None,
                with_grad: bool = False, n_cols_hint: Optional[int] = None,
                n_lanes: int = 1, unroll: int = 1, cache: bool = True,
                quantize: Optional[str] = None, out_dtype=None, verify=None,
                vmem_limit_bytes: Optional[int] = None, pipeline: bool = True,
                bn_hint: Optional[int] = None, prefetch: Optional[str] = None,
                device=None) -> SegmentPlan:
    """Plan a Segment-dataflow SpMM for the sparsity pattern of ``a``.

    The knobs mean what they mean in ``repro.api.plan_matmul``:
    ``policy`` (a registered policy), ``fold_len`` (temporal-fold cap),
    ``with_grad`` (also build the transposed schedule), ``n_lanes`` and
    ``unroll`` (lane partitioning), ``n_cols_hint`` (traffic hint),
    ``out_dtype`` (default output dtype), ``cache`` (the fingerprint cache),
    ``pipeline``/``bn_hint``/``prefetch`` (recorded on the plan; the TPU
    DMA-timing knobs change no result).  ``device`` places the plan's
    tensors; ``None`` means the card.
    """
    if policy == "auto":
        raise NotImplementedError(
            "plan_matmul(policy='auto'): the schedule tuner is not ported "
            "yet; see ROADMAP 'plan verification and tuning'")
    if verify not in (None, False):
        raise NotImplementedError(
            "plan_matmul(verify=...): the plan verifier is not ported yet; "
            "see ROADMAP 'plan verification and tuning'")
    if vmem_limit_bytes is not None:
        raise NotImplementedError(
            "plan_matmul(vmem_limit_bytes=...): the budget check is not "
            "ported yet; see ROADMAP 'plan verification and tuning'")
    if quantize is not None:
        raise NotImplementedError(
            "plan_matmul(quantize=...): quantized block storage is not "
            "ported yet; see ROADMAP 'quantized serving'")
    if backend is not None:
        resolve_backend(backend)
    if prefetch not in PREFETCH_MODES:
        raise ValueError(f"prefetch={prefetch!r} not in {PREFETCH_MODES}")
    if prefetch is not None and not pipeline:
        raise ValueError("prefetch='cross_pass' requires pipeline=True")
    device = resolve_device(device)
    pol = get_policy(policy)
    hint = _rhs_to_hint(a, b_or_shape)
    if n_cols_hint is not None:
        hint = n_cols_hint
    key = pattern_fingerprint(SPMM, f"{policy}#{pol.serial}", fold_len,
                              with_grad, a, n_lanes=n_lanes, unroll=unroll,
                              n_bucket=_bucket_hint(hint), pipeline=pipeline,
                              bn_hint=bn_hint, prefetch=prefetch)
    tpl = _CACHE.get(key) if cache else None
    if tpl is None:
        tpl = _build_spmm_template(a, policy, fold_len, with_grad, n_lanes,
                                   unroll, key, pipeline, bn_hint, prefetch)
        _STATS["misses"] += 1
        if cache:
            _CACHE[key] = tpl
    else:
        _STATS["hits"] += 1
    blocks = torch.as_tensor(np.asarray(a.blocks, np.float32), device=device)
    return tpl.realize(blocks, device, backend, hint, _dtype_name(out_dtype))
