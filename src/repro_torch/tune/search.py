"""Analytical schedule search and dataflow selection (the port of
``repro.tune.search``).

:func:`autotune_matmul` sweeps the knob grid — ``fold_len`` × ``n_lanes``
× ``unroll`` × ``bn`` × ``pipeline`` × ``prefetch`` — across every
registered schedule policy and prices each candidate; nothing executes.
Candidates are priced from the host schedule arrays, rejected against the
shared-memory budget of the launches they would make
(:mod:`repro_torch.analysis.budget`), ranked, and the winner is built once
and gated through ``verify_plan(level="full")`` plus the plan-level budget
check; a candidate that fails either falls through to the runner-up.

Two ways to price:

* an explicit :class:`~repro_torch.tune.cost.CostModel` (``objective=``
  or ``cost_model=``) prices as ``repro`` does — the revisiting-model
  traffic and the TPU grid's steps — so under one model both packages
  rank the same candidates the same way (only ``vmem_bytes`` differs: it
  measures other hardware);
* ``objective="cuda"`` (the default) prices the work the H100's kernels
  do (:func:`~repro_torch.tune.cost.spmm_card_work`,
  :func:`~repro_torch.tune.cost.spgemm_card_work`) with the model fitted
  on the card for the path the call takes at the N hint
  (:data:`~repro_torch.tune.cost.DEFAULT_CUDA`).  Knobs the card ignores
  price equal, so the rank key's tie-break keeps the planner's default.

``"tpu"`` and ``"interpret"`` name ``repro``'s models of other hardware
and raise ``ValueError`` here.

Dataflow selection rides on top, as in ``repro``: the static policies'
closed-form ``cost_hint`` estimates (:func:`repro_torch.sim.baselines
.dataflow_estimates`), each swept policy's default-knob revisiting-model
traffic, and the analytic ``"inner"`` dataflow, which has no policy: when
it wins on paper the tuner counts a ``dataflow_fallbacks`` tick in
:func:`repro_torch.api.plan_cache_stats`.

Winning schedules are cached by a pattern fingerprint (pattern bytes,
bucketed N hint, search configuration); the cache empties with
:func:`repro_torch.api.clear_plan_cache`.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.analysis.budget import (DEFAULT_VMEM_LIMIT_BYTES,
                                         VmemBudgetError, spgemm_vmem_bytes,
                                         spmm_vmem_bytes)
from repro_torch.analysis.invariants import PlanVerificationError
from repro_torch.core.formats import BSR, quant_base_dtype
from repro_torch.core.policies import available_policies, get_policy
from repro_torch.core.schedule import (build_spgemm_schedule,
                                       build_spmm_schedule, finalize_schedule,
                                       lane_select, lane_traffic_spgemm,
                                       lane_traffic_spmm, partition_lanes)
from repro_torch.kernels.segment_spmm import run_offsets
from repro_torch.sim.baselines import dataflow_estimates

from .cost import (DEFAULT_CUDA, CostModel, spgemm_card_work, spmm_card_work,
                   spmm_path)

#: plan ``block_dtype`` names → the dtype names the budget formulas take
_VMEM_DTYPE = {"fp32": "float32", "int8": "int8", "fp8": "float8_e4m3fn"}


def _vmem_dtype(block_dtype: str) -> str:
    return _VMEM_DTYPE[quant_base_dtype(block_dtype)]


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the knob grid: a (dataflow, schedule-shape) choice."""

    policy: str
    fold_len: Optional[int]
    n_lanes: int
    unroll: int
    bn: int
    pipeline: bool
    prefetch: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Knob axes the search sweeps (``repro``'s defaults).  The default
    space holds the planner's default point (``segment``, no fold, 1 lane,
    unroll 1, ``bn=512``, pipelined), so the winner is never worse than
    the default under the model being optimized.  ``policies=None`` sweeps
    every registered policy."""

    fold_lens: Tuple[Optional[int], ...] = (None, 8)
    n_lanes: Tuple[int, ...] = (1, 2, 4)
    unrolls: Tuple[int, ...] = (1, 2)
    bns: Tuple[int, ...] = (128, 512)
    pipelines: Tuple[bool, ...] = (True, False)
    prefetches: Tuple[Optional[str], ...] = (None, "cross_pass")
    policies: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class Scored:
    """A feasible candidate with its model price."""

    candidate: Candidate
    cost_us: float
    traffic: Tuple[Tuple[str, float], ...]   # frozen traffic dict
    lane_len: int                            # padded per-lane items
    n_tiles_n: int
    vmem_bytes: int                          # the launches' shared memory

    @property
    def traffic_total(self) -> float:
        return dict(self.traffic)["total"]


@dataclasses.dataclass
class TuneResult:
    """Outcome of one schedule search (possibly served from the cache)."""

    best: Scored
    candidates: Tuple[Scored, ...]           # ranked, best first
    dataflow_scores: Dict[str, float]        # analytic bytes per dataflow
    dataflow_choice: str                     # analytically best dataflow
    dataflow_dispatched: str                 # ...the dispatchable one used
    objective: str
    n_rejected_vmem: int
    from_cache: bool = False

    def plan_kwargs(self) -> Dict[str, object]:
        """Keyword arguments that make :func:`repro_torch.api.plan_matmul`
        build the winning schedule."""
        c = self.best.candidate
        return dict(policy=c.policy, fold_len=c.fold_len, n_lanes=c.n_lanes,
                    unroll=c.unroll, pipeline=c.pipeline, bn_hint=c.bn,
                    prefetch=c.prefetch)


#: fingerprint → TuneResult; cleared by repro_torch.api.clear_plan_cache
_SEARCH_CACHE: Dict[str, TuneResult] = {}


def _pin(pins: Dict[str, object], key: str, axis: tuple) -> tuple:
    """An explicitly pinned knob collapses its axis to the pinned value."""
    if key in pins:
        return (pins[key],)
    return axis


def _resolve_model(objective, cost_model):
    """``(model, name)``: a :class:`CostModel`, or the per-path dict of
    fitted models for ``"cuda"``."""
    if cost_model is not None:
        return cost_model, "custom"
    if isinstance(objective, CostModel):
        return objective, "custom"
    if objective == "cuda":
        return DEFAULT_CUDA, "cuda"
    if objective in ("tpu", "interpret"):
        raise ValueError(
            f"objective={objective!r} is repro's model of other hardware; "
            f"the port tunes for 'cuda' (the H100's fitted models) or an "
            f"explicit CostModel")
    raise ValueError(f"objective must be 'cuda' or a CostModel, got "
                     f"{objective!r}")


def _model_key(model) -> tuple:
    if isinstance(model, CostModel):
        return dataclasses.astuple(model)
    return tuple((k, dataclasses.astuple(v)) for k, v in sorted(model.items()))


def _search_key(kind: str, mats, n_bucket: Optional[int], with_grad: bool,
                block_dtype: str, space: SearchSpace, model,
                objective: str, limit: int, pins: Dict[str, object],
                rhs_dtype: Optional[str]) -> str:
    h = hashlib.sha1()
    h.update(repr((kind, n_bucket, with_grad, block_dtype,
                   dataclasses.astuple(space), _model_key(model),
                   objective, limit, tuple(sorted(pins.items())),
                   rhs_dtype)).encode())
    for m in mats:
        h.update(np.asarray(m.shape, np.int64).tobytes())
        h.update(np.asarray(m.block_shape, np.int64).tobytes())
        h.update(np.ascontiguousarray(m.brow, np.int64).tobytes())
        h.update(np.ascontiguousarray(m.bcol, np.int64).tobytes())
    return h.hexdigest()


def _rank_key(s: Scored, policy_order: Tuple[str, ...]):
    """Total order on scored candidates: model cost, then traffic bytes,
    then every tie broken toward the planner's default point (segment
    first, fewer lanes, smaller unroll, no fold, no prefetch, pipelined,
    wider bn)."""
    c = s.candidate
    return (s.cost_us, s.traffic_total,
            policy_order.index(c.policy) if c.policy in policy_order
            else len(policy_order),
            c.n_lanes, c.unroll,
            c.fold_len is not None, c.fold_len or 0,
            c.prefetch is not None,
            not c.pipeline, -c.bn)


def _is_default(c: Candidate) -> bool:
    """The default knobs at which a policy's dataflow is scored."""
    return (c.fold_len is None and c.n_lanes == 1 and c.unroll == 1
            and c.pipeline and c.prefetch is None)


def _card_scored(cand: Candidate, work: dict, model: CostModel,
                 lane_len: int, vbytes: int) -> "Scored":
    traffic = {k: work[k] for k in ("a_bytes", "b_bytes", "c_bytes", "total")}
    traffic["steps"] = work["steps"]
    return Scored(cand, model.predict_us(work["total"], work["steps"]),
                  tuple(sorted(traffic.items())), lane_len,
                  int(work["n_tiles"]), vbytes)


def _score_spmm(a: BSR, hint: int, block_dtype: str, model,
                space: SearchSpace, limit: int, pins: Dict[str, object],
                rhs_dtype: Optional[str]):
    from repro_torch.api.executor import pick_bn
    from repro_torch.api.planner import _quantize_a_traffic
    bm, bk = a.block_shape
    card = not isinstance(model, CostModel)
    path = spmm_path(bm, bk, max(1, hint), rhs_dtype)
    policies = _pin(pins, "policy",
                    space.policies or available_policies())
    scored, rejected, default_traffic = [], 0, {}
    for policy in policies:
        pol = get_policy(policy)
        folds = (_pin(pins, "fold_len", space.fold_lens)
                 if pol.supports_fold else (None,))
        for fold in folds:
            sched = build_spmm_schedule(a, policy=policy, fold_len=fold)
            fin = finalize_schedule(sched.seg_start, sched.m,
                                    n_slots=sched.n_m_blocks)
            for lanes in _pin(pins, "n_lanes", space.n_lanes):
                for un in _pin(pins, "unroll", space.unrolls):
                    layout = partition_lanes(
                        sched.m, lanes, unroll=un, policy=policy,
                        seg_start=sched.seg_start, seg_write=sched.seg_write,
                        accum_prev=fin.accum_prev)
                    lane_m = lane_select(layout, sched.m)
                    lane_k = lane_select(layout, sched.k)
                    ss = lane_select(layout, sched.seg_start, zero_pads=True)
                    valid = layout.valid.reshape(-1)
                    flags = None
                    if card:
                        flags = dict(
                            m=lane_m, valid=valid,
                            seg_write=lane_select(layout, sched.seg_write,
                                                  zero_pads=True),
                            accum_prev=lane_select(layout, fin.accum_prev,
                                                   zero_pads=True),
                            runs=run_offsets(lane_m, layout.n_lanes))
                    for pipe in _pin(pins, "pipeline", space.pipelines):
                        # cross-pass prefetch only exists on the explicit
                        # DMA pipeline; the legacy path sweeps prefetch=None
                        pfs = (_pin(pins, "prefetch", space.prefetches)
                               if pipe else (None,))
                        for pf in pfs:
                            traffic = _quantize_a_traffic(lane_traffic_spmm(
                                lane_m, lane_k, ss, valid, layout.n_lanes,
                                bm, bk, hint, unroll=un, pipeline=pipe,
                                prefetch=pf),
                                block_dtype, bm, bk)
                            for bn in _pin(pins, "bn", space.bns):
                                cand = Candidate(policy, fold, lanes, un, bn,
                                                 pipe, pf)
                                vbytes = spmm_vmem_bytes(
                                    bm=bm, bk=bk, bn=bn, unroll=un,
                                    block_dtype=_vmem_dtype(block_dtype),
                                    rhs_dtype=rhs_dtype,
                                    quantized=block_dtype != "fp32",
                                    rowwise=block_dtype.endswith(".rowwise"),
                                    pipelined=pipe, n_cols=max(1, hint))
                                if vbytes > limit:
                                    rejected += 1
                                    continue
                                if _is_default(cand):
                                    default_traffic[policy] = traffic["total"]
                                if card:
                                    work = spmm_card_work(
                                        path=path, bm=bm, bk=bk,
                                        n=max(1, hint), bn=bn,
                                        block_dtype=block_dtype,
                                        rhs_dtype=rhs_dtype, **flags)
                                    scored.append(_card_scored(
                                        cand, work, model[path],
                                        layout.lane_len, vbytes))
                                    continue
                                bn_eff, pad = pick_bn(max(1, hint), bn)
                                n_tiles = (max(1, hint) + pad) // bn_eff
                                cost = model.cost_us(
                                    traffic_bytes=traffic["total"],
                                    n_lanes=layout.n_lanes,
                                    lane_len=layout.lane_len, unroll=un,
                                    n_tiles_n=n_tiles, pipelined=pipe,
                                    prefetch=pf is not None)
                                scored.append(Scored(
                                    cand, cost,
                                    tuple(sorted(traffic.items())),
                                    layout.lane_len, n_tiles, vbytes))
    return scored, rejected, tuple(policies), default_traffic


def _score_spgemm(a: BSR, b: BSR, block_dtype: str, model,
                  space: SearchSpace, limit: int, pins: Dict[str, object]):
    from repro_torch.api.planner import _quantize_spgemm_traffic
    bm, bk = a.block_shape
    bn = b.block_shape[1]   # SpGEMM's N tile is B's block width — not a knob
    card = not isinstance(model, CostModel)
    path = "spgemm_tc" if bm == bk == bn == 64 else "spgemm_simt"
    policies = _pin(pins, "policy",
                    space.policies or available_policies())
    scored, rejected, default_traffic = [], 0, {}
    for policy in policies:
        pol = get_policy(policy)
        folds = (_pin(pins, "fold_len", space.fold_lens)
                 if pol.supports_fold else (None,))
        for fold in folds:
            sched = build_spgemm_schedule(a, b, policy=policy, fold_len=fold)
            fin = finalize_schedule(sched.seg_start, sched.c_idx)
            for lanes in _pin(pins, "n_lanes", space.n_lanes):
                for un in _pin(pins, "unroll", space.unrolls):
                    layout = partition_lanes(
                        sched.c_idx, lanes, unroll=un, policy=policy,
                        seg_start=sched.seg_start, seg_write=sched.seg_write,
                        accum_prev=fin.accum_prev)
                    lane_a = lane_select(layout, sched.a_idx)
                    lane_b = lane_select(layout, sched.b_idx)
                    lane_c = lane_select(layout, sched.c_idx)
                    ss = lane_select(layout, sched.seg_start, zero_pads=True)
                    valid = layout.valid.reshape(-1)
                    work = None
                    if card:
                        work = spgemm_card_work(
                            valid=valid,
                            seg_write=lane_select(layout, sched.seg_write,
                                                  zero_pads=True),
                            accum_prev=lane_select(layout, fin.accum_prev,
                                                   zero_pads=True),
                            runs=run_offsets(lane_c, layout.n_lanes),
                            bm=bm, bk=bk, bn=bn, block_dtype=block_dtype)
                    for pipe in _pin(pins, "pipeline", space.pipelines):
                        traffic = _quantize_spgemm_traffic(lane_traffic_spgemm(
                            lane_a, lane_b, lane_c, ss, valid, layout.n_lanes,
                            bm, bk, bn, unroll=un, pipeline=pipe),
                            block_dtype, bm, bk, bn)
                        cand = Candidate(policy, fold, lanes, un, bn, pipe,
                                         pins.get("prefetch") if pipe
                                         else None)
                        vbytes = spgemm_vmem_bytes(
                            bm=bm, bk=bk, bn=bn, unroll=un,
                            block_dtype=_vmem_dtype(block_dtype),
                            quant_a=block_dtype != "fp32",
                            quant_b=block_dtype != "fp32",
                            rowwise=block_dtype.endswith(".rowwise"),
                            pipelined=pipe)
                        if vbytes > limit:
                            rejected += 1
                            continue
                        if _is_default(cand):
                            default_traffic[policy] = traffic["total"]
                        if card:
                            scored.append(_card_scored(
                                cand, work, model[path], layout.lane_len,
                                vbytes))
                            continue
                        cost = model.cost_us(
                            traffic_bytes=traffic["total"],
                            n_lanes=layout.n_lanes,
                            lane_len=layout.lane_len, unroll=un, n_tiles_n=1,
                            pipelined=pipe)
                        scored.append(Scored(
                            cand, cost, tuple(sorted(traffic.items())),
                            layout.lane_len, 1, vbytes))
    return scored, rejected, tuple(policies), default_traffic


def _dataflow_scores(kind: str, a: BSR, b: Optional[BSR], hint: int,
                     default_traffic: Dict[str, float],
                     policies: Tuple[str, ...]) -> Dict[str, float]:
    """Analytic bytes per dataflow at default knobs: closed-form estimates
    for the hint-carrying policies and ``"inner"``, overlaid with each
    swept policy's own default-knob (1 lane, unroll 1, no fold, pipelined)
    revisiting-model traffic — that is how the hint-less ``segment`` gets
    scored."""
    bm, bk = a.block_shape
    if kind == "spmm":
        est = dataflow_estimates("spmm", bm=bm, bk=bk, n_cols=hint,
                                 m=a.brow.astype(np.int64),
                                 k=a.bcol.astype(np.int64))
    else:
        sched = build_spgemm_schedule(a, b, policy=policies[0])
        est = dataflow_estimates(
            "spgemm", bm=bm, bk=bk, bn=b.block_shape[1],
            m=sched.m.astype(np.int64), n=sched.n.astype(np.int64),
            k=sched.k.astype(np.int64), c=sched.c_idx.astype(np.int64),
            a_idx=sched.a_idx.astype(np.int64),
            b_idx=sched.b_idx.astype(np.int64))
    scores = {name: float(e["total"]) for name, e in est.items()}
    scores.update(default_traffic)
    return scores


def _rhs_dtype_name(b_or_shape, rhs_dtype) -> Optional[str]:
    """``rhs_dtype`` as a name, else the dtype of a dense rhs given as an
    array, else ``None`` (a shape or N: the models' bf16)."""
    dt = rhs_dtype if rhs_dtype is not None else getattr(b_or_shape, "dtype",
                                                         None)
    if dt is None:
        return None
    name = str(dt).removeprefix("torch.")
    return name if name in ("float32", "bfloat16") else None


def autotune_matmul(a: BSR, b_or_shape=None, *,
                    space: Optional[SearchSpace] = None,
                    objective="cuda", cost_model: Optional[CostModel] = None,
                    n_cols_hint: Optional[int] = None, with_grad: bool = False,
                    quantize: Optional[str] = None,
                    vmem_limit_bytes: Optional[int] = None,
                    cache: bool = True,
                    pins: Optional[Dict[str, object]] = None,
                    rhs_dtype=None) -> TuneResult:
    """Search the knob grid for the cheapest feasible schedule of ``a``'s
    pattern (× ``b``'s for SpGEMM) under the given objective.

    Purely static: no candidate is ever executed.  Candidates whose
    launches exceed ``vmem_limit_bytes`` of shared memory are rejected;
    the ranked winner is built once and must pass
    ``verify_plan(level="full")`` plus the plan-level budget, else the
    runner-up is promoted.  ``pins`` maps knob names (``policy``/
    ``fold_len``/``n_lanes``/``unroll``/``bn``/``pipeline``/``prefetch``)
    to values the search keeps fixed.  ``rhs_dtype`` (``"float32"`` or
    ``"bfloat16"``; taken from ``b_or_shape`` when it is a dense array)
    picks the SpMM path the ``"cuda"`` objective prices; ``None`` means
    the models' bf16.  Results are cached by pattern fingerprint
    (``cache=True``) so repeat patterns skip the sweep."""
    from repro_torch.api import planner as _planner
    b, hint = _planner._rhs_to_hint(a, b_or_shape)
    if n_cols_hint is not None:
        hint = int(n_cols_hint)
    if b is not None and with_grad:
        raise NotImplementedError("with_grad is only supported for SpMM plans")
    model, obj_name = _resolve_model(objective, cost_model)
    limit = (DEFAULT_VMEM_LIMIT_BYTES if vmem_limit_bytes is None
             else vmem_limit_bytes)
    space = space or SearchSpace()
    pins = dict(pins or {})
    block_dtype = quantize if quantize is not None else "fp32"
    kind = "spgemm" if b is not None else "spmm"
    mats = (a, b) if b is not None else (a,)
    rhs = _rhs_dtype_name(b_or_shape, rhs_dtype) if b is None else None
    key = _search_key(kind, mats,
                      _planner._bucket_hint(hint) if b is None else None,
                      with_grad, block_dtype, space, model, obj_name, limit,
                      pins, rhs)
    if cache and key in _SEARCH_CACHE:
        _planner._STATS["search_cache_hits"] += 1
        return dataclasses.replace(_SEARCH_CACHE[key], from_cache=True)
    _planner._STATS["searched"] += 1

    if kind == "spmm":
        scored, rejected, policies, default_traffic = _score_spmm(
            a, hint, block_dtype, model, space, limit, pins, rhs)
    else:
        scored, rejected, policies, default_traffic = _score_spgemm(
            a, b, block_dtype, model, space, limit, pins)
    if not scored:
        raise ValueError(
            f"autotune_matmul: every candidate in the search space exceeds "
            f"the {limit}-byte shared-memory (VMEM) budget ({rejected} "
            f"rejected); widen the space or raise vmem_limit_bytes")
    ranked = tuple(sorted(scored, key=lambda s: _rank_key(s, policies)))

    scores = _dataflow_scores(kind, a, b, hint, default_traffic, policies)
    choice = min(scores, key=lambda n: (scores[n], n != "segment"))
    dispatchable = {s.candidate.policy for s in scored}
    if choice not in dispatchable:
        _planner._STATS["dataflow_fallbacks"] += 1
        dispatched = min((n for n in scores if n in dispatchable),
                         key=lambda n: (scores[n], n != "segment"))
    else:
        dispatched = choice

    # static winner gate: the best candidate must survive the full verifier
    # and the plan-level budget; a failure promotes the runner-up
    best = None
    for s in ranked:
        c = s.candidate
        try:
            _planner.plan_matmul(
                a, b_or_shape, policy=c.policy, fold_len=c.fold_len,
                with_grad=with_grad, n_cols_hint=hint, n_lanes=c.n_lanes,
                unroll=c.unroll, cache=False, quantize=quantize,
                pipeline=c.pipeline, bn_hint=c.bn, prefetch=c.prefetch,
                verify="full", vmem_limit_bytes=limit, device="cpu")
        except (PlanVerificationError, VmemBudgetError):
            continue
        best = s
        break
    if best is None:
        raise ValueError("autotune_matmul: no candidate passed the static "
                         "verifier + shared-memory gate")

    result = TuneResult(best=best, candidates=ranked,
                        dataflow_scores=scores, dataflow_choice=choice,
                        dataflow_dispatched=dispatched, objective=obj_name,
                        n_rejected_vmem=rejected)
    if cache:
        _SEARCH_CACHE[key] = result
    return result


def select_schedule(a: BSR, b: Optional[BSR] = None, *,
                    n_cols_hint: Optional[int] = None,
                    with_grad: bool = False, quantize: Optional[str] = None,
                    vmem_limit_bytes: Optional[int] = None,
                    pins: Optional[Dict[str, object]] = None,
                    objective="cuda",
                    space: Optional[SearchSpace] = None,
                    cost_model: Optional[CostModel] = None,
                    cache: bool = True, rhs_dtype=None) -> Candidate:
    """The planner's ``policy="auto"`` entry point: run (or replay from the
    search cache) the schedule search and return the winning
    :class:`Candidate` — the knobs ``plan_matmul`` re-enters with."""
    res = autotune_matmul(a, b, space=space, objective=objective,
                          cost_model=cost_model, n_cols_hint=n_cols_hint,
                          with_grad=with_grad, quantize=quantize,
                          vmem_limit_bytes=vmem_limit_bytes, cache=cache,
                          pins=pins, rhs_dtype=rhs_dtype)
    return res.best.candidate
