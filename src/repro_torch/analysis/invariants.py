"""Static plan verifier — prove a :class:`SegmentPlan`'s schedule invariants
(a copy of ``repro.analysis.invariants``: the same catalog, checks and
messages).

The Segment dataflow's correctness rests on contracts between the host-side
planner and the kernels: ``accum_prev`` read-modify-writes must follow a
same-lane ``seg_write``, fetch flags must fire exactly where an operand
index changes within a lane, ring-buffer slots must advance one step per
fetch and never let an in-flight copy land on a slot whose previous tile is
still being read, pads must move no data.  This module checks all of them
*statically* on the host arrays, so an unsound schedule — hand-built,
custom-policy, or corrupted — is rejected before a kernel runs on it.

Entry points:

* :func:`verify_plan` — run the invariant catalog over a plan (and its
  nested ``grad_plan``), returning typed :class:`Finding` records;
* :func:`check_lane_accum` — the single implementation of the
  ``accum_prev`` write-before-read check, shared with
  ``repro_torch.core.schedule.partition_lanes``;
* :func:`check_traffic_agreement` — the model-vs-fetch-flag count gate.

Levels: ``"fast"`` runs every structural check (vectorized / per-lane host
passes, no block values touched); ``"full"`` additionally recomputes the
traffic model — an independent implementation of the fetch contract — and
demands exact count agreement with the flags and the plan's recorded
traffic estimate.

Plans of this package carry torch tensors on any device, or host numpy
arrays (a cached template); every array is read on the host
(:func:`_host`), and dtypes are compared by name, so a realized plan on the
card and its numpy template give the same findings.  The CUDA kernels of
this package walk owner runs and do not read the fetch flags or ring slots;
those leaves are verified all the same, because they are the plan's
contract and ``repro``'s kernels read them.

This module imports only ``repro_torch.core`` (never ``repro_torch.api``),
so ``core.schedule`` may call into it lazily and ``api`` may hook it
eagerly without a cycle.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.core.formats import (QUANT_DTYPES, dtype_name,
                                      quant_base_dtype, quant_is_rowwise)
from repro_torch.core.schedule import (fetch_flags, lane_traffic_spgemm,
                                       lane_traffic_spmm)

#: Invariant catalog: id -> one-line contract statement.  Every id here has
#: a mutation-kill test in ``tests/test_torch_verify.py`` proving the
#: verifier catches its violation.
INVARIANTS: Dict[str, str] = {
    "shape-agreement":
        "every per-item schedule array has length n_items (seg_start's)",
    "lane-divisibility":
        "n_items divides into n_lanes equal lanes; lane_len divides by "
        "unroll; an explicit N divides by bn",
    "index-bounds":
        "block-slot / coordinate / ring-slot indices address existing "
        "storage (slots < 2*unroll)",
    "segment-structure":
        "lanes start with a seg_start item, owners change only at segment "
        "heads, no partial sum is dropped before its seg_write",
    "accum-prev-order":
        "every accum_prev=1 read-modify-write follows a seg_write to the "
        "same output tile earlier in the same lane",
    "pads-fetch-nothing":
        "valid=0 pad items carry no seg/accum flags and issue no fetches",
    "lane-first-fetch":
        "a lane's first item is real and fetches both operands (lane cuts "
        "never inherit residency)",
    "fetch-on-change":
        "fetch flags fire exactly where the operand index differs from the "
        "previous item within the lane",
    "slot-advance":
        "ring slots advance one slot per fetch (mod 2*unroll) and reused "
        "items read the resident slot",
    "ring-war":
        "a fetch never lands on a slot whose previous tile is still "
        "unconsumed under the issue-one-step-ahead discipline",
    "scale-agreement":
        "quantized payload dtype and per-block scale shapes/dtypes agree "
        "with the plan's block_dtype",
    "traffic-agreement":
        "the traffic model's independent fetch counts equal the fetch-flag "
        "sums and the plan's recorded traffic exactly (level='full')",
}

#: More-specific findings suppress less-specific ones at the same
#: (path, stream, item) coordinate — one corruption reports one invariant.
_STREAM_SPECIFICITY = ("pads-fetch-nothing", "lane-first-fetch",
                      "fetch-on-change", "slot-advance", "ring-war")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation, addressable to a schedule coordinate.

    ``item`` is the flat lane-major schedule index (``lane * lane_len +
    step_in_lane``) where the violation anchors, or None for plan-global
    findings; ``stream`` names the operand stream (``"a"``/``"b"``) for
    fetch-pipeline findings; ``path`` distinguishes the forward plan from
    the nested backward schedule (``"plan"`` vs ``"plan.grad_plan"``).
    """

    invariant: str
    message: str
    severity: str = "error"
    lane: Optional[int] = None
    item: Optional[int] = None
    stream: Optional[str] = None
    path: str = "plan"

    def __str__(self) -> str:
        where = self.path
        if self.lane is not None:
            where += f" lane {self.lane}"
        if self.item is not None:
            where += f" item {self.item}"
        return f"[{self.invariant}] {where}: {self.message}"


@dataclasses.dataclass(frozen=True)
class VerifyResult:
    """Outcome of one :func:`verify_plan` run."""

    findings: Tuple[Finding, ...]
    level: str
    checked: Tuple[str, ...]

    @property
    def ok(self) -> bool:
        return not self.findings

    def raise_if_findings(self) -> "VerifyResult":
        if self.findings:
            raise PlanVerificationError(self)
        return self

    def summary(self) -> str:
        if self.ok:
            return (f"plan verifies clean at level={self.level!r} "
                    f"({len(self.checked)} invariants)")
        lines = [f"plan verification failed: {len(self.findings)} finding(s) "
                 f"at level={self.level!r}"]
        lines += [f"  {f}" for f in self.findings]
        return "\n".join(lines)


class PlanVerificationError(ValueError):
    """Raised by ``raise_if_findings`` / ``plan_matmul(..., verify=...)``."""

    def __init__(self, result: VerifyResult):
        self.result = result
        self.findings = result.findings
        super().__init__(result.summary())


def _host(x) -> Optional[np.ndarray]:
    """A plan leaf as host numpy: a torch tensor on any device, a numpy
    array, or ``None``."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


_QUANT_NAMES = {dtype_name(d) for d in QUANT_DTYPES.values()}


# ---------------------------------------------------------------------------
# Shared accum_prev write-before-read check (the one implementation — the
# planner path and partition_lanes' validation both route through here)
# ---------------------------------------------------------------------------


def check_lane_accum(owner, seg_start, seg_write, accum_prev, valid,
                     n_lanes: int, item_ids=None,
                     path: str = "plan") -> List[Finding]:
    """``accum_prev`` write-before-read over flat lane-major arrays.

    Every ``accum_prev=1`` segment head read-modify-writes its output tile,
    so a ``seg_write`` to that tile must already have happened earlier in
    the *same* lane — otherwise the kernel reads an output buffer nothing
    ever wrote (silent garbage).  ``item_ids`` optionally maps each
    lane-major position back to the original schedule item for messages
    (pads as -1).  Vectorized per lane (np.minimum.at first-read vs
    first-write per owner); runs on every verified plan build.
    """
    owner = np.asarray(owner).reshape(-1)
    seg_start = np.asarray(seg_start).reshape(-1)
    seg_write = np.asarray(seg_write).reshape(-1)
    accum_prev = np.asarray(accum_prev).reshape(-1)
    valid = np.asarray(valid).astype(bool).reshape(-1)
    ids = None if item_ids is None else np.asarray(item_ids).reshape(-1)
    out: List[Finding] = []
    if not valid.any():
        return out
    lane_len = owner.size // n_lanes
    # one flattened (lane, owner) key space: first-read vs first-write per
    # tile per lane in two minimum.at passes, no per-lane Python loop
    n_owner = int(owner[valid].max()) + 1
    key = (np.arange(owner.size) // lane_len) * n_owner + owner
    reads = valid & (seg_start == 1) & (accum_prev == 1)
    writes = valid & (seg_write == 1)
    big = np.iinfo(np.int64).max
    first_read = np.full(n_lanes * n_owner, big)
    np.minimum.at(first_read, key[reads], np.nonzero(reads)[0])
    first_write = np.full(n_lanes * n_owner, big)
    np.minimum.at(first_write, key[writes], np.nonzero(writes)[0])
    bad = np.nonzero((first_read < big) & (first_write >= first_read))[0]
    for k in bad.tolist():
        li, tile = divmod(k, n_owner)
        g = int(first_read[k])
        orig = int(ids[g]) if ids is not None else None
        label = (f"schedule item {orig}" if orig is not None
                 else f"lane-major item {g}")
        out.append(Finding(
            "accum-prev-order",
            f"{label} (output tile {tile}, lane {li}) has accum_prev=1 "
            f"but no earlier seg_write to that tile in the same lane — "
            f"the kernel would read-modify-write an output buffer "
            f"nothing wrote; the item's segment chain must follow its "
            f"tile's first write within one lane",
            lane=li, item=g, path=path))
    return out


# ---------------------------------------------------------------------------
# Fetch-pipeline checks (flags / slots / ring liveness)
# ---------------------------------------------------------------------------


def _check_pads(arrays: Dict[str, Optional[np.ndarray]], valid: np.ndarray,
                lane_len: int, path: str) -> List[Finding]:
    out: List[Finding] = []
    pads = ~valid
    if not pads.any():
        return out
    for name in ("seg_start", "seg_write", "accum_prev"):
        arr = arrays.get(name)
        if arr is None:
            continue
        bad = np.nonzero(pads & (arr != 0))[0]
        if bad.size:
            i = int(bad[0])
            out.append(Finding(
                "pads-fetch-nothing",
                f"pad item (valid=0) carries {name}={int(arr[i])}; pads "
                f"must neither initialize nor write any output tile "
                f"({bad.size} item(s))",
                lane=i // lane_len, item=i, path=path))
    for stream in ("a", "b"):
        arr = arrays.get(f"{stream}_fetch")
        if arr is None:
            continue
        bad = np.nonzero(pads & (arr != 0))[0]
        if bad.size:
            i = int(bad[0])
            out.append(Finding(
                "pads-fetch-nothing",
                f"pad item (valid=0) has {stream}_fetch=1; pads re-address "
                f"the resident ring slot and must issue no DMA "
                f"({bad.size} item(s))",
                lane=i // lane_len, item=i, stream=stream, path=path))
    return out


def _check_lane_first(arrays, valid, n_lanes: int, lane_len: int,
                      path: str) -> List[Finding]:
    out: List[Finding] = []
    if lane_len == 0:
        return out
    v2 = valid.reshape(n_lanes, -1)
    for li in range(n_lanes):
        head = li * lane_len
        if not v2[li, 0]:
            continue   # pad-start lanes are segment-structure's finding
        for stream in ("a", "b"):
            f = arrays.get(f"{stream}_fetch")
            if f is not None and f[head] != 1:
                out.append(Finding(
                    "lane-first-fetch",
                    f"lane's first item has {stream}_fetch="
                    f"{int(f[head])}; lane cuts and pass restarts never "
                    f"inherit residency, so the first item must fetch",
                    lane=li, item=head, stream=stream, path=path))
    return out


def _check_segment_structure(owner, seg_start, seg_write, valid,
                             n_lanes: int, path: str) -> List[Finding]:
    out: List[Finding] = []
    if owner is None or seg_start is None or seg_write is None:
        return out
    o2 = owner.reshape(n_lanes, -1)
    ss2 = seg_start.reshape(n_lanes, -1)
    sw2 = seg_write.reshape(n_lanes, -1)
    v2 = valid.reshape(n_lanes, -1)
    lane_len = o2.shape[1]
    for li in range(n_lanes):
        pos = np.nonzero(v2[li])[0]
        if pos.size == 0:
            continue
        first, last = int(pos[0]), int(pos[-1])
        if not v2[li, 0]:
            out.append(Finding(
                "segment-structure",
                "lane starts with a pad item — pads only follow real work "
                "(the forward-fill has nothing to fill from)",
                lane=li, item=li * lane_len, path=path))
        if v2[li, 0] and ss2[li, first] != 1:
            out.append(Finding(
                "segment-structure",
                "lane's first item has seg_start=0 — the accumulator holds "
                "another lane's tail and would leak into this output tile",
                lane=li, item=li * lane_len + first, path=path))
        if sw2[li, last] != 1:
            out.append(Finding(
                "segment-structure",
                "lane's last item has seg_write=0 — the final segment's "
                "partial sum is never written back",
                lane=li, item=li * lane_len + last, path=path))
        prev, cur = pos[:-1], pos[1:]
        owner_change = o2[li][prev] != o2[li][cur]
        no_start = ss2[li][cur] != 1
        bad = np.nonzero(owner_change & no_start)[0]
        if bad.size:
            j = int(cur[bad[0]])
            out.append(Finding(
                "segment-structure",
                f"output tile changes {int(o2[li][prev[bad[0]]])} -> "
                f"{int(o2[li][j])} without seg_start=1 — the new tile "
                f"would accumulate into the previous tile's partial sum",
                lane=li, item=li * lane_len + j, path=path))
        dropped = (sw2[li][prev] == 0) & (ss2[li][cur] == 1)
        bad = np.nonzero(dropped)[0]
        if bad.size:
            i = int(prev[bad[0]])
            out.append(Finding(
                "segment-structure",
                "segment re-starts before the running partial sum was "
                "seg_write-written — the accumulated contributions are "
                "silently dropped",
                lane=li, item=li * lane_len + i, path=path))
    return out


def _check_fetch_on_change(arrays, valid, n_lanes: int, depth: int,
                           path: str) -> List[Finding]:
    out: List[Finding] = []
    lane_len = valid.size // n_lanes if n_lanes else 0
    for stream, idx_name in (("a", "a_stream"), ("b", "b_stream")):
        f = arrays.get(f"{stream}_fetch")
        idx = arrays.get(idx_name)
        if f is None or idx is None:
            continue
        want, _ = fetch_flags(idx, valid, n_lanes, depth=depth)
        bad = np.nonzero(f.astype(np.int32) != want)[0]
        if bad.size:
            i = int(bad[0])
            out.append(Finding(
                "fetch-on-change",
                f"{stream}_fetch={int(f[i])} but the {stream} operand index "
                f"{'changes' if want[i] else 'is unchanged'} from the "
                f"previous item in the lane — flags must fire exactly on "
                f"index change ({bad.size} item(s) disagree)",
                lane=i // lane_len, item=i, stream=stream, path=path))
    return out


def _check_slots(arrays, valid, n_lanes: int, depth: int,
                 path: str) -> List[Finding]:
    """Ring-slot advance contract + bound, per lane per stream."""
    out: List[Finding] = []
    for stream in ("a", "b"):
        f = arrays.get(f"{stream}_fetch")
        s = arrays.get(f"{stream}_slot")
        if f is None or s is None:
            continue
        bad = np.nonzero((s < 0) | (s >= depth))[0]
        if bad.size:
            i = int(bad[0])
            lane_len = valid.size // n_lanes
            out.append(Finding(
                "index-bounds",
                f"{stream}_slot={int(s[i])} outside the ring "
                f"[0, {depth}) (depth = 2*unroll)",
                lane=i // lane_len, item=i, stream=stream, path=path))
            continue
        f2 = f.reshape(n_lanes, -1)
        s2 = s.reshape(n_lanes, -1)
        v2 = valid.reshape(n_lanes, -1)
        lane_len = f2.shape[1]
        # vectorized precheck: the simulation below is equivalent to
        # "slot == (fetches-so-far - 1) % depth" at every fetch item and at
        # every valid item with a prior fetch in the lane — one cumsum pass
        # settles the overwhelmingly common clean case, and the per-item
        # simulation runs only to pinpoint the first offending item
        c = np.cumsum(f2 == 1, axis=1)
        constrained = (f2 == 1) | (v2 & (c > 0))
        if not (constrained & (s2 != (c - 1) % depth)).any():
            continue
        for li in range(n_lanes):
            resident = None
            fl, sl, vl = f2[li].tolist(), s2[li].tolist(), v2[li].tolist()
            for j in range(lane_len):
                if fl[j] == 1:
                    expect = 0 if resident is None else (resident + 1) % depth
                    if sl[j] != expect:
                        out.append(Finding(
                            "slot-advance",
                            f"fetch lands in {stream}_slot={int(sl[j])}, "
                            f"expected slot {expect} — the ring advances "
                            f"exactly one slot per fetch so a reused tile "
                            f"is always the most recently copied one",
                            lane=li, item=li * lane_len + j, stream=stream,
                            path=path))
                        break
                    resident = int(sl[j])
                elif vl[j] and resident is not None and sl[j] != resident:
                    out.append(Finding(
                        "slot-advance",
                        f"non-fetch item reads {stream}_slot="
                        f"{int(sl[j])} but the resident tile lives in "
                        f"slot {resident}",
                        lane=li, item=li * lane_len + j, stream=stream,
                        path=path))
                    break
    return out


def _check_ring_war(arrays, valid, n_lanes: int, depth: int, unroll: int,
                    path: str) -> List[Finding]:
    """WAR liveness: a fetch into a slot is issued one grid step ahead of
    its item's step (prologue at step 0), so the slot's *previous* tile
    must have had its last meaningful (valid) read strictly before that
    issue step.  Simulated on the actual slot values — independent of the
    cumsum contract ``slot-advance`` enforces, so hand-built rings of a
    different depth are still judged on the safety property itself."""
    out: List[Finding] = []
    for stream in ("a", "b"):
        f = arrays.get(f"{stream}_fetch")
        s = arrays.get(f"{stream}_slot")
        if f is None or s is None:
            continue
        if ((s < 0) | (s >= depth)).any():
            continue   # index-bounds already reported; simulation undefined
        f2 = f.reshape(n_lanes, -1)
        s2 = s.reshape(n_lanes, -1)
        v2 = valid.reshape(n_lanes, -1)
        lane_len = f2.shape[1]
        for li in range(n_lanes):
            # last_read[slot] = lane step of the most recent *valid* read of
            # the tile currently resident in that slot
            last_read: Dict[int, int] = {}
            occupied: Dict[int, bool] = {}
            fl, sl, vl = f2[li].tolist(), s2[li].tolist(), v2[li].tolist()
            for j in range(lane_len):
                if fl[j] == 1:
                    slot = sl[j]
                    issue_step = max(j // unroll - 1, 0)
                    if occupied.get(slot) and slot in last_read \
                            and last_read[slot] // unroll >= issue_step:
                        out.append(Finding(
                            "ring-war",
                            f"fetch into {stream}_slot={slot} is issued at "
                            f"grid step {issue_step} but the slot's "
                            f"previous tile is still read at step "
                            f"{last_read[slot] // unroll} — the in-flight "
                            f"copy would overwrite a tile in use "
                            f"(ring depth {depth}, unroll {unroll})",
                            lane=li, item=li * lane_len + j, stream=stream,
                            path=path))
                        break
                    occupied[slot] = True
                    last_read.pop(slot, None)
                if vl[j]:
                    last_read[sl[j]] = j
            else:
                continue
            break   # one finding per stream is enough
    return out


# ---------------------------------------------------------------------------
# Scale / traffic checks
# ---------------------------------------------------------------------------


def _check_scales(plan, path: str) -> List[Finding]:
    out: List[Finding] = []
    quant = getattr(plan, "block_dtype", "fp32") != "fp32"
    pairs = [("lhs", getattr(plan, "lhs_blocks", None),
              getattr(plan, "lhs_scales", None))]
    if getattr(plan, "kind", None) == "spgemm":
        pairs.append(("rhs", getattr(plan, "rhs_blocks", None),
                      getattr(plan, "rhs_scales", None)))
    for side, blocks, scales in pairs:
        got = None if blocks is None else dtype_name(blocks.dtype)
        if quant:
            rowwise = quant_is_rowwise(plan.block_dtype)
            want = dtype_name(
                QUANT_DTYPES[quant_base_dtype(plan.block_dtype)])
            if blocks is not None and got != want:
                out.append(Finding(
                    "scale-agreement",
                    f"{side}_blocks dtype {got} does not "
                    f"match block_dtype={plan.block_dtype!r} (payload "
                    f"{want})", path=path))
            if blocks is not None and scales is None:
                out.append(Finding(
                    "scale-agreement",
                    f"quantized plan carries {side}_blocks but no "
                    f"{side}_scales — dequantization is impossible",
                    path=path))
            if scales is not None:
                if dtype_name(scales.dtype) != "float32":
                    out.append(Finding(
                        "scale-agreement",
                        f"{side}_scales dtype {dtype_name(scales.dtype)} "
                        f"must be float32", path=path))
                if blocks is not None:
                    # rowwise scales run over the block's *storage* rows
                    # (bm for lhs, bk for a SpGEMM rhs)
                    expect = ((int(blocks.shape[0]), int(blocks.shape[1]))
                              if rowwise else (int(blocks.shape[0]),))
                    if tuple(scales.shape) != expect:
                        gran = ("per block row" if rowwise
                                else "per stored block")
                        out.append(Finding(
                            "scale-agreement",
                            f"{side}_scales shape {tuple(scales.shape)} "
                            f"must be one fp32 scale {gran} {expect} for "
                            f"block_dtype={plan.block_dtype!r}",
                            path=path))
        else:
            if scales is not None:
                out.append(Finding(
                    "scale-agreement",
                    f"fp32 plan carries {side}_scales — scales without a "
                    f"quantized payload would silently rescale the result",
                    path=path))
            if blocks is not None and got in _QUANT_NAMES:
                out.append(Finding(
                    "scale-agreement",
                    f"{side}_blocks has quantized payload dtype "
                    f"{got} but block_dtype is 'fp32'",
                    path=path))
    return out


def check_scale_agreement(plan, path: str = "plan") -> List[Finding]:
    """The ``scale-agreement`` invariant alone — dtype/shape inspection
    only, no schedule-array work.  This is the per-realize check
    ``plan_matmul(verify=...)`` runs on every cache hit (the schedule
    template was already verified at build), so it must stay O(1)."""
    return _check_scales(plan, path)


def check_traffic_agreement(plan, path: str = "plan") -> List[Finding]:
    """Model-vs-flags fetch-count gate.

    Recomputes the traffic model's A/B fetch counts from the plan's index
    streams — :func:`repro_torch.core.schedule._revisit_traffic` is a
    deliberately independent implementation of the change-detection
    contract the fetch flags compile — and demands exact equality with the
    fetch-flag sums and with the counts recorded in ``plan.traffic``.
    Counts are size-independent, so the model runs at unit tile sizes.

    The fetch flags always implement the *pipelined* per-item-adjacency
    contract (they are pipeline-independent plan leaves), so the flag
    comparison uses the pipelined model unconditionally; the recorded
    ``plan.traffic`` counts follow the plan's ``pipeline`` switch — a
    ``pipeline=False`` plan records legacy per-BlockSpec-stream pricing and
    is checked against that model.

    A ``prefetch="cross_pass"`` plan records a ``prefetch_fetches`` count
    (the copies the kernel overlaps with each pass boundary); the model is
    recomputed under the same mode and must agree exactly — cross-pass
    prefetch never changes *which* items fetch, so the a/b counts above are
    mode-independent by construction.
    """
    out: List[Finding] = []
    a_fetch = _host(getattr(plan, "a_fetch", None))
    b_fetch = _host(getattr(plan, "b_fetch", None))
    valid = _host(getattr(plan, "valid", None))
    seg_start = _host(getattr(plan, "seg_start", None))
    if a_fetch is None or b_fetch is None or valid is None \
            or seg_start is None:
        return out
    n_lanes, unroll = plan.n_lanes, plan.unroll
    pipelined = bool(getattr(plan, "pipeline", True))
    prefetch = getattr(plan, "prefetch", None)
    if plan.kind == "spmm":
        m = _host(plan.m_idx)
        k = _host(plan.k_idx)
        if m is None or k is None:
            return out
        model = lane_traffic_spmm(m, k, seg_start, valid.astype(bool),
                                  n_lanes, 1, 1, 1, unroll=unroll)
        rec_model = lane_traffic_spmm(
            m, k, seg_start, valid.astype(bool), n_lanes, 1, 1, 1,
            unroll=unroll, pipeline=pipelined, prefetch=prefetch)
    else:
        a_idx, b_idx, c_idx = (_host(plan.a_idx), _host(plan.b_idx),
                               _host(plan.c_idx))
        if a_idx is None or b_idx is None or c_idx is None:
            return out
        model = lane_traffic_spgemm(a_idx, b_idx, c_idx, seg_start,
                                    valid.astype(bool), n_lanes, 1, 1, 1,
                                    unroll=unroll)
        rec_model = lane_traffic_spgemm(
            a_idx, b_idx, c_idx, seg_start, valid.astype(bool), n_lanes,
            1, 1, 1, unroll=unroll, pipeline=pipelined, prefetch=prefetch)
    recorded = dict(getattr(plan, "traffic_items", ()) or ())
    for stream, flags in (("a", a_fetch), ("b", b_fetch)):
        n_model = int(model[f"{stream}_fetches"])
        n_flags = int(flags.sum())
        if n_model != n_flags:
            out.append(Finding(
                "traffic-agreement",
                f"traffic model predicts {n_model} {stream}-stream fetches "
                f"but the fetch flags sum to {n_flags} — the model and "
                f"fetch_flags implement the same change-detection contract "
                f"independently and must agree exactly",
                stream=stream, path=path))
        n_rec = recorded.get(f"{stream}_fetches")
        n_rec_model = int(rec_model[f"{stream}_fetches"])
        if n_rec is not None and int(n_rec) != n_rec_model:
            out.append(Finding(
                "traffic-agreement",
                f"plan.traffic records {int(n_rec)} {stream}-stream fetches "
                f"but the model recomputes {n_rec_model} "
                f"(pipeline={'on' if pipelined else 'off'} pricing) — the "
                f"recorded estimate is stale or was tampered with",
                stream=stream, path=path))
    n_pf_rec = recorded.get("prefetch_fetches")
    if n_pf_rec is not None:
        n_pf_model = int(rec_model.get("prefetch_fetches", 0))
        if int(n_pf_rec) != n_pf_model:
            out.append(Finding(
                "traffic-agreement",
                f"plan.traffic records {int(n_pf_rec)} overlapped prefetch "
                f"fetches but the model recomputes {n_pf_model} under "
                f"prefetch={prefetch!r} — the recorded estimate is stale "
                f"or the mode changed without re-pricing",
                stream="prefetch", path=path))
    return out


# ---------------------------------------------------------------------------
# verify_plan — the catalog runner
# ---------------------------------------------------------------------------


def _verify_one(plan, level: str, only: Optional[Sequence[str]],
                bn: Optional[int], n_cols: Optional[int],
                path: str) -> Tuple[List[Finding], List[str]]:
    run = (lambda inv: only is None or inv in only)
    findings: List[Finding] = []
    checked: List[str] = []

    seg_start = _host(getattr(plan, "seg_start", None))
    if seg_start is None:
        if run("shape-agreement"):
            checked.append("shape-agreement")
            findings.append(Finding(
                "shape-agreement",
                "plan carries no seg_start array — the schedule length is "
                "undefined", path=path))
        return findings, checked
    n_items = int(seg_start.shape[0])
    n_lanes = max(int(getattr(plan, "n_lanes", 1)), 1)
    unroll = max(int(getattr(plan, "unroll", 1)), 1)
    depth = 2 * unroll

    spgemm = getattr(plan, "kind", "spmm") == "spgemm"
    arrays: Dict[str, Optional[np.ndarray]] = {
        "seg_start": seg_start,
        "seg_write": _host(getattr(plan, "seg_write", None)),
        "accum_prev": _host(getattr(plan, "accum_prev", None)),
        "valid": _host(getattr(plan, "valid", None)),
        "a_fetch": _host(getattr(plan, "a_fetch", None)),
        "b_fetch": _host(getattr(plan, "b_fetch", None)),
        "a_slot": _host(getattr(plan, "a_slot", None)),
        "b_slot": _host(getattr(plan, "b_slot", None)),
    }
    if spgemm:
        arrays["a_idx"] = _host(getattr(plan, "a_idx", None))
        arrays["b_idx"] = _host(getattr(plan, "b_idx", None))
        arrays["c_idx"] = _host(getattr(plan, "c_idx", None))
        owner = arrays["c_idx"]
        arrays["a_stream"] = arrays["a_idx"]
        arrays["b_stream"] = arrays["b_idx"]
    else:
        arrays["m_idx"] = _host(getattr(plan, "m_idx", None))
        arrays["k_idx"] = _host(getattr(plan, "k_idx", None))
        arrays["slot_idx"] = _host(getattr(plan, "slot_idx", None))
        owner = arrays["m_idx"]
        arrays["a_stream"] = arrays["slot_idx"]
        arrays["b_stream"] = arrays["k_idx"]

    if run("shape-agreement"):
        checked.append("shape-agreement")
        for name, arr in arrays.items():
            if name.endswith("_stream") or arr is None:
                continue
            if arr.shape != (n_items,):
                findings.append(Finding(
                    "shape-agreement",
                    f"{name} has shape {arr.shape}, expected ({n_items},) "
                    f"to match the schedule's n_items (seg_start length)",
                    path=path))
        if findings:
            return findings, checked   # lengths disagree: nothing else is safe

    if run("lane-divisibility"):
        checked.append("lane-divisibility")
        if n_items % n_lanes != 0:
            findings.append(Finding(
                "lane-divisibility",
                f"n_items={n_items} is not divisible by n_lanes={n_lanes}; "
                f"lanes must be equal length (pad via partition_lanes)",
                path=path))
            return findings, checked   # lane reshapes below would crash
        lane_len = n_items // n_lanes
        if lane_len % unroll != 0:
            findings.append(Finding(
                "lane-divisibility",
                f"lane length {lane_len} is not divisible by "
                f"unroll={unroll}", path=path))
            return findings, checked
        if bn is not None and n_cols is not None and n_cols % bn != 0:
            findings.append(Finding(
                "lane-divisibility",
                f"dense width N={n_cols} is not divisible by bn={bn} "
                f"(pad N or pick a divisor; see repro.api.pick_bn)",
                path=path))
    lane_len = n_items // n_lanes if n_items % n_lanes == 0 else n_items

    valid = arrays["valid"]
    valid = (np.ones(n_items, dtype=bool) if valid is None
             else valid.astype(bool))
    if n_items == 0:
        # degenerate empty schedule (e.g. an all-masked symbolic spgemm
        # pattern): the executor short-circuits before any kernel runs, so
        # an empty plan is vacuously sound.
        for inv in ("index-bounds", "segment-structure", "accum-prev-order",
                    "pads-fetch-nothing", "lane-first-fetch",
                    "fetch-on-change", "slot-advance", "ring-war"):
            if run(inv):
                checked.append(inv)
        if run("scale-agreement"):
            checked.append("scale-agreement")
            findings.extend(_check_scales(plan, path))
        return findings, checked

    # one pass serves both invariants it reports (ring bound -> index-bounds,
    # advance contract -> slot-advance)
    slot_findings = (_check_slots(arrays, valid, n_lanes, depth, path)
                     if run("index-bounds") or run("slot-advance") else [])

    if run("index-bounds"):
        checked.append("index-bounds")
        bounds = []
        if spgemm:
            for name, attr in (("a_idx", "a_brow"), ("b_idx", "b_brow")):
                ref = getattr(plan, attr, None)
                if arrays[name] is not None and ref is not None:
                    bounds.append((name, arrays[name], int(ref.shape[0])))
            if arrays["c_idx"] is not None:
                bounds.append(("c_idx", arrays["c_idx"],
                               int(getattr(plan, "n_out_blocks", 0))))
        else:
            ref = getattr(plan, "a_brow", None)
            if arrays["slot_idx"] is not None and ref is not None:
                bounds.append(("slot_idx", arrays["slot_idx"],
                               int(ref.shape[0])))
            grid = getattr(plan, "grid", None)
            if grid is not None:
                if arrays["m_idx"] is not None:
                    bounds.append(("m_idx", arrays["m_idx"], int(grid[0])))
                if arrays["k_idx"] is not None:
                    bounds.append(("k_idx", arrays["k_idx"], int(grid[1])))
        for name, arr, hi in bounds:
            bad = np.nonzero((arr < 0) | (arr >= hi))[0]
            if bad.size:
                i = int(bad[0])
                findings.append(Finding(
                    "index-bounds",
                    f"{name}={int(arr[i])} outside [0, {hi})",
                    lane=i // lane_len, item=i, path=path))
        findings.extend(f for f in slot_findings
                        if f.invariant == "index-bounds")

    if run("segment-structure"):
        checked.append("segment-structure")
        findings.extend(_check_segment_structure(
            owner, arrays["seg_start"], arrays["seg_write"], valid,
            n_lanes, path))

    if run("accum-prev-order") and owner is not None \
            and arrays["accum_prev"] is not None:
        checked.append("accum-prev-order")
        findings.extend(check_lane_accum(
            owner, arrays["seg_start"], arrays["seg_write"],
            arrays["accum_prev"], valid, n_lanes, path=path))

    if run("pads-fetch-nothing"):
        checked.append("pads-fetch-nothing")
        findings.extend(_check_pads(arrays, valid, lane_len, path))

    if run("lane-first-fetch"):
        checked.append("lane-first-fetch")
        findings.extend(
            f for f in _check_lane_first(arrays, valid, n_lanes, lane_len,
                                         path)
            if f.invariant == "lane-first-fetch")

    if run("fetch-on-change"):
        checked.append("fetch-on-change")
        findings.extend(_check_fetch_on_change(arrays, valid, n_lanes,
                                               depth, path))

    if run("slot-advance"):
        checked.append("slot-advance")
        findings.extend(f for f in slot_findings
                        if f.invariant == "slot-advance")

    if run("ring-war"):
        checked.append("ring-war")
        findings.extend(_check_ring_war(arrays, valid, n_lanes, depth,
                                        unroll, path))

    if run("scale-agreement"):
        checked.append("scale-agreement")
        findings.extend(_check_scales(plan, path))

    if level == "full" and run("traffic-agreement"):
        checked.append("traffic-agreement")
        findings.extend(check_traffic_agreement(plan, path=path))

    return findings, checked


def _suppress(findings: List[Finding]) -> List[Finding]:
    """Keep the most specific finding per (path, stream, item) coordinate.

    One targeted corruption should report one invariant: a pad marked as
    fetching also breaks the fetch-recompute and slot contracts, but the
    pad violation is the root cause.  Count-level ``traffic-agreement``
    findings are dropped for a stream whose per-item contract already
    failed (the count mismatch is a consequence, not new information).
    """
    rank = {inv: i for i, inv in enumerate(_STREAM_SPECIFICITY)}
    best: Dict[Tuple[str, Optional[str], Optional[int]], int] = {}
    broken_streams = set()
    for f in findings:
        if f.invariant in rank:
            key = (f.path, f.stream, f.item)
            r = rank[f.invariant]
            if key not in best or r < best[key]:
                best[key] = r
            broken_streams.add((f.path, f.stream))
            if f.stream is None:
                broken_streams.update({(f.path, "a"), (f.path, "b")})
    out = []
    for f in findings:
        if f.invariant in rank:
            key = (f.path, f.stream, f.item)
            if rank[f.invariant] > best.get(key, rank[f.invariant]):
                continue
            # a broken upstream item also explains downstream slot/ring
            # findings on the same stream at later items
            if f.invariant in ("slot-advance", "ring-war"):
                upstream = [g for g in findings
                            if g.path == f.path and g.stream == f.stream
                            and g.invariant in rank
                            and rank[g.invariant] < rank[f.invariant]]
                if upstream:
                    continue
        elif f.invariant == "traffic-agreement" \
                and (f.path, f.stream) in broken_streams:
            continue
        out.append(f)
    return out


def verify_plan(plan, level: str = "fast", *,
                invariants: Optional[Sequence[str]] = None,
                bn: Optional[int] = None,
                n_cols: Optional[int] = None) -> VerifyResult:
    """Run the invariant catalog over a plan (and its ``grad_plan``).

    Args:
      plan: a :class:`~repro_torch.api.plan.SegmentPlan` (realized, with
        tensors on any device, or a value-free template plan with numpy
        leaves — block values are never read, only shapes/dtypes).
      level: ``"fast"`` runs every structural check; ``"full"`` adds the
        independent traffic-model recomputation (``traffic-agreement``).
      invariants: optionally restrict the run to a subset of catalog ids
        (e.g. ``("ring-war",)`` to judge the liveness property in
        isolation — ``slot-advance``'s exact cumsum contract subsumes it
        on planner-built rings).
      bn / n_cols: optional execution-time tile width and dense N; when
        both are given their divisibility is checked too.

    Returns a :class:`VerifyResult`; call ``raise_if_findings()`` to turn
    findings into a :class:`PlanVerificationError`.
    """
    if level not in ("fast", "full"):
        raise ValueError(f"level must be 'fast' or 'full', got {level!r}")
    if invariants is not None:
        unknown = set(invariants) - set(INVARIANTS)
        if unknown:
            raise ValueError(f"unknown invariant id(s) {sorted(unknown)}; "
                             f"catalog: {sorted(INVARIANTS)}")
    findings, checked = _verify_one(plan, level, invariants, bn, n_cols,
                                    "plan")
    grad = getattr(plan, "grad_plan", None)
    if grad is not None:
        gf, gc = _verify_one(grad, level, invariants, bn, n_cols,
                             "plan.grad_plan")
        findings.extend(gf)
        checked.extend(c for c in gc if c not in checked)
    return VerifyResult(findings=tuple(_suppress(findings)), level=level,
                        checked=tuple(checked))
