"""Block-level Segment scheduler, SpMM half (a copy of
``repro.core.schedule`` trimmed to what SpMM planning needs).

A *work item* is one nonzero-block multiply; the policy orders the items so
that consecutive items share operands, :func:`partition_lanes` cuts the
ordered list into load-balanced lanes at segment-chain boundaries, and
:func:`lane_traffic_spmm` prices a lane-cut schedule under the revisiting
model.  All of it is host-side numpy and depends only on the pattern.

The CUDA kernel reads the lane-major arrays as they are: every output
block row (owner) sits in one contiguous run of one lane, so one thread
block per run is exact.  ``check_lane_accum`` is this package's own copy of
``repro.analysis.invariants.check_lane_accum``: the package imports nothing
of ``repro``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .folding import balance_bins, round_robin_bins
from .formats import BSR
from .policies import get_policy, register_policy


@dataclasses.dataclass
class SpmmSchedule:
    """Work list for BSR(A) × dense(B): one item per nonzero A block.

    * ``a_idx``   — index into ``BSR.blocks`` for the item's A tile
    * ``m``/``k`` — block coordinates of the item
    * ``seg_start`` — 1 where the item begins a new output segment
    * ``seg_write`` — 1 where the item is the last of its segment
    """

    m: np.ndarray
    k: np.ndarray
    a_idx: np.ndarray
    seg_start: np.ndarray
    seg_write: np.ndarray
    n_m_blocks: int
    n_k_blocks: int
    policy: str


def _runs_from_sorted(m_sorted: np.ndarray) -> np.ndarray:
    """seg_start flags for a list whose equal-m items are contiguous."""
    if m_sorted.size == 0:
        return np.zeros(0, dtype=np.int32)
    starts = np.ones(m_sorted.size, dtype=np.int32)
    starts[1:] = (m_sorted[1:] != m_sorted[:-1]).astype(np.int32)
    return starts


def _seg_write_from_starts(seg_start: np.ndarray) -> np.ndarray:
    if seg_start.size == 0:
        return np.zeros(0, dtype=np.int32)
    w = np.zeros(seg_start.size, dtype=np.int32)
    w[:-1] = seg_start[1:]
    w[-1] = 1
    return w


def _segment_order(m: np.ndarray, k: np.ndarray) -> np.ndarray:
    """SELECTA-adapted ordering for a bipartite (m,k) item set.

    1. Group items into output runs (same m) — C stationarity.
    2. Serpentine the k direction inside alternate runs.
    3. Chain runs greedily: after finishing a run ending at boundary block
       ``k_end``, pick the unvisited run whose k-set contains ``k_end``,
       preferring the largest k-overlap with the current run; fall back to
       the run with the most items.

    Returns a permutation of item indices.
    """
    n = m.size
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    base = np.lexsort((k, m))
    m_s, k_s = m[base], k[base]
    starts = np.nonzero(_runs_from_sorted(m_s))[0]
    ends = np.append(starts[1:], n)
    runs = []  # (item_indices_ascending_k, kset)
    for s, e in zip(starts, ends):
        idx = base[s:e]
        runs.append((idx, set(int(x) for x in k_s[s:e])))
    n_runs = len(runs)
    visited = np.zeros(n_runs, dtype=bool)
    order = []
    cur = int(np.argmax([len(r[0]) for r in runs]))
    flip = False
    for _ in range(n_runs):
        visited[cur] = True
        idx, kset = runs[cur]
        idx_seq = idx[::-1] if flip else idx
        order.append(idx_seq)
        k_end = int(k[idx_seq[-1]])
        best, best_score = -1, (-1, -1)
        for j in range(n_runs):
            if visited[j]:
                continue
            _, ks = runs[j]
            boundary = 1 if k_end in ks else 0
            overlap = len(kset & ks)
            score = (boundary, overlap + len(ks) * 1e-9)
            if score > best_score:
                best_score, best = score, j
        if best < 0:
            rem = np.nonzero(~visited)[0]
            if rem.size == 0:
                break
            best = int(rem[np.argmax([len(runs[j][0]) for j in rem])])
        nxt_kset = runs[best][1]
        nxt_idx = runs[best][0]
        if k_end in nxt_kset:
            k_first = int(k[nxt_idx[0]])
            k_last = int(k[nxt_idx[-1]])
            flip = abs(k_last - k_end) < abs(k_first - k_end)
        else:
            flip = not flip
        cur = best
    return np.concatenate(order) if order else np.zeros(0, dtype=np.int64)


register_policy(
    "segment",
    spmm_order=_segment_order,
    spgemm_order=lambda m, n, k, c: _segment_order(c, k),
    supports_fold=True,
    description="Paper's dynamic order: output-segment runs + SELECTA run "
                "chaining + serpentine k + temporal folding",
    overwrite=True)
register_policy(
    "gustavson",
    spmm_order=lambda m, k: np.lexsort((k, m)),
    spgemm_order=lambda m, n, k, c: np.lexsort((k, n, m)),
    description="m-major static order (best classic static dataflow)",
    overwrite=True)
register_policy(
    "outer",
    spmm_order=lambda m, k: np.lexsort((m, k)),
    spgemm_order=lambda m, n, k, c: np.lexsort((n, m, k)),
    description="k-major static order (outer-product-like; B reuse, C thrash)",
    overwrite=True)


def _apply_fold(seg_start: np.ndarray, fold_len: Optional[int]) -> np.ndarray:
    """Temporal folding: cap run length; folded continuations re-start a
    segment (the kernel read-modify-writes C on non-first sub-segments)."""
    if fold_len is None or fold_len <= 0:
        return seg_start
    run_pos = np.zeros(seg_start.size, dtype=np.int64)
    cnt = 0
    for i in range(seg_start.size):
        cnt = 0 if seg_start[i] else cnt + 1
        run_pos[i] = cnt
    refold = (run_pos > 0) & (run_pos % fold_len == 0)
    return (seg_start.astype(bool) | refold).astype(np.int32)


@dataclasses.dataclass
class SegmentFinalization:
    """``accum_prev[i]`` is 1 exactly when item ``i`` starts a segment whose
    output tile an earlier segment already wrote; ``row_mask`` (when
    ``n_slots`` is given) is 1.0 for output slots that receive any work."""

    accum_prev: np.ndarray              # (n_items,) int32
    row_mask: Optional[np.ndarray]      # (n_slots,) float32 or None


def finalize_schedule(seg_start: np.ndarray, owner: np.ndarray,
                      n_slots: Optional[int] = None) -> SegmentFinalization:
    """Derive ``accum_prev`` (+ optional ``row_mask``) for a schedule;
    ``owner[i]`` is the output-tile id of item ``i``."""
    seg_start = np.asarray(seg_start)
    owner = np.asarray(owner)
    if seg_start.shape != owner.shape:
        raise ValueError(f"seg_start {seg_start.shape} and owner "
                         f"{owner.shape} must have matching shapes")
    accum_prev = np.zeros(owner.size, dtype=np.int32)
    seen = set()
    for i in np.nonzero(seg_start)[0]:
        o = int(owner[i])
        accum_prev[i] = 1 if o in seen else 0
        seen.add(o)
    row_mask = None
    if n_slots is not None:
        row_mask = np.zeros(n_slots, dtype=np.float32)
        if owner.size:
            row_mask[np.unique(owner)] = 1.0
    return SegmentFinalization(accum_prev=accum_prev, row_mask=row_mask)


def build_spmm_schedule(a: BSR, policy: str = "segment",
                        fold_len: Optional[int] = None) -> SpmmSchedule:
    """Order the nonzero blocks of A into a kernel work list."""
    pol = get_policy(policy)
    m, k = a.brow.astype(np.int64), a.bcol.astype(np.int64)
    idx = np.arange(a.nblocks, dtype=np.int64)
    order = pol.spmm_order(m, k)
    m_o, k_o, idx_o = m[order], k[order], idx[order]
    seg_start = _runs_from_sorted(m_o)
    if pol.supports_fold:
        seg_start = _apply_fold(seg_start, fold_len)
    gm, gk = a.grid
    return SpmmSchedule(m=m_o.astype(np.int32), k=k_o.astype(np.int32),
                        a_idx=idx_o.astype(np.int32),
                        seg_start=seg_start.astype(np.int32),
                        seg_write=_seg_write_from_starts(seg_start),
                        n_m_blocks=gm, n_k_blocks=gk, policy=policy)


# ---------------------------------------------------------------------------
# Lane partitioning
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LaneLayout:
    """Lane-parallel realization of a finished 1-D schedule.

    ``perm[l, j]`` is the schedule item executed at step ``j`` of lane
    ``l``, or ``-1`` for a padding no-op.  ``filled`` replaces every ``-1``
    with the most recent real item of the same lane, so index arrays stay
    valid on pads; flag arrays are zeroed on pads instead.  All items of one
    output tile live in exactly one lane, contiguously, in schedule order.
    """

    perm: np.ndarray        # (n_lanes, lane_len) int64, -1 = pad
    filled: np.ndarray      # (n_lanes, lane_len) int64, pads forward-filled
    valid: np.ndarray       # (n_lanes, lane_len) bool
    n_lanes: int
    lane_len: int
    stats: dict             # load-balance stats from shard_schedule


def partition_lanes(owner: np.ndarray, n_lanes: int, *, unroll: int = 1,
                    policy: str = "segment", seg_start=None, seg_write=None,
                    accum_prev=None) -> LaneLayout:
    """Split a schedule's item list into ``n_lanes`` balanced lanes.

    Items are grouped per owner (a whole segment chain is atomic), the
    groups are packed into lanes by :func:`shard_schedule`, and each lane
    keeps its groups in first-appearance order.  ``unroll > 1`` pads every
    group to a multiple of ``unroll``.  ``n_lanes`` is clamped to the number
    of owner groups.  When the flag arrays are passed, every
    ``accum_prev=1`` item must find its tile written earlier in its lane,
    else ``ValueError``.
    """
    if n_lanes < 1:
        raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    owner = np.asarray(owner, dtype=np.int64)
    n = owner.size
    if n == 0:
        z = np.zeros((1, 0), dtype=np.int64)
        return LaneLayout(perm=z, filled=z.copy(), valid=z.astype(bool),
                          n_lanes=1, lane_len=0,
                          stats={"imbalance": 1.0, "max_load": 0,
                                 "mean_load": 0.0})
    first: dict = {}
    groups: list = []
    for i, o in enumerate(owner.tolist()):
        gi = first.get(o)
        if gi is None:
            first[o] = len(groups)
            groups.append([i])
        else:
            groups[gi].append(i)
    sizes = np.asarray([len(g) for g in groups], dtype=np.int64)
    eff = max(1, min(n_lanes, len(groups)))
    assign, stats = shard_schedule(sizes, eff, policy=policy)
    lanes: list = [[] for _ in range(eff)]
    for gi, g in enumerate(groups):
        lane = lanes[int(assign[gi])]
        lane.extend(g)
        lane.extend([-1] * ((-len(g)) % unroll))
    lane_len = max(len(l) for l in lanes)
    perm = np.full((eff, lane_len), -1, dtype=np.int64)
    for li, l in enumerate(lanes):
        perm[li, :len(l)] = l
    if accum_prev is not None:
        _validate_lane_accum(perm, owner, seg_start, seg_write, accum_prev)
    pos = np.maximum.accumulate(
        np.where(perm >= 0, np.arange(lane_len)[None, :], -1), axis=1)
    filled = np.take_along_axis(perm, np.maximum(pos, 0), axis=1)
    filled = np.where(pos >= 0, filled, 0)
    stats = dict(stats, n_lanes=eff,
                 padded_items=int((perm < 0).sum()))
    stats.pop("loads", None)
    return LaneLayout(perm=perm, filled=filled, valid=perm >= 0,
                      n_lanes=eff, lane_len=lane_len, stats=stats)


def check_lane_accum(owner, seg_start, seg_write, accum_prev, valid,
                     n_lanes: int, item_ids=None) -> List[str]:
    """``accum_prev`` write-before-read over flat lane-major arrays.

    Every ``accum_prev=1`` segment head read-modify-writes its output tile,
    so a ``seg_write`` to that tile must already have happened earlier in
    the same lane.  Returns one message per violating (lane, tile).
    """
    owner = np.asarray(owner).reshape(-1)
    seg_start = np.asarray(seg_start).reshape(-1)
    seg_write = np.asarray(seg_write).reshape(-1)
    accum_prev = np.asarray(accum_prev).reshape(-1)
    valid = np.asarray(valid).astype(bool).reshape(-1)
    ids = None if item_ids is None else np.asarray(item_ids).reshape(-1)
    out: List[str] = []
    if not valid.any():
        return out
    lane_len = owner.size // n_lanes
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
        label = (f"schedule item {int(ids[g])}" if ids is not None
                 else f"lane-major item {g}")
        out.append(
            f"{label} (output tile {tile}, lane {li}) has accum_prev=1 but "
            f"no earlier seg_write to that tile in the same lane — the "
            f"kernel would read-modify-write an output buffer nothing "
            f"wrote; the item's segment chain must follow its tile's first "
            f"write within one lane")
    return out


def _validate_lane_accum(perm: np.ndarray, owner: np.ndarray, seg_start,
                         seg_write, accum_prev) -> None:
    """Gather the schedule-order flags into lane layout and turn the first
    :func:`check_lane_accum` finding into a ``ValueError``."""
    accum_prev = np.asarray(accum_prev)
    seg_start = (np.ones_like(accum_prev) if seg_start is None
                 else np.asarray(seg_start))
    seg_write = (np.zeros_like(accum_prev) if seg_write is None
                 else np.asarray(seg_write))
    for arr, name in ((seg_start, "seg_start"), (seg_write, "seg_write"),
                      (accum_prev, "accum_prev")):
        if arr.shape != owner.shape:
            raise ValueError(f"{name} has shape {arr.shape}, expected "
                             f"{owner.shape} to match owner")
    filled = np.where(perm >= 0, perm, 0)
    findings = check_lane_accum(
        owner[filled], seg_start[filled], seg_write[filled],
        accum_prev[filled], perm >= 0, perm.shape[0], item_ids=perm)
    if findings:
        raise ValueError(findings[0])


#: valid ``prefetch=`` schedule modes (TPU DMA timing; see repro.core.schedule)
PREFETCH_MODES = (None, "cross_pass")


def fetch_flags(stream: np.ndarray, valid: np.ndarray, n_lanes: int,
                depth: int = 2, prefetch: Optional[str] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-item fetch flags + ring-buffer slots for one operand stream.

    ``fetch[i]`` is 1 exactly when the item is valid and its operand index
    differs from the previous item's within the same lane (a lane's first
    item always fetches); ``slot[i]`` is the ``depth``-slot ring position
    that advances one slot per fetch.  These are plan leaves kept for
    parity with ``repro``; the CUDA kernel of this package does not read
    them.
    """
    if prefetch not in PREFETCH_MODES:
        raise ValueError(f"prefetch={prefetch!r} not in {PREFETCH_MODES}")
    if depth < 2:
        raise ValueError(f"ring-buffer depth must be >= 2, got {depth}")
    stream = np.asarray(stream)
    valid = np.asarray(valid).astype(bool)
    if stream.shape != valid.shape:
        raise ValueError(f"stream {stream.shape} and valid {valid.shape} "
                         f"must have matching shapes")
    if stream.size % max(n_lanes, 1) != 0:
        raise ValueError(f"n_items={stream.size} is not divisible by "
                         f"n_lanes={n_lanes}")
    s2 = stream.reshape(n_lanes, -1)
    v2 = valid.reshape(n_lanes, -1)
    delta = np.ones_like(s2, dtype=bool)
    if s2.shape[1] > 1:
        delta[:, 1:] = s2[:, 1:] != s2[:, :-1]
    fetch = delta & v2
    slot = np.maximum(np.cumsum(fetch, axis=1) - 1, 0) % depth
    return (fetch.reshape(-1).astype(np.int32),
            slot.reshape(-1).astype(np.int32))


def lane_select(layout: LaneLayout, arr: np.ndarray,
                zero_pads: bool = False) -> np.ndarray:
    """Gather a per-item schedule array into flattened lane-major order.

    Index arrays keep the previous real item's value on pads
    (``zero_pads=False``); flag arrays are zeroed on pads.
    """
    arr = np.asarray(arr)
    out = arr[layout.filled.reshape(-1)]
    if zero_pads:
        out = np.where(layout.valid.reshape(-1), out, 0).astype(arr.dtype)
    return out


# ---------------------------------------------------------------------------
# Traffic model under the revisiting rule
# ---------------------------------------------------------------------------


def _revisit_traffic(fetch_streams, owner, seg_start, valid, n_lanes,
                     c_tile_bytes, unroll: int = 1, pipeline: bool = True):
    """Revisiting-model core over flattened lane-major arrays (see
    ``repro.core.schedule._revisit_traffic``): an operand tile is fetched
    when its index changes within a lane (``pipeline=True``) or within the
    same unrolled stream position (``pipeline=False``), or on every valid
    item when ``always``; C tiles are written once per segment head and read
    back on owner revisits."""
    valid = np.asarray(valid, dtype=bool)
    fetches = []
    for arr, tile_bytes, always in fetch_streams:
        if always:
            n_fetch = int(valid.sum())
        elif pipeline:
            a2 = np.asarray(arr).reshape(n_lanes, -1)
            delta = np.ones_like(a2, dtype=bool)
            if a2.shape[1] > 1:
                delta[:, 1:] = a2[:, 1:] != a2[:, :-1]
            n_fetch = int((delta.reshape(-1) & valid).sum())
        else:
            a3 = np.asarray(arr).reshape(n_lanes, -1, unroll)
            delta = np.ones_like(a3, dtype=bool)
            if a3.shape[1] > 1:
                delta[:, 1:, :] = a3[:, 1:, :] != a3[:, :-1, :]
            n_fetch = int((delta.reshape(-1) & valid).sum())
        fetches.append((n_fetch, n_fetch * tile_bytes))
    seg_heads = np.nonzero(np.asarray(seg_start) & valid)[0]
    seen = set()
    c_reads = 0
    owner = np.asarray(owner)
    for h in seg_heads:
        o = int(owner[h])
        if o in seen:
            c_reads += 1
        seen.add(o)
    c_bytes = (seg_heads.size + c_reads) * c_tile_bytes
    return fetches, int(seg_heads.size), c_bytes


def _head_window_fetches(k, valid, n_lanes: int, unroll: int) -> int:
    """Fetches that land in each lane's first-``unroll`` head window."""
    k2 = np.asarray(k).reshape(n_lanes, -1)
    v2 = np.asarray(valid, dtype=bool).reshape(n_lanes, -1)
    w = min(unroll, k2.shape[1])
    delta = np.ones_like(k2, dtype=bool)
    if k2.shape[1] > 1:
        delta[:, 1:] = k2[:, 1:] != k2[:, :-1]
    a_head = int(v2[:, :w].sum())
    b_head = int((delta[:, :w] & v2[:, :w]).sum())
    return a_head + b_head


def lane_traffic_spmm(m, k, seg_start, valid, n_lanes: int, bm: int, bk: int,
                      n_cols: int, bytes_per_el: int = 4,
                      unroll: int = 1, pipeline: bool = True,
                      prefetch: Optional[str] = None) -> dict:
    """Revisiting-model bytes for the lane-parallel SpMM schedule.

    A tiles are fetched once per valid item; a B row-block when ``k``
    changes within a lane; C tiles follow the segment write/revisit rule.
    ``prefetch_fetches`` counts the head-window copies the TPU kernel's
    ``"cross_pass"`` mode overlaps (0 when ``prefetch`` is off).
    """
    if prefetch not in PREFETCH_MODES:
        raise ValueError(f"prefetch={prefetch!r} not in {PREFETCH_MODES}")
    fetches, c_segments, c_bytes = _revisit_traffic(
        [(k, 0, True), (k, bk * n_cols * bytes_per_el, False)],
        m, seg_start, valid, n_lanes, bm * n_cols * bytes_per_el,
        unroll=unroll, pipeline=pipeline)
    a_fetches = fetches[0][0]
    a_bytes = a_fetches * bm * bk * bytes_per_el
    b_fetches, b_bytes = fetches[1]
    total = a_bytes + b_bytes + c_bytes
    prefetch_fetches = (_head_window_fetches(k, valid, n_lanes, unroll)
                        if prefetch == "cross_pass" else 0)
    return dict(a_bytes=a_bytes, b_bytes=b_bytes, c_bytes=c_bytes, total=total,
                a_fetches=a_fetches, b_fetches=b_fetches,
                c_segments=c_segments, prefetch_fetches=prefetch_fetches)


def shard_schedule(sizes: np.ndarray, n_shards: int, policy: str = "segment"):
    """Partition per-owner work across lanes: LPT for fold-capable
    policies, round-robin for static ones.  Returns (assignment, stats)."""
    if get_policy(policy).supports_fold:
        return balance_bins(sizes, n_shards)
    return round_robin_bins(sizes, n_shards)
