"""Folding — mapping irregular virtual rows onto regular hardware (§IV-D);
a copy of ``repro.core.folding``.

* **Microarchitectural (simulator)**: :func:`spatial_fold` places virtual
  rows of C onto an ``R×P`` PE occupancy grid with the paper's neighbor
  priority {right, up, down, left}; overflow beyond the array spills to the
  per-row scratchpad (**temporal folding**, :func:`temporal_fold_spills`).
* **Schedule granularity**: :func:`fold_segments` splits oversized
  reduction segments into bounded chunks, and :func:`balance_bins` /
  :func:`round_robin_bins` pack work into lanes.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Microarchitectural folding (paper-faithful placement model)
# ---------------------------------------------------------------------------

_NEIGHBOR_PRIORITY = ((0, 1), (-1, 0), (1, 0), (0, -1))  # right, up, down, left


def spatial_fold(row_lengths: np.ndarray, R: int, P: int,
                 enabled: bool = True) -> dict:
    """Place virtual rows of the given lengths onto an R×P occupancy grid.

    Rows are anchored at their home PE row (``x % R``, column 0) and grow
    following the paper's priority order.  With ``enabled=False`` a virtual row
    may only use its home physical row (the no-folding baseline): the rest
    spills.

    Returns occupancy/utilization/spill telemetry.
    """
    occ = np.zeros((R, P), dtype=bool)
    spills = 0
    placed = 0
    for x, length in enumerate(row_lengths):
        r0 = x % R
        # anchor: first free cell in the home row, else home cell conflicts
        cur = None
        for p in range(P):
            if not occ[r0, p]:
                cur = (r0, p)
                break
        if cur is None:
            spills += int(length)
            continue
        remaining = int(length)
        while remaining > 0:
            r, p = cur
            occ[r, p] = True
            placed += 1
            remaining -= 1
            if remaining == 0:
                break
            nxt = None
            for dr, dp in _NEIGHBOR_PRIORITY:
                rr, pp = r + dr, p + dp
                if not enabled and rr != r0:
                    continue
                if 0 <= rr < R and 0 <= pp < P and not occ[rr, pp]:
                    nxt = (rr, pp)
                    break
            if nxt is None:
                spills += remaining        # temporal fold: overflow to spad
                remaining = 0
            else:
                cur = nxt
    total = int(np.sum(row_lengths))
    return {
        "placed": placed,
        "spills": spills,
        "utilization": placed / float(R * P),
        "spill_fraction": spills / float(max(total, 1)),
        "occupancy": occ,
    }


def temporal_fold_spills(row_lengths: np.ndarray, capacity: int) -> int:
    """Entries beyond per-row capacity that go to the scratchpad."""
    lengths = np.asarray(row_lengths, dtype=np.int64)
    return int(np.maximum(lengths - capacity, 0).sum())


# ---------------------------------------------------------------------------
# Schedule-grain folding: segment splitting + lane balancing
# ---------------------------------------------------------------------------


def fold_segments(seg_sizes: np.ndarray, fold_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Split segments longer than ``fold_len`` into chunks.

    Returns ``(chunk_seg, chunk_size)``: for each resulting chunk, the index of
    its parent segment and its size.
    """
    chunk_seg: List[int] = []
    chunk_size: List[int] = []
    for i, s in enumerate(np.asarray(seg_sizes, dtype=np.int64)):
        s = int(s)
        while s > fold_len:
            chunk_seg.append(i)
            chunk_size.append(fold_len)
            s -= fold_len
        if s > 0:
            chunk_seg.append(i)
            chunk_size.append(s)
    return np.asarray(chunk_seg, dtype=np.int64), np.asarray(chunk_size, dtype=np.int64)


def _load_stats(loads: np.ndarray, n_bins: int) -> dict:
    mean = loads.mean() if n_bins else 0.0
    return {
        "max_load": int(loads.max(initial=0)),
        "mean_load": float(mean),
        "imbalance": float(loads.max(initial=0) / mean) if mean > 0 else 1.0,
        "loads": loads,
    }


def balance_bins(work_sizes: np.ndarray, n_bins: int) -> Tuple[np.ndarray, dict]:
    """Greedy LPT makespan packing: assign each work item to the least-loaded bin.

    Returns (assignment, stats) where stats reports the load imbalance
    ``max_load / mean_load``.
    """
    sizes = np.asarray(work_sizes, dtype=np.int64)
    order = np.argsort(-sizes)
    loads = np.zeros(n_bins, dtype=np.int64)
    assign = np.zeros(sizes.size, dtype=np.int64)
    for i in order:
        b = int(np.argmin(loads))
        assign[i] = b
        loads[b] += sizes[i]
    return assign, _load_stats(loads, n_bins)


def round_robin_bins(work_sizes: np.ndarray, n_bins: int) -> Tuple[np.ndarray, dict]:
    """Static round-robin baseline (what a static dataflow would do)."""
    sizes = np.asarray(work_sizes, dtype=np.int64)
    assign = np.arange(sizes.size, dtype=np.int64) % max(n_bins, 1)
    loads = np.zeros(n_bins, dtype=np.int64)
    np.add.at(loads, assign, sizes)
    return assign, _load_stats(loads, n_bins)
