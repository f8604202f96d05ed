"""Folding at schedule granularity (a copy of the TPU-grain half of
``repro.core.folding``): :func:`fold_segments` splits oversized reduction
segments into bounded chunks, and :func:`balance_bins` /
:func:`round_robin_bins` pack work into lanes."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


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
