"""SELECTA — dynamic (m, k) selection over an active window (paper Alg. 1).

This is the *element-granularity* faithful implementation used by the
simulator and the reference Segment dataflow (a copy of
``repro.core.selecta``).  The block-granularity adaptation the kernels run
lives in :mod:`repro_torch.core.schedule`.

The selector keeps a sliding window of up to ``w_max`` K-columns of A.  Each
invocation returns up to ``r_max`` (m, k) pairs such that:

* pairs greedily share the same ``k`` (maximizes reuse of the B row ``k``),
* no two pairs share the same ``m`` (avoids C-row reduction conflicts),
* exhausted ``k`` columns retire from the window and new ones slide in
  (inter-tile reordering / k-level pipelining).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .formats import CSC


@dataclasses.dataclass
class SelectaState:
    """Mutable scheduler state: consumption bitmask + window membership."""

    a: CSC
    w_max: int
    r_max: int
    dynamic_k: bool = True           # False => fixed k order (§VI-C.1 ablation)
    k_active: Optional[np.ndarray] = None  # bool mask: B row k non-empty
    next_k: int = 0                  # next column to slide into the window
    window: List[int] = dataclasses.field(default_factory=list)
    # per-column cursor into the remaining (unconsumed) row ids
    remaining: dict = dataclasses.field(default_factory=dict)
    # batch index at which each k entered the window (prefetch lead time —
    # the simulator uses it to model DRAM-latency hiding, §III-A inter-tile
    # reordering / k-level pipelining)
    entry_batch: dict = dataclasses.field(default_factory=dict)
    batch_idx: int = 0

    def __post_init__(self):
        self._refill()

    # -- window management ---------------------------------------------------
    def _refill(self) -> None:
        k_dim = self.a.shape[1]
        while len(self.window) < self.w_max and self.next_k < k_dim:
            k = self.next_k
            self.next_k += 1
            if self.k_active is not None and not self.k_active[k]:
                continue  # intersection filter: B row k is empty (§IV-B)
            rows, _ = self.a.col(k)
            if rows.size == 0:
                continue  # DCSR-style O(1) skip of empty columns
            self.window.append(k)
            # (row-id array, cursor, deferred-conflict list) — O(taken) scans
            self.remaining[k] = [rows.astype(np.int64), 0, []]
            self.entry_batch[k] = self.batch_idx

    def _col_remaining(self, k: int) -> int:
        arr, pos, deferred = self.remaining[k]
        return (arr.size - pos) + len(deferred)

    @property
    def done(self) -> bool:
        return not self.window and self.next_k >= self.a.shape[1]

    # -- one SELECTA invocation ----------------------------------------------
    def select(self) -> List[Tuple[int, int]]:
        """Return up to ``r_max`` (m, k) pairs per Algorithm 1."""
        selected: List[Tuple[int, int]] = []
        used_m = set()
        self.batch_idx += 1

        if self.dynamic_k:
            # Greedy: visit window columns in order of most remaining work so
            # the batch concentrates on few k (max B-row reuse).
            order = sorted(self.window, key=self._col_remaining, reverse=True)
        else:
            # §VI-C.1 ablation: ks processed in a predetermined sequence —
            # the batch draws only from the oldest live k (a "constrained
            # outer-product scheme"), forgoing cross-k batch packing.
            order = list(self.window[:1])

        for k in order:
            if len(selected) >= self.r_max:
                break
            arr, pos, deferred = self.remaining[k]
            new_deferred = []
            for m in deferred:
                if len(selected) < self.r_max and m not in used_m:
                    selected.append((m, k))
                    used_m.add(m)
                else:
                    new_deferred.append(m)
            while pos < arr.size and len(selected) < self.r_max:
                m = int(arr[pos])
                pos += 1
                if m in used_m:
                    new_deferred.append(m)  # conflict: defer to a later batch
                else:
                    selected.append((m, k))
                    used_m.add(m)
            self.remaining[k] = [arr, pos, new_deferred]

        # retire completed ks, slide new ones in
        done_ks = [k for k in self.window if self._col_remaining(k) == 0]
        for k in done_ks:
            self.window.remove(k)
            del self.remaining[k]
        self._refill()
        return selected


def run_selecta(a: CSC, w_max: int = 32, r_max: int = 16,
                dynamic_k: bool = True) -> List[List[Tuple[int, int]]]:
    """Drain matrix A through SELECTA; returns the batch list."""
    st = SelectaState(a=a, w_max=w_max, r_max=r_max, dynamic_k=dynamic_k)
    batches = []
    guard = 0
    limit = 10 * (a.nnz + a.shape[1] + 1)
    while not st.done:
        batch = st.select()
        if batch:
            batches.append(batch)
        guard += 1
        if guard > limit:  # pragma: no cover - safety net
            raise RuntimeError("SELECTA failed to make progress")
    return batches


def selecta_stats(batches: List[List[Tuple[int, int]]], r_max: int) -> dict:
    """Reuse / occupancy statistics over a SELECTA trace."""
    if not batches:
        return {"batches": 0, "occupancy": 0.0, "k_sharing": 0.0, "pairs": 0}
    sizes = np.array([len(b) for b in batches], dtype=np.float64)
    # k-sharing: mean pairs per distinct k within a batch (B-row reuse factor)
    shares = []
    for b in batches:
        ks = [k for _, k in b]
        shares.append(len(ks) / max(len(set(ks)), 1))
    return {
        "batches": len(batches),
        "pairs": int(sizes.sum()),
        "occupancy": float(sizes.mean() / r_max),
        "k_sharing": float(np.mean(shares)),
    }
