"""SEGMENTBC — the virtual coordinate space (V-space) and merge routing
(a copy of ``repro.core.segmentbc``).

Implements the paper's §III-B / §IV-A at functional granularity:

* a :class:`VSpace` holding one virtual row per non-empty output row of C,
  maintaining the four mapping invariants (injectivity, row saturation,
  column ordering, time ascending);
* merge routing of an incoming B element (compare, forward, insert,
  accumulate) with *segment displacement* accounting (Eq. 5);
* three index-to-PE mappers (§VI-C.2): ``zero`` (always start at 0), ``ideal``
  (oracle binary search on up-to-date state), ``lut`` (binary search on a
  bounded-write-bandwidth, possibly *stale* copy — SegFold's IPM).

Correctness does not depend on the mapper: a stale LUT can only start a
segment *left* of its true legal start (time-ascending property), lengthening
the traversal but never missing the match — mirrored here and verified by
property tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class VirtualRow:
    """One virtual row: sorted column indices + partial sums."""

    cols: List[int] = dataclasses.field(default_factory=list)
    vals: List[float] = dataclasses.field(default_factory=list)

    def check_invariants(self) -> None:
        # a named error, not a bare assert: this must hold under python -O
        # too (the simulator's routing correctness rests on it)
        if any(self.cols[i] >= self.cols[i + 1]
               for i in range(len(self.cols) - 1)):
            raise ValueError(
                f"virtual-row column ordering violated: cols={self.cols} "
                f"must be strictly increasing (SEGMENTBC keeps every "
                f"virtual row sorted so shift-based insertion stays exact)")


class StaleLUT:
    """IPM model: a lagging copy of a virtual row's column indices.

    Real hardware has a limited number of LUT write ports; updates queue and
    apply serially (``write_ports`` per ``tick``).  Staleness only under-
    estimates legal start positions (time-ascending ⇒ entries only move right),
    which is safe.
    """

    def __init__(self, write_ports: int = 1):
        self.snapshot: List[int] = []
        self.pending: List[List[int]] = []   # queue of full-row snapshots
        self.write_ports = write_ports
        self._credit = 0

    def notify(self, cols: List[int]) -> None:
        """A PE updated its c value → enqueue the new state."""
        self.pending.append(list(cols))

    def tick(self) -> None:
        """Apply up to ``write_ports`` queued updates (one per port)."""
        self._credit += self.write_ports
        while self.pending and self._credit > 0:
            self.snapshot = self.pending.pop(0)
            self._credit -= 1
        self._credit = min(self._credit, self.write_ports)

    def lookup(self, b: int) -> int:
        """Rightmost legal start: #entries with c < b in the (stale) snapshot."""
        return int(np.searchsorted(np.asarray(self.snapshot, dtype=np.int64), b, side="left"))


class VSpace:
    """The evolving compressed coordinate space for C (one matrix tile)."""

    def __init__(self, mapping: str = "lut", lut_write_ports: int = 1):
        if mapping not in ("zero", "ideal", "lut"):
            raise ValueError(f"unknown V-space mapping {mapping!r}; "
                             f"expected 'zero', 'ideal' or 'lut'")
        self.mapping = mapping
        self.rows: Dict[int, VirtualRow] = {}
        self.luts: Dict[int, StaleLUT] = {}
        self.lut_write_ports = lut_write_ports
        # telemetry
        self.total_displacement = 0
        self.total_shifts = 0
        self.elements_routed = 0

    # -- mapping f_t ----------------------------------------------------------
    def _row(self, m: int) -> VirtualRow:
        if m not in self.rows:
            self.rows[m] = VirtualRow()
            self.luts[m] = StaleLUT(self.lut_write_ports)
        return self.rows[m]

    def start_position(self, m: int, b: int) -> int:
        """f_t_in from the configured mapper."""
        row = self._row(m)
        if self.mapping == "zero":
            return 0
        if self.mapping == "ideal":
            return int(np.searchsorted(np.asarray(row.cols, dtype=np.int64), b, side="left"))
        # lut: stale binary search, clamped to legal range
        s = self.luts[m].lookup(b)
        # A stale LUT may only be *behind* (entries moved right since the
        # snapshot) => s can only be <= the true start. Clamp defensively.
        true_s = int(np.searchsorted(np.asarray(row.cols, dtype=np.int64), b, side="left"))
        return min(s, true_s)

    # -- merge routing ----------------------------------------------------------
    def route(self, m: int, n: int, value: float) -> Tuple[int, int]:
        """Route one B/T element into row ``m`` with column index ``n``.

        Returns ``(displacement, shifts)``: PE hops traversed and entries
        shifted right (insert cost).  Implements Fig. 6 cases.
        """
        row = self._row(m)
        s = self.start_position(m, n)
        cols = row.cols
        # walk right from s: b > c → forward; b < c → insert; b == c → accumulate
        pos = s
        while pos < len(cols) and cols[pos] < n:
            pos += 1
        displacement = pos - s
        shifts = 0
        if pos < len(cols) and cols[pos] == n:
            row.vals[pos] += value                      # Fig. 6(c) accumulate
        else:
            cols.insert(pos, n)                         # Fig. 6(b) insert
            row.vals.insert(pos, value)
            shifts = len(cols) - 1 - pos                # entries shifted right
        self.total_displacement += displacement
        self.total_shifts += shifts
        self.elements_routed += 1
        if self.mapping == "lut":
            self.luts[m].notify(cols)
        return displacement, shifts

    def tick(self) -> None:
        """Advance LUT write queues one cycle."""
        if self.mapping == "lut":
            for lut in self.luts.values():
                lut.tick()

    # -- extraction -------------------------------------------------------------
    def to_coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        rows, cols, vals = [], [], []
        for m, row in sorted(self.rows.items()):
            rows.extend([m] * len(row.cols))
            cols.extend(row.cols)
            vals.extend(row.vals)
        return (np.asarray(rows, dtype=np.int64),
                np.asarray(cols, dtype=np.int64),
                np.asarray(vals, dtype=np.float32))

    def check_invariants(self) -> None:
        for row in self.rows.values():
            row.check_invariants()

    @property
    def mean_displacement(self) -> float:
        return self.total_displacement / max(self.elements_routed, 1)


def segment_spgemm_elementwise(a_csc, b_csr, *, w_max: int = 32, r_max: int = 16,
                               mapping: str = "lut", dynamic_k: bool = True):
    """Reference Segment-dataflow SpGEMM: SELECTA batches × SEGMENTBC routing.

    Functional model (no timing): used as the paper-faithful algorithmic
    oracle.  Returns (dense C, telemetry dict).
    """
    from .selecta import SelectaState

    m_dim, k_dim = a_csc.shape
    n_dim = b_csr.shape[1]
    vspace = VSpace(mapping=mapping)
    st = SelectaState(a=a_csc, w_max=w_max, r_max=r_max, dynamic_k=dynamic_k)
    a_dense = a_csc.to_dense()
    batches = 0
    while not st.done:
        batch = st.select()
        if not batch:
            continue
        batches += 1
        for (m, k) in batch:
            b_cols, b_vals = b_csr.row(k)
            a_val = a_dense[m, k]
            for n, bv in zip(b_cols, b_vals):
                vspace.route(m, int(n), float(a_val * bv))
        vspace.tick()
    rows, cols, vals = vspace.to_coo()
    c = np.zeros((m_dim, n_dim), dtype=np.float32)
    if rows.size:
        c[rows, cols] = vals
    telemetry = {
        "batches": batches,
        "mean_displacement": vspace.mean_displacement,
        "total_shifts": vspace.total_shifts,
        "elements_routed": vspace.elements_routed,
    }
    return c, telemetry
