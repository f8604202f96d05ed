"""Cycle-approximate simulator of the SegFold microarchitecture (§IV-V); a
copy of ``repro.sim.segfold_sim``.

One unified *wave engine* times every accelerator model, so that performance
differences come **only from scheduling/mapping mechanisms** — the same logic
the paper's incremental ablation (Fig. 11) uses.  A *wave* is one scheduling
step across the PE rows; its latency is the max of decoupled pipelines:

``wave = max(compute, multicast, dram, 1)``

* **compute** — per-pair merge cost ``ceil(blen/P) + disp`` (the row shifter
  injects one P-wide vector of a B row per cycle, §IV-C; ``disp`` is the
  merge-network displacement, §III-B), times a *folding serialization factor*
  (active virtual-row footprints beyond the physical array serialize
  sub-waves; without spatial folding, long rows pay per-chunk spad swaps
  instead, §IV-D).
* **multicast** — the vector crossbar issues ``multicast_width`` row-vectors
  per cycle; SELECTA's k-sharing needs few distinct rows per wave, static
  round-robin needs up to R distinct rows (a structural reuse gap).
* **dram** — bytes moved this wave (A stream + B LRU misses + spills +
  phase-separated partial traffic when SEGMENTBC is disabled) over the HBM
  bytes/cycle.

Scheduling modes:

* ``selecta``        — Algorithm 1 (dynamic window, greedy k-sharing,
                       m-conflict avoidance); ``dynamic_k=False`` gives the
                       §VI-C.1 fixed-k ablation.
* ``static_rr``      — MatRaptor/Flexagon-Gustavson-like: R row lanes, each
                       streaming its own A row's pairs in static order.
* ``static_kmajor``  — OuterSPACE/Flexagon-OP-like: k-major cross products;
                       combined with ``segmentbc_enabled=False`` it pays the
                       multiply/merge phase separation (2× partial traffic
                       plus a merge pass).

Mapping modes (§VI-C.2): ``zero`` | ``lut`` (stale IPM) | ``ideal`` (oracle).

The per-pair C-row evolution is tracked exactly (sorted unions) while rows
are small, switching to a uniform-occupancy estimate once rows grow dense
(exact regime covers the SuiteSparse-like suite; the estimate is exact in
expectation for the uniform synthetic matrices of the density sweeps).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.formats import CSC, CSR
from repro_torch.core.selecta import SelectaState


@dataclasses.dataclass
class SegFoldConfig:
    pe_rows: int = 16
    pe_cols: int = 16
    window: int = 32
    multicast_width: int = 4
    mapping: str = "lut"            # zero | lut | ideal
    dynamic_k: bool = True          # False = fixed-k ablation (§VI-C.1)
    spatial_folding: bool = True
    schedule_mode: str = "selecta"  # selecta | static_rr | static_kmajor
    segmentbc_enabled: bool = True  # False = phase-separated partials (OP)
    element_bytes: int = 8          # value + index
    cache_bytes: int = int(1.5 * 1024 * 1024)
    dram_bytes_per_cycle: int = 256  # HBM2 @2Gbps, 1 GHz core
    dram_latency: int = 96          # cycles; hidden by window prefetch lead
    lut_write_ports: int = 1
    exact_row_limit: int = 1024     # switch to occupancy estimate beyond this
    swap_cost: int = 2              # spad chunk-swap cycles (no-folding mode)
    spad_factor: int = 4            # per-row spad capacity in PE-row widths
    tail_cap: Optional[int] = None  # cap per-pair spad-tail cost (Spada-like
                                    # multi-lane row splitting); None = uncapped
    vector_injection: bool = True   # SegFold row shifter injects P-wide
                                    # vectors (§IV-C); scalar comparator-queue
                                    # designs (MatRaptor/Flexagon) stream one
                                    # element per lane per cycle

    @property
    def r_max(self) -> int:
        return self.pe_rows


@dataclasses.dataclass
class SimResult:
    cycles: float
    macs: int
    dram_bytes: float
    batches: int
    compute_cycles: float
    multicast_cycles: float
    dram_cycles: float
    spill_elements: int
    mean_occupancy: float
    mean_displacement: float

    @property
    def cycles_per_mac(self) -> float:
        return self.cycles / max(self.macs, 1)


class _LRUCache:
    """Fully-associative LRU byte cache (B rows)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.used = 0
        self.entries: "OrderedDict[int, int]" = OrderedDict()

    def access(self, key: int, nbytes: int) -> bool:
        if key in self.entries:
            self.entries.move_to_end(key)
            return True
        while self.used + nbytes > self.capacity and self.entries:
            _, sz = self.entries.popitem(last=False)
            self.used -= sz
        if nbytes <= self.capacity:
            self.entries[key] = nbytes
            self.used += nbytes
        return False


class _CRowTracker:
    """Evolving C-row occupancy: exact sorted sets → estimate when large."""

    def __init__(self, n_cols: int, exact_limit: int):
        self.n = n_cols
        self.exact_limit = exact_limit
        self.exact: Dict[int, np.ndarray] = {}
        self.approx_len: Dict[int, float] = {}

    def merge(self, m: int, b_cols: np.ndarray) -> dict:
        blen = int(b_cols.size)
        if blen == 0:
            return dict(inserts=0, rank_first=0, rank_last=0, c_len=int(self.length(m)))
        if m in self.approx_len or blen + self.length(m) > self.exact_limit:
            c_len = self.approx_len.pop(m, None)
            if c_len is None:
                c_len = float(len(self.exact.pop(m, np.zeros(0))))
            overlap = min(c_len * blen / self.n, float(min(c_len, blen)))
            inserts = blen - overlap
            new_len = min(c_len + inserts, float(self.n))
            self.approx_len[m] = new_len
            return dict(inserts=int(round(inserts)),
                        rank_first=int(float(b_cols[0]) / self.n * new_len),
                        rank_last=int(float(b_cols[-1]) / self.n * new_len),
                        c_len=int(new_len))
        cur = self.exact.get(m)
        if cur is None:
            self.exact[m] = np.asarray(b_cols, dtype=np.int64)
            return dict(inserts=blen, rank_first=0, rank_last=blen - 1, c_len=blen)
        union = np.union1d(cur, b_cols)
        res = dict(inserts=int(union.size - cur.size),
                   rank_first=int(np.searchsorted(union, b_cols[0])),
                   rank_last=int(np.searchsorted(union, b_cols[-1])),
                   c_len=int(union.size))
        self.exact[m] = union
        return res

    def length(self, m: int) -> float:
        if m in self.approx_len:
            return self.approx_len[m]
        if m in self.exact:
            return float(self.exact[m].size)
        return 0.0

    def total_nnz(self) -> int:
        return int(sum(a.size for a in self.exact.values())
                   + sum(self.approx_len.values()))


# ---------------------------------------------------------------------------
# batch generators (the scheduling mechanisms)
# ---------------------------------------------------------------------------


def _selecta_batches(st: SelectaState) -> Iterable[List[Tuple[int, int]]]:
    guard, limit = 0, 10 * (st.a.nnz + st.a.shape[1] + 1)
    while not st.done:
        yield st.select()
        guard += 1
        if guard > limit:  # pragma: no cover
            raise RuntimeError("SELECTA stalled")


def _static_rr_batches(a: CSR, k_active: np.ndarray, r_max: int):
    """R row lanes, each streaming its own A row's pairs in static order."""
    queues: List[List[int]] = []
    rows = [m for m in range(a.shape[0]) if a.indptr[m + 1] > a.indptr[m]]
    next_row = 0
    lanes: List[Optional[Tuple[int, List[int]]]] = [None] * r_max
    while True:
        batch = []
        for i in range(r_max):
            if lanes[i] is None and next_row < len(rows):
                m = rows[next_row]
                next_row += 1
                ks = [int(k) for k in a.indices[a.indptr[m]:a.indptr[m + 1]]
                      if k_active[int(k)]]
                lanes[i] = (m, ks)
            if lanes[i] is not None:
                m, ks = lanes[i]
                if ks:
                    batch.append((m, ks.pop(0)))
                if not ks:
                    lanes[i] = None
        if not batch:
            if next_row >= len(rows) and all(l is None for l in lanes):
                return
            continue
        yield batch


def _static_kmajor_batches(a: CSR, k_active: np.ndarray, r_max: int):
    """k-major static order (outer-product-like): chunk each column's rows."""
    a_csc = CSC.from_csr(a)
    for k in range(a_csc.shape[1]):
        if not k_active[k]:
            continue
        rows, _ = a_csc.col(k)
        for i in range(0, rows.size, r_max):
            yield [(int(m), k) for m in rows[i:i + r_max]]


# ---------------------------------------------------------------------------
# the wave engine
# ---------------------------------------------------------------------------


def estimate_n_tiles(a: CSR, b: CSR, cfg: SegFoldConfig) -> int:
    """Static N-tiling choice (§V Tiling): tile C so the *expected* virtual
    row roughly fits the physical PE row (spad is the safety margin). Long-
    tail rows still overflow — exactly the spills the paper calls infrequent.
    Tiling costs an A re-stream per tile, which the engine charges."""
    import scipy.sparse as sp
    A = sp.csr_matrix((np.ones_like(a.data, np.int8), a.indices, a.indptr), shape=a.shape)
    B = sp.csr_matrix((np.ones_like(b.data, np.int8), b.indices, b.indptr), shape=b.shape)
    C = A @ B
    lens = np.diff(C.tocsr().indptr)
    lens = lens[lens > 0]
    if lens.size == 0:
        return 1
    cap = cfg.pe_cols * 2
    return max(1, int(np.ceil(float(lens.mean()) / cap)))


class _WaveEngine:
    """Shared cost semantics for one SpGEMM execution."""

    def __init__(self, b: CSR, cfg: SegFoldConfig, n_tiles: int = 1,
                 entry_batch: Optional[Dict[int, int]] = None):
        self.b = b
        self.cfg = cfg
        self.n_tiles = max(1, n_tiles)
        self.b_lens = b.row_lengths()
        self.cache = _LRUCache(cfg.cache_bytes)
        self.tracker = _CRowTracker(b.shape[1], cfg.exact_row_limit)
        self.pending_lut: Dict[int, int] = {}
        # DRAM-latency model (Little's law): with `window` outstanding B-row
        # prefetch slots and `dram_latency` cycles per fetch, sustained new-
        # row throughput is window/dram_latency rows per cycle. The active
        # window is SegFold's outstanding-request structure (§III-A k-level
        # pipelining); static dataflows get an equal-depth stream prefetcher
        # (same memory system, §V).
        self.prefetch_depth = max(1, cfg.window)
        self.entry_batch = entry_batch  # retained for telemetry
        # telemetry
        self.cycles = 0.0
        self.macs = 0
        self.dram_bytes = 0.0
        self.batches = 0
        self.sum_compute = 0.0
        self.sum_mc = 0.0
        self.sum_dram = 0.0
        self.spills = 0
        self.occ_acc = 0.0
        self.disp_acc = 0.0
        self.disp_cnt = 0

    def wave(self, batch: List[Tuple[int, int]]) -> float:
        cfg, eb = self.cfg, self.cfg.element_bytes
        P = cfg.pe_cols
        self.batches += 1
        # ---- multicast ----
        ks = sorted({k for _, k in batch})
        lens = [int(self.b_lens[k]) for k in ks]
        total_vectors = sum((ln + P - 1) // P for ln in lens)
        mc_cycles = (total_vectors + cfg.multicast_width - 1) // cfg.multicast_width
        # ---- memory: A stream (once per N-tile pass) + B rows through LRU ----
        batch_bytes = len(batch) * eb * self.n_tiles
        new_rows = 0
        for k, ln in zip(ks, lens):
            if ln and not self.cache.access(k, ln * eb):
                batch_bytes += ln * eb
                new_rows += 1
        # ---- per-pair merge/compute ----
        pair_cycles = []
        tails = []          # spad-tail serialization per pair (beyond array)
        spad_cap = P * cfg.spad_factor
        for (m, k) in batch:
            b_cols = self.b.indices[self.b.indptr[k]:self.b.indptr[k + 1]]
            info = self.tracker.merge(m, np.asarray(b_cols, dtype=np.int64))
            blen = int(b_cols.size)
            self.macs += blen
            if cfg.segmentbc_enabled:
                if cfg.mapping == "zero":
                    disp = info["rank_first"]
                elif cfg.mapping == "ideal":
                    disp = 0
                else:  # stale LUT
                    disp = min(self.pending_lut.get(m, 0), info["c_len"])
                self.pending_lut[m] = info["inserts"]
            else:
                disp = 0
                batch_bytes += 2 * blen * eb  # phase-separated partials
            # N-tiling (§V) bounds the virtual row width seen per tile
            c_len = max(1, info["c_len"] // self.n_tiles)
            disp = disp // self.n_tiles
            blen_t = max(1, blen // self.n_tiles)  # per-tile B row slice
            if cfg.vector_injection:
                cyc = (blen_t + P - 1) // P + (disp + P - 1) // P
            else:
                cyc = blen_t + disp   # scalar comparator-queue stream
            # elements landing beyond the physical row need the per-row spad
            # (one port → serialized access), unless spatial folding placed
            # them on a free neighbor PE row (handled at batch level below)
            if c_len > P:
                frac_beyond = 1.0 - P / c_len
                tail = int(round(blen_t * frac_beyond))
                if cfg.tail_cap is not None:
                    tail = min(tail, cfg.tail_cap)
                tails.append(tail)
                if c_len > spad_cap:
                    # true overflow: partials round-trip DRAM
                    over = int(round(info["inserts"] / self.n_tiles
                                     * (1.0 - spad_cap / c_len)))
                    batch_bytes += 2 * over * eb
                    self.spills += over
            else:
                tails.append(0)
            pair_cycles.append(cyc)
            self.disp_acc += disp
            self.disp_cnt += 1
        if cfg.mapping == "lut":
            for m in list(self.pending_lut):
                self.pending_lut[m] = max(0, self.pending_lut[m] - cfg.lut_write_ports)
                if self.pending_lut[m] == 0:
                    del self.pending_lut[m]
        # spatial folding: free PE rows absorb the largest tails in parallel
        if cfg.spatial_folding:
            free = cfg.pe_rows - len(batch)
            if free > 0 and tails:
                for i in np.argsort(tails)[::-1][:free]:
                    tails[i] = 0
        compute = max((pc + t) for pc, t in zip(pair_cycles, tails)) if batch else 0
        dram_cyc = batch_bytes / cfg.dram_bytes_per_cycle
        # DRAM-latency throughput bound (Little's law over prefetch slots).
        # The coalescing unit (§IV-B) merges fine-grain row requests into
        # cache-line fetches, giving each window slot ~4 lines in flight.
        lat_cyc = new_rows * cfg.dram_latency / (self.prefetch_depth * 4)
        wave = max(compute, mc_cycles, dram_cyc, lat_cyc, 1.0)
        self.cycles += wave
        self.dram_bytes += batch_bytes
        self.sum_compute += compute
        self.sum_mc += mc_cycles
        self.sum_dram += dram_cyc
        self.occ_acc += len(batch) / cfg.r_max
        return wave

    def finish(self, merge_pass: bool = False) -> SimResult:
        cfg, eb = self.cfg, self.cfg.element_bytes
        c_nnz = self.tracker.total_nnz()
        wb = c_nnz * eb
        self.dram_bytes += wb
        self.cycles += wb / cfg.dram_bytes_per_cycle
        if merge_pass:
            # phase-separated designs re-read all partials and merge them
            t_bytes = self.macs * eb
            self.dram_bytes += t_bytes
            self.cycles += max(self.macs / cfg.pe_rows,
                               t_bytes / cfg.dram_bytes_per_cycle)
        return SimResult(
            cycles=float(self.cycles), macs=int(self.macs),
            dram_bytes=float(self.dram_bytes), batches=self.batches,
            compute_cycles=float(self.sum_compute),
            multicast_cycles=float(self.sum_mc),
            dram_cycles=float(self.sum_dram), spill_elements=int(self.spills),
            mean_occupancy=self.occ_acc / max(self.batches, 1),
            mean_displacement=self.disp_acc / max(self.disp_cnt, 1),
        )


def simulate_segfold(a: CSR, b: CSR, cfg: Optional[SegFoldConfig] = None) -> SimResult:
    """Simulate SpGEMM C = A @ B; scheduling per ``cfg.schedule_mode``."""
    cfg = cfg or SegFoldConfig()
    b_lens = b.row_lengths()
    k_active = b_lens > 0
    entry_batch = None
    if cfg.schedule_mode == "selecta":
        st = SelectaState(a=CSC.from_csr(a), w_max=cfg.window, r_max=cfg.r_max,
                          dynamic_k=cfg.dynamic_k, k_active=k_active)
        batches = _selecta_batches(st)
        entry_batch = st.entry_batch   # live dict: filled as the window slides
    elif cfg.schedule_mode == "static_rr":
        batches = _static_rr_batches(a, k_active, cfg.r_max)
    elif cfg.schedule_mode == "static_kmajor":
        batches = _static_kmajor_batches(a, k_active, cfg.r_max)
    else:
        raise ValueError(cfg.schedule_mode)
    eng = _WaveEngine(b, cfg, n_tiles=estimate_n_tiles(a, b, cfg),
                      entry_batch=entry_batch)
    for batch in batches:
        if batch:
            eng.wave(batch)
    return eng.finish(merge_pass=not cfg.segmentbc_enabled)
