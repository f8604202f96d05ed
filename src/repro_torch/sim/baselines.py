"""Baseline accelerator models on the shared wave engine (§V Methodology);
a copy of ``repro.sim.baselines``.

Every baseline runs on the *same*
:class:`~repro_torch.sim.segfold_sim._WaveEngine` timing machinery as
SegFold, with its scheduling/mapping mechanisms swapped — so performance
differences are attributable purely to dataflow mechanisms (the logic of
the paper's Fig. 11 incremental ablation):

* ``flexagon_gust`` — MatRaptor/Flexagon-Gustavson: independent row lanes in
  static order (``static_rr``), zero-offset merge starts (no IPM), no
  folding (long C rows pay spad chunk swaps).  Generous distribution network
  (16 row-vectors/cycle, matching the paper's 128-elem/cycle scaling).
* ``flexagon_op``   — OuterSPACE/Flexagon-OP: k-major static cross products
  with multiply/merge **phase separation**: every partial is written to and
  re-read from the intermediate store, plus a final merge pass.
* ``flexagon_ip``   — ExTensor-like inner product, analytical: streams both
  fibers for every candidate output (control-dominated at low density).
* ``spada``         — window-adaptive Gustavson: k-synchronous waves inside
  row windows (all lanes process the same k → perfect in-window B reuse,
  exactly Spada's window dataflow), window height adapted per tile,
  neighbor-lane stealing compresses the tail, but the in-window k order is
  static, so sparse column slices yield low-occupancy waves — the sub-tile
  opportunity SegFold's SELECTA exploits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.formats import CSR
from .segfold_sim import (SegFoldConfig, SimResult, _WaveEngine,
                          simulate_segfold)


def _k_synchronous_run(a: CSR, b: CSR, run: SegFoldConfig,
                       window_candidates, adapt: bool, steal: bool) -> SimResult:
    """Tiled Gustavson executed as k-synchronous waves.

    All lanes in a row-window process the same k each wave (the windowed /
    tiled loop structure of Spada and of Flexagon's per-tile static
    dataflows).  Sparse column slices therefore yield low-occupancy waves —
    this static loop overhead is exactly what SELECTA's dynamic work
    selection removes.
    """
    from .segfold_sim import estimate_n_tiles
    eng = _WaveEngine(b, run, n_tiles=estimate_n_tiles(a, b, run))
    b_lens = b.row_lengths()
    k_active = b_lens > 0
    m_dim = a.shape[0]
    lanes = run.pe_rows
    r = 0
    while r < m_dim:
        if adapt:
            best_h, best_score = window_candidates[0], None
            for h in window_candidates:
                hi = min(r + h, m_dim)
                ks = a.indices[a.indptr[r]:a.indptr[hi]]
                ks = ks[k_active[ks]]
                if ks.size == 0:
                    score = 0.0
                else:
                    distinct = np.unique(ks).size
                    groups = max(1, (hi - r + lanes - 1) // lanes)
                    score = distinct * groups / max(hi - r, 1)
                if best_score is None or score < best_score:
                    best_score, best_h = score, h
            h = best_h
        else:
            h = lanes
        hi = min(r + h, m_dim)
        for g in range(r, hi, lanes):
            ghi = min(g + lanes, hi)
            cols = {}
            for m in range(g, ghi):
                for k in a.indices[a.indptr[m]:a.indptr[m + 1]]:
                    k = int(k)
                    if k_active[k]:
                        cols.setdefault(k, []).append(m)
            for k in sorted(cols):   # static in-window k order
                batch = [(m, k) for m in cols[k]]
                if steal and len(batch) <= lanes // 2:
                    # neighbor-lane stealing: idle lanes split the busiest
                    # rows' elements → wave cost halves (bounded by 2×)
                    before = eng.cycles
                    eng.wave(batch)
                    eng.cycles = before + max((eng.cycles - before) / 2.0, 1.0)
                else:
                    eng.wave(batch)
        r = hi
    return eng.finish()


def flexagon_gust(a: CSR, b: CSR, cfg: Optional[SegFoldConfig] = None) -> SimResult:
    base = cfg or SegFoldConfig()
    run = dataclasses.replace(
        base, schedule_mode="static_rr", mapping="zero",
        spatial_folding=False, multicast_width=16, segmentbc_enabled=True,
        vector_injection=False)  # scalar comparator-queue lanes
    return _k_synchronous_run(a, b, run, (16,), adapt=False, steal=False)


def flexagon_op(a: CSR, b: CSR, cfg: Optional[SegFoldConfig] = None) -> SimResult:
    base = cfg or SegFoldConfig()
    run = dataclasses.replace(
        base, schedule_mode="static_kmajor", mapping="ideal",
        spatial_folding=False, swap_cost=0, multicast_width=16,
        segmentbc_enabled=False, tail_cap=0,  # no in-place merge: partials
        vector_injection=False)               # pay 2× traffic + merge pass
    return simulate_segfold(a, b, run)


def flexagon_ip(a: CSR, b: CSR, cfg: Optional[SegFoldConfig] = None) -> SimResult:
    """Analytical inner product: streams both fibers per candidate output."""
    base = cfg or SegFoldConfig()
    eb = base.element_bytes
    pes = base.pe_rows * base.pe_cols
    a_lens = np.diff(a.indptr).astype(np.int64)
    bt = b.transpose()
    b_col_lens = np.diff(bt.indptr).astype(np.int64)
    nonempty_rows = int((a_lens > 0).sum())
    nonempty_cols = int((b_col_lens > 0).sum())
    stream = float(a_lens.sum()) * nonempty_cols + float(b_col_lens.sum()) * nonempty_rows
    compute = stream / pes
    import scipy.sparse as sp
    A = sp.csr_matrix((np.ones_like(a.data, np.int8), a.indices, a.indptr), shape=a.shape)
    B = sp.csr_matrix((np.ones_like(b.data, np.int8), b.indices, b.indptr), shape=b.shape)
    macs = int((A @ np.diff(b.indptr).reshape(-1, 1)).sum())
    c_nnz = int((A @ B).nnz)
    b_bytes_once = b.nnz * eb
    if b_bytes_once <= base.cache_bytes:
        b_traffic = b_bytes_once
    else:
        b_traffic = float(b_col_lens.sum()) * nonempty_rows * eb
    dram_bytes = a.nnz * eb + b_traffic + c_nnz * eb
    dram = dram_bytes / base.dram_bytes_per_cycle
    cycles = max(compute, dram)
    return SimResult(cycles=float(cycles), macs=macs, dram_bytes=float(dram_bytes),
                     batches=0, compute_cycles=float(compute),
                     multicast_cycles=0.0, dram_cycles=float(dram),
                     spill_elements=0, mean_occupancy=0.0, mean_displacement=0.0)


def flexagon_best(a: CSR, b: CSR, cfg: Optional[SegFoldConfig] = None) -> dict:
    """Best static configuration per matrix (Fig. 8's strongest baseline)."""
    results = {
        "ip": flexagon_ip(a, b, cfg),
        "op": flexagon_op(a, b, cfg),
        "gust": flexagon_gust(a, b, cfg),
    }
    best = min(results, key=lambda k: results[k].cycles)
    return dict(result=results[best], config=best,
                all={k: v.cycles for k, v in results.items()},
                cycles=results[best].cycles, macs=results[best].macs)


def spada(a: CSR, b: CSR, cfg: Optional[SegFoldConfig] = None,
          window_candidates=(8, 16, 32, 64), steal: bool = True) -> SimResult:
    """Window-adaptive Gustavson with k-synchronous in-window waves."""
    base = cfg or SegFoldConfig()
    run = dataclasses.replace(
        base, schedule_mode="static_rr", mapping="ideal",
        spatial_folding=False, swap_cost=0, multicast_width=16,
        tail_cap=base.pe_cols)  # tile-level adaptation splits dense rows
    return _k_synchronous_run(a, b, run, window_candidates, adapt=True,
                              steal=steal)


# ---------------------------------------------------------------------------
# closed-form dataflow traffic estimates over a BSR block pattern
# ---------------------------------------------------------------------------


def _inner_product_estimate(kind: str, *, bm: int, bk: int,
                            n_cols: Optional[int] = None,
                            bn: Optional[int] = None,
                            bytes_per_el: int = 4, **coords) -> dict:
    """ExTensor-like inner-product traffic over a block pattern.

    Inner product enumerates candidate outputs and streams both operand
    fibers per output with no inter-item operand reuse: every work item
    re-fetches its A block and B stripe, and each output tile is written
    exactly once.  This is a lower bound on what a real inner-product
    machine moves (intersection misses would add fiber traffic), yet it is
    already never below Gustavson's adjacency-reuse counts — which is the
    point: it exists as a comparison dataflow for the tuner's scoring, not
    as a dispatch target (no registered policy executes it)."""
    if kind == "spmm":
        m = np.asarray(coords["m"])
        items = int(m.size)
        n = 1 if n_cols is None else int(n_cols)
        a_bytes = items * bm * bk * bytes_per_el
        b_bytes = items * bk * n * bytes_per_el
        n_out = int(np.unique(m).size)
        c_bytes = n_out * bm * n * bytes_per_el
    elif kind == "spgemm":
        c = np.asarray(coords["c"])
        items = int(c.size)
        bn_eff = bk if bn is None else int(bn)
        a_bytes = items * bm * bk * bytes_per_el
        b_bytes = items * bk * bn_eff * bytes_per_el
        n_out = int(np.unique(c).size)
        c_bytes = n_out * bm * bn_eff * bytes_per_el
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return dict(a_bytes=a_bytes, b_bytes=b_bytes, c_bytes=c_bytes,
                total=a_bytes + b_bytes + c_bytes,
                a_fetches=items, b_fetches=items, c_segments=n_out)


def dataflow_estimates(kind: str, *, bm: int, bk: int,
                       n_cols: Optional[int] = None,
                       bn: Optional[int] = None,
                       bytes_per_el: int = 4, **coords) -> dict:
    """Closed-form traffic estimates per dataflow for one block pattern.

    Walks the policy registry and calls each policy's ``cost_hint`` (see
    :class:`repro_torch.core.policies.SchedulePolicy`) — exact
    revisiting-model counts for the static orders that carry one
    (``gustavson``, ``outer``) — then adds the analytic ``"inner"``
    inner-product estimate, which has no registered policy and exists for
    comparison only.  Policies without
    a hint (``segment``: its order *is* the schedule) are skipped; the
    tuner scores those by building the schedule.

    ``coords`` carries the pattern: ``m``/``k`` block coordinates for
    ``kind="spmm"``; ``m``/``n``/``k``/``c``/``a_idx``/``b_idx`` for
    ``kind="spgemm"``.  Returns ``{name: traffic_dict}`` with
    :func:`repro_torch.core.schedule.lane_traffic_spmm`-shaped dicts priced
    at default knobs (one lane, pipelined), so entries are directly comparable
    with each other and with a built plan's recorded traffic."""
    from repro_torch.core.policies import available_policies, get_policy
    tiles = dict(bm=bm, bk=bk, bytes_per_el=bytes_per_el)
    if kind == "spmm":
        tiles["n_cols"] = 1 if n_cols is None else int(n_cols)
    else:
        tiles["bn"] = bk if bn is None else int(bn)
    out = {}
    for name in available_policies():
        hint = get_policy(name).cost_hint
        if hint is None:
            continue
        est = hint(kind, **coords, **tiles)
        if est is not None:
            out[name] = est
    out["inner"] = _inner_product_estimate(
        kind, bm=bm, bk=bk, n_cols=n_cols, bn=bn,
        bytes_per_el=bytes_per_el, **coords)
    return out
