"""Reference static SpGEMM dataflows (paper §II): inner / outer / Gustavson
(a copy of ``repro.core.dataflows``).

Functional element-granularity implementations that return C plus *work and
traffic counters* — the quantities whose imbalance the paper's Fig. 1
illustrates.  The cycle/bandwidth timing interpretation of these counters
lives in :mod:`repro_torch.sim.baselines`.

Counter semantics (per dataflow):

* ``mults`` / ``adds``          — arithmetic work (identical across dataflows
                                  up to insert-vs-add bookkeeping).
* ``a_fetch`` / ``b_fetch``     — operand elements fetched assuming the
                                  dataflow's natural stationarity (an operand
                                  held stationary by the loop order is fetched
                                  once; a streamed operand is re-fetched per
                                  use).
* ``c_traffic``                 — partial-sum elements moved to/from the
                                  intermediate store (OP's scatter cost).
* ``iter_work``                 — work per outermost iteration (load-balance
                                  distribution; its variance is the imbalance).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .formats import CSC, CSR


def inner_product(a: CSR, b_csc: CSC) -> Tuple[np.ndarray, Dict]:
    """IP: order M·N·K — dot(A[m,:], B[:,n]) per output; C reuse only."""
    m_dim, k_dim = a.shape
    n_dim = b_csc.shape[1]
    c = np.zeros((m_dim, n_dim), dtype=np.float32)
    mults = adds = 0
    a_fetch = b_fetch = 0
    iter_work = []
    for m in range(m_dim):
        a_cols, a_vals = a.row(m)
        for n in range(n_dim):
            b_rows, b_vals = b_csc.col(n)
            # sorted intersection of a_cols and b_rows
            inter, ia, ib = np.intersect1d(a_cols, b_rows, return_indices=True)
            w = inter.size
            if w:
                c[m, n] = np.dot(a_vals[ia], b_vals[ib])
            mults += w
            adds += max(w - 1, 0)
            # IP streams both vectors to compute the intersection
            a_fetch += a_cols.size
            b_fetch += b_rows.size
            iter_work.append(w)
    stats = dict(mults=mults, adds=adds, a_fetch=a_fetch, b_fetch=b_fetch,
                 c_traffic=0, iter_work=np.asarray(iter_work, dtype=np.int64))
    return c, stats


def outer_product(a_csc: CSC, b: CSR) -> Tuple[np.ndarray, Dict]:
    """OP: order K·M·N — cross product per k; A,B reuse, C scatter traffic."""
    m_dim, k_dim = a_csc.shape
    n_dim = b.shape[1]
    c = np.zeros((m_dim, n_dim), dtype=np.float32)
    touched = np.zeros((m_dim, n_dim), dtype=bool)
    mults = adds = 0
    c_traffic = 0
    iter_work = []
    for k in range(k_dim):
        a_rows, a_vals = a_csc.col(k)
        b_cols, b_vals = b.row(k)
        w = a_rows.size * b_cols.size
        iter_work.append(w)
        if w == 0:
            continue
        partial = np.outer(a_vals, b_vals)
        adds += int(touched[np.ix_(a_rows, b_cols)].sum())
        touched[np.ix_(a_rows, b_cols)] = True
        c[np.ix_(a_rows, b_cols)] += partial
        mults += w
        # every partial product is written to (and later merged from) the
        # intermediate T store: the OP merge-phase traffic
        c_traffic += 2 * w
    stats = dict(mults=mults, adds=adds, a_fetch=a_csc.nnz, b_fetch=b.nnz,
                 c_traffic=c_traffic, iter_work=np.asarray(iter_work, dtype=np.int64))
    return c, stats


def gustavson(a: CSR, b: CSR) -> Tuple[np.ndarray, Dict]:
    """Gust: order M·K·N — row products; A fully reused, B re-fetched per use."""
    m_dim, k_dim = a.shape
    n_dim = b.shape[1]
    c = np.zeros((m_dim, n_dim), dtype=np.float32)
    mults = adds = 0
    b_fetch = 0
    iter_work = []
    for m in range(m_dim):
        a_cols, a_vals = a.row(m)
        acc: Dict[int, float] = {}
        w = 0
        for k, av in zip(a_cols, a_vals):
            b_cols, b_vals = b.row(int(k))
            b_fetch += b_cols.size
            for n, bv in zip(b_cols, b_vals):
                n = int(n)
                w += 1
                if n in acc:
                    acc[n] += av * bv
                    adds += 1
                else:
                    acc[n] = av * bv
        mults += w
        iter_work.append(w)
        for n, v in acc.items():
            c[m, n] = v
    stats = dict(mults=mults, adds=adds, a_fetch=a.nnz, b_fetch=b_fetch,
                 c_traffic=0, iter_work=np.asarray(iter_work, dtype=np.int64))
    return c, stats


DATAFLOWS = {
    "inner": lambda a_csr, b_csr: inner_product(a_csr, CSC.from_csr(b_csr)),
    "outer": lambda a_csr, b_csr: outer_product(CSC.from_csr(a_csr), b_csr),
    "gustavson": gustavson,
}
