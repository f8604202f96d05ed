"""Frozen work of one block-sparse product ``C = W @ B`` (or ``Wᵀ @ B``),
whatever path the program runs it on.

``W`` is ``(d_out, d_in)`` with ``nnz`` stored ``bs × bs`` blocks.  The
operations are ``2 · nnz · bs² · n``; the bytes count the stored blocks, B
and C once each, at the widths the configuration states (fp32 weights,
bf16 activations).  The least time is the larger of the operations at the
bf16 peak and the bytes at the memory peak (:mod:`perfbench.counts.peaks`).
"""
from __future__ import annotations

from typing import Tuple

from perfbench.counts.peaks import H100
from perfbench.inputs import FFN_PROJ, Arch, ffn_nnz, ffn_shapes


def call(nnz: int, bs: int, d_out: int, d_in: int, n: int, *,
         transposed: bool = False, a_bytes: int = 4, b_bytes: int = 2,
         c_bytes: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one call over ``n`` columns."""
    k, m = (d_out, d_in) if transposed else (d_in, d_out)
    ops = 2.0 * nnz * bs * bs * n
    moved = nnz * bs * bs * a_bytes + k * n * b_bytes + m * n * c_bytes
    return ops, float(moved)


def least_seconds(ops: float, moved: float, peak=H100) -> float:
    return max(ops / peak["bf16_flops"], moved / peak["hbm_bytes_per_s"])


def ffn_least_seconds(a: Arch, n: int, dx: bool = False) -> float:
    """Least time of one pass of every layer's block-sparse FFN over ``n``
    columns: each projection's forward call, and with ``dx`` its
    ``transpose_lhs`` call too."""
    one = 0.0
    for proj in FFN_PROJ:
        d_out, d_in = ffn_shapes(a)[proj]
        for transposed in ((False, True) if dx else (False,)):
            one += least_seconds(*call(ffn_nnz(a, proj), a.ffn_block, d_out,
                                       d_in, n, transposed=transposed))
    return a.n_layers * one
