"""The schedule search's cost model, and the work a schedule gives the card.

:class:`CostModel` and :func:`calibrate` are ``repro.tune.cost``'s, as they
are: a two-term roofline, ``cost_us = bytes / bytes_per_us + steps ·
step_us``, and its least-squares fit.  Neither knows any hardware.

What the port adds is what the two terms count on an H100.  ``repro``
counts the TPU kernel's grid steps and its revisiting-model HBM traffic;
the CUDA kernels run another schedule: one thread block per (N tile,
owner run) — per (N tile, chunk of a run) on the folded ``"split"`` path,
per pipeline of an owner run on the SpGEMM tensor-core path — and every
item of a run reads its A tile and B slice into the SM.  So the card's
work (:func:`spmm_card_work`, :func:`spgemm_card_work`) is:

* **bytes**: what the SMs read and write, N tile by N tile: every valid
  item's A tile (payload and scales) and its B slice, and the C tile at
  each segment write (plus a read at each ``accum_prev``); on ``"split"``,
  which sums a run's valid items whatever the flags say, each chunk's
  fp32 partial written and read once and each run's C once;
* **steps**: the critical path in items, the larger of the longest block's
  items (a run, or a chunk; pads count, the block walks them) and all the
  blocks' items spread over the blocks the card holds at once (132 SMs ×
  the blocks one SM keeps resident).  On the CUDA-core paths (``"split"``,
  ``"simt"``) an item's work per thread grows with the N tile, so a step
  there is an item at 4 columns: the items times ``tile / 4``.

The knobs the card ignores then price equal: ``pipeline`` and ``prefetch``
(TPU DMA timing), and ``bn`` outside the CUDA-core SpMM kernel's tile.
``policy`` and ``fold_len`` change the item order and the segments; lanes
cut runs only at lane starts and, like ``unroll``, add pads.

Each path has its own fitted model, :data:`DEFAULT_CUDA`, chosen by the
path the call takes at the search's N hint.  No TPU coefficient is a
default here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis import budget

#: H100 SXM: streaming multiprocessors, each with this much shared memory
#: for its resident blocks (228 KiB; 1 KiB of it reserved per block)
SMS = 132
SM_SMEM_BYTES = 233472
MAX_THREADS_PER_SM = 2048


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Two-coefficient roofline cost model (see ``repro.tune.cost``)."""

    bytes_per_us: float          # effective bandwidth, bytes / microsecond
    step_us: float               # per-step overhead, microseconds
    lane_parallel: bool = True   # False: lanes execute sequentially
    legacy_factor: float = 1.0   # cost multiplier for pipeline=False plans
    prefetch_step_credit: float = 0.0

    def steps(self, *, n_lanes: int, lane_len: int, unroll: int,
              n_tiles_n: int = 1) -> float:
        """Grid steps one kernel launch executes for this schedule shape
        (``repro``'s TPU grid: ``lane_len / unroll`` a lane and N tile)."""
        per_lane = (lane_len / max(1, unroll)) * max(1, n_tiles_n)
        return per_lane * (n_lanes if not self.lane_parallel else 1)

    def cost_us(self, *, traffic_bytes: float, n_lanes: int, lane_len: int,
                unroll: int, n_tiles_n: int = 1,
                pipelined: bool = True, prefetch: bool = False) -> float:
        base = (traffic_bytes / self.bytes_per_us
                + self.steps(n_lanes=n_lanes, lane_len=lane_len,
                             unroll=unroll, n_tiles_n=n_tiles_n)
                * self.step_us)
        if prefetch and pipelined and n_tiles_n > 1:
            base -= (n_tiles_n - 1) * self.step_us * self.prefetch_step_credit
        return base if pipelined else base * self.legacy_factor

    def predict_us(self, nbytes: float, steps: float) -> float:
        """The roofline at given bytes and steps (the card's work)."""
        return nbytes / self.bytes_per_us + steps * self.step_us


def calibrate(samples: Iterable[Tuple[float, float, float]],
              lane_parallel: bool = False) -> CostModel:
    """Fit ``(bytes_per_us, step_us)`` from measured ``(bytes, steps, us)``
    triples by non-negative least squares on ``us ≈ bytes/bw + steps·c``
    (``repro.tune.calibrate``: the 2×2 normal equations, each coefficient
    clamped at a small positive floor; a rank-deficient set attributes
    everything to whichever axis varies)."""
    rows: Sequence[Tuple[float, float, float]] = [
        (float(b), float(s), float(t)) for b, s, t in samples]
    if not rows:
        raise ValueError("calibrate() needs at least one (bytes, steps, us) "
                         "sample")
    sbb = sum(b * b for b, _, _ in rows)
    sss = sum(s * s for _, s, _ in rows)
    sbs = sum(b * s for b, s, _ in rows)
    sbt = sum(b * t for b, _, t in rows)
    sst = sum(s * t for _, s, t in rows)
    det = sbb * sss - sbs * sbs
    if abs(det) > 1e-12 * max(1.0, sbb) * max(1.0, sss):
        inv_bw = (sbt * sss - sst * sbs) / det
        c = (sst * sbb - sbt * sbs) / det
    else:
        inv_bw = sbt / sbb if sbb > 0 else 0.0
        c = sst / sss if sss > 0 else 0.0
    inv_bw = max(inv_bw, 1e-12)
    c = max(c, 1e-9)
    return CostModel(bytes_per_us=1.0 / inv_bw, step_us=c,
                     lane_parallel=lane_parallel)


#: One model per CUDA path, fitted by ``python3 chip_smoke.py --only tune``
#: on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit: CUDA-graph device
#: times of every policy × fold of granite-3-8b's FFN projections (up and
#: down, 64×64 blocks at 25 %) on the SpMM paths — ``"split"`` at N = 4 and
#: 16, ``"tc"`` at 64 and 2048 (bf16 B), ``"simt"`` at 64 (fp32 B) — and
#: of the paper's suite, A @ Aᵀ at 64×64 blocks, on both SpGEMM paths;
#: ``calibrate`` over each sample scaled by its own time (relative least
#: squares).  Worst / mean residual: split 2.1 / 0.9 %, tc 29.6 / 13.1 %,
#: simt 24.5 / 11.5 %, spgemm_tc 33.4 / 10.5 %, spgemm_simt 25.4 / 11.1 %.
DEFAULT_CUDA: Dict[str, CostModel] = {
    "split": CostModel(bytes_per_us=2.69635e+06, step_us=0.761959),
    "tc": CostModel(bytes_per_us=5.43293e+06, step_us=0.780255),
    "simt": CostModel(bytes_per_us=1.7048e+06, step_us=0.13079),
    "spgemm_tc": CostModel(bytes_per_us=1.11508e+07, step_us=2.45835),
    "spgemm_simt": CostModel(bytes_per_us=3.38168e+06, step_us=2.62665),
}


# ---------------------------------------------------------------------------
# the card's work of one schedule
# ---------------------------------------------------------------------------


def _resident(smem: int, threads: int) -> int:
    """Blocks one SM keeps resident, by shared memory and threads."""
    return max(1, min(SM_SMEM_BYTES // (smem + 1024),
                      MAX_THREADS_PER_SM // threads))


def _critical_path(lengths: np.ndarray, n_tiles: int, slots: int) -> float:
    """Items on the longest chain: the longest block's, or all blocks'
    items over the blocks the card runs at once."""
    if lengths.size == 0:
        return 0.0
    return float(max(int(lengths.max()),
                     -(-int(lengths.sum()) * n_tiles // slots)))


def _payload_bytes(block_dtype: str, rows: int, cols: int) -> int:
    """A stored tile's bytes, scales included: fp32 values, or a 1-byte
    payload with one fp32 scale (``"int8"``/``"fp8"``) or one a row
    (``".rowwise"``)."""
    if block_dtype == "fp32":
        return rows * cols * 4
    return rows * cols + 4 * (rows if block_dtype.endswith(".rowwise")
                              else 1)


def spmm_path(bm: int, bk: int, n: int, rhs_dtype: Optional[str]) -> str:
    """The path ``segment_spmm.choose_path`` takes at width ``n`` for a B of
    ``rhs_dtype`` laid out as the models lay it (a contiguous (K, N)
    tensor or its transpose, which TMA can read); ``None`` means bf16,
    the models' activations."""
    return budget.spmm_paths(bm, bk, n, rhs_dtype or "bfloat16")[0]


def spmm_card_work(*, path: str, m: np.ndarray, valid: np.ndarray,
                   seg_write: np.ndarray, accum_prev: np.ndarray,
                   runs: np.ndarray, bm: int, bk: int, n: int, bn: int = 512,
                   block_dtype: str = "fp32",
                   rhs_dtype: Optional[str] = None,
                   transpose_lhs: bool = False) -> Dict[str, float]:
    """The card's work of one SpMM launch on ``path`` at width ``n``, from a
    lane-major schedule (``m`` owners, the flags, ``runs`` its owner-run
    offsets): ``a_bytes``, ``b_bytes``, ``c_bytes``, ``total`` (bytes into
    and out of the SMs), ``steps`` (the critical path in items) and
    ``n_tiles``."""
    from repro_torch.kernels.segment_spmm import chunk_offsets
    valid = np.asarray(valid).reshape(-1).astype(bool)
    b_item = 4 if rhs_dtype == "float32" else 2
    rows, contract = (bk, bm) if transpose_lhs else (bm, bk)
    payload, scale = budget.plan_mode(block_dtype)
    if path == "tc":
        tile = 128 * budget.tc_spmm_warpgroups(n)
        smem = budget.tc_spmm_smem_bytes(n, payload, scale)
        threads = 128 * (1 + budget.tc_spmm_warpgroups(n))
    elif path == "split":
        tile = budget.split_tile_n(n)
        smem = budget.split_spmm_smem_bytes(tile, payload, scale)
        threads = 256
    else:
        tile = budget.simt_tile_n(n, bn)
        smem = budget.simt_spmm_smem_bytes(bm, tile, transpose_lhs, payload,
                                           scale, bk=bk)
        threads = 4 * bm
    n_tiles = -(-int(n) // tile)
    n_valid = int(valid.sum())
    a_bytes = n_tiles * n_valid * _payload_bytes(block_dtype, bm, bk)
    b_bytes = n_tiles * n_valid * contract * tile * b_item
    c_tile = rows * tile * 4
    runs = np.asarray(runs, np.int64).reshape(-1)
    if path == "split":
        chunks = chunk_offsets(runs)
        lengths = (chunks[:, 1] - chunks[:, 0]).astype(np.int64)
        c_bytes = n_tiles * c_tile * (2 * lengths.size + runs.size - 1)
    else:
        lengths = np.diff(runs)
        writes = int((np.asarray(seg_write).reshape(-1).astype(bool)
                      & valid).sum())
        reads = int((np.asarray(accum_prev).reshape(-1).astype(bool)
                     & valid).sum())
        c_bytes = n_tiles * c_tile * (writes + reads)
    slots = SMS * _resident(smem, threads)
    steps = _critical_path(lengths, n_tiles, slots)
    if path != "tc":
        steps *= tile / 4
    return dict(a_bytes=float(a_bytes), b_bytes=float(b_bytes),
                c_bytes=float(c_bytes),
                total=float(a_bytes + b_bytes + c_bytes),
                steps=steps, n_tiles=float(n_tiles))


def spgemm_card_work(*, valid: np.ndarray, seg_write: np.ndarray,
                     accum_prev: np.ndarray, runs: np.ndarray, bm: int,
                     bk: int, bn: int,
                     block_dtype: str = "fp32") -> Dict[str, float]:
    """The card's work of one SpGEMM launch (the path ``choose_path`` takes
    for these tiles), from a lane-major triple schedule: keys as
    :func:`spmm_card_work`'s (``n_tiles`` is 1)."""
    valid = np.asarray(valid).reshape(-1).astype(bool)
    payload, scale = budget.plan_mode(block_dtype)
    n_valid = int(valid.sum())
    a_bytes = n_valid * _payload_bytes(block_dtype, bm, bk)
    b_bytes = n_valid * _payload_bytes(block_dtype, bk, bn)
    writes = int((np.asarray(seg_write).reshape(-1).astype(bool)
                  & valid).sum())
    reads = int((np.asarray(accum_prev).reshape(-1).astype(bool)
                 & valid).sum())
    c_bytes = bm * bn * 4 * (writes + reads)
    if budget.spgemm_path(bm, bk, bn) == "tc":
        # one block per SM, its pipelines taking runs as they free up
        slots = SMS * budget.tc_spgemm_pipelines(payload, scale)
    else:
        smem = budget.simt_spgemm_smem_bytes(bm, bk, bn, payload, scale)
        slots = SMS * _resident(smem, bm * bn // 16)
    lengths = np.diff(np.asarray(runs, np.int64).reshape(-1))
    return dict(a_bytes=float(a_bytes), b_bytes=float(b_bytes),
                c_bytes=float(c_bytes),
                total=float(a_bytes + b_bytes + c_bytes),
                steps=_critical_path(lengths, 1, slots), n_tiles=1.0)
