"""Sparse containers and quantized block storage of the port.

The element-granularity formats (``CSR``, ``DCSR``, ``CSC``) carry the
paper's dataflows and the SegFold simulator; ``BSR`` is the block format
the kernels run on.  Schedules are built on the host from the sparsity
pattern, so all four stay numpy (copies of ``repro.core.formats``); the
planner uploads the block values to the device.  Quantized
blocks (:class:`QuantizedBlocks`) are torch tensors: an ``int8`` or
``float8_e4m3fn`` payload beside fp32 scales, made by the same sequence of
fp32 operations as ``repro.core.formats.quantize_blocks``, so the payload
bits and the scales equal ``repro``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Element-granularity formats (simulator + reference dataflows)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CSR:
    """Compressed sparse row. ``indptr`` has length ``M+1``."""

    shape: Tuple[int, int]
    indptr: np.ndarray   # int64 (M+1,)
    indices: np.ndarray  # int32 (nnz,) column ids, sorted within a row
    data: np.ndarray     # float32 (nnz,)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def density(self) -> float:
        m, n = self.shape
        return self.nnz / float(max(m * n, 1))

    def row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = int(self.indptr[i]), int(self.indptr[i + 1])
        return self.indices[lo:hi], self.data[lo:hi]

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def to_dense(self) -> np.ndarray:
        m, n = self.shape
        out = np.zeros((m, n), dtype=self.data.dtype)
        rows = np.repeat(np.arange(m), self.row_lengths())
        out[rows, self.indices] = self.data
        return out

    def transpose(self) -> "CSR":
        return csr_from_coo(
            self.shape[::-1],
            self.indices,
            np.repeat(np.arange(self.shape[0]), self.row_lengths()),
            self.data,
        )

    @staticmethod
    def from_dense(a: np.ndarray) -> "CSR":
        m, n = a.shape
        rows, cols = np.nonzero(a)
        return csr_from_coo((m, n), rows, cols, a[rows, cols])


def csr_from_coo(shape, rows, cols, vals) -> CSR:
    """Build a CSR with rows ascending and columns sorted within each row;
    duplicate coordinates are summed (in float64, then cast back)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if rows.size:
        key = rows * shape[1] + cols
        uniq, inv = np.unique(key, return_inverse=True)
        if uniq.size != key.size:
            merged = np.zeros(uniq.size, dtype=np.float64)
            np.add.at(merged, inv, vals.astype(np.float64))
            rows = (uniq // shape[1]).astype(np.int64)
            cols = (uniq % shape[1]).astype(np.int64)
            vals = merged.astype(vals.dtype)
    indptr = np.zeros(shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(
        shape=tuple(shape),
        indptr=indptr.astype(np.int64),
        indices=cols.astype(np.int32),
        data=vals.astype(np.float32),
    )


@dataclasses.dataclass
class DCSR:
    """Doubly compressed sparse rows: only non-empty rows are materialized.

    ``row_ids[i]`` is the Cartesian row index of compressed row ``i``;
    ``indptr`` has length ``len(row_ids)+1``.  The paper stores ``B`` this
    way so that the scheduler skips empty rows in O(1) (§IV-B).
    """

    shape: Tuple[int, int]
    row_ids: np.ndarray  # int32 (nrows_nonempty,)
    indptr: np.ndarray   # int64 (nrows_nonempty+1,)
    indices: np.ndarray  # int32 (nnz,)
    data: np.ndarray     # float32 (nnz,)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @staticmethod
    def from_csr(a: CSR) -> "DCSR":
        lengths = a.row_lengths()
        nonempty = np.nonzero(lengths > 0)[0]
        indptr = np.concatenate([[0], np.cumsum(lengths[nonempty])])
        chunks_idx = []
        chunks_val = []
        for r in nonempty:
            lo, hi = a.indptr[r], a.indptr[r + 1]
            chunks_idx.append(a.indices[lo:hi])
            chunks_val.append(a.data[lo:hi])
        indices = (np.concatenate(chunks_idx) if chunks_idx
                   else np.zeros(0, np.int32))
        data = (np.concatenate(chunks_val) if chunks_val
                else np.zeros(0, np.float32))
        return DCSR(
            shape=a.shape,
            row_ids=nonempty.astype(np.int32),
            indptr=indptr.astype(np.int64),
            indices=indices.astype(np.int32),
            data=data.astype(np.float32),
        )

    def lookup(self, r: int) -> int:
        """Compressed index of Cartesian row ``r`` or -1 (O(log nrows))."""
        pos = np.searchsorted(self.row_ids, r)
        if pos < self.row_ids.size and self.row_ids[pos] == r:
            return int(pos)
        return -1


@dataclasses.dataclass
class CSC:
    """Compressed sparse column (A's storage; SELECTA scans columns of A)."""

    shape: Tuple[int, int]
    indptr: np.ndarray   # (K+1,) column pointers
    indices: np.ndarray  # (nnz,) row ids, sorted within a column
    data: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def col(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = int(self.indptr[k]), int(self.indptr[k + 1])
        return self.indices[lo:hi], self.data[lo:hi]

    def col_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    @staticmethod
    def from_csr(a: CSR) -> "CSC":
        t = a.transpose()  # CSR of A^T == CSC of A
        return CSC(shape=a.shape, indptr=t.indptr, indices=t.indices,
                   data=t.data)

    def to_dense(self) -> np.ndarray:
        m, k = self.shape
        out = np.zeros((m, k), dtype=self.data.dtype)
        cols = np.repeat(np.arange(k), self.col_lengths())
        out[self.indices, cols] = self.data
        return out


def random_csr(rng: np.random.Generator, shape, density: float) -> CSR:
    """Uniform random sparse matrix (iid Bernoulli pattern)."""
    m, n = shape
    nnz = max(1, int(round(density * m * n)))
    flat = rng.choice(m * n, size=min(nnz, m * n), replace=False)
    rows, cols = flat // n, flat % n
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return csr_from_coo((m, n), rows, cols, vals)


def spgemm_reference(a: CSR, b: CSR) -> CSR:
    """Ground-truth C = A @ B via dense numpy (for tests and small sims)."""
    c = a.to_dense() @ b.to_dense()
    return CSR.from_dense(c)


# ---------------------------------------------------------------------------
# Block-granularity format (the kernels)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BSR:
    """Block-sparse rows: nonzero dense tiles of shape ``(bm, bk)``.

    ``blocks[i]`` is the dense tile for the i-th stored block; block
    coordinates are ``(brow[i], bcol[i])`` in block units.  Blocks are sorted
    row-major ``(brow, bcol)``.
    """

    shape: Tuple[int, int]          # logical (M, K)
    block_shape: Tuple[int, int]    # (bm, bk)
    brow: np.ndarray                # int32 (nblocks,)
    bcol: np.ndarray                # int32 (nblocks,)
    blocks: np.ndarray              # float32 (nblocks, bm, bk)

    @property
    def nblocks(self) -> int:
        return int(self.brow.shape[0])

    @property
    def grid(self) -> Tuple[int, int]:
        bm, bk = self.block_shape
        return (self.shape[0] + bm - 1) // bm, (self.shape[1] + bk - 1) // bk

    @property
    def block_density(self) -> float:
        """Stored blocks over grid cells."""
        gm, gk = self.grid
        return self.nblocks / float(max(gm * gk, 1))

    def block_mask(self) -> np.ndarray:
        """``(grid_m, grid_k)`` bool: True where a block is stored."""
        gm, gk = self.grid
        m = np.zeros((gm, gk), dtype=bool)
        m[self.brow, self.bcol] = True
        return m

    def to_dense(self) -> np.ndarray:
        bm, bk = self.block_shape
        gm, gk = self.grid
        out = np.zeros((gm, bm, gk, bk), dtype=self.blocks.dtype)
        out[self.brow, :, self.bcol, :] = self.blocks
        return out.reshape(gm * bm, gk * bk)[: self.shape[0], : self.shape[1]]

    @staticmethod
    def from_dense(a: np.ndarray, block_shape: Tuple[int, int],
                   keep_threshold: float = 0.0) -> "BSR":
        """Tile a dense matrix (zero-padded to whole blocks) and keep the
        blocks whose max-abs exceeds ``keep_threshold``, row-major."""
        m, k = a.shape
        bm, bk = block_shape
        gm, gk = (m + bm - 1) // bm, (k + bk - 1) // bk
        pad = np.zeros((gm * bm, gk * bk), dtype=np.float32)
        pad[:m, :k] = a
        tiles = pad.reshape(gm, bm, gk, bk).transpose(0, 2, 1, 3)
        mask = np.abs(tiles).max(axis=(2, 3)) > keep_threshold
        brow, bcol = np.nonzero(mask)
        order = np.lexsort((bcol, brow))
        brow, bcol = brow[order], bcol[order]
        return BSR(
            shape=(m, k),
            block_shape=(bm, bk),
            brow=brow.astype(np.int32),
            bcol=bcol.astype(np.int32),
            blocks=tiles[brow, bcol].astype(np.float32),
        )

    @staticmethod
    def random(key: np.random.Generator, shape, block_shape,
               block_density: float, dtype=np.float32) -> "BSR":
        """Random pattern and values; draws exactly what
        ``repro.core.formats.BSR.random`` draws, so one seed gives one
        matrix in both packages."""
        m, k = shape
        bm, bk = block_shape
        gm, gk = (m + bm - 1) // bm, (k + bk - 1) // bk
        mask = key.random((gm, gk)) < block_density
        if not mask.any():  # ensure at least one block
            mask[key.integers(gm), key.integers(gk)] = True
        brow, bcol = np.nonzero(mask)
        blocks = key.standard_normal((brow.size, bm, bk)).astype(dtype)
        return BSR(shape=(m, k), block_shape=(bm, bk),
                   brow=brow.astype(np.int32), bcol=bcol.astype(np.int32),
                   blocks=blocks)

    def row_major_order(self) -> "BSR":
        order = np.lexsort((self.bcol, self.brow))
        return BSR(self.shape, self.block_shape, self.brow[order],
                   self.bcol[order], self.blocks[order])

    def col_major_order(self) -> "BSR":
        order = np.lexsort((self.brow, self.bcol))
        return BSR(self.shape, self.block_shape, self.brow[order],
                   self.bcol[order], self.blocks[order])


# ---------------------------------------------------------------------------
# Quantized block storage (int8 / fp8-e4m3 payloads + fp32 scales)
# ---------------------------------------------------------------------------

#: Payload dtype of each quantized base type (fp8 is e4m3fn: max 448).
QUANT_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}

#: Largest magnitude of each payload dtype: a scale group's absmax maps here.
QUANT_MAX = {"int8": 127.0, "fp8": 448.0}

#: A mode is a bare payload dtype (one fp32 scale per block) or
#: ``"<dtype>.rowwise"`` (one fp32 scale per row of each block).
ROWWISE_SUFFIX = ".rowwise"

#: Every accepted quantization mode string.
QUANT_MODES = tuple(QUANT_DTYPES) + tuple(
    d + ROWWISE_SUFFIX for d in QUANT_DTYPES)


def dtype_name(dtype) -> Optional[str]:
    """A torch or numpy dtype by the name numpy prints for it (``"int8"``,
    ``"float8_e4m3fn"``, ``"float32"``); ``None`` passes through."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def quant_base_dtype(mode: str) -> str:
    """Payload dtype name of a mode (``"int8.rowwise"`` → ``"int8"``);
    ``"fp32"`` passes through."""
    return mode.split(".", 1)[0]


def quant_is_rowwise(mode: str) -> bool:
    """True when ``mode`` carries one scale per row of each block."""
    return mode.endswith(ROWWISE_SUFFIX)


def _check_quant_dtype(dtype: str) -> str:
    if quant_base_dtype(dtype) not in QUANT_DTYPES or (
            "." in dtype and not quant_is_rowwise(dtype)):
        raise ValueError(f"unknown quantized block dtype {dtype!r}; "
                         f"available: {QUANT_MODES}")
    return dtype


@dataclasses.dataclass
class QuantizedBlocks:
    """Quantized BSR block values: a payload beside fp32 scales.

    ``payload`` is ``(nblocks, bm, bk)`` ``torch.int8`` or
    ``torch.float8_e4m3fn``; ``scales`` is ``(nblocks,)`` fp32 per block,
    or ``(nblocks, bm)`` per block row in a ``.rowwise`` mode.  Block order
    is the carrier BSR's storage order (quantization never reorders).
    """

    payload: torch.Tensor
    scales: torch.Tensor
    dtype: str            # quantization mode (one of QUANT_MODES)

    @property
    def nblocks(self) -> int:
        return int(self.payload.shape[0])

    @property
    def block_shape(self) -> Tuple[int, int]:
        return tuple(self.payload.shape[1:])

    @property
    def nbytes(self) -> int:
        """Storage bytes: payload plus scales."""
        return int(self.payload.numel() * self.payload.element_size()
                   + self.scales.numel() * self.scales.element_size())


def quantize_blocks(blocks: Union[np.ndarray, torch.Tensor],
                    dtype: str = "int8") -> QuantizedBlocks:
    """Absmax quantization of a ``(nblocks, bm, bk)`` tile array, on the
    device the blocks lie on (numpy arrays on the CPU).

    The operations and their order are ``repro``'s, all in fp32: the
    absmax of each block (or block row), ``scale = absmax / QUANT_MAX``
    (``1.0`` for an all-zero group), ``blocks / scale``, then round half to
    even and clip to ±127 for int8, or the round-to-nearest-even cast for
    fp8.  So payload bits and scales equal ``repro``'s on the same input.
    """
    _check_quant_dtype(dtype)
    base = quant_base_dtype(dtype)
    blocks = torch.as_tensor(blocks).float()
    if blocks.ndim != 3:
        raise ValueError(f"blocks must be (nblocks, bm, bk), got shape "
                         f"{tuple(blocks.shape)}")
    if quant_is_rowwise(dtype):
        amax = blocks.abs().amax(dim=2)                   # (nblocks, bm)
        scales = torch.where(amax > 0, amax / QUANT_MAX[base], 1.0)
        scaled = blocks / scales[:, :, None]
    else:
        amax = blocks.abs().amax(dim=(1, 2))              # (nblocks,)
        scales = torch.where(amax > 0, amax / QUANT_MAX[base], 1.0)
        scaled = blocks / scales[:, None, None]
    if base == "int8":
        payload = torch.clamp(torch.round(scaled), -127.0, 127.0).to(
            torch.int8)
    else:
        payload = scaled.to(QUANT_DTYPES[base])           # RTNE cast
    return QuantizedBlocks(payload=payload, scales=scales.float(),
                           dtype=dtype)


def dequantize_blocks(q: QuantizedBlocks) -> torch.Tensor:
    """fp32 reconstruction of quantized blocks."""
    payload = q.payload.float()
    scales = q.scales.float()
    if scales.ndim == 2:                                  # rowwise
        return payload * scales[:, :, None]
    return payload * scales[:, None, None]


def quant_error_bound(dtype: str) -> float:
    """Per-element round-trip bound as a fraction of the scale group's
    absmax: ``1/254`` for int8 (half a step), ``1/16`` for fp8-e4m3 (3
    mantissa bits); the same fraction of the row absmax in rowwise modes."""
    _check_quant_dtype(dtype)
    return {"int8": 1.0 / 254.0, "fp8": 1.0 / 16.0}[quant_base_dtype(dtype)]
