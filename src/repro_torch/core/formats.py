"""Block-sparse container and quantized block storage of the port.

Schedules are built on the host from the sparsity pattern, so ``BSR`` stays
numpy; the planner uploads the block values to the device.  Quantized
blocks (:class:`QuantizedBlocks`) are torch tensors: an ``int8`` or
``float8_e4m3fn`` payload beside fp32 scales, made by the same sequence of
fp32 operations as ``repro.core.formats.quantize_blocks``, so the payload
bits and the scales equal ``repro``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch


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
