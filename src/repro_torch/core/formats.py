"""Block-sparse container of the port (host-side numpy, as in ``repro``).

Schedules are built on the host from the sparsity pattern, so ``BSR`` stays
numpy; the planner uploads the block values to the device.  The quantized
block storage of ``repro.core.formats`` is not ported yet (see ROADMAP).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


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
