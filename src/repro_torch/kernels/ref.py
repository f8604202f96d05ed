"""Dense oracles in torch (the port of ``repro.kernels.ref``'s block-sparse
matmul part: SpMM, SpGEMM and the dequantization they share).

These are the ground truth of the ``"reference"`` backend: no schedule, no
kernel, just the dense matrix and one fp32 matmul.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def bsr_to_dense(blocks: torch.Tensor, brow: torch.Tensor, bcol: torch.Tensor,
                 grid_m: int, grid_k: int) -> torch.Tensor:
    """Scatter-add BSR blocks ``(nb, bm, bk)`` into a dense
    ``(grid_m*bm, grid_k*bk)`` matrix."""
    nb, bm, bk = blocks.shape
    out = torch.zeros((grid_m, bm, grid_k, bk), dtype=blocks.dtype,
                      device=blocks.device)
    # (grid_m, grid_k, bm, bk) view of the same storage, indexed per block
    out.permute(0, 2, 1, 3).index_put_((brow.long(), bcol.long()), blocks,
                                       accumulate=True)
    return out.reshape(grid_m * bm, grid_k * bk)


def dequant_blocks_ref(blocks: torch.Tensor,
                       scales: Optional[torch.Tensor]) -> torch.Tensor:
    """fp32 blocks from a quantized payload and its scales (``scales=None``:
    the blocks as fp32).  1-D scales are per block, 2-D per block row."""
    blocks = blocks.float()
    if scales is None:
        return blocks
    scales = scales.float()
    if scales.ndim == 2:
        return blocks * scales[:, :, None]
    return blocks * scales[:, None, None]


def spmm_ref(blocks: torch.Tensor, brow: torch.Tensor, bcol: torch.Tensor,
             grid_m: int, grid_k: int, b_dense: torch.Tensor,
             transpose_lhs: bool = False,
             scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``C = BSR(A) @ B`` (or ``BSR(A)ᵀ @ B``) computed densely in fp32.

    ``brow``/``bcol``/``grid_m``/``grid_k`` always describe the *stored* A;
    ``transpose_lhs`` contracts along its rows instead (the backward pass's
    oracle reads the forward storage, as the kernel's transposed mode does).
    ``scales`` dequantize a quantized block payload first.
    """
    a = bsr_to_dense(dequant_blocks_ref(blocks, scales), brow, bcol, grid_m,
                     grid_k)
    if transpose_lhs:
        a = a.T
    return a @ b_dense.float()


def spgemm_ref(a_blocks: torch.Tensor, a_brow: torch.Tensor,
               a_bcol: torch.Tensor, a_grid: Tuple[int, int],
               b_blocks: torch.Tensor, b_brow: torch.Tensor,
               b_bcol: torch.Tensor, b_grid: Tuple[int, int],
               c_brow: torch.Tensor, c_bcol: torch.Tensor,
               a_scales: Optional[torch.Tensor] = None,
               b_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``(n_c_blocks, bm, bn)`` C blocks of BSR(A) @ BSR(B) at the
    symbolic pattern ``(c_brow, c_bcol)``: both operands densified
    (dequantized first), one fp32 matmul, the C tiles gathered."""
    gm, gk = a_grid
    gk2, gn = b_grid
    bm = a_blocks.shape[1]
    bn = b_blocks.shape[2]
    a = bsr_to_dense(dequant_blocks_ref(a_blocks, a_scales), a_brow, a_bcol,
                     gm, gk)
    b = bsr_to_dense(dequant_blocks_ref(b_blocks, b_scales), b_brow, b_bcol,
                     gk2, gn)
    c = (a @ b).reshape(gm, bm, gn, bn)
    return c[c_brow.long(), :, c_bcol.long(), :]
