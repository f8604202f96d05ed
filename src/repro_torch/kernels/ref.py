"""Dense oracles in torch (the port of ``repro.kernels.ref``'s SpMM part).

These are the ground truth of the ``"reference"`` backend: no schedule, no
kernel, just the dense matrix and one fp32 matmul.
"""
from __future__ import annotations

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


def spmm_ref(blocks: torch.Tensor, brow: torch.Tensor, bcol: torch.Tensor,
             grid_m: int, grid_k: int, b_dense: torch.Tensor,
             transpose_lhs: bool = False) -> torch.Tensor:
    """``C = BSR(A) @ B`` (or ``BSR(A)ᵀ @ B``) computed densely in fp32.

    ``brow``/``bcol``/``grid_m``/``grid_k`` always describe the *stored* A;
    ``transpose_lhs`` contracts along its rows instead (the backward pass's
    oracle reads the forward storage, as the kernel's transposed mode does).
    """
    a = bsr_to_dense(blocks.float(), brow, bcol, grid_m, grid_k)
    if transpose_lhs:
        a = a.T
    return a @ b_dense.float()
