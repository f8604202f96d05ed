"""Dense oracles in torch (the port of ``repro.kernels.ref``: SpMM, SpGEMM
and the dequantization they share, the grouped MoE GEMM, attention, the
RG-LRU recurrence and RWKV-6's time mix).

The matmul oracles are the ground truth of the ``"reference"`` backend: no
schedule, no kernel, just the dense matrix and one fp32 matmul.  Attention,
the MoE GEMM and the RG-LRU are what :mod:`repro_torch.kernels.ops`'s entry
points are held against; :func:`rwkv6_ref` is the recurrence RWKV-6's
time mix runs (no kernel exists for it in either package).
"""
from __future__ import annotations

import math
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


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor, chunk_expert: torch.Tensor,
                 chunk_rows: int) -> torch.Tensor:
    """Grouped GEMM: rows of x are chunked; chunk c uses expert weight
    ``w[chunk_expert[c]]``.  x: (C*rows, d_in), w: (E, d_in, d_out)."""
    out = torch.empty((x.shape[0], w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    # one chunk at a time: only one expert's weights are ever cast to fp32
    for c, e in enumerate(chunk_expert.tolist()):
        rows = slice(c * chunk_rows, (c + 1) * chunk_rows)
        out[rows] = x[rows].float() @ w[e].float()
    return out


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: Optional[int] = None,
            scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention oracle, fp32 out.

    q: (B, Tq, H, D); k/v: (B, Tk, Hkv, D) with H % Hkv == 0 (GQA).
    ``window`` masks keys further than `window` positions behind the query
    (local attention).  Query positions are the last Tq positions of the
    Tk-long context.
    """
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    k_pos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    logits = torch.where(mask[None, None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float())


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``log(1 + e^x)`` as ``logaddexp(x, 0)``, with no
    cut-off where it turns into x (torch's ``softplus`` has one at 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def rg_lru_ref(x: torch.Tensor, a_gate: torch.Tensor, x_gate: torch.Tensor,
               a_param: torch.Tensor, h0: Optional[torch.Tensor] = None,
               c: float = 8.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU oracle:  h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

    a_t = exp(-c · softplus(a_param) ⊙ σ(a_gate_t)),  i_t = σ(x_gate_t).
    x, a_gate, x_gate: (B, T, D); a_param: (D,).  Returns (out, h_T), both
    fp32 (the gate math runs in the inputs' dtype, as ``repro``'s does).
    """
    log_a = -c * softplus(a_param)[None, None, :] * torch.sigmoid(a_gate)
    a = torch.exp(log_a.float())
    gated_x = (torch.sigmoid(x_gate) * x).float()
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    xb = beta * gated_x
    h = (torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    hs = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + xb[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 (Finch) time-mix oracle, a torch loop over T in fp32.

    r, k, v: (B, T, H, D); w: (B, T, H, D) data-dependent log-decay (< 0);
    u: (H, D) bonus; state0: (B, H, D, D) (zeros when ``None``).
    ``out_t = r_t · (S + u ⊙ (k_tᵀ v_t))``, ``S ← diag(e^{w_t}) S +
    k_tᵀ v_t``.  Returns ``(out (B, T, H, D), S_T)``, both fp32.
    """
    b, t, h, d = r.shape
    s = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    rf, kf, vf = r.float(), k.float(), v.float()
    decay = torch.exp(w.float())
    bonus = u.float()[None, :, :, None]
    outs = []
    for i in range(t):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]       # (B, H, D, D)
        outs.append(torch.einsum("bhi,bhij->bhj", rf[:, i], s + bonus * kv))
        s = decay[:, i, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s
