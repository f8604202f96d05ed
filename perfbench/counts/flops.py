"""Frozen FLOP counts of a model's work: the arithmetic of
``repro_torch.roofline.model_flops``, copied so that it cannot move with
the program.

Useful work a token is ``2 · N_active`` (every matrix product's weights:
attention, the FFN at its stored blocks, the top-k experts and the router,
the head; the input embedding's lookup is no product) plus, per attention
layer, ``4 · ctx · H · hd`` for QKᵀ and P·V over the ``ctx`` keys it
attends to.  A training step counts three times its forward (the
rematerialised forward is not counted).
"""
from __future__ import annotations

from perfbench.inputs import FFN_PROJ, Arch, ffn_nnz


def active_params(a: Arch) -> int:
    """Weights a token multiplies by."""
    d, hd = a.d_model, a.head_dim
    attn = d * a.n_heads * hd * 2 + d * a.n_kv * hd * 2
    if a.family == "moe":
        ffn = a.top_k * 3 * d * a.d_ff + d * a.n_experts
    elif a.ffn_block_sparse:
        ffn = sum(ffn_nnz(a, p) for p in FFN_PROJ) * a.ffn_block ** 2
    else:
        ffn = 3 * d * a.d_ff
    return a.n_layers * (attn + ffn) + a.vocab * d


def forward_flops(a: Arch, tokens: int, ctx_sum: float) -> float:
    """Forward FLOPs of ``tokens`` tokens whose attention spans add up to
    ``ctx_sum`` keys (a token at position p of a causal sequence attends
    to p + 1)."""
    return 2.0 * active_params(a) * tokens + 4.0 * ctx_sum * a.n_heads \
        * a.head_dim * a.n_layers


def causal_ctx(start: int, n: int) -> float:
    """The keys that ``n`` tokens at positions ``start .. start+n-1``
    attend to, summed."""
    return n * start + n * (n + 1) / 2


def train_step_flops(a: Arch, batch: int, seq: int) -> float:
    """``model_flops`` of a training step over ``batch`` causal rows of
    ``seq`` tokens: three times the forward."""
    return 3.0 * forward_flops(a, batch * seq, batch * causal_ctx(0, seq))
