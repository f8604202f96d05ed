"""Decoder-only transformer of the dense family (the part of
``repro.models.transformer`` that granite-class models serve with).

GQA attention + SwiGLU or block-sparse Segment FFN; the layers are an
``nn.ModuleList`` instead of a scanned stack.  With ``ffn_block_sparse``
every layer uses one shared pruning pattern (three plans, built once) and
owns its block values, as in ``repro``.  Parameter names follow the JAX
param dict (``embed.table``, ``layers.<i>.attn.wq.w``,
``layers.<i>.mlp.up.blocks``, ...), see :mod:`repro_torch.convert`.

The KV cache is a dict of two ``(n_layers, B, T_max, n_kv, hd)`` tensors;
:meth:`Transformer.decode_step` writes into it in place.

Training: :meth:`Transformer.loss_fn` is ``repro``'s.  With ``cfg.remat``
each block of a forward pass that records gradients is rematerialized
(``torch.utils.checkpoint``, as ``repro`` wraps its layer scan in
``jax.checkpoint``): only block inputs are kept, and the backward pass runs
each block's forward again.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.formats import BSR

from . import layers
from .sparse_ffn import SparseLinear, SparseMLP

#: numpy seed of the shared FFN pattern when none is given
PATTERN_SEED = 17

FfnPatterns = Dict[str, Tuple[np.ndarray, np.ndarray]]


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _shared_sparse_mlp(cfg: ModelConfig, patterns: Optional[FfnPatterns],
                       device) -> SparseMLP:
    """The shared plans: random from :data:`PATTERN_SEED`, or built over
    given ``{proj: (brow, bcol)}`` patterns."""
    if patterns is None:
        return SparseMLP.create(PATTERN_SEED, cfg.d_model, cfg.d_ff,
                                block=cfg.ffn_block, density=cfg.ffn_density,
                                device=device)
    b = cfg.ffn_block
    shapes = {"up": (cfg.d_ff, cfg.d_model), "gate": (cfg.d_ff, cfg.d_model),
              "down": (cfg.d_model, cfg.d_ff)}
    lin = {}
    for proj, shape in shapes.items():
        brow, bcol = (np.asarray(v, np.int32) for v in patterns[proj])
        w = BSR(shape, (b, b), brow, bcol,
                np.zeros((brow.size, b, b), np.float32))
        lin[proj] = SparseLinear.from_pattern(w, device=device)
    return SparseMLP(lin["up"], lin["gate"], lin["down"])


class Block(nn.Module):
    """Pre-norm attention + FFN block."""

    def __init__(self, cfg: ModelConfig, mlp: nn.Module, *, device=None):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.norm1 = layers.RMSNorm(d, device=device)
        self.attn = layers.Attention(d, cfg.n_heads, cfg.n_kv, cfg.hd,
                                     qkv_bias=cfg.qkv_bias, device=device)
        self.norm2 = layers.RMSNorm(d, device=device)
        self.mlp = mlp

    def forward(self, x, *, positions, cache=None, cache_pos=0):
        cfg = self.cfg
        x = x + self.attn(self.norm1(x, cfg.norm_eps), positions=positions,
                          rope_theta=cfg.rope_theta, cache=cache,
                          cache_pos=cache_pos, chunk=cfg.attn_chunk)
        return x + self.mlp(self.norm2(x, cfg.norm_eps))


class Transformer(nn.Module):
    """Dense-family decoder.  Parameters are allocated (uninitialized) on
    ``device``; call :meth:`init` or load a state dict."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 ffn_patterns: Optional[FfnPatterns] = None):
        super().__init__()
        if cfg.family != "dense" or cfg.n_experts or cfg.layer_pattern:
            raise NotImplementedError(
                f"{cfg.name}: only the dense decoder family is ported; see "
                f"ROADMAP 'remaining model families'")
        if cfg.kv_cache_dtype != "bfloat16" or cfg.frontend != "none":
            raise NotImplementedError(
                "int8 KV caches and modality frontends are not ported yet")
        self.cfg = cfg
        d = cfg.d_model
        self.embed = layers.Embedding(cfg.padded_vocab, d, device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        layers.Embedding(cfg.padded_vocab, d, device=device))
        if cfg.ffn_block_sparse:
            proto = _shared_sparse_mlp(cfg, ffn_patterns, device)
            mlps = [proto.like() for _ in range(cfg.n_layers)]
        else:
            mlps = [layers.SwiGLU(d, cfg.d_ff, device=device)
                    for _ in range(cfg.n_layers)]
        self.layers = nn.ModuleList(Block(cfg, m, device=device) for m in mlps)
        self.final_norm = layers.RMSNorm(d, device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "Transformer":
        """Random weights from ``gen`` (a generator on the model's device):
        N(0, 0.02²) embeddings, N(0, 1/d_in) dense and sparse weights,
        unit norm scales."""
        for mod in self.modules():
            if isinstance(mod, (layers.Dense, layers.RMSNorm,
                                layers.Embedding, SparseLinear)):
                mod.init_(gen)
        return self

    def _head(self) -> torch.Tensor:
        return (self.lm_head or self.embed).table

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, T) → logits (B, T, padded_vocab)."""
        x = self.embed(tokens).to(act_dtype(self.cfg))
        b, t, _ = x.shape
        positions = torch.arange(t, device=x.device).expand(b, t)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for blk in self.layers:
            if remat:
                # the blocks draw no random numbers: no RNG state to keep
                x = checkpoint(blk, x, positions=positions,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = blk(x, positions=positions)
        x = self.final_norm(x, self.cfg.norm_eps)
        return layers.lm_head_apply(self._head(), x)

    def loss_fn(self, batch: Dict[str, torch.Tensor]):
        """batch: dict(tokens (B, T), targets (B, T)[, mask (B, T)]).

        Returns ``(loss + 0.01·aux, {"loss", "aux"})`` as ``repro`` does;
        the dense family has no auxiliary loss, so ``aux`` is 0."""
        logits = self(batch["tokens"])
        loss = layers.cross_entropy(logits, batch["targets"],
                                    batch.get("mask"))
        aux = torch.zeros((), device=loss.device)
        return loss + 0.01 * aux, {"loss": loss.detach(), "aux": aux}

    def init_cache(self, batch_size: int, max_len: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv, cfg.hd)
        return {"k": torch.zeros(shape, dtype=act_dtype(cfg),
                                 device=self.device),
                "v": torch.zeros(shape, dtype=act_dtype(cfg),
                                 device=self.device)}

    def decode_step(self, cache: Dict[str, torch.Tensor], token: torch.Tensor,
                    pos, *, logit_idx: Optional[torch.Tensor] = None):
        """token: (B, T) int (T=1 decode, T>1 chunked prefill); pos: the
        absolute position of token[:, 0], a shared int or a per-row (B,)
        tensor.  ``logit_idx``: optional per-row (B,) index of each row's
        last valid token (logits are taken there, not at T-1).

        Writes the new keys and values into ``cache`` in place and returns
        ``(logits (B, padded_vocab), cache)``."""
        x = self.embed(token).to(act_dtype(self.cfg))
        b, t, _ = x.shape
        steps = torch.arange(t, device=x.device)
        if isinstance(pos, int) or pos.ndim == 0:
            positions = (int(pos) + steps).expand(b, t)
        else:
            positions = pos.long()[:, None] + steps
        for i, blk in enumerate(self.layers):
            x = blk(x, positions=positions,
                    cache=(cache["k"][i], cache["v"][i]), cache_pos=pos)
        x = self.final_norm(x, self.cfg.norm_eps)
        # gather each row's output position before the head, so the
        # (B, T, vocab) prefill logits never materialize
        if logit_idx is None:
            x = x[:, -1:]
        else:
            idx = torch.as_tensor(logit_idx, device=x.device).long().expand(b)
            x = x[torch.arange(b, device=x.device), idx][:, None]
        return layers.lm_head_apply(self._head(), x)[:, 0], cache
