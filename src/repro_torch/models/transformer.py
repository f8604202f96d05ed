"""Decoder-only transformer of the dense and hybrid families (the parts of
``repro.models.transformer`` that granite-class models and RecurrentGemma
serve with).

Dense: GQA attention + SwiGLU or block-sparse Segment FFN.  Hybrid
(``cfg.layer_pattern``, e.g. RecurrentGemma's ``("rec", "rec", "local")``):
``rec`` layers are an RG-LRU block (:mod:`.recurrent`) with a dense SwiGLU,
``local`` layers windowed attention with the model's FFN, as in ``repro``.
The layers are one ``nn.ModuleList`` in ``repro``'s order (the pattern
repeated, then its first ``n_layers mod len(pattern)`` kinds) instead of
scanned stacks.  With ``ffn_block_sparse`` every sparse FFN uses one shared
pruning pattern (three plans, built once) and owns its block values, as in
``repro``.  Parameter names follow the JAX param dict (``embed.table``,
``layers.<i>.attn.wq.w``, ``layers.<i>.mlp.up.blocks``,
``layers.<i>.rec.a_param``, ...), see :mod:`repro_torch.convert`.

The cache is a flat dict of tensors, the layer axis first and the slot
axis second: ``k``/``v`` ``(n_attn, B, T, n_kv, hd)`` over the attention
layers (T = ``min(max_len, local_window)`` for a ring of local layers;
int8 with ``kv_cache_dtype="int8"``, beside ``(n_attn, B, T, n_kv)`` fp32
scales ``k_s``/``v_s``), ``conv`` ``(n_rec, B, 3, D)`` and ``h``
``(n_rec, B, D)`` fp32 over the RG-LRU layers.  :meth:`Transformer.decode_step`
writes every entry in place.

Quantized serving: :meth:`Transformer.quantize` returns a model whose
sparse FFN blocks are int8/fp8 payloads with scales and which shares every
other tensor with the source.

Training: :meth:`Transformer.loss_fn` is ``repro``'s.  With ``cfg.remat``
each block of a forward pass that records gradients is rematerialized
(``torch.utils.checkpoint``, as ``repro`` wraps its layer scan in
``jax.checkpoint``): only block inputs are kept, and the backward pass runs
each block's forward again.  The hybrid family has no backward: neither
the ``rg_lru`` nor the ``flash_attention`` kernel has one, so its forward
runs only without gradients (``torch.no_grad``/``inference_mode``).
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.formats import BSR

from . import layers
from .recurrent import RGLRUBlock
from .sparse_ffn import SparseLinear, SparseMLP

#: numpy seed of the shared FFN pattern when none is given
PATTERN_SEED = 17

FfnPatterns = Dict[str, Tuple[np.ndarray, np.ndarray]]

#: the cache entries of the RG-LRU layers; the others belong to attention
REC_KEYS = ("conv", "h")
_NO_BACKWARD = ("the hybrid family has no backward (the rg_lru and "
                "flash_attention kernels have none); see ROADMAP 'hybrid "
                "training'. Run its forward under torch.no_grad() or "
                "torch.inference_mode()")


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


def _sharing_copy(mod: nn.Module, **children: nn.Module) -> nn.Module:
    """A new module object that shares every parameter, buffer and child of
    ``mod``, with ``children`` replaced (nothing is copied on the device)."""
    new = copy.copy(mod)
    new._parameters = dict(mod._parameters)
    new._buffers = dict(mod._buffers)
    new._modules = dict(mod._modules)
    for name, child in children.items():
        setattr(new, name, child)
    return new


class Block(nn.Module):
    """Pre-norm attention + FFN block; ``local``: attention within
    ``cfg.local_window``, over a ring KV cache."""

    def __init__(self, cfg: ModelConfig, mlp: nn.Module, *, local=False,
                 device=None):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.window = cfg.local_window if local else None
        self.norm1 = layers.RMSNorm(d, device=device)
        self.attn = layers.Attention(d, cfg.n_heads, cfg.n_kv, cfg.hd,
                                     qkv_bias=cfg.qkv_bias, device=device)
        self.norm2 = layers.RMSNorm(d, device=device)
        self.mlp = mlp

    def forward(self, x, *, positions, cache=None, cache_pos=0):
        cfg = self.cfg
        x = x + self.attn(self.norm1(x, cfg.norm_eps), positions=positions,
                          rope_theta=cfg.rope_theta, cache=cache,
                          cache_pos=cache_pos, chunk=cfg.attn_chunk,
                          window=self.window, ring=self.window is not None)
        return x + self.mlp(self.norm2(x, cfg.norm_eps))


class RecBlock(nn.Module):
    """Pre-norm RG-LRU block + dense SwiGLU (``repro`` gives ``rec`` layers a
    dense FFN even when ``ffn_block_sparse`` is set)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.norm1 = layers.RMSNorm(d, device=device)
        self.rec = RGLRUBlock(d, device=device)
        self.norm2 = layers.RMSNorm(d, device=device)
        self.mlp = layers.SwiGLU(d, cfg.d_ff, device=device)

    def forward(self, x, *, positions=None, cache=None, cache_pos=0):
        """``cache``: optional dict of ``conv`` (B, 3, D) and ``h`` (B, D),
        read as the state and overwritten in place with the new one."""
        cfg = self.cfg
        h, state = self.rec(self.norm1(x, cfg.norm_eps), state=cache)
        if cache is not None:
            for k in REC_KEYS:
                cache[k].copy_(state[k])
        x = x + h
        return x + self.mlp(self.norm2(x, cfg.norm_eps))


class Transformer(nn.Module):
    """Dense- or hybrid-family decoder.  Parameters are allocated
    (uninitialized) on ``device``; call :meth:`init` or load a state dict."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 ffn_patterns: Optional[FfnPatterns] = None):
        super().__init__()
        kinds = tuple(cfg.layer_kind(i) for i in range(cfg.n_layers))
        if (cfg.family not in ("dense", "hybrid") or cfg.n_experts
                or not set(kinds) <= {"attn", "local", "rec"}
                or {"attn", "local"} <= set(kinds)):
            raise NotImplementedError(
                f"{cfg.name}: only the dense and hybrid decoder families are "
                f"ported; see ROADMAP 'remaining model families'")
        if cfg.frontend != "none":
            raise NotImplementedError(
                "modality frontends are not ported yet")
        self.cfg = cfg
        self.layer_kinds = kinds
        d = cfg.d_model
        self.embed = layers.Embedding(cfg.padded_vocab, d, device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        layers.Embedding(cfg.padded_vocab, d, device=device))
        proto = (_shared_sparse_mlp(cfg, ffn_patterns, device)
                 if cfg.ffn_block_sparse else None)

        def block(kind):
            if kind == "rec":
                return RecBlock(cfg, device=device)
            mlp = (proto.like() if proto is not None else
                   layers.SwiGLU(d, cfg.d_ff, device=device))
            return Block(cfg, mlp, local=kind == "local", device=device)

        self.layers = nn.ModuleList(block(k) for k in kinds)
        self.final_norm = layers.RMSNorm(d, device=device)
        # each layer's index along the layer axis of its cache entries
        is_rec = [k == "rec" for k in kinds]
        self._cache_index = [is_rec[:i].count(r) for i, r in enumerate(is_rec)]

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
                                layers.Embedding, SparseLinear, RGLRUBlock)):
                mod.init_(gen)
        return self

    @property
    def recurrent(self) -> bool:
        """True when some layer carries recurrent state (the hybrid
        family), which has no backward."""
        return "rec" in self.layer_kinds

    @property
    def quantized(self) -> bool:
        """True when the sparse FFN blocks are int8/fp8 payloads."""
        return any(isinstance(blk.mlp, SparseMLP) and blk.mlp.up.quantized
                   for blk in self.layers)

    def quantize(self, mode: str = "int8") -> "Transformer":
        """A copy of this model for quantized serving (``repro``'s
        ``Transformer.quantize``): every sparse FFN's blocks become a
        ``mode`` payload (``"int8"``, ``"fp8"``, ``"int8.rowwise"`` or
        ``"fp8.rowwise"``) with fp32 scales, under quantized plans that
        share one cached schedule per projection.  Every other tensor (the
        RG-LRU blocks and their dense SwiGLU included) is shared with this
        model, not copied."""
        if not self.cfg.ffn_block_sparse:
            raise ValueError(
                "Transformer.quantize requires a block-sparse FFN model "
                "(ModelConfig.ffn_block_sparse=True); dense SwiGLU weights "
                "have no Segment plan to quantize")
        if self.quantized:
            raise ValueError("the model is already quantized; quantize "
                             "from the fp32 model")
        layers = nn.ModuleList(
            _sharing_copy(blk, mlp=blk.mlp.quantize(mode))
            if isinstance(blk.mlp, SparseMLP) else blk for blk in self.layers)
        return _sharing_copy(self, layers=layers)

    def _head(self) -> torch.Tensor:
        return (self.lm_head or self.embed).table

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, T) → logits (B, T, padded_vocab).  A hybrid model
        raises ``NotImplementedError`` when gradients are recorded."""
        if self.recurrent and torch.is_grad_enabled():
            raise NotImplementedError(_NO_BACKWARD)
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
        the dense family has no auxiliary loss, so ``aux`` is 0.  The
        hybrid family raises ``NotImplementedError`` (no backward)."""
        if self.recurrent:
            raise NotImplementedError(_NO_BACKWARD)
        logits = self(batch["tokens"])
        loss = layers.cross_entropy(logits, batch["targets"],
                                    batch.get("mask"))
        aux = torch.zeros((), device=loss.device)
        return loss + 0.01 * aux, {"loss": loss.detach(), "aux": aux}

    def init_cache(self, batch_size: int, max_len: int) -> Dict[str, torch.Tensor]:
        """Zero cache for ``batch_size`` slots of ``max_len`` positions.
        Raises ``ValueError`` for an int8 KV cache over local layers: the
        ring has no int8 mode (``repro``'s ring write drops the scales)."""
        cfg = self.cfg
        dev, dt = self.device, act_dtype(cfg)
        kinds = self.layer_kinds
        cache = {}
        n_attn = sum(k != "rec" for k in kinds)
        if n_attn:
            local = "local" in kinds
            t_len = min(max_len, cfg.local_window) if local else max_len
            shape = (n_attn, batch_size, t_len, cfg.n_kv, cfg.hd)
            if cfg.kv_cache_dtype == "int8":
                if local:
                    raise ValueError(
                        f"{cfg.name}: kv_cache_dtype='int8' is not supported "
                        f"with local attention layers (the ring KV cache has "
                        f"no int8 mode); use the {dt} cache")
                cache.update(
                    k=torch.zeros(shape, dtype=torch.int8, device=dev),
                    v=torch.zeros(shape, dtype=torch.int8, device=dev),
                    k_s=torch.zeros(shape[:-1], device=dev),
                    v_s=torch.zeros(shape[:-1], device=dev))
            else:
                cache.update(k=torch.zeros(shape, dtype=dt, device=dev),
                             v=torch.zeros(shape, dtype=dt, device=dev))
        n_rec = kinds.count("rec")
        if n_rec:
            d = cfg.d_model
            cache.update(
                conv=torch.zeros((n_rec, batch_size, 3, d), dtype=dt,
                                 device=dev),
                h=torch.zeros((n_rec, batch_size, d), dtype=torch.float32,
                              device=dev))
        return cache

    def decode_step(self, cache: Dict[str, torch.Tensor], token: torch.Tensor,
                    pos, *, logit_idx: Optional[torch.Tensor] = None):
        """token: (B, T) int (T=1 decode, T>1 chunked prefill); pos: the
        absolute position of token[:, 0], a shared int or a per-row (B,)
        tensor.  ``logit_idx``: optional per-row (B,) index of each row's
        last valid token (logits are taken there, not at T-1).

        Writes the new keys and values (and the recurrent state) into
        ``cache`` in place and returns ``(logits (B, padded_vocab),
        cache)``."""
        x = self.embed(token).to(act_dtype(self.cfg))
        b, t, _ = x.shape
        steps = torch.arange(t, device=x.device)
        if isinstance(pos, int) or pos.ndim == 0:
            positions = (int(pos) + steps).expand(b, t)
        else:
            positions = pos.long()[:, None] + steps
        for blk, kind, i in zip(self.layers, self.layer_kinds,
                                self._cache_index):
            mine = {k: v[i] for k, v in cache.items()
                    if (k in REC_KEYS) == (kind == "rec")}
            x = blk(x, positions=positions, cache=mine, cache_pos=pos)
        x = self.final_norm(x, self.cfg.norm_eps)
        # gather each row's output position before the head, so the
        # (B, T, vocab) prefill logits never materialize
        if logit_idx is None:
            x = x[:, -1:]
        else:
            idx = torch.as_tensor(logit_idx, device=x.device).long().expand(b)
            x = x[torch.arange(b, device=x.device), idx][:, None]
        return layers.lm_head_apply(self._head(), x)[:, 0], cache
