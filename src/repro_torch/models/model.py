"""Model construction and the abstract specs of every (arch × shape) cell:
``repro``'s ``jax.ShapeDtypeStruct`` stand-ins as ``torch`` tensors on the
``meta`` device (shapes and dtypes, no memory)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.api.backends import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig

from .transformer import FfnPatterns, Transformer, act_dtype


def build_model(cfg: ModelConfig, *, device=None,
                ffn_patterns: Optional[FfnPatterns] = None,
                mesh=None, fsdp="data") -> Transformer:
    """The model of ``cfg`` with its parameters allocated on ``device``
    (``None`` means the card; raises when there is none).  On ``mesh`` it
    is split over the ``model`` axis (``Transformer.shard_``) and every
    parameter is held as this rank's shard of the rules, FSDP on ``fsdp``,
    gathered a unit at a time as the model runs (``Transformer.zero3_``):
    the forward-only model of a sharded prefill or decode, which a mesh
    ``Trainer`` takes as it is.  Weights are uninitialized: call
    ``model.init(generator)`` or load a state dict (full tensors are
    sliced, or sharded, on a split model)."""
    model = Transformer(cfg, device=resolve_device(device),
                        ffn_patterns=ffn_patterns, mesh=mesh)
    if mesh is not None:
        model.zero3_(mesh, fsdp)
    return model


def _abstract_device(device) -> torch.device:
    return torch.device("meta" if device is None else device)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device=None) -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input of the cell, keyed as ``repro``'s:
    ``token`` (B, 1) and ``pos`` () int32 for a decode cell; else
    ``tokens`` (and ``targets`` for training) (B, T_text) int32, beside
    ``vis_embeds`` (``vlm``; T_text = T - Nv) or ``enc_embeds``
    (``enc_dec``) (B, n_frontend_tokens, d_model) in the model dtype.  On
    ``device`` (default ``meta``: no memory)."""
    dev = _abstract_device(device)
    b, t = shape.global_batch, shape.seq_len

    def spec(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=dev)

    if shape.kind == "decode":
        return {"token": spec((b, 1)), "pos": spec(())}
    specs: Dict[str, torch.Tensor] = {}
    t_text = t
    if cfg.family in ("vlm", "enc_dec"):
        key = "vis_embeds" if cfg.family == "vlm" else "enc_embeds"
        specs[key] = spec((b, cfg.n_frontend_tokens, cfg.d_model),
                          act_dtype(cfg))
        if cfg.family == "vlm":
            t_text = t - cfg.n_frontend_tokens
    specs["tokens"] = spec((b, t_text))
    if shape.kind == "train":
        specs["targets"] = spec((b, t_text))
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                device=None) -> Dict[str, torch.Tensor]:
    """The decode cache of the cell (``Transformer.init_cache(B, T)``) on
    ``device`` (default ``meta``)."""
    model = Transformer(cfg, device=_abstract_device(device))
    return model.init_cache(shape.global_batch, shape.seq_len)


def abstract_params(cfg: ModelConfig, device=None) -> Dict[str, torch.Tensor]:
    """The model's state dict (parameters and buffers, keyed by the port's
    names) on ``device`` (default ``meta``)."""
    return Transformer(cfg, device=_abstract_device(device)).state_dict()
