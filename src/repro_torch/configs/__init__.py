"""Architecture registry of the port.  granite-3-8b is the model it serves
and trains; recurrentgemma-9b and llama4-maverick give the widths of the
``kernels.ops`` entry points (their model families are not ported yet:
``build_model`` raises ``NotImplementedError`` on them)."""
import dataclasses

from . import granite_3_8b, llama4_maverick_400b_a17b, recurrentgemma_9b
from .base import ModelConfig, ShapeConfig

REGISTRY = {m.CONFIG.name: m.CONFIG for m in (
    granite_3_8b, recurrentgemma_9b, llama4_maverick_400b_a17b)}


def get_config(name: str) -> ModelConfig:
    return REGISTRY[name]


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test scale: same family/topology, tiny dims."""
    pattern_len = len(cfg.layer_pattern) or 1
    return dataclasses.replace(
        cfg,
        n_layers=max(2, pattern_len + 1) if cfg.layer_pattern else 2,
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv=min(max(cfg.n_kv, 0), 2) if cfg.n_heads else 0,
        head_dim=16 if cfg.head_dim else None,
        d_ff=128,
        vocab=512,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        enc_layers=min(cfg.enc_layers, 2),
        dec_layers=min(cfg.dec_layers, 2),
        local_window=32,
        n_frontend_tokens=min(cfg.n_frontend_tokens, 8),
        attn_chunk=64,
        remat=False)


__all__ = ["REGISTRY", "ModelConfig", "ShapeConfig", "get_config",
           "reduced_config"]
