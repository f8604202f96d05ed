"""Architecture registry of the port: a copy of ``repro.configs``, one
module per architecture, in ``repro``'s order.  ``build_model`` builds the
dense and hybrid families and raises ``NotImplementedError`` on the others
(moe, ssm, vlm, enc_dec), which are not ported yet."""
import dataclasses

from . import (command_r_plus_104b, granite_3_8b, internvl2_2b,
               llama4_maverick_400b_a17b, phi3_5_moe_42b_a6_6b,
               phi3_mini_3_8b, qwen1_5_4b, recurrentgemma_9b, rwkv6_1_6b,
               whisper_tiny)
from .base import SHAPES, ModelConfig, ShapeConfig

REGISTRY = {m.CONFIG.name: m.CONFIG for m in (
    internvl2_2b, whisper_tiny, phi3_mini_3_8b, qwen1_5_4b, granite_3_8b,
    command_r_plus_104b, recurrentgemma_9b, llama4_maverick_400b_a17b,
    phi3_5_moe_42b_a6_6b, rwkv6_1_6b)}

ARCH_IDS = list(REGISTRY)

# long_500k needs sub-quadratic context handling: only the constant-state
# and windowed architectures run it
LONG_CONTEXT_ARCHS = ("recurrentgemma-9b", "rwkv6-1.6b")


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


def cell_is_live(arch: str, shape: str) -> bool:
    """Which (arch × shape) cells run (40 total, 32 live)."""
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


__all__ = ["ARCH_IDS", "LONG_CONTEXT_ARCHS", "REGISTRY", "SHAPES",
           "ModelConfig", "ShapeConfig", "cell_is_live", "get_config",
           "reduced_config"]
