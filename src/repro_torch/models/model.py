"""Model construction."""
from __future__ import annotations

from typing import Optional

from repro_torch.api.backends import resolve_device
from repro_torch.configs.base import ModelConfig

from .transformer import FfnPatterns, Transformer


def build_model(cfg: ModelConfig, *, device=None,
                ffn_patterns: Optional[FfnPatterns] = None) -> Transformer:
    """The model of ``cfg`` with its parameters allocated on ``device``
    (``None`` means the card; raises when there is none).  Weights are
    uninitialized: call ``model.init(generator)`` or load a state dict."""
    return Transformer(cfg, device=resolve_device(device),
                       ffn_patterns=ffn_patterns)
