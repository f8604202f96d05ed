"""RecurrentGemma-9B: RG-LRU + local attention, 1:2 pattern (2 recurrent
blocks then 1 local-attention block). [arXiv:2402.19427]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv=1, d_ff=12288, vocab=256000, head_dim=256,
    layer_pattern=("rec", "rec", "local"), local_window=2048)
