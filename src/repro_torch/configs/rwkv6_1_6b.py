"""RWKV-6 (Finch) 1.6B: attention-free, data-dependent decay.
[arXiv:2404.05892]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
    n_heads=32, n_kv=0, d_ff=7168, vocab=65536)
