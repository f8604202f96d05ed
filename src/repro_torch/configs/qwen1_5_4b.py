"""Qwen1.5-4B: dense with QKV bias. [hf:Qwen/Qwen1.5-0.5B]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
    n_heads=20, n_kv=20, d_ff=6912, vocab=151936, qkv_bias=True)
