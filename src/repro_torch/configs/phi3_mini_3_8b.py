"""Phi-3-mini 3.8B: dense, RoPE, SwiGLU, GQA(kv=32)=MHA. [arXiv:2404.14219]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=32, n_kv=32, d_ff=8192, vocab=32064)
