"""Llama-4 Maverick 400B-A17B: MoE 128 experts top-1, interleaved with
dense layers (the 400B-total / 17B-active figures correspond to alternating
dense/MoE blocks, as in the official architecture).
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
    d_model=5120, n_heads=40, n_kv=8, d_ff=8192, vocab=202048,
    n_experts=128, top_k=1, layer_pattern=("attn", "moe"))
