"""Granite-3 8B: dense GQA(kv=8). [hf:ibm-granite/granite-3.0-8b-base]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv=8, d_ff=12800, vocab=49155)
