"""Whisper-tiny backbone: enc-dec, conv frontend stubbed to precomputed
frame embeddings. [arXiv:2212.04356]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="enc_dec", n_layers=8, d_model=384,
    n_heads=6, n_kv=6, d_ff=1536, vocab=51865,
    enc_layers=4, dec_layers=4, frontend="frame", n_frontend_tokens=1500)
