"""InternVL2-2B backbone: InternViT frontend (stub) + InternLM2 LM.
[arXiv:2404.16821; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
    n_heads=16, n_kv=8, d_ff=8192, vocab=92553,
    frontend="patch", n_frontend_tokens=256)
