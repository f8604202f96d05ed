"""Command-R+ 104B: dense GQA(kv=8), no bias. [hf:CohereForAI/c4ai-command-r-v01]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense", n_layers=64, d_model=12288,
    n_heads=96, n_kv=8, d_ff=33792, vocab=256000)
