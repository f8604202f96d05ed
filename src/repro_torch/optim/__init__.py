"""Optimizer and learning-rate schedules of the port."""
from .adamw import AdamW, AdamWState
from .schedule import constant, cosine_with_warmup

__all__ = ["AdamW", "AdamWState", "constant", "cosine_with_warmup"]
