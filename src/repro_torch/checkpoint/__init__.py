"""Checkpointing of the port."""
from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
