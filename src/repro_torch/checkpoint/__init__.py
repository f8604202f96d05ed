"""Checkpointing of the port, and the reader of ``repro``'s checkpoints."""
from .checkpoint import CheckpointManager
from .jax_format import JaxCheckpoint, jax_state_layout, restore_jax_checkpoint

__all__ = ["CheckpointManager", "JaxCheckpoint", "jax_state_layout",
           "restore_jax_checkpoint"]
