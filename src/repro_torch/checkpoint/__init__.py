"""Checkpointing of the port's training state."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
