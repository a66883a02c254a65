"""Optimizer of the port: AdamW with f32 moments, and gradient compression."""
from . import adamw, compression
from .adamw import AdamWConfig, AdamWState, apply_updates, global_norm, init_state, state_from_numpy
from .compression import CompressionConfig, compress_grads

__all__ = ["AdamWConfig", "AdamWState", "CompressionConfig", "adamw", "apply_updates",
           "compress_grads", "compression", "global_norm", "init_state", "state_from_numpy"]
