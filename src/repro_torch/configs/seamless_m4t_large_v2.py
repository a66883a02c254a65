"""seamless-m4t-large-v2 [audio] — enc-dec backbone [arXiv:2308.11596; hf].

The speech frontend is a stub: the encoder takes precomputed frame
embeddings (b, frames, d_model)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=256206, enc_layers=24, dec_target_len=1024,
))
