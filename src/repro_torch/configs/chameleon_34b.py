"""chameleon-34b [vlm] — early-fusion decoder-only; VQ image tokens live in
the unified vocab so the modality frontend is just token ids
[arXiv:2405.09818]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=65536, rope_theta=1e4,
))
