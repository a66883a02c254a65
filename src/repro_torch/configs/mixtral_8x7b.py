"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, rope_theta=1e6, window=4096, n_experts=8, top_k=2,
    subquadratic=True,  # sliding window bounds the KV cache
    notes="SWA ring KV cache (window=4096) makes long_500k decode O(window)",
))
