"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, rope_theta=1e6, window=4096, n_experts=8, top_k=2,
    subquadratic=True,
    notes="SWA ring KV cache (window=4096) makes long_500k decode O(window)",
))
