"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, head_dim=80, ssm_state=64, ssm_conv=4, ssm_expand=2,
    ssm_head_dim=64, ssm_chunk=1024, attn_every=6, subquadratic=True,
    notes="shared attention block applied every 6 mamba layers (9 sites)",
))
