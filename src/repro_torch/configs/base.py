"""Architecture configuration: a frozen ``ArchConfig`` per model, a registry
of the ported ones, and ``reduce()`` for the small same-family variant the
CPU tests run. A copy of the JAX package's ``configs/base.py`` without its
XLA-only parts (shape suites, ``ShapeDtypeStruct`` input specs, scan
unrolling)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    window: Optional[int] = None  # sliding-window attention
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # hybrid: one shared attention block applied every k SSM layers
    attn_every: int = 0
    # enc-dec: n_layers = decoder layers
    enc_layers: int = 0
    dec_target_len: int = 1024
    # numerics
    param_dtype: str = "bfloat16"
    subquadratic: bool = False
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab, 256)


# the ported configurations (dense family only so far; see ROADMAP.md)
_ARCH_MODULES = ("chameleon_34b", "deepseek_67b", "glm4_9b", "internlm2_20b", "qwen2_5_32b")

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        list_archs()
    return _REGISTRY[name]


def list_archs() -> Tuple[str, ...]:
    for m in _ARCH_MODULES:
        importlib.import_module(f"{__package__}.{m}")
    return tuple(sorted(_REGISTRY))


def reduce(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family variant for CPU smoke tests (f32, 2 layers,
    d_model 128, head dim 32, vocab 512)."""
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = 4 if cfg.n_heads >= 4 else cfg.n_heads
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=4 if cfg.family == "hybrid" else 2,
        d_model=128,
        n_heads=heads,
        n_kv_heads=kv if cfg.n_kv_heads != cfg.n_heads else heads,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        window=min(cfg.window, 64) if cfg.window else None,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else 64,
        ssm_chunk=16,
        attn_every=2 if cfg.attn_every else 0,
        enc_layers=2 if cfg.enc_layers else 0,
        dec_target_len=32,
        param_dtype="float32",
    )
