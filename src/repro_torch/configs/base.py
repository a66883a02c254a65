"""Architecture and input-shape configuration: a frozen ``ArchConfig`` per
model, a registry of the ported ones, ``reduce()`` for the small
same-family variant the CPU tests run, the four ``ShapeConfig`` suites and
``input_specs()``, their inputs as tensors on the ``meta`` device (shapes
and dtypes, no storage) for the dry-run. A copy of the JAX package's
``configs/base.py`` without scan unrolling (an XLA cost-analysis switch);
all ten of its architectures are registered."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch


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

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Approximate parameter count N (the JAX package's, used for
        MODEL_FLOPS = 6*N*D)."""
        d, ff, v, L = self.d_model, self.d_ff, self.vocab_padded, self.n_layers
        n = v * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "moe"):
            attn = d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd + self.n_heads * self.hd * d
            mlp = 3 * d * ff
            if self.family == "moe":
                mlp = mlp * self.n_experts + d * self.n_experts
            n += L * (attn + mlp)
        elif self.family == "ssm":
            di, ns, hh = self.d_inner, self.ssm_state, self.ssm_heads
            per = d * (2 * di + 2 * ns + hh) + self.ssm_conv * (di + 2 * ns) + di * d + hh * 2
            n += L * per
        elif self.family == "hybrid":
            di, ns, hh = self.d_inner, self.ssm_state, self.ssm_heads
            per = d * (2 * di + 2 * ns + hh) + self.ssm_conv * (di + 2 * ns) + di * d + hh * 2
            n += L * per
            # one shared attention+mlp block (input is concat[x, residual] -> 2d)
            n += 2 * d * self.n_heads * self.hd + 2 * 2 * d * self.n_kv_heads * self.hd + self.n_heads * self.hd * d
            n += 3 * d * ff if ff else 0
        elif self.family == "encdec":
            attn = d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd + self.n_heads * self.hd * d
            mlp = 3 * d * ff
            n += self.enc_layers * (attn + mlp)  # encoder
            n += L * (2 * attn + mlp)  # decoder has self + cross attention
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, ff, v, L = self.d_model, self.d_ff, self.vocab_padded, self.n_layers
        n = v * d * 2
        attn = d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd + self.n_heads * self.hd * d
        n += L * (attn + 3 * d * ff * self.top_k + d * self.n_experts)
        return n


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_ARCH_MODULES = (
    "deepseek_67b", "internlm2_20b", "glm4_9b", "qwen2_5_32b", "mamba2_130m",
    "mixtral_8x7b", "mixtral_8x22b", "seamless_m4t_large_v2", "zamba2_2_7b",
    "chameleon_34b",
)

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        list_archs()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; one of {', '.join(sorted(_REGISTRY))}")
    return _REGISTRY[name]


def list_archs() -> Tuple[str, ...]:
    for m in _ARCH_MODULES:
        importlib.import_module(f"{__package__}.{m}")
    return tuple(sorted(_REGISTRY))


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs: long_500k needs a sub-quadratic
    path (SSM, hybrid, or a sliding window)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention architecture: no sub-quadratic path at 512k"
    return True, ""


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


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The model inputs of a shape suite as tensors on the ``meta`` device,
    with the JAX package's shapes and dtypes (int32 tokens; bf16 or f32
    frame embeddings). The enc-dec backbone takes precomputed source frame
    embeddings (its speech frontend is a stub); decode is one token a
    sequence at ``pos``."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    act = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if cfg.family == "encdec":
        tgt = min(cfg.dec_target_len, max(s // 32, 16))
        if shape.kind == "train":
            return {"src_embeds": spec((b, s, cfg.d_model), act), "tgt_tokens": spec((b, tgt + 1), i32)}
        if shape.kind == "prefill":
            return {"src_embeds": spec((b, s, cfg.d_model), act), "tgt_tokens": spec((b, tgt), i32)}
        return {"tokens": spec((b,), i32), "pos": spec((b,), i32)}
    if shape.kind == "train":
        return {"tokens": spec((b, s + 1), i32)}
    if shape.kind == "prefill":
        return {"tokens": spec((b, s), i32)}
    return {"tokens": spec((b,), i32), "pos": spec((b,), i32)}
