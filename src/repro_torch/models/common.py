"""Shared model components: RMSNorm, RoPE, GQA attention (full sequence,
prefill and one decode step against a KV cache), SwiGLU MLP, embedding and
LM head.

Plain functions on tensors, in the JAX package's order of casts (the tests
hold them against ``repro/models/common.py``), and the ``nn.Module``s that
hold the weights. Weights keep the JAX layout, ``(in, out)``, so a product is
``x @ w``. bf16 products accumulate in f32 on the card, as XLA's do
(:func:`repro_torch.device.resolve_device` pins it).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import ops


def act_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def empty_weight(*shape, dtype, device) -> nn.Parameter:
    """An uninitialised inference weight (filled by ``init_params`` or
    ``params_from_numpy``)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def dense_init_(w: torch.Tensor, generator: torch.Generator, scale: Optional[float] = None) -> None:
    """``repro.models.common.dense_init``: a standard normal drawn in f32,
    times ``fan_in ** -0.5`` (or ``scale``), cast to the weight's dtype.
    Drawn in blocks of rows of at most 64 Mi values, so that the f32 draw
    adds at most 256 MiB to the memory of the allocated weights."""
    fan_in = w.shape[-2] if w.dim() >= 2 else w.shape[-1]
    scale = scale if scale is not None else fan_in**-0.5
    rows = max(1, (1 << 26) // max(1, w[0].numel())) if w.dim() >= 2 else w.shape[0]
    for block in torch.split(w, rows):
        z = torch.randn(block.shape, generator=generator, dtype=torch.float32, device=w.device)
        block.copy_(z.mul_(scale))


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalised in f32, cast to x's dtype, then scaled (in that order)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., s, h, dh); positions (..., s) int. Rotates the two halves of
    the head dim (not interleaved pairs), in f32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.scale = empty_weight(d, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """GQA projections ``wq`` (d, h*hd), ``wk``/``wv`` (d, kv*hd), ``wo``
    (h*hd, d), and the QKV biases where the config has them."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        d, hd, h, kv, dt = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, act_dtype(cfg)
        self.wq = empty_weight(d, h * hd, dtype=dt, device=device)
        self.wk = empty_weight(d, kv * hd, dtype=dt, device=device)
        self.wv = empty_weight(d, kv * hd, dtype=dt, device=device)
        self.wo = empty_weight(h * hd, d, dtype=dt, device=device)
        if cfg.qkv_bias:
            self.bq = empty_weight(h * hd, dtype=dt, device=device)
            self.bk = empty_weight(kv * hd, dtype=dt, device=device)
            self.bv = empty_weight(kv * hd, dtype=dt, device=device)

    def init_(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)
        if self.cfg.qkv_bias:
            for b in (self.bq, self.bk, self.bv):
                b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return attention(self, x, self.cfg)


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """(b, s, d) -> q (b, s, h, hd), k and v (b, s, kv, hd), RoPE on q and k."""
    b, s, _ = x.shape
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = rope(q.reshape(b, s, cfg.n_heads, cfg.hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, cfg.n_kv_heads, cfg.hd), positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, cfg.n_kv_heads, cfg.hd)


def _positions(b: int, s: int, device: torch.device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def attention(p: Attention, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Causal full-sequence self-attention (the forward pass)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, _positions(b, s, x.device))
    out = ops.flash_attention(q, k, v, causal=True, window=cfg.window)
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ p.wo


def attention_prefill(p: Attention, x: torch.Tensor, cfg: ArchConfig,
                      cache_len: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: the output and a KV cache of ``cache_len`` slots (>= s, or
    the window's last keys for a sliding-window config)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, _positions(b, s, x.device))
    out = ops.flash_attention(q, k, v, causal=True, window=cfg.window)
    out = out.reshape(b, s, cfg.n_heads * cfg.hd) @ p.wo
    ck = torch.zeros((b, cache_len, cfg.n_kv_heads, cfg.hd), dtype=k.dtype, device=k.device)
    cv = torch.zeros_like(ck)
    take = min(s, cache_len)
    keep = slice(s - take, s) if cfg.window is not None and cache_len <= cfg.window else slice(0, take)
    ck[:, :take] = k[:, keep]
    cv[:, :take] = v[:, keep]
    return out, {"k": ck, "v": cv}


def attention_decode(p: Attention, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                     cfg: ArchConfig, pos: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: x (b, d) at position ``pos`` against the cache (a
    ring buffer for a sliding-window config). Writes the new K/V into slot
    ``pos % s_cache`` (window) or ``min(pos, s_cache - 1)``, in place, and
    returns the output and the same cache. Plain PyTorch: the einsums over
    the cache are not a kernel of the JAX package either."""
    b, _ = x.shape
    hd, h, kv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    ck, cv = cache["k"], cache["v"]
    s_cache = ck.shape[1]
    q, k_new, v_new = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k_new, v_new = q + p.bq, k_new + p.bk, v_new + p.bv
    posb = torch.full((b, 1), pos, device=x.device)
    q = rope(q.reshape(b, 1, h, hd), posb, cfg.rope_theta)
    k_new = rope(k_new.reshape(b, 1, kv, hd), posb, cfg.rope_theta)
    slot = pos % s_cache if cfg.window is not None else min(pos, s_cache - 1)
    ck[:, slot] = k_new[:, 0]
    cv[:, slot] = v_new.reshape(b, kv, hd)
    qf = q.reshape(b, kv, h // kv, hd).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qf, ck.float()) / hd**0.5
    if pos < s_cache:  # a ring buffer is all valid once pos >= s_cache
        logits[..., pos + 1:] = float("-inf")
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, cv.float())
    return out.reshape(b, h * hd).to(x.dtype) @ p.wo, cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    """SwiGLU: ``w_gate``, ``w_up`` (d, ff) and ``w_down`` (ff, d)."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        d, ff, dt = cfg.d_model, cfg.d_ff, act_dtype(cfg)
        self.w_gate = empty_weight(d, ff, dtype=dt, device=device)
        self.w_up = empty_weight(d, ff, dtype=dt, device=device)
        self.w_down = empty_weight(ff, d, dtype=dt, device=device)

    def init_(self, generator: torch.Generator) -> None:
        for w in (self.w_gate, self.w_up, self.w_down):
            dense_init_(w, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self, x)


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------
def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens]


def lm_logits(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Logits over the padded vocabulary (``cfg.vocab_padded`` columns)."""
    w = params.head if not cfg.tie_embeddings else params.embed.T
    return x @ w
