"""Dense decoder-only transformer (GQA, RoPE, SwiGLU, optional QKV bias,
optional sliding window): glm4-9b, deepseek-67b, internlm2-20b, qwen2.5-32b
and chameleon-34b. The serving half of ``repro/models/transformer.py``:
``init_params``, ``forward``, ``prefill``, ``decode_step``, ``init_cache``
and ``cache_len_for``; the training loss waits for the training slice.

The layer stack is a Python loop over ``Block`` modules where JAX scans
stacked parameters; KV caches keep the JAX layout, stacked
``(n_layers, b, s, kv, hd)``, so the tests compare like with like.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig
from . import common as cm


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        dt = cm.act_dtype(cfg)
        self.attn_norm = cm.RMSNorm(cfg.d_model, dt, device)
        self.attn = cm.Attention(cfg, device)
        self.mlp_norm = cm.RMSNorm(cfg.d_model, dt, device)
        self.mlp = cm.MLP(cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x))
        return x + self.mlp(self.mlp_norm(x))


class Transformer(nn.Module):
    """The weights of one dense model: ``embed`` (vocab_padded, d), ``head``
    (d, vocab_padded) unless tied, the blocks and the final norm. Allocated
    uninitialised; :func:`init_params` or :func:`params_from_numpy` fill it."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        dt = cm.act_dtype(cfg)
        self.embed = cm.empty_weight(cfg.vocab_padded, cfg.d_model, dtype=dt, device=device)
        self.head = (None if cfg.tie_embeddings
                     else cm.empty_weight(cfg.d_model, cfg.vocab_padded, dtype=dt, device=device))
        self.blocks = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = cm.RMSNorm(cfg.d_model, dt, device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens, self.cfg)


def init_params(generator: torch.Generator, cfg: ArchConfig) -> Transformer:
    """Random weights on the generator's device, with the JAX package's
    distributions (not its values): normal ``fan_in ** -0.5`` projections,
    normal 0.02 embedding, zero biases, unit norm scales."""
    p = Transformer(cfg, generator.device)
    cm.dense_init_(p.embed, generator, scale=0.02)
    if p.head is not None:
        cm.dense_init_(p.head, generator)
    for blk in p.blocks:
        blk.attn.init_(generator)
        blk.mlp.init_(generator)
    for norm in [p.final_norm] + [n for blk in p.blocks for n in (blk.attn_norm, blk.mlp_norm)]:
        norm.scale.fill_(1.0)
    return p


def params_from_numpy(cfg: ArchConfig, np_params: Mapping) -> Transformer:
    """The port's weights, on the CPU, holding the JAX package's parameters:
    the nested dict of ``repro.models.transformer.init_params`` as numpy
    arrays, with stacked ``(n_layers, ...)`` layer leaves and ``(in, out)``
    weights."""
    p = Transformer(cfg, torch.device("cpu"))

    def put(dst: torch.Tensor, src) -> None:
        src = np.asarray(src, dtype=np.float32)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape {src.shape} does not fit {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(src))

    put(p.embed, np_params["embed"])
    if p.head is not None:
        put(p.head, np_params["head"])
    put(p.final_norm.scale, np_params["final_norm"]["scale"])
    layers = np_params["layers"]
    for i, blk in enumerate(p.blocks):
        put(blk.attn_norm.scale, layers["attn_norm"]["scale"][i])
        put(blk.mlp_norm.scale, layers["mlp_norm"]["scale"][i])
        names = ("wq", "wk", "wv", "wo") + (("bq", "bk", "bv") if cfg.qkv_bias else ())
        for name in names:
            put(getattr(blk.attn, name), layers["attn"][name][i])
        for name in ("w_gate", "w_up", "w_down"):
            put(getattr(blk.mlp, name), layers["mlp"][name][i])
    return p


def forward(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """tokens (b, s) -> final hidden states (b, s, d)."""
    x = cm.embed(params, tokens)
    for blk in params.blocks:
        x = blk(x)
    return cm.rms_norm(x, params.final_norm.scale)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def cache_len_for(cfg: ArchConfig, seq_len: int) -> int:
    return min(seq_len, cfg.window) if cfg.window is not None else seq_len


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device) -> Dict[str, torch.Tensor]:
    shape = (cfg.n_layers, batch, cache_len_for(cfg, seq_len), cfg.n_kv_heads, cfg.hd)
    dt = cm.act_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def prefill(params: Transformer, batch: Mapping[str, torch.Tensor], cfg: ArchConfig,
            cache_len: Optional[int] = None):
    """Returns (last-token logits (b, vocab_padded), stacked KV cache)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    cl = cache_len or cache_len_for(cfg, s)
    x = cm.embed(params, tokens)
    ks, vs = [], []
    for blk in params.blocks:
        a, cache = cm.attention_prefill(blk.attn, blk.attn_norm(x), cfg, cl)
        x = x + a
        x = x + blk.mlp(blk.mlp_norm(x))
        ks.append(cache["k"])
        vs.append(cache["v"])
    x = cm.rms_norm(x[:, -1:], params.final_norm.scale)
    logits = cm.lm_logits(params, x, cfg)[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params: Transformer, cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                pos: int, cfg: ArchConfig):
    """One token for the whole batch: tokens (b,), ``pos`` the position of
    that token. Updates the cache in place; returns (logits, cache)."""
    x = cm.embed(params, tokens)
    for i, blk in enumerate(params.blocks):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        a, _ = cm.attention_decode(blk.attn, blk.attn_norm(x), layer_cache, cfg, pos)
        x = x + a
        x = x + blk.mlp(blk.mlp_norm(x))
    x = cm.rms_norm(x, params.final_norm.scale)
    return cm.lm_logits(params, x, cfg), cache
