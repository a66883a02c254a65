"""Encoder-decoder transformer backbone: seamless-m4t-large-v2. The port of
``repro/models/encdec.py``.

The speech frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings (b, frames, d_model) and attends both ways.
The decoder is causal self-attention, then cross-attention over the
encoder's memory (non-causal, no RoPE), then the MLP. Decode keeps a self
cache of ``dec_target_len`` slots and the cross K/V of every layer over
the memory, which it reads without writing.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig
from . import common as cm
from .transformer import remat_call


class EncoderBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        dt = cm.act_dtype(cfg)
        self.attn_norm = cm.RMSNorm(cfg.d_model, dt, device)
        self.attn = cm.Attention(cfg, device)
        self.mlp_norm = cm.RMSNorm(cfg.d_model, dt, device)
        self.mlp = cm.MLP(cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + cm.attention(self.attn, self.attn_norm(x), self.cfg, causal=False)
        return x + self.mlp(self.mlp_norm(x))


class DecoderBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        dt = cm.act_dtype(cfg)
        self.attn_norm = cm.RMSNorm(cfg.d_model, dt, device)
        self.attn = cm.Attention(cfg, device)
        self.cross_norm = cm.RMSNorm(cfg.d_model, dt, device)
        self.cross = cm.Attention(cfg, device)
        self.mlp_norm = cm.RMSNorm(cfg.d_model, dt, device)
        self.mlp = cm.MLP(cfg, device)

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        x = x + cm.attention(self.attn, self.attn_norm(x), self.cfg, causal=True)
        x = x + cross_attention(self.cross, self.cross_norm(x), cross_kv(self.cross, memory, self.cfg),
                                self.cfg)
        return x + self.mlp(self.mlp_norm(x))


class EncDec(nn.Module):
    """``embed``, ``head`` unless tied, the encoder and decoder blocks, the
    encoder's final norm and the decoder's."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        dt = cm.act_dtype(cfg)
        self.embed = cm.empty_weight(cfg.vocab_padded, cfg.d_model, dtype=dt, device=device)
        self.head = (None if cfg.tie_embeddings
                     else cm.empty_weight(cfg.d_model, cfg.vocab_padded, dtype=dt, device=device))
        self.encoder = nn.ModuleList(EncoderBlock(cfg, device) for _ in range(cfg.enc_layers))
        self.decoder = nn.ModuleList(DecoderBlock(cfg, device) for _ in range(cfg.n_layers))
        self.enc_norm = cm.RMSNorm(cfg.d_model, dt, device)
        self.final_norm = cm.RMSNorm(cfg.d_model, dt, device)


def init_params(generator: torch.Generator, cfg: ArchConfig) -> EncDec:
    """Random weights with the JAX package's distributions."""
    p = EncDec(cfg, generator.device)
    cm.init_embed_(p, generator)
    for blk in list(p.encoder) + list(p.decoder):
        for m in blk.children():
            if isinstance(m, cm.RMSNorm):
                m.scale.fill_(1.0)
            else:
                m.init_(generator)
    p.enc_norm.scale.fill_(1.0)
    p.final_norm.scale.fill_(1.0)
    return p


_NORMS = {"encoder": ("attn_norm", "mlp_norm"), "decoder": ("attn_norm", "cross_norm", "mlp_norm")}
_ATTNS = {"encoder": ("attn",), "decoder": ("attn", "cross")}


def named_from_numpy(cfg: ArchConfig, tree: Mapping) -> Dict[str, np.ndarray]:
    """A JAX parameter pytree of ``repro.models.encdec`` (or one shaped like
    it) keyed by the port's parameter names, the stacked leaves split."""
    out = dict(cm.named_embed(cfg, tree), **{"enc_norm.scale": tree["enc_norm"]["scale"]})
    attn = ("wq", "wk", "wv", "wo") + (("bq", "bk", "bv") if cfg.qkv_bias else ())
    for part, n in (("encoder", cfg.enc_layers), ("decoder", cfg.n_layers)):
        t = tree[part]
        for i in range(n):
            for norm in _NORMS[part]:
                out[f"{part}.{i}.{norm}.scale"] = t[norm]["scale"][i]
            for a in _ATTNS[part]:
                for name in attn:
                    out[f"{part}.{i}.{a}.{name}"] = t[a][name][i]
            for name in ("w_gate", "w_up", "w_down"):
                out[f"{part}.{i}.mlp.{name}"] = t["mlp"][name][i]
    return {k: np.asarray(v) for k, v in out.items()}


def params_from_numpy(cfg: ArchConfig, np_params: Mapping) -> EncDec:
    """The port's weights, on the CPU, holding the JAX package's parameters."""
    return cm.load_named_(EncDec(cfg, torch.device("cpu")), named_from_numpy(cfg, np_params))


def cross_kv(p: cm.Attention, memory: torch.Tensor, cfg: ArchConfig):
    """The cross-attention's K and V (b, s_src, kv, hd) over the memory (no
    bias, no RoPE, as the JAX package's ``_cross_kv``)."""
    b, s, _ = memory.shape
    return ((memory @ p.wk).reshape(b, s, cfg.n_kv_heads, cfg.hd),
            (memory @ p.wv).reshape(b, s, cfg.n_kv_heads, cfg.hd))


def cross_attention(p: cm.Attention, x: torch.Tensor, kv, cfg: ArchConfig) -> torch.Tensor:
    return cm.attention(p, x, cfg, causal=False, kv_override=kv, use_rope=False)


def encode(params: EncDec, src_embeds: torch.Tensor, cfg: ArchConfig, remat: str = "dots"):
    """src_embeds (b, s_src, d) -> encoder memory (b, s_src, d)."""
    x = src_embeds
    for blk in params.encoder:
        x = remat_call(blk, x, remat=remat)
    return cm.rms_norm(x, params.enc_norm.scale)


def decode_train(params: EncDec, memory: torch.Tensor, tgt_tokens: torch.Tensor, cfg: ArchConfig,
                 remat: str = "dots"):
    """Teacher-forced decoder forward: tgt_tokens (b, t) -> hidden states."""
    x = cm.embed(params, tgt_tokens)
    for blk in params.decoder:
        x = remat_call(blk, x, memory, remat=remat)
    return cm.rms_norm(x, params.final_norm.scale)


def loss_fn(params: EncDec, batch: Mapping[str, torch.Tensor], cfg: ArchConfig,
            remat: str = "dots") -> torch.Tensor:
    """Next-token cross-entropy of ``batch["tgt_tokens"]`` given
    ``batch["src_embeds"]``."""
    memory = encode(params, batch["src_embeds"], cfg, remat=remat)
    tgt = batch["tgt_tokens"]
    x = decode_train(params, memory, tgt[:, :-1], cfg, remat=remat)
    return cm.lm_loss(params, x, tgt[:, 1:], cfg)


def init_cache(cfg: ArchConfig, batch: int, src_len: int, device) -> Dict[str, torch.Tensor]:
    """Self cache of ``dec_target_len`` slots and cross K/V over ``src_len``
    frames, per decoder layer."""
    dt = cm.act_dtype(cfg)
    self_shape = (cfg.n_layers, batch, cfg.dec_target_len, cfg.n_kv_heads, cfg.hd)
    cross_shape = (cfg.n_layers, batch, src_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(self_shape, dtype=dt, device=device),
            "v": torch.zeros(self_shape, dtype=dt, device=device),
            "ck": torch.zeros(cross_shape, dtype=dt, device=device),
            "cv": torch.zeros(cross_shape, dtype=dt, device=device)}


def prefill(params: EncDec, batch: Mapping[str, torch.Tensor], cfg: ArchConfig,
            cache_len: Optional[int] = None):
    """Encodes ``src_embeds`` and runs the decoder over ``tgt_tokens``:
    returns (last-token logits, {'k', 'v' (self, ``cache_len`` or
    ``dec_target_len`` slots), 'ck', 'cv' (cross)} stacked over the layers)."""
    memory = encode(params, batch["src_embeds"], cfg)
    cl = cache_len or cfg.dec_target_len
    x = cm.embed(params, batch["tgt_tokens"])
    caches = {"k": [], "v": [], "ck": [], "cv": []}
    for blk in params.decoder:
        a, cache = cm.attention_prefill(blk.attn, blk.attn_norm(x), cfg, cl)
        x = x + a
        ck, cv = cross_kv(blk.cross, memory, cfg)
        x = x + cross_attention(blk.cross, blk.cross_norm(x), (ck, cv), cfg)
        x = x + blk.mlp(blk.mlp_norm(x))
        for name, t in (("k", cache["k"]), ("v", cache["v"]), ("ck", ck), ("cv", cv)):
            caches[name].append(t)
    x = cm.rms_norm(x[:, -1:], params.final_norm.scale)
    return cm.lm_logits(params, x, cfg)[:, 0], {n: torch.stack(t) for n, t in caches.items()}


def decode_step(params: EncDec, cache: Dict[str, torch.Tensor], tokens: torch.Tensor, pos: int,
                cfg: ArchConfig):
    """One decoder token at ``pos``: self-attention against the self cache
    (written in place), cross-attention over the cross K/V (read only).
    Returns (logits, cache)."""
    x = cm.embed(params, tokens)
    src_last = cache["ck"].shape[2] - 1
    for i, blk in enumerate(params.decoder):
        a, _ = cm.attention_decode(blk.attn, blk.attn_norm(x), {"k": cache["k"][i], "v": cache["v"][i]},
                                   cfg, pos)
        x = x + a
        c, _ = cm.attention_decode(blk.cross, blk.cross_norm(x),
                                   {"k": cache["ck"][i], "v": cache["cv"][i]}, cfg, src_last,
                                   update_cache=False, use_rope=False)
        x = x + c
        x = x + blk.mlp(blk.mlp_norm(x))
    x = cm.rms_norm(x, params.final_norm.scale)
    return cm.lm_logits(params, x, cfg), cache
