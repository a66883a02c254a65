"""Zamba2 hybrid (arXiv:2411.15242): zamba2-2.7b. A Mamba2 backbone with
ONE shared attention + MLP block applied after every ``attn_every`` Mamba
layers. The shared block reads concat(hidden, original embedding), 2
d_model wide, and its weights serve every site (9 sites at 54 layers), so
their gradients sum over the sites. The port of ``repro/models/zamba2.py``.

``forward`` checkpoints the Mamba layers (``remat``) and not the shared
block, as the JAX package does. Decode keeps every Mamba layer's state and
one KV cache of ``seq_len`` slots per site.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig
from . import common as cm
from . import mamba2 as mb
from .transformer import remat_call


def n_shared_sites(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def group_slices(cfg: ArchConfig):
    """The Mamba layers [lo, hi) before each shared site."""
    k = cfg.attn_every
    return [(g * k, min((g + 1) * k, cfg.n_layers)) for g in range(n_shared_sites(cfg))]


class SharedBlock(nn.Module):
    """Attention over 2 d_model inputs (its norm 2 d wide) and a SwiGLU MLP."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        dt = cm.act_dtype(cfg)
        self.attn_norm = cm.RMSNorm(2 * cfg.d_model, dt, device)
        self.attn = cm.Attention(cfg, device, d_in=2 * cfg.d_model)
        self.mlp_norm = cm.RMSNorm(cfg.d_model, dt, device)
        self.mlp = cm.MLP(cfg, device)


class Zamba2(nn.Module):
    """``embed``, ``head`` unless tied, the Mamba blocks, the shared block
    and the final norm."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        dt = cm.act_dtype(cfg)
        self.embed = cm.empty_weight(cfg.vocab_padded, cfg.d_model, dtype=dt, device=device)
        self.head = (None if cfg.tie_embeddings
                     else cm.empty_weight(cfg.d_model, cfg.vocab_padded, dtype=dt, device=device))
        self.blocks = nn.ModuleList(mb.Block(cfg, device) for _ in range(cfg.n_layers))
        self.shared = SharedBlock(cfg, device)
        self.final_norm = cm.RMSNorm(cfg.d_model, dt, device)


def init_params(generator: torch.Generator, cfg: ArchConfig) -> Zamba2:
    """Random weights with the JAX package's distributions."""
    p = Zamba2(cfg, generator.device)
    cm.init_embed_(p, generator)
    for blk in p.blocks:
        blk.mamba.init_(generator)
        blk.norm.scale.fill_(1.0)
    p.shared.attn.init_(generator)
    p.shared.mlp.init_(generator)
    for norm in (p.shared.attn_norm, p.shared.mlp_norm, p.final_norm):
        norm.scale.fill_(1.0)
    return p


def named_from_numpy(cfg: ArchConfig, tree: Mapping) -> Dict[str, np.ndarray]:
    """A JAX parameter pytree of ``repro.models.zamba2`` (or one shaped like
    it) keyed by the port's parameter names: the stacked Mamba leaves split
    per block, the shared block's leaves once."""
    out = cm.named_embed(cfg, tree)
    for i in range(cfg.n_layers):
        out.update(mb.named_mamba(f"blocks.{i}", tree["layers"], i))
    sh = tree["shared"]
    attn = ("wq", "wk", "wv", "wo") + (("bq", "bk", "bv") if cfg.qkv_bias else ())
    for name in attn:
        out[f"shared.attn.{name}"] = sh["attn"][name]
    for name in ("w_gate", "w_up", "w_down"):
        out[f"shared.mlp.{name}"] = sh["mlp"][name]
    out["shared.attn_norm.scale"] = sh["attn_norm"]["scale"]
    out["shared.mlp_norm.scale"] = sh["mlp_norm"]["scale"]
    return {k: np.asarray(v) for k, v in out.items()}


def params_from_numpy(cfg: ArchConfig, np_params: Mapping) -> Zamba2:
    """The port's weights, on the CPU, holding the JAX package's parameters."""
    return cm.load_named_(Zamba2(cfg, torch.device("cpu")), named_from_numpy(cfg, np_params))


def shared_block(p: SharedBlock, x: torch.Tensor, x0: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = cm.rms_norm(torch.cat([x, x0], dim=-1), p.attn_norm.scale)
    x = x + cm.attention(p.attn, h, cfg, causal=True)
    return x + cm.mlp(p.mlp, cm.rms_norm(x, p.mlp_norm.scale))


def forward(params: Zamba2, tokens: torch.Tensor, cfg: ArchConfig, remat: str = "dots"):
    """tokens (b, s) -> final hidden states; the Mamba layers under
    ``transformer.remat_call``, the shared block not."""
    x = cm.embed(params, tokens)
    x0 = x
    for lo, hi in group_slices(cfg):
        for blk in params.blocks[lo:hi]:
            x = remat_call(blk, x, remat=remat)
        x = shared_block(params.shared, x, x0, cfg)
    return cm.rms_norm(x, params.final_norm.scale)


def loss_fn(params: Zamba2, batch: Mapping[str, torch.Tensor], cfg: ArchConfig,
            remat: str = "dots") -> torch.Tensor:
    tokens = batch["tokens"]
    x = forward(params, tokens[:, :-1], cfg, remat=remat)
    return cm.lm_loss(params, x, tokens[:, 1:], cfg)


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device):
    """Every Mamba layer's state and conv tail, and a KV cache of
    ``seq_len`` slots per shared site."""
    shape = (n_shared_sites(cfg), batch, seq_len, cfg.n_kv_heads, cfg.hd)
    dt = cm.act_dtype(cfg)
    return {"ssm": mb.init_cache(cfg, batch, seq_len, device),
            "attn": {"k": torch.zeros(shape, dtype=dt, device=device),
                     "v": torch.zeros(shape, dtype=dt, device=device)}}


def prefill(params: Zamba2, batch: Mapping[str, torch.Tensor], cfg: ArchConfig,
            cache_len: Optional[int] = None):
    """Returns (last-token logits, {'ssm': {'h', 'conv'}, 'attn': {'k',
    'v'}}), the KV caches of ``cache_len`` slots (the prompt's length when
    None)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    cl = cache_len or s
    x = cm.embed(params, tokens)
    x0 = x
    hs, convs, ks, vs = [], [], [], []
    sh = params.shared
    for lo, hi in group_slices(cfg):
        x, h_g, conv_g = mb.prefill_blocks(params.blocks[lo:hi], x, cfg)
        hs += h_g
        convs += conv_g
        h = cm.rms_norm(torch.cat([x, x0], dim=-1), sh.attn_norm.scale)
        a, kv = cm.attention_prefill(sh.attn, h, cfg, cl)
        x = x + a
        x = x + cm.mlp(sh.mlp, cm.rms_norm(x, sh.mlp_norm.scale))
        ks.append(kv["k"])
        vs.append(kv["v"])
    x = cm.rms_norm(x[:, -1:], params.final_norm.scale)
    cache = {"ssm": {"h": torch.stack(hs), "conv": torch.stack(convs)},
             "attn": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    return cm.lm_logits(params, x, cfg)[:, 0], cache


def decode_step(params: Zamba2, cache, tokens: torch.Tensor, pos: int, cfg: ArchConfig):
    """One token for the whole batch at position ``pos``. Updates the cache
    in place; returns (logits, cache)."""
    x = cm.embed(params, tokens)
    x0 = x
    sh = params.shared
    h_all, conv_all = cache["ssm"]["h"], cache["ssm"]["conv"]
    for g, (lo, hi) in enumerate(group_slices(cfg)):
        x = mb.decode_blocks(params.blocks[lo:hi], x, h_all[lo:hi], conv_all[lo:hi], cfg)
        h = cm.rms_norm(torch.cat([x, x0], dim=-1), sh.attn_norm.scale)
        site = {"k": cache["attn"]["k"][g], "v": cache["attn"]["v"][g]}
        a, _ = cm.attention_decode(sh.attn, h, site, cfg, pos)
        x = x + a
        x = x + cm.mlp(sh.mlp, cm.rms_norm(x, sh.mlp_norm.scale))
    x = cm.rms_norm(x, params.final_norm.scale)
    return cm.lm_logits(params, x, cfg), cache
