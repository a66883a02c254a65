"""Mixtral-style MoE transformer: mixtral-8x7b and mixtral-8x22b. GQA with
a sliding window, and a top-2-of-8 SwiGLU expert MLP behind a grouped
capacity dispatch. The port of ``repro/models/moe.py``.

The dispatch picks the tokens the reference picks: T tokens in g =
min(32, T) groups (g lowered until it divides T), each group's (token,
slot) pairs stably sorted by expert and packed into its own (E, capacity)
buffer; pairs past an expert's capacity are dropped (their slot in the
output gets nothing). The expert products are then three batched products
over (G, E, capacity, d), the gathers and the scatter-add back to token
order plain PyTorch, as the JAX package's are plain jnp. No kernel of the
port runs in the MLP; the attention runs ``ops.flash_attention``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.ref import topk_stable
from . import common as cm
from .transformer import cache_len_for, init_cache, remat_call  # noqa: F401  (the dense cache)


class MoEMLP(nn.Module):
    """``router`` (d, e), ``we_gate`` and ``we_up`` (e, d, ff), ``we_down``
    (e, ff, d)."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        d, ff, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cm.act_dtype(cfg)
        self.router = cm.empty_weight(d, e, dtype=dt, device=device)
        self.we_gate = cm.empty_weight(e, d, ff, dtype=dt, device=device)
        self.we_up = cm.empty_weight(e, d, ff, dtype=dt, device=device)
        self.we_down = cm.empty_weight(e, ff, d, dtype=dt, device=device)

    def init_(self, generator: torch.Generator) -> None:
        for w in (self.router, self.we_gate, self.we_up, self.we_down):
            cm.dense_init_(w, generator)


#: while :func:`count_drops` is active, each dispatch appends the number of
#: (token, slot) pairs that capacity dropped (a device tensor: no sync)
_DROPS: Optional[list] = None


@contextlib.contextmanager
def count_drops():
    """Collects the dropped-pair count of every dispatch inside the block:
    ``with count_drops() as drops: ...``, then ``sum(int(d) for d in drops)``."""
    global _DROPS
    outer, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = outer


def dispatch(router: torch.Tensor, x: torch.Tensor, cfg: ArchConfig, groups: int = 32) -> dict:
    """The routing of ``repro/models/moe.py::moe_mlp`` for x (..., d):
    groups g, capacity ``cap``, the grouped tokens ``xg`` (g, tl, d), the
    f32 router ``probs``, ``topi`` (lowest index first on ties), the aux
    loss, and the per-group (E * cap) buffers ``buf_tok`` (token of each
    slot), ``buf_valid`` and ``buf_w`` (its normalised top-k weight)."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    g = min(groups, t)
    while t % g:
        g -= 1
    tl = t // g
    cap = max(int(math.ceil(cfg.capacity_factor * tl * k / e)), 1)
    cap = min(cap, tl * k)

    xg = xt.reshape(g, tl, d)
    probs = torch.softmax((xg @ router).float(), dim=-1)  # (G, TL, E)
    topw, topi = topk_stable(probs, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch-style), over all groups
    me = probs.mean((0, 1))
    ce = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, topi.reshape(-1), torch.ones(t * k, dtype=torch.float32, device=x.device)) / (t * k)
    aux = e * torch.sum(me * ce)

    # pack (token, slot) pairs into per-group per-expert buffers of size cap;
    # slot e * cap is the sentinel that the dropped pairs write to
    eid = topi.reshape(g, tl * k)
    w = topw.reshape(g, tl * k).to(xt.dtype)
    order = torch.argsort(eid, dim=1, stable=True)
    sorted_eid = torch.gather(eid, 1, order)
    seg_start = torch.searchsorted(sorted_eid, torch.arange(e, device=x.device).expand(g, e).contiguous(),
                                   side="left")  # (G, E)
    rank = torch.arange(tl * k, device=x.device)[None, :] - torch.gather(seg_start, 1, sorted_eid)
    keep = rank < cap
    dest = torch.where(keep, sorted_eid * cap + rank, torch.full_like(rank, e * cap))
    if _DROPS is not None:
        _DROPS.append((~keep).sum())
    buf_tok = torch.zeros((g, e * cap + 1), dtype=torch.long, device=x.device).scatter_(
        1, dest, order // k)[:, :e * cap]
    buf_valid = torch.zeros((g, e * cap + 1), dtype=torch.bool, device=x.device).scatter_(
        1, dest, keep)[:, :e * cap]
    w_sorted = torch.gather(w, 1, order)
    buf_w = torch.zeros((g, e * cap + 1), dtype=xt.dtype, device=x.device).scatter_(
        1, dest, torch.where(keep, w_sorted, torch.zeros_like(w_sorted)))[:, :e * cap]
    return dict(g=g, tl=tl, cap=cap, xg=xg, probs=probs, topi=topi, aux=aux, buf_tok=buf_tok,
                buf_valid=buf_valid, buf_w=buf_w)


def moe_mlp(p: MoEMLP, x: torch.Tensor, cfg: ArchConfig, groups: int = 32):
    """x (..., d) -> (output of x's shape, aux load-balance loss f32)."""
    r = dispatch(p.router, x, cfg, groups)
    g, cap, xg, d = r["g"], r["cap"], r["xg"], x.shape[-1]
    e = cfg.n_experts
    tok = r["buf_tok"][..., None].expand(g, e * cap, d)
    xe = torch.gather(xg, 1, tok) * r["buf_valid"][..., None].to(xg.dtype)
    xe = xe.reshape(g, e, cap, d)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p.we_gate)) * torch.einsum(
        "gecd,edf->gecf", xe, p.we_up)
    ye = torch.einsum("gecf,efd->gecd", h, p.we_down).reshape(g, e * cap, d)
    ye = ye * r["buf_w"][..., None]
    ye = torch.where(r["buf_valid"][..., None], ye, torch.zeros((), dtype=ye.dtype, device=ye.device))
    out = torch.zeros_like(xg).scatter_add_(1, tok, ye)
    return out.reshape(x.shape), r["aux"]


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        dt = cm.act_dtype(cfg)
        self.attn_norm = cm.RMSNorm(cfg.d_model, dt, device)
        self.attn = cm.Attention(cfg, device)
        self.mlp_norm = cm.RMSNorm(cfg.d_model, dt, device)
        self.moe = MoEMLP(cfg, device)

    def forward(self, x: torch.Tensor, aux: torch.Tensor):
        x = x + self.attn(self.attn_norm(x))
        y, a = moe_mlp(self.moe, self.mlp_norm(x), self.cfg)
        return x + y, aux + a


class MoETransformer(nn.Module):
    """The weights of one MoE model: ``embed``, ``head`` unless tied, the
    blocks and the final norm."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        dt = cm.act_dtype(cfg)
        self.embed = cm.empty_weight(cfg.vocab_padded, cfg.d_model, dtype=dt, device=device)
        self.head = (None if cfg.tie_embeddings
                     else cm.empty_weight(cfg.d_model, cfg.vocab_padded, dtype=dt, device=device))
        self.blocks = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = cm.RMSNorm(cfg.d_model, dt, device)


def init_params(generator: torch.Generator, cfg: ArchConfig) -> MoETransformer:
    """Random weights with the JAX package's distributions."""
    p = MoETransformer(cfg, generator.device)
    cm.init_embed_(p, generator)
    for blk in p.blocks:
        blk.attn.init_(generator)
        blk.moe.init_(generator)
        blk.attn_norm.scale.fill_(1.0)
        blk.mlp_norm.scale.fill_(1.0)
    p.final_norm.scale.fill_(1.0)
    return p


def named_from_numpy(cfg: ArchConfig, tree: Mapping) -> Dict[str, np.ndarray]:
    """A JAX parameter pytree of ``repro.models.moe`` (or one shaped like
    it) keyed by the port's parameter names, the stacked leaves split."""
    out = cm.named_embed(cfg, tree)
    layers = tree["layers"]
    attn = ("wq", "wk", "wv", "wo") + (("bq", "bk", "bv") if cfg.qkv_bias else ())
    for i in range(cfg.n_layers):
        out[f"blocks.{i}.attn_norm.scale"] = layers["attn_norm"]["scale"][i]
        out[f"blocks.{i}.mlp_norm.scale"] = layers["mlp_norm"]["scale"][i]
        for name in attn:
            out[f"blocks.{i}.attn.{name}"] = layers["attn"][name][i]
        for name in ("router", "we_gate", "we_up", "we_down"):
            out[f"blocks.{i}.moe.{name}"] = layers["moe"][name][i]
    return {k: np.asarray(v) for k, v in out.items()}


def params_from_numpy(cfg: ArchConfig, np_params: Mapping) -> MoETransformer:
    """The port's weights, on the CPU, holding the JAX package's parameters."""
    return cm.load_named_(MoETransformer(cfg, torch.device("cpu")), named_from_numpy(cfg, np_params))


def forward(params: MoETransformer, tokens: torch.Tensor, cfg: ArchConfig, remat: str = "dots"):
    """tokens (b, s) -> (final hidden states, mean aux loss over the layers)."""
    x = cm.embed(params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in params.blocks:
        x, aux = remat_call(blk, x, aux, remat=remat)
    return cm.rms_norm(x, params.final_norm.scale), aux / cfg.n_layers


def loss_fn(params: MoETransformer, batch: Mapping[str, torch.Tensor], cfg: ArchConfig,
            remat: str = "dots", aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token cross-entropy plus ``aux_weight`` times the aux loss."""
    tokens = batch["tokens"]
    x, aux = forward(params, tokens[:, :-1], cfg, remat=remat)
    return cm.lm_loss(params, x, tokens[:, 1:], cfg) + aux_weight * aux


def prefill(params: MoETransformer, batch: Mapping[str, torch.Tensor], cfg: ArchConfig,
            cache_len: Optional[int] = None):
    """Returns (last-token logits, stacked KV cache of ``cache_len_for``
    slots: the window's last keys once the prompt is longer)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    cl = cache_len or cache_len_for(cfg, s)
    x = cm.embed(params, tokens)
    ks, vs = [], []
    for blk in params.blocks:
        a, cache = cm.attention_prefill(blk.attn, blk.attn_norm(x), cfg, cl)
        x = x + a
        x = x + moe_mlp(blk.moe, blk.mlp_norm(x), cfg)[0]
        ks.append(cache["k"])
        vs.append(cache["v"])
    x = cm.rms_norm(x[:, -1:], params.final_norm.scale)
    return cm.lm_logits(params, x, cfg)[:, 0], {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params: MoETransformer, cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                pos: int, cfg: ArchConfig):
    """One token for the whole batch; the cache is a ring buffer under the
    window. Updates it in place; returns (logits, cache)."""
    x = cm.embed(params, tokens)
    for i, blk in enumerate(params.blocks):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        a, _ = cm.attention_decode(blk.attn, blk.attn_norm(x), layer_cache, cfg, pos)
        x = x + a
        x = x + moe_mlp(blk.moe, blk.mlp_norm(x), cfg)[0]
    x = cm.rms_norm(x, params.final_norm.scale)
    return cm.lm_logits(params, x, cfg), cache
