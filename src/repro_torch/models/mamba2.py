"""Mamba2 (SSD, state-space duality, arXiv:2405.21060): mamba2-130m. The
port of ``repro/models/mamba2.py``: the depthwise causal conv, the chunked
SSD scan, the full block, the O(1) decode recurrence, and a prefill that
keeps each layer's final state and conv tail.

Chunked SSD: within a chunk of ``ssm_chunk`` positions the recurrence is
expanded into attention-like products (a (q, q) decay matrix per head);
chunks are linked by a Python loop carrying the f32 (b, nh, hp, ns) state,
where the JAX package scans. Plain PyTorch products, as the JAX package's
are plain jnp: no kernel of the port runs here. Decode is the recurrence
h <- h exp(dt A) + dt (B outer x).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from . import common as cm
from .transformer import remat_call


def _dims(cfg: ArchConfig):
    di = cfg.d_inner
    nh = cfg.ssm_heads
    ns = cfg.ssm_state
    conv_dim = di + 2 * ns  # x, B, C go through the causal conv
    d_in_proj = 2 * di + 2 * ns + nh  # z, x, B, C, dt
    return di, nh, ns, conv_dim, d_in_proj


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


class Mamba(nn.Module):
    """One Mamba2 mixer: ``in_proj`` (d, 2 di + 2 ns + nh), ``conv_w``
    (width, di + 2 ns), ``conv_bias``, ``a_log``, ``ssm_d``, ``dt_bias``
    (nh, f32), the gated norm over di and ``out_proj`` (di, d)."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        d, dt = cfg.d_model, cm.act_dtype(cfg)
        di, nh, _, conv_dim, d_in_proj = _dims(cfg)
        self.in_proj = cm.empty_weight(d, d_in_proj, dtype=dt, device=device)
        self.conv_w = cm.empty_weight(cfg.ssm_conv, conv_dim, dtype=dt, device=device)
        self.conv_bias = cm.empty_weight(conv_dim, dtype=dt, device=device)
        self.a_log = cm.empty_weight(nh, dtype=torch.float32, device=device)
        self.ssm_d = cm.empty_weight(nh, dtype=torch.float32, device=device)
        self.dt_bias = cm.empty_weight(nh, dtype=torch.float32, device=device)
        self.norm = cm.RMSNorm(di, dt, device)
        self.out_proj = cm.empty_weight(di, d, dtype=dt, device=device)

    def init_(self, generator: torch.Generator) -> None:
        nh = self.a_log.shape[0]
        cm.dense_init_(self.in_proj, generator)
        cm.dense_init_(self.conv_w, generator, scale=0.5)
        self.conv_bias.zero_()
        self.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh, device=self.a_log.device)))
        self.ssm_d.fill_(1.0)
        self.dt_bias.zero_()
        self.norm.scale.fill_(1.0)
        cm.dense_init_(self.out_proj, generator)


class Block(nn.Module):
    """Pre-norm residual Mamba2 layer."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.norm = cm.RMSNorm(cfg.d_model, cm.act_dtype(cfg), device)
        self.mamba = Mamba(cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + mamba_block(self.mamba, self.norm(x), self.cfg)[0]


class Mamba2(nn.Module):
    """The weights of one SSM model: ``embed`` (vocab_padded, d), ``head``
    unless tied, the blocks and the final norm."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        dt = cm.act_dtype(cfg)
        self.embed = cm.empty_weight(cfg.vocab_padded, cfg.d_model, dtype=dt, device=device)
        self.head = (None if cfg.tie_embeddings
                     else cm.empty_weight(cfg.d_model, cfg.vocab_padded, dtype=dt, device=device))
        self.blocks = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = cm.RMSNorm(cfg.d_model, dt, device)


def init_params(generator: torch.Generator, cfg: ArchConfig) -> Mamba2:
    """Random weights with the JAX package's distributions (normal
    ``fan_in ** -0.5`` projections, conv 0.5 ``fan_in ** -0.5``, a_log =
    log linspace(1, 16), D = 1, zero biases, unit norm scales)."""
    p = Mamba2(cfg, generator.device)
    cm.init_embed_(p, generator)
    for blk in p.blocks:
        blk.mamba.init_(generator)
        blk.norm.scale.fill_(1.0)
    p.final_norm.scale.fill_(1.0)
    return p


def named_mamba(prefix: str, layers: Mapping, i: int) -> Dict[str, np.ndarray]:
    """Layer ``i`` of the JAX package's stacked mamba leaves (``layers`` =
    ``{"mamba": ..., "norm": ...}``) under the port's names of a
    :class:`Block` at ``prefix``."""
    m = layers["mamba"]
    out = {f"{prefix}.norm.scale": layers["norm"]["scale"][i],
           f"{prefix}.mamba.norm.scale": m["norm"]["scale"][i]}
    for name in ("in_proj", "conv_w", "conv_bias", "a_log", "ssm_d", "dt_bias", "out_proj"):
        out[f"{prefix}.mamba.{name}"] = m[name][i]
    return out


def named_from_numpy(cfg: ArchConfig, tree: Mapping) -> Dict[str, np.ndarray]:
    """A JAX parameter pytree of ``repro.models.mamba2`` (or one shaped like
    it) as numpy arrays keyed by the port's parameter names, the stacked
    layer leaves split per block."""
    out = cm.named_embed(cfg, tree)
    for i in range(cfg.n_layers):
        out.update(named_mamba(f"blocks.{i}", tree["layers"], i))
    return {k: np.asarray(v) for k, v in out.items()}


def params_from_numpy(cfg: ArchConfig, np_params: Mapping) -> Mamba2:
    """The port's weights, on the CPU, holding the JAX package's parameters."""
    return cm.load_named_(Mamba2(cfg, torch.device("cpu")), named_from_numpy(cfg, np_params))


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
def _split_proj(zxbcdt: torch.Tensor, cfg: ArchConfig):
    di, _, _, conv_dim, _ = _dims(cfg)
    return zxbcdt[..., :di], zxbcdt[..., di:di + conv_dim], zxbcdt[..., di + conv_dim:]


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence, then SiLU: xbc (b, l, c), w
    (width, c); the taps summed in the JAX package's order."""
    width, l = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + l, :] * w[i][None, None, :] for i in range(width))
    return F.silu(out + bias)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_in: torch.Tensor,
             c_in: torch.Tensor, cfg: ArchConfig, h0: Optional[torch.Tensor] = None):
    """Chunked SSD. x (b, l, nh, hp); dt (b, l, nh) f32; a (nh,) negative;
    b_in, c_in (b, l, ns) f32; h0 (b, nh, hp, ns) f32 or None (zeros).
    Returns (y (b, l, nh, hp) in x's dtype, final state (b, nh, hp, ns) f32).
    l is padded with zeros to a whole number of chunks (dt = 0 there, so the
    padding leaves the state as it was)."""
    bsz, l, nh, hp = x.shape
    ns = b_in.shape[-1]
    q = min(cfg.ssm_chunk, l)
    n_chunks = (l + q - 1) // q
    if l % q:
        padn = n_chunks * q - l
        x = F.pad(x, (0, 0, 0, 0, 0, padn))
        dt = F.pad(dt, (0, 0, 0, padn))
        b_in = F.pad(b_in, (0, 0, 0, padn))
        c_in = F.pad(c_in, (0, 0, 0, padn))
    above = torch.triu(torch.ones((q, q), dtype=torch.bool, device=x.device), diagonal=1)
    h = torch.zeros((bsz, nh, hp, ns), dtype=torch.float32, device=x.device) if h0 is None else h0
    ys = []
    for c in range(n_chunks):
        sl = slice(c * q, (c + 1) * q)
        xq, dtq, bq, cq = x[:, sl], dt[:, sl], b_in[:, sl], c_in[:, sl]
        adt = dtq * a[None, None, :]  # (b, q, nh), negative
        cum = torch.cumsum(adt, dim=1)
        # intra-chunk: y[i] = sum_{j<=i} C_i.B_j exp(cum_i - cum_j) dt_j x_j,
        # with the (q, q) matrices laid out per head, (b, nh, i, j), so that
        # the product over j is a batched matmul without a transposed copy
        cum_h = cum.transpose(1, 2).contiguous()  # so that seg, decay and w are contiguous
        seg = cum_h[:, :, :, None] - cum_h[:, :, None, :]
        # the mask goes in BEFORE exp: exp of the masked (positive) entries
        # would overflow, and their gradient through where() be inf * 0 = nan.
        # In place: seg is a fresh (b, nh, q, q) f32 temporary (1.3 GB a
        # chunk at zamba2's prefill) that no backward reads
        decay = torch.exp_(seg.masked_fill_(above, -1e30))
        cb = torch.einsum("bin,bjn->bij", cq, bq)
        w = cb[:, None] * decay  # (b, nh, q, q)
        xdt = xq * dtq[..., None]  # (b, q, nh, hp) f32
        y_intra = torch.matmul(w, xdt.transpose(1, 2)).transpose(1, 2)  # (b, q, nh, hp)
        # inter-chunk: y[i] += C_i . h exp(cum_i)
        y_inter = torch.einsum("bin,bhpn,bih->bihp", cq, h, torch.exp(cum))
        # h' = h exp(cum_last) + sum_j exp(cum_last - cum_j) B_j (dt_j x_j)
        last = cum[:, -1:, :]
        sdecay = torch.exp(last - cum)
        h = h * torch.exp(last)[:, 0, :, None, None] + torch.einsum(
            "bjn,bjh,bjhp->bhpn", bq, sdecay, xdt)
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.cat(ys, dim=1)[:, :l]
    return y, h


def mamba_block(p: Mamba, x: torch.Tensor, cfg: ArchConfig):
    """Full-sequence Mamba2 mixer: x (b, l, d) -> (out (b, l, d), final SSM
    state (b, nh, hp, ns) f32, conv tail (b, width - 1, conv_dim): the last
    pre-conv inputs, which decode continues from)."""
    di, nh, ns, _, _ = _dims(cfg)
    zxbcdt = x @ p.in_proj
    z, xbc, dt_raw = _split_proj(zxbcdt, cfg)
    conv_tail = xbc[:, -(cfg.ssm_conv - 1):, :]
    xbc = causal_conv(xbc, p.conv_w, p.conv_bias)
    xin = xbc[..., :di]
    b_in = xbc[..., di:di + ns].float()
    c_in = xbc[..., di + ns:].float()
    dt = softplus(dt_raw.float() + p.dt_bias)  # (b, l, nh)
    a = -torch.exp(p.a_log)
    xh = xin.reshape(*xin.shape[:-1], nh, cfg.ssm_head_dim)
    y, h_final = ssd_scan(xh, dt, a, b_in, c_in, cfg)
    y = y + xh * p.ssm_d[None, None, :, None].to(xh.dtype)
    y = y.reshape(xin.shape)
    y = cm.rms_norm(y * F.silu(z), p.norm.scale)
    return y @ p.out_proj, h_final, conv_tail


def mamba_decode(p: Mamba, x: torch.Tensor, state: Dict[str, torch.Tensor], cfg: ArchConfig):
    """One token: x (b, d); state {'h': (b, nh, hp, ns) f32, 'conv': (b,
    width - 1, conv_dim)}. Returns (out (b, d), the new state)."""
    di, nh, ns, _, _ = _dims(cfg)
    zxbcdt = x @ p.in_proj
    z, xbc, dt_raw = _split_proj(zxbcdt, cfg)
    window = torch.cat([state["conv"], xbc[:, None, :]], dim=1)  # (b, width, c)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, p.conv_w) + p.conv_bias)
    xin = conv_out[..., :di]
    b_in = conv_out[..., di:di + ns].float()
    c_in = conv_out[..., di + ns:].float()
    dt = softplus(dt_raw.float() + p.dt_bias)  # (b, nh)
    a = -torch.exp(p.a_log)
    xh = xin.reshape(-1, nh, cfg.ssm_head_dim).float()
    decay = torch.exp(dt * a[None, :])
    h_new = state["h"] * decay[:, :, None, None] + torch.einsum("bn,bh,bhp->bhpn", b_in, dt, xh)
    y = torch.einsum("bn,bhpn->bhp", c_in, h_new) + xh * p.ssm_d[None, :, None]
    y = y.reshape(-1, di).to(x.dtype)
    y = cm.rms_norm(y * F.silu(z), p.norm.scale)
    return y @ p.out_proj, {"h": h_new, "conv": window[:, 1:]}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def forward(params: Mamba2, tokens: torch.Tensor, cfg: ArchConfig, remat: str = "dots"):
    """tokens (b, s) -> final hidden states (b, s, d), each block under
    ``transformer.remat_call``."""
    x = cm.embed(params, tokens)
    for blk in params.blocks:
        x = remat_call(blk, x, remat=remat)
    return cm.rms_norm(x, params.final_norm.scale)


def loss_fn(params: Mamba2, batch: Mapping[str, torch.Tensor], cfg: ArchConfig,
            remat: str = "dots") -> torch.Tensor:
    tokens = batch["tokens"]
    x = forward(params, tokens[:, :-1], cfg, remat=remat)
    return cm.lm_loss(params, x, tokens[:, 1:], cfg)


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device) -> Dict[str, torch.Tensor]:
    """Every layer's SSM state (f32) and conv tail; ``seq_len`` plays no part."""
    _, nh, ns, conv_dim, _ = _dims(cfg)
    l = cfg.n_layers
    return {"h": torch.zeros((l, batch, nh, cfg.ssm_head_dim, ns), dtype=torch.float32, device=device),
            "conv": torch.zeros((l, batch, cfg.ssm_conv - 1, conv_dim), dtype=cm.act_dtype(cfg),
                                device=device)}


def prefill_blocks(blocks, x: torch.Tensor, cfg: ArchConfig):
    """Runs ``blocks`` over x, keeping each one's final state and conv tail:
    returns (x, [h], [conv])."""
    hs, convs = [], []
    for blk in blocks:
        y, h_final, conv_tail = mamba_block(blk.mamba, blk.norm(x), cfg)
        x = x + y
        hs.append(h_final)
        convs.append(conv_tail)
    return x, hs, convs


def decode_blocks(blocks, x: torch.Tensor, h: torch.Tensor, conv: torch.Tensor, cfg: ArchConfig):
    """One token through ``blocks``, their states the leading rows of ``h``
    and ``conv``, which are updated in place."""
    for i, blk in enumerate(blocks):
        y, st = mamba_decode(blk.mamba, blk.norm(x), {"h": h[i], "conv": conv[i]}, cfg)
        x = x + y
        h[i] = st["h"]
        conv[i] = st["conv"]
    return x


def prefill(params: Mamba2, batch: Mapping[str, torch.Tensor], cfg: ArchConfig,
            cache_len: Optional[int] = None):
    """Returns (last-token logits (b, vocab_padded), {'h', 'conv'} stacked
    over the layers)."""
    x = cm.embed(params, batch["tokens"])
    x, hs, convs = prefill_blocks(params.blocks, x, cfg)
    x = cm.rms_norm(x[:, -1:], params.final_norm.scale)
    return cm.lm_logits(params, x, cfg)[:, 0], {"h": torch.stack(hs), "conv": torch.stack(convs)}


def decode_step(params: Mamba2, cache: Dict[str, torch.Tensor], tokens: torch.Tensor, pos: int,
                cfg: ArchConfig):
    """One token for the whole batch (``pos`` plays no part: the state
    carries the position). Updates the cache in place; returns (logits, cache)."""
    x = decode_blocks(params.blocks, cm.embed(params, tokens), cache["h"], cache["conv"], cfg)
    x = cm.rms_norm(x, params.final_norm.scale)
    return cm.lm_logits(params, x, cfg), cache
