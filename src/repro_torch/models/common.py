"""Shared model components: RMSNorm, RoPE, GQA attention (full sequence,
cross-attention, prefill and one decode step against a KV cache), SwiGLU
MLP, embedding, LM head, the token-chunked LM loss, and the loading of the
JAX package's parameters by name.

On a mesh (:func:`parallel_context`) training runs in the Megatron style
over the reference's logical axes: ``wq``/``wk``/``wv``/``w_gate``/``w_up``
column-parallel over heads / kv heads / ff, ``wo``/``w_down`` row-parallel,
the QKV biases split on heads, a vocab-parallel embedding and a
vocab-parallel cross-entropy (:func:`attention_tp`, :func:`embed_tp`,
:func:`lm_loss_tp`); :class:`Parallel` says where the collectives go.

Plain functions on tensors, in the JAX package's order of casts (the tests
hold them against ``repro/models/common.py``), and the ``nn.Module``s that
hold the weights. Weights keep the JAX layout, ``(in, out)``, so a product is
``x @ w``. bf16 products accumulate in f32 on the card, as XLA's do
(:func:`repro_torch.device.resolve_device` pins it).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..distributed import collectives as col
from ..distributed.sharding import current_rules, spec_axes
from ..kernels import ops


def act_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def empty_weight(*shape, dtype, device) -> nn.Parameter:
    """An uninitialised weight (filled by ``init_params`` or
    ``params_from_numpy``), without a gradient until the trainer asks for
    one (``params.requires_grad_()``)."""
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
    """GQA projections ``wq`` (d_in, h*hd), ``wk``/``wv`` (d_in, kv*hd),
    ``wo`` (h*hd, d), and the QKV biases where the config has them. ``d_in``
    is d_model unless given (zamba2's shared block reads 2 d_model)."""

    def __init__(self, cfg: ArchConfig, device: torch.device, d_in: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        d, hd, h, kv, dt = d_in or cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, act_dtype(cfg)
        self.wq = empty_weight(d, h * hd, dtype=dt, device=device)
        self.wk = empty_weight(d, kv * hd, dtype=dt, device=device)
        self.wv = empty_weight(d, kv * hd, dtype=dt, device=device)
        self.wo = empty_weight(h * hd, cfg.d_model, dtype=dt, device=device)
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


def _project_q(p: Attention, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    q = x @ p.wq
    return q + p.bq if cfg.qkv_bias else q


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                 use_rope: bool = True):
    """(b, s, d) -> q (b, s, h, hd), k and v (b, s, kv, hd), RoPE on q and k
    unless ``use_rope`` is False."""
    b, s, _ = x.shape
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, cfg.n_heads, cfg.hd)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, cfg.n_kv_heads, cfg.hd)


def _positions(b: int, s: int, device: torch.device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def attention(p: Attention, x: torch.Tensor, cfg: ArchConfig, *, causal: bool = True,
              use_rope: bool = True,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill) at positions 0 .. s - 1.
    ``kv_override`` = (k, v) of another sequence (b, sk, kv, hd) is
    cross-attention: only q is projected from x (the JAX package projects
    k and v too and drops them)."""
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    if kv_override is not None:
        q = _project_q(p, x, cfg).reshape(b, s, cfg.n_heads, cfg.hd)
        if use_rope:
            q = rope(q, positions, cfg.rope_theta)
        k, v = kv_override
    else:
        q, k, v = _project_qkv(p, x, cfg, positions, use_rope)
    out = ops.flash_attention(q, k, v, causal=causal, window=cfg.window)
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
                     cfg: ArchConfig, pos: int, *, update_cache: bool = True,
                     use_rope: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: x (b, d) at position ``pos`` against the cache (a
    ring buffer for a sliding-window config). Writes the new K/V into slot
    ``pos % s_cache`` (window) or ``min(pos, s_cache - 1)``, in place, and
    returns the output and the same cache. ``update_cache=False`` reads the
    cache as it is (cross-attention over an encoder's K/V): k and v are not
    projected. Plain PyTorch: the einsums over the cache are not a kernel of
    the JAX package either."""
    b, _ = x.shape
    hd, h, kv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    ck, cv = cache["k"], cache["v"]
    s_cache = ck.shape[1]
    posb = torch.full((b, 1), pos, device=x.device)
    q = _project_q(p, x, cfg).reshape(b, 1, h, hd)
    if use_rope:
        q = rope(q, posb, cfg.rope_theta)
    if update_cache:
        k_new, v_new = x @ p.wk, x @ p.wv
        if cfg.qkv_bias:
            k_new, v_new = k_new + p.bk, v_new + p.bv
        k_new = k_new.reshape(b, 1, kv, hd)
        if use_rope:
            k_new = rope(k_new, posb, cfg.rope_theta)
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
def init_embed_(params, generator: torch.Generator) -> None:
    """The JAX package's ``init_embed``: embedding normal 0.02, head (unless
    tied) normal ``d ** -0.5``."""
    dense_init_(params.embed, generator, scale=0.02)
    if params.head is not None:
        dense_init_(params.head, generator)


def named_embed(cfg: ArchConfig, tree: Mapping) -> Dict[str, np.ndarray]:
    """The embedding, head (unless tied) and final norm of a JAX parameter
    pytree under the port's names."""
    out = {"embed": tree["embed"], "final_norm.scale": tree["final_norm"]["scale"]}
    if not cfg.tie_embeddings:
        out["head"] = tree["head"]
    return out


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens]


def lm_logits(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Logits over the padded vocabulary (``cfg.vocab_padded`` columns)."""
    w = params.head if not cfg.tie_embeddings else params.embed.T
    return x @ w


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy; logits (..., V) of any float dtype, reductions in f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    true = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - true)


def lm_loss(params, x: torch.Tensor, labels: torch.Tensor, cfg: ArchConfig,
            chunk_tokens: int = 8192) -> torch.Tensor:
    """Token-chunked LM cross-entropy (``repro/models/common.py::lm_loss``):
    the (tokens, vocab_padded) f32 logits exist one chunk at a time, in the
    forward and in the backward (each chunk is checkpointed, so the backward
    recomputes its logits). The chunks' summed losses are added in chunk
    order and divided by the token count."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    lt = labels.reshape(t).long()
    n_chunks = max(1, t // chunk_tokens)
    while t % n_chunks:
        n_chunks -= 1
    size = t // n_chunks

    def chunk_loss(xi, li):
        lf = lm_logits(params, xi, cfg).float()
        lse = torch.logsumexp(lf, dim=-1)
        true = torch.gather(lf, 1, li[:, None])[:, 0]
        return torch.sum(lse - true)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        xi, li = xt[i * size:(i + 1) * size], lt[i * size:(i + 1) * size]
        part = (checkpoint(chunk_loss, xi, li, use_reentrant=False) if torch.is_grad_enabled()
                else chunk_loss(xi, li))
        total = total + part
    return total / t


# ---------------------------------------------------------------------------
# the JAX package's parameters
# ---------------------------------------------------------------------------
def load_named_(params: nn.Module, named: Mapping[str, np.ndarray]) -> nn.Module:
    """Copies ``named`` (the port's parameter names -> arrays, as each
    family's ``named_from_numpy`` gives them) into ``params``, every one of
    its parameters, casting to its dtype."""
    with torch.no_grad():
        for name, dst in params.named_parameters():
            src = np.asarray(named[name], dtype=np.float32)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {src.shape} does not fit {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(src))
    return params


# ---------------------------------------------------------------------------
# tensor parallelism on a mesh
# ---------------------------------------------------------------------------
#: weights whose model-axis block each rank multiplies by (column- or
#: row-parallel, or the vocab-parallel embedding and head)
TP_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "embed", "head")


@dataclasses.dataclass(frozen=True)
class Parallel:
    """What one rank computes on a mesh: its ``comm``, the model axis's size
    ``m`` and this rank's index ``r`` on it, the data-parallel axes ``dp``
    (of total size ``dp_size``), and the rules' placement of the activations:
    ``sp`` (the residual stream's sequence split over model, "seq_act"),
    ``heads`` and ``kv_heads`` (q and k/v heads split over model; a head
    axis that does not divide falls back to replicated, as the reference's
    ``constrain`` does)."""

    comm: object
    m: int
    r: int
    dp: Tuple[str, ...]
    dp_size: int
    sp: bool
    heads: bool
    kv_heads: bool

    def use(self, w: torch.Tensor, partial: bool = False) -> torch.Tensor:
        """A parameter as the step uses it: its FSDP blocks all-gathered over
        the data-parallel axes (whose backward reduce-scatters the
        gradient), and its gradient summed over the data-parallel axes it is
        replicated on, and over ``model`` when ``partial`` (a parameter
        replicated over model that meets activations split along it)."""
        spec = getattr(w, "shard_spec", None)
        for dim, entry in enumerate(spec or ()):
            dp = tuple(a for a in spec_axes((entry,)) if a in col.DP_AXES)
            if dp:  # the rules never split one dim over data and model axes together
                w = col.all_gather(w, dp, dim, self.comm)
        split = spec_axes(spec)
        rep = tuple(a for a in self.dp if a not in split)
        if partial and "model" not in split:
            rep += ("model",)
        return col.copy_to(w, rep, self.comm)

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        """Into a tensor-parallel region: the sequence all-gathered under
        ``sp``, else the identity with the gradient summed over model."""
        return (col.all_gather(h, "model", 1, self.comm) if self.sp
                else col.copy_to(h, "model", self.comm))

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """Out of one: the partial sums reduce-scattered along the sequence
        under ``sp``, else all-reduced."""
        return (col.reduce_scatter(y, "model", 1, self.comm) if self.sp
                else col.all_reduce(y, "model", self.comm))


#: rules -> {(b, s, cfg): Parallel}: a layout is worked out (and its
#: fallbacks recorded) once a shape, as the reference traces once a shape
_LAYOUTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def parallel_context(b: int, s: int, cfg: ArchConfig) -> Optional[Parallel]:
    """The :class:`Parallel` of a rank that holds ``b`` rows of ``s`` tokens
    under the active rules (``sharding.use_rules``); None on one device.
    The placement of the residual stream and of the q and k/v heads is the
    rules' spec of those activations at the global batch (a fallback is
    recorded in the rules, as the reference's ``constrain`` records it)."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return None
    comm = col.comm_for(rules.mesh)
    if comm.backend == "none":
        return None
    known = _LAYOUTS.setdefault(rules, {})
    if (b, s, cfg) not in known:
        known[(b, s, cfg)] = _layout(rules, comm, b, s, cfg)
    return known[(b, s, cfg)]


def _layout(rules, comm, b: int, s: int, cfg: ArchConfig) -> Parallel:
    dp = comm.axes(col.DP_AXES)
    batch = b * comm.size(dp)

    def on_model(axes, shape):
        return "model" in spec_axes(rules.spec(axes, shape))

    return Parallel(
        comm=comm, m=comm.size("model"), r=comm.index("model"), dp=dp, dp_size=comm.size(dp),
        sp=on_model(("batch", "seq_act", None), (batch, s, cfg.d_model)),
        heads=on_model(("batch", None, "heads", None), (batch, s, cfg.n_heads, cfg.hd)),
        kv_heads=on_model(("batch", None, "kv_heads", None), (batch, s, cfg.n_kv_heads, cfg.hd)))


def check_tp_layout(params: nn.Module, par: Parallel) -> None:
    """Every tensor-parallel weight must be split over model: the port has
    no layout for one that falls back to replicated there."""
    if par.m == 1:
        return
    for name, p in params.named_parameters():
        if name.rsplit(".", 1)[-1] in TP_WEIGHTS and "model" not in spec_axes(getattr(p, "shard_spec", None)):
            raise NotImplementedError(f"{name} {tuple(p.shape)} is not split over model "
                                      f"({getattr(p, 'shard_spec', None)}); the port's tensor "
                                      "parallelism needs it split")


def _rank_kv_heads(k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig, par: Parallel):
    """The k/v heads that this rank's q heads read, when the q heads are
    split over model and the kv heads are not: rank r holds q heads
    [r hl, (r + 1) hl), which read kv heads (r hl) // g onwards (g q heads a
    kv head)."""
    hl = cfg.n_heads // par.m
    g = cfg.n_heads // cfg.n_kv_heads
    lo = par.r * hl
    if g % hl == 0:
        n = 1
    elif hl % g == 0 and lo % g == 0:
        n = hl // g
    else:
        raise NotImplementedError(f"{hl} q heads a rank over groups of {g}")
    k0 = lo // g
    return k[:, :, k0:k0 + n], v[:, :, k0:k0 + n]


def attention_tp(p, x: torch.Tensor, cfg: ArchConfig, par: Parallel) -> torch.Tensor:
    """Causal self-attention of one rank at positions 0 .. s - 1: ``x``
    (b, s, d) is the whole sequence (the tensor-parallel region's input),
    ``p`` holds this rank's column blocks of ``wq``/``wk``/``wv`` (and the
    biases) and row block of ``wo``. Returns the rank's partial sum of the
    output (b, s, d), which :meth:`Parallel.exit` reduces. The flash kernels
    run on the rank's own q heads; kv heads that do not split are gathered
    and the rank's group sliced out; q heads that do not split are gathered
    whole, and the rank's block of the output multiplies its ``wo`` rows."""
    b, s, _ = x.shape
    hd = cfg.hd
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if not par.heads:
        q = col.all_gather(q, "model", 2, par.comm)
    if not par.kv_heads:
        k = col.all_gather(k, "model", 2, par.comm)
        v = col.all_gather(v, "model", 2, par.comm)
    q, k, v = (t.reshape(b, s, -1, hd) for t in (q, k, v))
    if par.heads and not par.kv_heads:
        k, v = _rank_kv_heads(k, v, cfg, par)
    positions = _positions(b, s, x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=True, window=cfg.window).reshape(b, s, -1)
    if not par.heads:
        rows = p.wo.shape[0]
        out = out[..., par.r * rows:(par.r + 1) * rows]
    return out @ p.wo


def embed_tp(table: torch.Tensor, tokens: torch.Tensor, par: Parallel) -> torch.Tensor:
    """The vocab-parallel embedding: ``table`` is this rank's block of rows;
    tokens outside it take zeros, and the rows are summed over model
    (reduce-scattered along the sequence under ``sp``)."""
    rows = table.shape[0]
    local = tokens - par.r * rows
    inside = (local >= 0) & (local < rows)
    e = table[torch.where(inside, local, 0)] * inside[..., None].to(table.dtype)
    return par.exit(e)


def lm_loss_tp(head: torch.Tensor, x: torch.Tensor, labels: torch.Tensor, cfg: ArchConfig,
               par: Parallel, chunk_tokens: int = 8192) -> torch.Tensor:
    """:func:`lm_loss` with a vocab-parallel head: ``head`` is this rank's
    column block (d, V / m), ``x`` the whole sequence of this rank's rows.
    A chunk's log-sum-exp is the global max (an all-reduce of the max) plus
    the log of the summed exponentials, and its true logit a masked gather,
    each summed over model; each chunk is checkpointed as in
    :func:`lm_loss`. The loss is the global token mean: this rank's sum over
    all data-parallel ranks' tokens, summed over the data-parallel axes."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    lt = labels.reshape(t).long()
    n_chunks = max(1, t // chunk_tokens)
    while t % n_chunks:
        n_chunks -= 1
    size = t // n_chunks
    cols = head.shape[1]
    lo = par.r * cols

    def chunk_loss(xi, li):
        lf = (xi @ head).float()
        top = col.all_reduce_max(lf.amax(dim=-1), "model", par.comm)
        total = col.all_reduce(torch.exp(lf - top[:, None]).sum(dim=-1), "model", par.comm)
        lse = torch.log(total) + top
        local = li - lo
        inside = (local >= 0) & (local < cols)
        true = torch.gather(lf, 1, torch.where(inside, local, 0)[:, None])[:, 0] * inside
        true = col.all_reduce(true, "model", par.comm)
        return torch.sum(lse - true)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        xi, li = xt[i * size:(i + 1) * size], lt[i * size:(i + 1) * size]
        part = (checkpoint(chunk_loss, xi, li, use_reentrant=False) if torch.is_grad_enabled()
                else chunk_loss(xi, li))
        total = total + part
    return col.all_reduce(total / (t * par.dp_size), par.dp, par.comm)
