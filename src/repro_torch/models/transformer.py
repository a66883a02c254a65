"""Dense decoder-only transformer (GQA, RoPE, SwiGLU, optional QKV bias,
optional sliding window): glm4-9b, deepseek-67b, internlm2-20b, qwen2.5-32b
and chameleon-34b. The port of ``repro/models/transformer.py``:
``init_params``, ``forward`` with its remat policies, ``loss_fn``,
``prefill``, ``decode_step``, ``init_cache`` and ``cache_len_for``.

The layer stack is a Python loop over ``Block`` modules where JAX scans
stacked parameters; KV caches keep the JAX layout, stacked
``(n_layers, b, s, kv, hd)``, so the tests compare like with like.

Training on a mesh (rules with a mesh of several devices in force, the
parameters cut by ``distributed.shard_params``): each block all-gathers its
FSDP blocks over ``("pod", "data")`` on entry, inside its remat call, so the
recomputation gathers them again and the gathers' backward reduce-scatters
the gradients; inside the block the attention and the MLP are tensor
parallel (``common.attention_tp``, ``common.Parallel``), and the loss is
vocab-parallel (``common.lm_loss_tp``).
"""
from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from . import common as cm

_aten = torch.ops.aten
# matrix products as they reach the dispatcher: ``x @ w`` of a 2-D weight is
# ``mm``/``addmm`` after a reshape; einsums with a batch dim are ``bmm``
_DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default)
_DOTS_NO_BATCH = (_aten.mm.default, _aten.addmm.default)


def _saving(ops):
    """Selective checkpointing that keeps the outputs of ``ops`` and
    recomputes everything else of the block in the backward."""
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


#: remat policy name -> what each block keeps for its backward, with the JAX
#: package's meanings (``repro/models/transformer.py:18``): "everything"
#: (None here) recomputes nothing; "none" (``jax.checkpoint`` without a
#: policy) and "nothing" recompute the whole block; "dots" keeps the matrix
#: products; "dots_no_batch" only those without batch dimensions. A callable
#: is the ``context_fn`` of ``torch.utils.checkpoint``. No policy changes a
#: value: each recomputes the same operations on the same inputs.
REMAT_POLICIES = {
    "none": torch.utils.checkpoint.noop_context_fn,
    "dots": _saving(_DOTS),
    "dots_no_batch": _saving(_DOTS_NO_BATCH),
    "nothing": torch.utils.checkpoint.noop_context_fn,
    "everything": None,
}


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
    cm.init_embed_(p, generator)
    for blk in p.blocks:
        blk.attn.init_(generator)
        blk.mlp.init_(generator)
    for norm in [p.final_norm] + [n for blk in p.blocks for n in (blk.attn_norm, blk.mlp_norm)]:
        norm.scale.fill_(1.0)
    return p


def named_from_numpy(cfg: ArchConfig, tree: Mapping) -> Dict[str, np.ndarray]:
    """A JAX parameter pytree (or one shaped like it: gradients, AdamW
    moments) as numpy arrays keyed by the port's parameter names
    (``Transformer.named_parameters()``), the stacked layer leaves split
    per block."""
    out = cm.named_embed(cfg, tree)
    layers = tree["layers"]
    attn = ("wq", "wk", "wv", "wo") + (("bq", "bk", "bv") if cfg.qkv_bias else ())
    for i in range(cfg.n_layers):
        out[f"blocks.{i}.attn_norm.scale"] = layers["attn_norm"]["scale"][i]
        for name in attn:
            out[f"blocks.{i}.attn.{name}"] = layers["attn"][name][i]
        out[f"blocks.{i}.mlp_norm.scale"] = layers["mlp_norm"]["scale"][i]
        for name in ("w_gate", "w_up", "w_down"):
            out[f"blocks.{i}.mlp.{name}"] = layers["mlp"][name][i]
    return {k: np.asarray(v) for k, v in out.items()}


def params_from_numpy(cfg: ArchConfig, np_params: Mapping) -> Transformer:
    """The port's weights, on the CPU, holding the JAX package's parameters:
    the nested dict of ``repro.models.transformer.init_params`` as numpy
    arrays, with stacked ``(n_layers, ...)`` layer leaves and ``(in, out)``
    weights."""
    return cm.load_named_(Transformer(cfg, torch.device("cpu")), named_from_numpy(cfg, np_params))


def remat_call(fn, *args, remat: str):
    """``fn(*args)``; where a gradient is being recorded, under
    ``torch.utils.checkpoint`` with the ``remat`` policy (see
    :data:`REMAT_POLICIES`), as the JAX package wraps a block in
    ``jax.checkpoint``."""
    context_fn = REMAT_POLICIES[remat]
    if context_fn is None or not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)


def _block_tp(blk: Block, x: torch.Tensor, cfg: ArchConfig, par: cm.Parallel) -> torch.Tensor:
    """One block on a mesh: its weights gathered (``Parallel.use``; the norm
    scales' gradients summed over model when the residual stream is split
    along the sequence), then the tensor-parallel attention and MLP, each
    between :meth:`~common.Parallel.enter` and :meth:`~common.Parallel.exit`."""
    w = {n: par.use(p, partial=par.sp and n.endswith("norm.scale")) for n, p in blk.named_parameters()}
    attn = SimpleNamespace(**{n[5:]: t for n, t in w.items() if n.startswith("attn.")})
    mlp = SimpleNamespace(**{n[4:]: t for n, t in w.items() if n.startswith("mlp.")})
    h = cm.rms_norm(x, w["attn_norm.scale"])
    x = x + par.exit(cm.attention_tp(attn, par.enter(h), cfg, par))
    h = cm.rms_norm(x, w["mlp_norm.scale"])
    return x + par.exit(cm.mlp(mlp, par.enter(h)))


def forward(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig,
            remat: str = "dots") -> torch.Tensor:
    """tokens (b, s) -> final hidden states (b, s, d), each block under
    :func:`remat_call`. On a mesh: this rank's rows, and (b, s / model, d)
    when the rules split the residual stream's sequence."""
    return _forward(params, tokens, cfg, remat, cm.parallel_context(*tokens.shape, cfg))


def _forward(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig, remat: str,
             par: Optional[cm.Parallel]) -> torch.Tensor:
    if par is None:
        x = cm.embed(params, tokens)
        for blk in params.blocks:
            x = remat_call(blk, x, remat=remat)
        return cm.rms_norm(x, params.final_norm.scale)
    cm.check_tp_layout(params, par)
    x = cm.embed_tp(par.use(params.embed), tokens, par)
    block = functools.partial(_block_tp, cfg=cfg, par=par)
    for blk in params.blocks:
        x = remat_call(block, blk, x, remat=remat)
    return cm.rms_norm(x, par.use(params.final_norm.scale, partial=par.sp))


def loss_fn(params: Transformer, batch: Mapping[str, torch.Tensor], cfg: ArchConfig,
            remat: str = "dots") -> torch.Tensor:
    """Next-token cross-entropy of ``batch["tokens"]`` (b, s + 1); on a mesh
    the global token mean over every data-parallel rank's rows."""
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    par = cm.parallel_context(*inp.shape, cfg)
    x = _forward(params, inp, cfg, remat, par)
    if par is None:
        return cm.lm_loss(params, x, labels, cfg)
    if cfg.tie_embeddings:
        raise NotImplementedError("tied embeddings on a mesh")
    return cm.lm_loss_tp(par.use(params.head), par.enter(x), labels, cfg, par)


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
