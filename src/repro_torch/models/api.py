"""Unified model API: one entry point per family.

``build_model(cfg, device, remat=)`` returns a ``Model`` whose methods mirror
the JAX package's ``repro.models.api.Model``:
    init(generator) -> params                         (weights on the model's device)
    loss(params, batch) -> scalar                     (train objective, ``remat`` policy)
    prefill(params, batch) -> (last-token logits, cache)
    decode(params, cache, tokens, pos) -> (logits, cache)
    init_cache(batch, seq_len) -> cache
for the five families: dense, moe, ssm (Mamba2), hybrid (Zamba2) and encdec.
A batch is ``{"tokens"}``, or ``{"src_embeds", "tgt_tokens"}`` for encdec.
``prefill`` and ``decode`` run under ``torch.inference_mode``: serving
records no gradient, so no block goes through ``torch.utils.checkpoint``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Union

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..distributed.sharding import shard_params
from . import encdec, mamba2, moe, transformer, zamba2

_FAMILIES = {
    "dense": transformer,
    "moe": moe,
    "ssm": mamba2,
    "hybrid": zamba2,
    "encdec": encdec,
}


#: family -> the ``nn.Module`` class of its weights
_PARAMS_CLASS = {"dense": "Transformer", "moe": "MoETransformer", "ssm": "Mamba2",
                 "hybrid": "Zamba2", "encdec": "EncDec"}


def family_module(cfg: ArchConfig):
    """The module of ``cfg.family``; an unknown family raises ``ValueError``."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; one of {sorted(_FAMILIES)}")
    return _FAMILIES[cfg.family]


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    module: Any
    device: torch.device
    remat: str = "dots"

    def init(self, generator: torch.Generator):
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        return self.module.init_params(generator, self.cfg)

    def loss(self, params, batch):
        return self.module.loss_fn(params, batch, self.cfg, remat=self.remat)

    @torch.inference_mode()
    def prefill(self, params, batch):
        return self.module.prefill(params, batch, self.cfg)

    @torch.inference_mode()
    def decode(self, params, cache, tokens, pos: int):
        return self.module.decode_step(params, cache, tokens, pos, self.cfg)

    def init_cache(self, batch: int, seq_len: int):
        return self.module.init_cache(self.cfg, batch, seq_len, self.device)


def build_model(cfg: ArchConfig, device: Optional[Union[str, torch.device]] = None,
                remat: str = "dots") -> Model:
    """The model of ``cfg`` on ``device`` (the GPU when None), its loss under
    the ``remat`` policy (``transformer.REMAT_POLICIES``)."""
    module = family_module(cfg)
    if remat not in transformer.REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; one of {sorted(transformer.REMAT_POLICIES)}")
    return Model(cfg=cfg, module=module, device=resolve_device(device), remat=remat)


def meta_params(cfg: ArchConfig) -> torch.nn.Module:
    """``cfg``'s weights on the ``meta`` device: every parameter's shape and
    dtype, no storage and no values (the dry-run's)."""
    return getattr(family_module(cfg), _PARAMS_CLASS[cfg.family])(cfg, torch.device("meta"))


def named_from_numpy(cfg: ArchConfig, tree: Mapping) -> dict:
    """A JAX parameter pytree of ``cfg``'s family (or one shaped like it:
    gradients, AdamW moments) as numpy arrays keyed by the port's parameter
    names."""
    return family_module(cfg).named_from_numpy(cfg, tree)


def params_from_numpy(cfg: ArchConfig, np_params: Mapping,
                      shardings: Optional[Mapping] = None) -> torch.nn.Module:
    """The port's weights of ``cfg``'s family, on the CPU, holding the JAX
    package's parameters (its ``init_params`` pytree as numpy arrays). With
    ``shardings`` (``distributed.params_sharding``'s ``{name:
    NamedSharding}``) each parameter is this rank's block of it
    (``distributed.shard_params``)."""
    params = family_module(cfg).params_from_numpy(cfg, np_params)
    return params if shardings is None else shard_params(params, shardings)
