"""Unified model API: one entry point per family.

``build_model(cfg, device)`` returns a ``Model`` whose methods mirror the
JAX package's ``repro.models.api.Model``:
    init(generator) -> params                         (weights on the model's device)
    prefill(params, batch) -> (last-token logits, cache)
    decode(params, cache, tokens, pos) -> (logits, cache)
    init_cache(batch, seq_len) -> cache
Only the dense family is ported; the training loss comes with training.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import transformer

_FAMILIES = {"dense": transformer}
_NOT_PORTED = ("moe", "ssm", "hybrid", "encdec")


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    module: Any
    device: torch.device

    def init(self, generator: torch.Generator):
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        return self.module.init_params(generator, self.cfg)

    def prefill(self, params, batch):
        return self.module.prefill(params, batch, self.cfg)

    def decode(self, params, cache, tokens, pos: int):
        return self.module.decode_step(params, cache, tokens, pos, self.cfg)

    def init_cache(self, batch: int, seq_len: int):
        return self.module.init_cache(self.cfg, batch, seq_len, self.device)


def build_model(cfg: ArchConfig, device: Optional[Union[str, torch.device]] = None) -> Model:
    """The model of ``cfg`` on ``device`` (the GPU when None)."""
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to PyTorch yet (see ROADMAP.md)")
    return Model(cfg=cfg, module=_FAMILIES[cfg.family], device=resolve_device(device))
