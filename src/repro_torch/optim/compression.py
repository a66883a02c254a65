"""Gradient compression (the JAX package's ``optim/compression.py``):

* ``bf16``    — gradients rounded to bf16 and back (half the wire bytes);
* ``int8_ef`` — per-tensor-scaled int8 with error feedback: the rounding
  residual is carried to the next step, so the compressed estimator stays
  unbiased over time.

One device needs no all-reduce, so each is written as quantise then
dequantise, which is exact on one host. Gradients are mappings name ->
tensor; the error-feedback state is f32 and keyed alike.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"  # none | bf16 | int8_ef


def _quant_int8(g: torch.Tensor) -> torch.Tensor:
    """Scale max|g| / 127, rounded half to even (``torch.round``, as
    ``jnp.round``), clipped to [-127, 127], dequantised."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    return torch.clamp(torch.round(g / scale), -127, 127) * scale


def compress_grads(grads: Mapping[str, torch.Tensor], ef_state: Optional[Mapping[str, torch.Tensor]],
                   cfg: CompressionConfig
                   ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
    if cfg.kind == "none":
        return dict(grads), ef_state
    if cfg.kind == "bf16":
        return {n: g.to(torch.bfloat16).float() for n, g in grads.items()}, ef_state
    if cfg.kind == "int8_ef":
        if ef_state is None:
            raise ValueError("int8_ef needs an error-feedback state")
        out, resid = {}, {}
        for n, g in grads.items():
            target = g.float() + ef_state[n]
            out[n] = _quant_int8(target)
            resid[n] = target - out[n]
        return out, resid
    raise ValueError(cfg.kind)
