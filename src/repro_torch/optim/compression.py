"""Gradient compression (the JAX package's ``optim/compression.py``):

* ``bf16``    — gradients rounded to bf16 and back (half the wire bytes);
* ``int8_ef`` — per-tensor-scaled int8 with error feedback: the rounding
  residual is carried to the next step, so the compressed estimator stays
  unbiased over time.

Each is written as quantise then dequantise, which is exact on one host.
Gradients are mappings name -> tensor; the error-feedback state is f32 and
keyed alike. On a mesh the gradients are each rank's blocks: ``int8_ef``'s
scale is then the leaf's global max (an all-reduce of the max over the axes
the leaf is split on), as the reference's global arrays give it; ``bf16``
is elementwise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

from ..distributed.collectives import all_reduce_max


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"  # none | bf16 | int8_ef


def _quant_int8(g: torch.Tensor, axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """Scale max|g| / 127 (the max over the mesh ``axes`` that ``g`` is a
    block of), rounded half to even (``torch.round``, as ``jnp.round``),
    clipped to [-127, 127], dequantised."""
    scale = torch.clamp(all_reduce_max(torch.max(torch.abs(g)), axes), min=1e-12) / 127.0
    return torch.clamp(torch.round(g / scale), -127, 127) * scale


def compress_grads(grads: Mapping[str, torch.Tensor], ef_state: Optional[Mapping[str, torch.Tensor]],
                   cfg: CompressionConfig, axes: Optional[Mapping[str, Tuple[str, ...]]] = None
                   ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
    """The compressed gradients and the next error-feedback state. ``axes``:
    name -> the mesh axes a leaf is split over (``adamw.shard_axes``)."""
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
            out[n] = _quant_int8(target, (axes or {}).get(n, ()))
            resid[n] = target - out[n]
        return out, resid
    raise ValueError(cfg.kind)
