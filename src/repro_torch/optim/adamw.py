"""AdamW in PyTorch: f32 moments keyed like the parameters (no separate
master copy: the update math runs in f32 and is cast back to the parameter
dtype), as the JAX package's ``optim/adamw.py``.

Parameters and gradients are mappings name -> tensor (an ``nn.Module`` is
taken as its ``named_parameters()``). On a mesh each rank holds its blocks
of the parameters, gradients and moments (``distributed.shard_params``);
the update is elementwise, and only the global norm behind ``grad_clip``
crosses ranks. Where the JAX version returns new
arrays, :func:`apply_updates` updates the parameters and the moments in
place under ``torch.no_grad()``: at glm4-9b's width a second copy of the
f32 moments would not fit beside the first.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..distributed.collectives import all_reduce_sum
from ..distributed.sharding import spec_axes

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32, on the parameters' device
    m: Dict[str, torch.Tensor]  # f32, keyed like the parameters
    v: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def named(params: Params) -> Dict[str, torch.Tensor]:
    """The parameters as an ordered name -> tensor dict."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def init_state(params: Params) -> AdamWState:
    p = named(params)
    device = next(iter(p.values())).device if p else torch.device("cpu")
    zeros = {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device) for n, t in p.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), m=zeros,
                      v={n: z.clone() for n, z in zeros.items()})


def state_from_numpy(step, m: Mapping[str, np.ndarray], v: Mapping[str, np.ndarray],
                     device=None) -> AdamWState:
    """A JAX ``AdamWState`` carried across: the step and the moments as numpy
    arrays keyed by the port's parameter names (see
    ``models.transformer.named_from_numpy``)."""
    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return AdamWState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
                      m={n: put(a) for n, a in m.items()}, v={n: put(a) for n, a in v.items()})


def shard_axes(params: Params) -> Dict[str, Tuple[str, ...]]:
    """name -> the mesh axes its block is split over, for the parameters
    that carry a spec (``distributed.shard_params``)."""
    return {n: spec_axes(t.shard_spec) for n, t in named(params).items()
            if getattr(t, "shard_spec", None) is not None}


def global_norm(tree: Params, axes: Optional[Mapping[str, Tuple[str, ...]]] = None) -> torch.Tensor:
    """sqrt of the f32 sum of squares over every leaf. With ``axes`` (name
    -> the mesh axes a leaf is split over, :func:`shard_axes`) the leaves
    are this rank's blocks: the sums of squares of the leaves split over the
    same axes are added, then summed over those axes, so a leaf counts once
    however many ranks hold a replica of it."""
    leaves = named(tree)
    if not axes:
        total = sum(torch.sum(torch.square(x.float())) for x in leaves.values())
        return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
    sums: Dict[Tuple[str, ...], torch.Tensor] = {}
    for n, x in leaves.items():
        key = tuple(sorted(axes.get(n, ())))
        part = torch.sum(torch.square(x.float()))
        sums[key] = sums[key] + part if key in sums else part
    total = sum(all_reduce_sum(sums[key], key) for key in sorted(sums))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def apply_updates(params: Params, grads: Mapping[str, torch.Tensor], state: AdamWState,
                  cfg: AdamWConfig, lr_scale: Union[torch.Tensor, float] = 1.0) -> AdamWState:
    """One AdamW step: global-norm clip (the norm of the whole model on a
    mesh), bias-corrected moments, decoupled weight decay on every leaf. Updates ``params`` and the state's moments
    in place; returns the state with its step advanced."""
    p = named(params)
    gn = global_norm(grads, shard_axes(p))
    clip = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    step = state.step + 1
    stepf = step.float()
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=step.device)
    with torch.no_grad():
        for name, w in p.items():
            g = grads[name].float() * clip
            m, v = state.m[name], state.v[name]
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            wf = w.float()
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * wf
            w.copy_((wf - lr * delta).to(w.dtype))
    return AdamWState(step=step, m=state.m, v=state.v)
