"""GPipe-style pipeline schedule (off by default, as in the JAX package):
the port of ``repro/distributed/pipeline.py``.

``pipeline_apply`` runs a layer stack split into S stages over M
microbatches with the classic (S + M - 1)-slot schedule: in each slot every
stage runs its layers on its current input, then stage s hands its output
to stage s + 1; stage 0 takes microbatch t in slot t, and the last stage's
output for microbatch t - S + 1 is final. Slots without a microbatch
(the bubbles) compute on zeros, as the reference's do. On one device this
is exactly the sequential computation in another order, and autograd
differentiates it. The stages run one after another in a Python loop
rather than under ``torch.func.vmap``: the flash kernels are called
through ``ctypes`` and have no vmap rule.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch import nn


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def layer(layers_params: Any, i: int) -> Any:
    """Layer ``i``'s parameters: every leaf of the stacked pytree at ``i``
    (views, so gradients reach the stacked leaves)."""
    return _map(lambda a: a[i], layers_params)


def sequential_apply(layers_params: Any, x: torch.Tensor,
                     block_fn: Callable[[Any, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The plain stack: ``block_fn`` of each layer in order."""
    for i in range(_first_leaf(layers_params).shape[0]):
        x = block_fn(layer(layers_params, i), x)
    return x


def pipeline_apply(layers_params: Any, x: torch.Tensor,
                   block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   n_stages: int, n_micro: int) -> torch.Tensor:
    """Apply a stacked layer pytree (dicts, lists or tuples of tensors with
    a leading ``n_layers`` dim) to x (b, ...) through ``block_fn(layer_params,
    h)``. The stack is split into ``n_stages`` contiguous stages and the
    batch into ``n_micro`` microbatches. Returns the value of
    :func:`sequential_apply`."""
    n_layers = _first_leaf(layers_params).shape[0]
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not divide into {n_stages} stages")
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not divide into {n_micro} microbatches")
    per_stage = n_layers // n_stages
    micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])

    def run_stage(s: int, h: torch.Tensor) -> torch.Tensor:
        for i in range(s * per_stage, (s + 1) * per_stage):
            h = block_fn(layer(layers_params, i), h)
        return h

    zeros = torch.zeros_like(micro[0])
    buf = [zeros] * n_stages  # the input each stage holds, in flight
    out = [None] * n_micro
    for t in range(n_stages + n_micro - 1):
        # stage s takes what stage s - 1 made last slot; stage 0 microbatch t
        incoming = micro[t] if t < n_micro else zeros
        shifted = [incoming] + buf[:-1]
        buf = [run_stage(s, h) for s, h in enumerate(shifted)]
        done = t - (n_stages - 1)
        if 0 <= done < n_micro:
            out[done] = buf[-1]
    return torch.stack(out).reshape(x.shape)


def stack_blocks(blocks) -> Dict[str, torch.Tensor]:
    """The parameters of identical ``nn.Module`` blocks stacked along a
    leading layer dim (``torch.func.stack_module_state``), for
    :func:`pipeline_apply` with :func:`module_block_fn`."""
    params, _ = torch.func.stack_module_state(list(blocks))
    return params


def module_block_fn(template: nn.Module) -> Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor]:
    """``block_fn`` running ``template``'s forward with one layer's
    parameters (``torch.func.functional_call``)."""
    def block_fn(p, h):
        return torch.func.functional_call(template, p, (h,))

    return block_fn
