"""The port's GPipe-style pipeline schedule (``repro_torch.distributed.
pipeline``) against the JAX package's ``pipeline_apply`` and against the
port's sequential stack: the four schedules of ``tests/test_pipeline.py``,
the gradients against ``jax.grad``, and ``nn.Module`` blocks stacked with
``torch.func.stack_module_state``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.pipeline import pipeline_apply as jax_pipeline_apply
from repro_torch.configs import get_arch, reduce
from repro_torch.distributed.pipeline import (module_block_fn, pipeline_apply, sequential_apply,
                                              stack_blocks)
from repro_torch.models import build_model
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)

TOL = 1e-5  # f32, the same arithmetic in another order of microbatches
GRAD_TOL = 1e-5


def _jax_block(layer_p, h):
    return jnp.tanh(h @ layer_p["w"]) + h


def _block(layer_p, h):
    return torch.tanh(h @ layer_p["w"]) + h


def _inputs(seed, n_layers, b, d):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((n_layers, d, d)) * 0.1).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32))


@pytest.mark.parametrize("n_stages,n_micro", [(2, 2), (4, 2), (2, 4), (1, 1)])
def test_pipeline_matches_reference_and_sequential(n_stages, n_micro):
    w, x = _inputs(0, 8, 8, 16)
    want = jax_pipeline_apply({"w": jnp.asarray(w)}, jnp.asarray(x), _jax_block, n_stages=n_stages,
                              n_micro=n_micro)
    params = {"w": torch.from_numpy(w)}
    got = pipeline_apply(params, torch.from_numpy(x), _block, n_stages=n_stages, n_micro=n_micro)
    seq = sequential_apply(params, torch.from_numpy(x), _block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), atol=TOL)


@pytest.mark.parametrize("n_stages,n_micro", [(2, 2), (4, 2), (2, 4), (1, 1)])
def test_pipeline_grads_match_jax_grad(n_stages, n_micro):
    w, x = _inputs(1, 4, 4, 8)
    gw, gx = jax.grad(lambda p, xx: jnp.sum(jax_pipeline_apply(p, xx, _jax_block, n_stages, n_micro) ** 2),
                      argnums=(0, 1))({"w": jnp.asarray(w)}, jnp.asarray(x))
    wt = torch.from_numpy(w).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    loss = torch.sum(pipeline_apply({"w": wt}, xt, _block, n_stages, n_micro) ** 2)
    dw, dx = torch.autograd.grad(loss, (wt, xt))
    assert torch.isfinite(dw).all()
    np.testing.assert_allclose(dw.numpy(), np.asarray(gw["w"]), atol=GRAD_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx), atol=GRAD_TOL)


def test_pipeline_rejects_uneven_splits():
    w, x = _inputs(2, 6, 6, 8)
    with pytest.raises(ValueError, match="stages"):
        pipeline_apply({"w": torch.from_numpy(w)}, torch.from_numpy(x), _block, 4, 2)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply({"w": torch.from_numpy(w)}, torch.from_numpy(x), _block, 2, 4)


@pytest.mark.parametrize("n_stages,n_micro", [(2, 2), (1, 4)])
def test_pipeline_over_transformer_blocks(n_stages, n_micro):
    """Reduced glm4-9b blocks (nn.Modules) stacked with ``stack_module_state``:
    the pipeline's output and its gradients (stacked weights and input)
    equal the sequential stack's; the attention runs through
    ``ops.flash_attention``'s plain version."""
    cfg = dataclasses.replace(reduce(get_arch("glm4-9b")), n_layers=4)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    stacked = {n: t.detach().requires_grad_() for n, t in stack_blocks(params.blocks).items()}
    fn = module_block_fn(params.blocks[0])
    x = torch.randn(4, 16, cfg.d_model, generator=torch.Generator().manual_seed(1)).requires_grad_()

    def run(apply):
        out = apply()
        grads = torch.autograd.grad(out.square().mean(), [x] + list(stacked.values()))
        return out.detach(), grads

    want, want_g = run(lambda: sequential_apply(stacked, x, fn))
    got, got_g = run(lambda: pipeline_apply(stacked, x, fn, n_stages, n_micro))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-4)
