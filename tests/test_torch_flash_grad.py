"""The flash attention gradient of the port on the CPU: the plain backward
(``flash_attention_bwd_torch``, the contract of the CUDA backward kernel)
and the forward's log-sum-exp against the JAX package's block-scanned flash
(``repro.kernels.flash_xla``, its custom VJP ``_bwd``) at blocks smaller
than the sequences, so that its padding is exercised; the plain backward
against autograd of the plain forward; and ``ops.flash_attention``'s
gradient path for CPU tensors; the bf16 kernel's launch plan and which
strides it reads as they lie. The CUDA kernels are held to the same plain
versions on the card by ``test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_xla
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (_tma_ready, bwd_plan,
                                                 flash_attention_bwd_torch,
                                                 flash_attention_lse_torch,
                                                 flash_attention_torch)
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)

# (b, sq, sk, hq, hkv, dh, causal, window): GQA groups of 1, 2 and 4,
# causal and bidirectional, windows, fewer queries than keys
CASES = [
    (2, 40, 40, 4, 4, 16, True, None),
    (2, 40, 40, 4, 2, 16, True, None),
    (1, 40, 40, 8, 2, 32, True, None),
    (2, 33, 50, 4, 2, 16, False, None),
    (2, 37, 37, 4, 1, 16, True, 9),
    (1, 20, 45, 4, 2, 32, True, None),
    (1, 20, 45, 8, 2, 16, True, 12),
]
BQ, BK = 16, 32  # flash_xla blocks: every case pads its last query or key block
# f32 on both sides; the sums run in other orders (blocked scan against whole
# einsums) over at most 50 keys or queries
TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(case, seed=0):
    b, sq, sk, hq, hkv, dh, _, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, dh)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, dh)).astype(np.float32)
    dout = rng.uniform(-1, 1, (b, sq, hq, dh)).astype(np.float32)
    return q, k, v, dout


def _port_bwd(q, k, v, dout, causal, window):
    t = [torch.from_numpy(a) for a in (q, k, v, dout)]
    out, lse = flash_attention_lse_torch(*t[:3], causal, window)
    return (out, lse), flash_attention_bwd_torch(*t[:3], out, lse, t[3], causal, window)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_plain_matches_reference_vjp(case):
    """dq, dk, dv of the plain backward against ``jax.vjp`` of
    ``flash_attention_xla`` (the custom VJP ``_bwd``); the forward's output
    and lse against ``_forward``'s."""
    *_, causal, window = case
    q, k, v, dout = _inputs(case)
    (out, lse), got = _port_bwd(q, k, v, dout, causal, window)

    @jax.jit
    def reference(q, k, v, dout):
        out, vjp = jax.vjp(
            lambda a, b_, c: flash_xla.flash_attention_xla(a, b_, c, causal, window, BQ, BK),
            q, k, v)
        return out, vjp(dout), flash_xla._forward(q, k, v, causal, window, BQ, BK)[1]

    want_out, want, want_lse = reference(*map(jnp.asarray, (q, k, v, dout)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **TOL, err_msg=name)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(lse.shape), **TOL)


@pytest.mark.parametrize("case", CASES[:1] + CASES[3:], ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_plain_matches_autograd(case):
    """The plain backward's formulas against autograd of the plain forward
    (softmax and einsums), on the same inputs."""
    *_, causal, window = case
    q, k, v, dout = _inputs(case, seed=1)
    _, got = _port_bwd(q, k, v, dout, causal, window)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    flash_attention_torch(*leaves, causal, window).backward(torch.from_numpy(dout))
    for name, a, b_ in zip(("dq", "dk", "dv"), got, leaves):
        np.testing.assert_allclose(a.numpy(), b_.grad.numpy(), **TOL, err_msg=name)


def test_flash_bwd_rows_that_see_no_key():
    """More queries than keys under causal: the first rows see no key; their
    lse is -inf, their output and dq are 0, and nothing is NaN."""
    q, k, v, dout = _inputs((1, 30, 10, 4, 2, 16, True, None), seed=2)
    (out, lse), (dq, dk, dv) = _port_bwd(q, k, v, dout, True, None)
    assert bool(torch.isneginf(lse[:, :20]).all()) and bool(torch.isfinite(lse[:, 20:]).all())
    assert not bool(out[:, :20].any()) and not bool(dq[:, :20].any())
    assert all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))


def test_flash_attention_grad_dispatch_on_the_cpu():
    """CPU tensors that need a gradient take the plain forward under
    autograd: no kernel launches, and the gradient of the plain version."""
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(CASES[1], seed=3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = ops.launch_counts()
    ops.flash_attention(*leaves, causal=True).backward(dout)
    assert ops.launch_counts() == before
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention_torch(*ref, True, None).backward(dout)
    for a, b_ in zip(leaves, ref):
        assert torch.equal(a.grad, b_.grad)


@pytest.mark.parametrize("shape,nsplit", [
    ((4, 2048, 2048, 32, 2, 128), 4),   # glm4-9b training: 128 key blocks -> 512
    ((1, 200, 1200, 8, 8, 64), 1),      # groups of one query head: nothing to split
    ((1, 200, 1200, 32, 2, 64), 16),    # 20 key blocks: the whole group of 16 split
    ((1, 75, 75, 12, 4, 32), 1),        # a group of 3 does not halve
    ((64, 2048, 2048, 32, 2, 128), 1),  # 2,048 key blocks fill the card unsplit
], ids=["glm4-9b", "group1", "group16", "group3", "batch64"])
def test_bwd_plan(shape, nsplit):
    """The bf16 backward's plan on a 132-SM card: a group's query heads are
    split (by halving) until the dK/dV grid has three blocks an SM; the
    lse/delta rows are padded to a multiple of 128; the workspace holds
    those rows and, when split, the f32 partials of dK and dV."""
    b, sq, sk, hq, hkv, dh = shape
    plan = bwd_plan(*shape, 132)
    assert plan["nsplit"] == nsplit
    assert plan["sq_pad"] % 128 == 0 and plan["sq_pad"] - 128 < sq <= plan["sq_pad"]
    partials = 2 * nsplit * b * sk * hkv * dh if nsplit > 1 else 0
    assert plan["ws_floats"] == 2 * b * hq * plan["sq_pad"] + partials


def test_tma_ready_strides():
    """TMA reads a view as it lies when its head dim is contiguous, its
    other strides are multiples of 16 bytes and its data 16-byte aligned;
    anything else is copied by the wrapper first."""
    packed = torch.zeros(2, 10, 4, 2, 16, dtype=torch.bfloat16)
    assert _tma_ready(packed[:, :, 0]) and _tma_ready(packed[:, :, 3].contiguous())
    assert not _tma_ready(torch.zeros(2, 10, 2, 17, dtype=torch.bfloat16)[..., :16])
    assert not _tma_ready(torch.zeros(2, 10, 16, 2, dtype=torch.bfloat16).transpose(2, 3))
    assert not _tma_ready(torch.zeros(641, dtype=torch.bfloat16)[1:].view(2, 10, 2, 16))
    assert _tma_ready(torch.zeros(2, 10, 2, 16)) and not _tma_ready(torch.zeros(2, 10, 2, 18)[..., :16])
