"""Flash attention in the PyTorch port (the plain version, which CPU tensors
take through ``ops.flash_attention``) against the JAX package: the Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` runs it, and the
einsum oracle ``repro.kernels.ref.flash_attention``. The CUDA kernel is held
to the same plain version on the card by ``test_torch_cuda.py`` and
``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_torch

# tests/test_kernels.py's FA_CASES: (b, sq, sk, hq, hkv, dh, causal, window)
FA_CASES = [
    (2, 64, 64, 4, 2, 32, True, None),
    (1, 128, 256, 8, 8, 64, True, None),
    (2, 100, 100, 4, 1, 32, True, 48),
    (1, 1, 96, 4, 2, 64, True, None),  # decode-shaped
    (2, 48, 48, 6, 3, 16, False, None),  # bidirectional (encoder)
]
PALLAS_TOL = 2e-3  # the JAX package's own tolerance for the interpret-mode kernel
REF_TOL = 1e-5  # f32 against the f32 einsum: the same arithmetic, other summation orders


def _qkv(seed, b, sq, sk, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, dh)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, dh)).astype(np.float32))


def _port(q, k, v, **kw):
    return ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,dh,causal,win", FA_CASES)
def test_flash_plain_matches_pallas_interpret(b, sq, sk, hq, hkv, dh, causal, win):
    q, k, v = _qkv(10, b, sq, sk, hq, hkv, dh)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                  window=win, interpret=True)
    got = _port(q, k, v, causal=causal, window=win)
    assert got.shape == (b, sq, hq, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PALLAS_TOL)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,dh,causal,win", FA_CASES)
def test_flash_plain_matches_ref(b, sq, sk, hq, hkv, dh, causal, win):
    q, k, v = _qkv(11, b, sq, sk, hq, hkv, dh)
    want = ref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               window=win)
    got = _port(q, k, v, causal=causal, window=win, impl="torch")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=REF_TOL, rtol=0)


def test_flash_plain_fully_masked_tiles():
    """tests/test_kernels.py's tile-skipping case: a window smaller than one
    tile, so that most (64 x 64) tiles of the Pallas kernel are skipped."""
    q, k, v = _qkv(12, 1, 256, 256, 2, 2, 32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    got = _port(q, k, v, causal=True, window=16).numpy()
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, window=16, bq=64, bk=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=PALLAS_TOL)
    np.testing.assert_allclose(got, np.asarray(ref.flash_attention(jq, jk, jv, causal=True, window=16)),
                               atol=REF_TOL, rtol=0)


def test_flash_plain_bf16():
    """bf16 storage: both sides compute in f32 and round the output to bf16
    once. v is uniform in [-1, 1), so |out| < 1 and one bf16 ulp is at most
    2**-8; the tolerance is that ulp (a last-bit rounding flip where the two
    f32 results straddle a rounding boundary)."""
    rng = np.random.default_rng(13)
    q = jnp.asarray(rng.standard_normal((2, 80, 4, 64)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((2, 80, 2, 64)), jnp.bfloat16)
    v = jnp.asarray(rng.uniform(-1, 1, (2, 80, 2, 64)), jnp.bfloat16)
    want = np.asarray(ref.flash_attention(q, k, v, causal=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2.0**-8, rtol=0)


def test_flash_fully_masked_rows_are_zero():
    """More queries than keys: causal rows before the first key see nothing.
    The port (kernel and plain version) gives 0 there, where the reference
    einsum gives NaN; the other rows match the reference."""
    q, k, v = _qkv(14, 1, 40, 24, 4, 2, 32)
    got = _port(q, k, v, causal=True).numpy()
    want = np.asarray(ref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    masked = 40 - 24  # query i is at position i - 16
    assert np.isnan(want[:, :masked]).all()
    np.testing.assert_array_equal(got[:, :masked], 0.0)
    np.testing.assert_allclose(got[:, masked:], want[:, masked:], atol=REF_TOL, rtol=0)


def test_flash_dispatch_on_the_cpu():
    """CPU tensors take the plain version and launch nothing; the CUDA
    wrapper refuses CPU tensors and unsupported head dims rather than fall
    back."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(15, 1, 8, 8, 2, 1, 32))
    before = ops.launch_counts()["flash_attention"]
    torch.testing.assert_close(ops.flash_attention(q, k, v), flash_attention_torch(q, k, v),
                               rtol=0, atol=0)
    assert ops.launch_counts()["flash_attention"] == before
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_cuda(q, k, v)
    q48, k48, v48 = (torch.from_numpy(a) for a in _qkv(16, 1, 8, 8, 2, 1, 48))
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_cuda(q48, k48, v48)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=0)
