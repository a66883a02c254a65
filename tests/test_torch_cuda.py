"""The port's CUDA kernels against their plain PyTorch versions on a GPU.

Every test here carries the ``cuda`` marker and skips without a CUDA
device: the kernels have no CPU mode. The module imports no JAX, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from torch_parity import TOL, assert_topk_match

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, n_seg=3, s=700, d=100, nlist=16, cap=80, b=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.nn.functional.normalize(torch.randn(n_seg, s, d, generator=g), dim=-1)
    q = torch.nn.functional.normalize(torch.randn(b, d, generator=g), dim=-1)
    cents = torch.nn.functional.normalize(torch.randn(n_seg, nlist, d, generator=g), dim=-1)
    assign = torch.einsum("zsd,zld->zsl", x, cents).argmax(-1)
    members = torch.full((n_seg, nlist, cap), -1, dtype=torch.int32)
    for z in range(n_seg):
        for l in range(nlist):
            ids = torch.nonzero(assign[z] == l)[:cap, 0]
            members[z, l, : len(ids)] = ids.to(torch.int32)
    gids = torch.arange(n_seg * s, dtype=torch.int32).reshape(n_seg, s)
    gids[:, -30:] = -1
    return tuple(t.to(dev) for t in (q, x, cents, members, gids))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["ip", "l2"])
def test_distance_kernel(dev, kind, bf16):
    q, x, *_ = _inputs(dev)
    x = x.to(torch.bfloat16) if bf16 else x
    fn = ops.batched_ip if kind == "ip" else ops.l2_distance
    for qq in (q[:32], q):  # the 32-row and 64-row tiles
        before = ops.launch_counts()["distance"]
        got = fn(qq, x)
        assert ops.launch_counts()["distance"] == before + 1
        np.testing.assert_allclose(got.cpu().numpy(), fn(qq, x, impl="torch").cpu().numpy(),
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("mask_dead", [False, True])
def test_fused_kernels(dev, k, mask_dead):
    q, x, cents, members, gids = _inputs(dev)
    scale = (x.abs().amax(dim=(0, 1)) / 127.0 + 1e-12).contiguous()
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    sq8 = (q, codes, scale, cents, members, gids)
    g = torch.Generator(device=dev).manual_seed(1)
    lut = torch.randn(q.shape[0], 5, 256, generator=g, device=dev)
    pq_codes = torch.randint(0, 256, (3, 700, 5), generator=g, device=dev).to(torch.uint8)
    pq = (q, lut, pq_codes, cents, members, gids)
    for fn, args in ((ops.fused_ivf_sq8_topk, sq8), (ops.fused_ivf_pq_topk, pq)):
        kw = dict(nprobe=4, k=k, mask_dead=mask_dead)
        got = fn(*args, **kw)
        want = fn(*args, **kw, impl="torch")
        assert_topk_match(*(t.cpu() for t in got), *(t.cpu() for t in want))


def _attn_inputs(dev, dtype, b, sq, sk, hq, hkv, dh, seed=0):
    """q, k ~ N(0, 1); v uniform in [-1, 1), so |out| < 1 and one bf16 ulp of
    the output is at most 2**-8."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, sq, hq, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(b, sk, hkv, dh, generator=g, device=dev).to(dtype)
    v = (torch.rand(b, sk, hkv, dh, generator=g, device=dev) * 2 - 1).to(dtype)
    return q, k, v


# f32: other summation orders over up to 200 keys; bf16: one ulp of the output
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0**-8}


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("mask", ["causal", "window", "bidirectional"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_kernel(dev, dtype, mask, dh):
    q, k, v = _attn_inputs(dev, dtype, 2, 150, 200, 8, 2, dh, seed=dh)
    kw = dict(causal=mask != "bidirectional", window=48 if mask == "window" else None)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ops.flash_attention(q, k, v, **kw, impl="torch")
    assert got.dtype == dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=ATTN_TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_kernel_strides_and_masked_rows(dev, dtype):
    """k and v as strided views of one (b, sk, 2, hkv, dh) tensor, and more
    queries than keys: the first sq - sk causal rows see no key and give 0."""
    q, _, _ = _attn_inputs(dev, dtype, 2, 130, 1, 4, 2, 16)
    kv = (torch.rand(2, 70, 2, 2, 16, device=dev) * 2 - 1).to(dtype)
    k, v = kv[:, :, 0], kv[:, :, 1]
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q, k, v, impl="torch")
    assert not bool(got[:, :60].any())
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=ATTN_TOL[dtype], rtol=0)
