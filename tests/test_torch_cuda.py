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
