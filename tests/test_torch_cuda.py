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


def _unit_rows(dev, shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.nn.functional.normalize(torch.randn(*shape, generator=g), dim=-1)
    return x.to(dtype).to(dev)


def _check_distance(q, x, kind):
    fn = ops.batched_ip if kind == "ip" else ops.l2_distance
    before = ops.launch_counts()["distance"]
    got = fn(q, x)
    assert ops.launch_counts()["distance"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), fn(q, x, impl="torch").cpu().numpy(),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("b", [1, 32, 33, 64, 100])
@pytest.mark.parametrize("kind", ["ip", "l2"])
def test_distance_kernel_ragged_tiles(dev, kind, b):
    """S = 1000 fills no whole column tile (512 or 256 rows); B from one
    query to more than one 64-row tile."""
    q = _unit_rows(dev, (b, 100), torch.float32, b)
    x = _unit_rows(dev, (3, 1000, 100), torch.float32, b + 1)
    _check_distance(q, x, kind)


@pytest.mark.parametrize("d,dtype", [(37, torch.float32), (96, torch.float32),
                                     (100, torch.float32), (256, torch.float32),
                                     (1536, torch.float32), (100, torch.bfloat16),
                                     (37, torch.bfloat16)],
                         ids=["37-f32", "96-f32", "100-f32", "256-f32", "1536-f32", "100-bf16",
                              "37-bf16"])
@pytest.mark.parametrize("kind", ["ip", "l2"])
def test_distance_kernel_any_dim(dev, kind, d, dtype):
    """Rows that are not 16-byte aligned (f32 at d = 37, bf16 at d = 100 and
    37), d that is not a multiple of the 52-value chunk, and a d whose query
    chunk would not fit in shared memory whole."""
    q = _unit_rows(dev, (40, d), torch.float32, d)
    x = _unit_rows(dev, (2, 777, d), dtype, d + 1)
    _check_distance(q, x, kind)


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


def _check_flash(q, k, v, **kw):
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ops.flash_attention(q, k, v, **kw, impl="torch")
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=ATTN_TOL[q.dtype], rtol=0)
    return got


@pytest.mark.parametrize("mask", ["causal", "window", "bidirectional"])
def test_flash_attention_bf16_long_keys_wrap_the_ring(dev, mask):
    """1,200 keys are 19 tiles of 64: the four-stage ring wraps four times;
    the window of 300 ends inside a tile."""
    q, k, v = _attn_inputs(dev, torch.bfloat16, 1, 200, 1200, 8, 2, 128, seed=3)
    _check_flash(q, k, v, causal=mask != "bidirectional", window=300 if mask == "window" else None)


@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (32, 2)], ids=["group1", "group4", "group16"])
def test_flash_attention_bf16_groups_and_ragged_rows(dev, hq, hkv, dh):
    """GQA groups of 1, 4 and 16 query heads per kv head (a block holds 4, 2
    or 1 of them x 128 / G rows); sq = 75 fills no whole block."""
    q, k, v = _attn_inputs(dev, torch.bfloat16, 2, 75, 75, hq, hkv, dh, seed=dh + hq)
    _check_flash(q, k, v, causal=True)


@pytest.mark.parametrize("dh", [64, 128])
def test_flash_attention_bf16_strided_window_and_empty_rows(dev, dh):
    """q, k and v as strided views of packed buffers; more queries than keys
    (the first 50 causal rows see no key and give 0); a window of 70 whose
    edge crosses the 64-key tiles."""
    g = torch.Generator(device=dev).manual_seed(dh)
    qbuf = torch.randn(2, 150, 2, 8, dh, generator=g, device=dev).to(torch.bfloat16)
    kv = (torch.rand(2, 100, 2, 2, dh, generator=g, device=dev) * 2 - 1).to(torch.bfloat16)
    q, k, v = qbuf[:, :, 1], kv[:, :, 0], kv[:, :, 1]
    got = _check_flash(q, k, v, causal=True, window=70)
    assert not bool(got[:, :50].any())


# ---------------------------------------------------------------------------
# pq_adc: the same summing order as the plain version, so exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q,n,m,c", [(13, 1000, 5, 256), (128, 8192, 8, 256), (9, 700, 8, 16),
                                     (20, 333, 1, 64), (17, 2049, 32, 256)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8], ids=["int32", "uint8"])
def test_pq_adc_kernel(dev, q, n, m, c, dtype):
    g = torch.Generator(device=dev).manual_seed(q * n)
    lut = torch.randn(q, m, c, generator=g, device=dev)
    codes = torch.randint(0, c, (n, m), generator=g, device=dev).to(dtype)
    before = ops.launch_counts()["pq_adc"]
    got = ops.pq_adc(lut, codes)
    assert ops.launch_counts()["pq_adc"] == before + 1
    torch.testing.assert_close(got, ops.pq_adc(lut, codes, impl="torch"), rtol=0, atol=0)


def test_pq_adc_kernel_rejects_what_it_does_not_take(dev):
    from repro_torch.kernels._build import KernelContractError

    lut = torch.randn(4, 2, 16, device=dev)
    with pytest.raises(KernelContractError, match="outside"):
        ops.pq_adc(lut, torch.full((5, 2), 16, dtype=torch.int32, device=dev))
    with pytest.raises(KernelContractError, match="256"):
        ops.pq_adc(torch.randn(4, 2, 300, device=dev), torch.zeros(5, 2, dtype=torch.int32,
                                                                   device=dev))


def test_fused_pq_kernel_k_beyond_candidates(dev):
    """IVF_PQR's reorder width can exceed a query's live candidates: the
    kernel fills the slots beyond them with -1 / -inf, as the plain version."""
    q, x, cents, members, gids = _inputs(dev, cap=40)
    g = torch.Generator(device=dev).manual_seed(2)
    lut = torch.randn(q.shape[0], 5, 256, generator=g, device=dev)
    codes = torch.randint(0, 256, (3, 700, 5), generator=g, device=dev).to(torch.uint8)
    args = (q, lut, codes, cents, members, gids)
    got = ops.fused_ivf_pq_topk(*args, nprobe=2, k=512, mask_dead=False)
    want = ops.fused_ivf_pq_topk(*args, nprobe=2, k=512, mask_dead=False, impl="torch")
    assert bool((got[0][..., 80:] == -1).all()) and bool(torch.isinf(got[1][..., 80:]).all())
    assert_topk_match(*(t.cpu() for t in got), *(t.cpu() for t in want))


def test_ivf_pqr_fused_matches_composed_on_card(dev):
    from repro_torch.vdms import VDMSInstance, make_dataset, set_search_pipeline
    from repro_torch.vdms.ivf_pqr import register
    from repro_torch.vdms.registry import REGISTRY

    register()
    try:
        ds = make_dataset("glove_like", n=3000, n_queries=32, k=10, seed=0, dim=64, device=dev)
        cfg = dict(index_type="IVF_PQR", nlist=16, nprobe=1, m=8, nbits=8, reorder_k=512,
                   segment_max_size=1024, seal_proportion=0.75, graceful_time=0.2,
                   search_batch_size=16, topk_merge_width=64, kmeans_iters=4,
                   storage_bf16=False)
        inst = VDMSInstance(ds, cfg, device=dev)
        out = {}
        for mode in ("composed", "fused"):
            set_search_pipeline(mode)
            out[mode] = inst.search(ds.queries, 10)
        set_search_pipeline("fused")
        for a, b in zip(out["composed"], out["fused"]):
            assert set(a[a >= 0]) == set(b[b >= 0])
    finally:
        REGISTRY.unregister("IVF_PQR")
