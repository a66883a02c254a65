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


def _fused_args(kind, dev, q, x, cents, members, gids, m=5, c=256, seed=1):
    """The SQ8 or PQ kernel's arguments over the same segments and lists."""
    if kind == "sq8":
        scale = (x.abs().amax(dim=(0, 1)) / 127.0 + 1e-12).contiguous()
        codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return ops.fused_ivf_sq8_topk, (q, codes, scale, cents, members, gids)
    g = torch.Generator(device=dev).manual_seed(seed)
    lut = torch.randn(q.shape[0], m, c, generator=g, device=dev)
    codes = torch.randint(0, c, x.shape[:2] + (m,), generator=g, device=dev).to(torch.uint8)
    return ops.fused_ivf_pq_topk, (q, lut, codes, cents, members, gids)


def _check_fused(fn, args, **kw):
    name = "fused_ivf_sq8_topk" if fn is ops.fused_ivf_sq8_topk else "fused_ivf_pq_topk"
    before = ops.launch_counts()[name]
    got = fn(*args, **kw)
    assert ops.launch_counts()[name] == before + 1
    want = fn(*args, **kw, impl="torch")
    assert_topk_match(*(t.cpu() for t in got), *(t.cpu() for t in want))
    return got


def _assert_sorted(lids, sims):
    """Rows sorted by score descending, ties to the lowest id, then -1 / -inf."""
    lids, sims = lids.cpu().numpy(), sims.cpu().numpy()
    live = np.isfinite(sims)
    n = live.sum(-1, keepdims=True)
    assert (live == (np.arange(lids.shape[-1]) < n)).all() and (lids[~live] == -1).all()
    a, b = sims[..., :-1], sims[..., 1:]
    ia, ib = lids[..., :-1], lids[..., 1:]
    pair = live[..., 1:]
    assert ((a > b) | ((a == b) & (ia < ib)))[pair].all()


@pytest.mark.parametrize("k", [10, 64, 128, 256, 512])
@pytest.mark.parametrize("nlist,cap", [(128, 72), (512, 48)], ids=["nlist128", "nlist512"])
def test_fused_kernels_large_probe_corner(dev, nlist, cap, k):
    """The session's corner: segments of 8,192, nprobe 128, the engine's list
    capacity for it (P = 9,216 slots a query at nlist 128), k up to IVF_PQR's
    largest reorder width."""
    q, x, cents, members, gids = _inputs(dev, n_seg=2, s=8192, nlist=nlist, cap=cap, b=48,
                                         seed=k)
    for kind in ("sq8", "pq"):
        fn, args = _fused_args(kind, dev, q, x, cents, members, gids)
        lids, sims = _check_fused(fn, args, nprobe=128, k=k, mask_dead=True)
        _assert_sorted(lids, sims)


@pytest.mark.parametrize("d", [37, 100])
@pytest.mark.parametrize("b", [1, 33, 100])
def test_fused_kernels_ragged_batch_and_dims(dev, b, d):
    """Query counts that fill no whole block (32 queries), dims that are not
    a multiple of 4 (code rows not 4-byte aligned), PQ at m 4 / 25 / 32."""
    q, x, cents, members, gids = _inputs(dev, d=d, b=b, seed=b + d)
    fn, args = _fused_args("sq8", dev, q, x, cents, members, gids)
    _assert_sorted(*_check_fused(fn, args, nprobe=5, k=64, mask_dead=False))
    for m in (4, 25, 32):
        fn, args = _fused_args("pq", dev, q, x, cents, members, gids, m=m, seed=m)
        _assert_sorted(*_check_fused(fn, args, nprobe=5, k=64, mask_dead=True))


def _exact_order(fn, args, k, **kw):
    """Every candidate of the plain version, sorted by (score desc, id asc),
    cut to k: the exact rows the kernel must give when the scores are exact."""
    members = args[4]
    lids, sims = fn(*args, k=members.shape[1] * members.shape[2], **kw, impl="torch")
    key = torch.where(torch.isfinite(sims), sims.double(), torch.tensor(-1e300, device=sims.device))
    order = torch.argsort(lids.double() - key * 1e6, dim=-1, stable=True)  # ids < 1e6
    lids, sims = torch.gather(lids, -1, order)[..., :k], torch.gather(sims, -1, order)[..., :k]
    return torch.where(torch.isfinite(sims), lids, -1), sims


def test_fused_kernels_ties_to_the_lowest_id(dev):
    """Integer codes, queries and tables: every score is exact in f32 and many
    are equal, so kernel and plain version agree slot for slot once the plain
    candidates are ordered by (score desc, id asc)."""
    q, x, cents, members, gids = _inputs(dev, s=2000, nlist=16, cap=200, b=40, seed=3)
    qi = torch.sign(torch.round(q * 3)).contiguous()  # entries -1, 0, 1
    codes = torch.sign(torch.round(x * 3)).to(torch.int8)
    sq8 = (qi, codes, torch.ones(x.shape[2], device=dev), cents, members, gids)
    g = torch.Generator(device=dev).manual_seed(4)
    lut = torch.randint(-2, 3, (q.shape[0], 4, 16), generator=g, device=dev).float()
    pcodes = torch.randint(0, 16, x.shape[:2] + (4,), generator=g, device=dev).to(torch.uint8)
    pq = (q, lut, pcodes, cents, members, gids)
    for fn, args in ((ops.fused_ivf_sq8_topk, sq8), (ops.fused_ivf_pq_topk, pq)):
        for k in (7, 64, 300):
            kw = dict(nprobe=6, mask_dead=True)
            got = fn(*args, k=k, **kw)
            want = _exact_order(fn, args, k, **kw)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_fused_kernels_padding_anywhere_and_k_beyond_live(dev):
    """-1 slots in the middle of member lists (not only at their ends), dead
    gids among live slots, and k beyond a query's live candidates."""
    q, x, cents, members, gids = _inputs(dev, seed=5)
    g = torch.Generator(device=dev).manual_seed(5)
    perm = torch.argsort(torch.rand(members.shape, generator=g, device=dev), dim=-1)
    members = torch.gather(members, -1, perm)
    members[torch.rand(members.shape, generator=g, device=dev) < 0.3] = -1
    members = members.contiguous()
    gids[:, ::5] = -1
    for kind in ("sq8", "pq"):
        fn, args = _fused_args(kind, dev, q, x, cents, members, gids)
        for mask_dead in (False, True):
            lids, sims = _check_fused(fn, args, nprobe=3, k=512, mask_dead=mask_dead)
            _assert_sorted(lids, sims)
            assert bool((lids[..., -1] == -1).all())  # fewer than 512 live candidates


def test_fused_kernels_reject_a_k_beyond_shared_memory(dev):
    """The one ceiling: a k whose queues no block shape can hold (far above
    the 512 the engine's paths reach) raises KernelContractError."""
    from repro_torch.kernels._build import KernelContractError

    q, x, cents, members, gids = _inputs(dev)
    for kind, k in (("sq8", 4096), ("pq", 40000)):
        fn, args = _fused_args(kind, dev, q, x, cents, members, gids)
        with pytest.raises(KernelContractError, match="shared memory"):
            fn(*args, nprobe=3, k=k)
    fn, args = _fused_args("sq8", dev, q, x, cents, members, gids)
    _check_fused(fn, args, nprobe=3, k=1024)  # well above the engine's widths still runs


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


@pytest.mark.parametrize("dh", [32, 64, 80, 128])
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


@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128])
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
# flash attention backward and the forward's log-sum-exp
# ---------------------------------------------------------------------------
# lse: f32 sums over up to 1,200 keys in other orders, at |lse| < 10
LSE_TOL = 1e-4
# gradients, relative to the largest |gradient|: f32 sums of up to 1,200
# products in other orders; bf16, one rounding of the output (2**-8) doubled
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-7}


def _check_grads(got, want, dtype, what):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape, (what, name)
        a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
        scale = max(float(np.abs(b).max()), 1e-6)
        assert np.abs(a - b).max() <= GRAD_TOL[dtype] * scale, (what, name, np.abs(a - b).max(), scale)


def _bwd_case(dev, dtype, b, sq, sk, hq, hkv, dh, causal, window, seed=0):
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_torch,
                                                     flash_attention_cuda,
                                                     flash_attention_lse_torch)

    q, k, v = _attn_inputs(dev, dtype, b, sq, sk, hq, hkv, dh, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dout = (torch.rand(q.shape, generator=g, device=dev) * 2 - 1).to(dtype)
    out, lse = flash_attention_cuda(q, k, v, causal, window, return_lse=True)
    out_ref, lse_ref = flash_attention_lse_torch(q, k, v, causal, window)
    seen = torch.isfinite(lse_ref)
    assert torch.equal(seen, torch.isfinite(lse))
    assert float((lse - lse_ref)[seen].abs().max()) <= LSE_TOL
    np.testing.assert_allclose(out.float().cpu().numpy(), out_ref.float().cpu().numpy(),
                               atol=ATTN_TOL[dtype], rtol=0)
    before = ops.launch_counts()["flash_attention_bwd"]
    got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal, window)
    assert ops.launch_counts()["flash_attention_bwd"] == before + 1
    want = flash_attention_bwd_torch(q, k, v, out, lse, dout, causal, window)
    _check_grads(got, want, dtype, (b, sq, sk, hq, hkv, dh, causal, window))
    return got


@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("mask", ["causal", "window", "bidirectional"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_bwd_kernel(dev, dtype, mask, dh):
    """The backward kernel against the plain backward on the same (out,
    lse), and the forward's lse against the plain one: fewer queries than
    keys (tail offset 70), ragged tiles, a window of 48 inside a tile."""
    _bwd_case(dev, dtype, 2, 130, 200, 8, 2, dh, mask != "bidirectional",
              48 if mask == "window" else None, seed=dh)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 4), (8, 2), (32, 2)],
                         ids=["group1", "group2", "group4", "group16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_bwd_kernel_gqa_groups(dev, dtype, hq, hkv):
    """dK and dV summed over groups of 1, 2, 4 and 16 query heads; 1,200
    keys (19 tiles), a window of 300 whose edge falls inside a tile."""
    _bwd_case(dev, dtype, 1, 200, 1200, hq, hkv, 64, True, 300, seed=hq)


def test_flash_attention_bwd_kernel_rows_that_see_no_key(dev):
    """More queries than keys: the first 60 causal rows see no key, their
    lse is -inf and their dq is 0."""
    _bwd_case(dev, torch.float32, 2, 130, 70, 4, 2, 32, True, None, seed=5)


@pytest.mark.parametrize("dh", [32, 128])
def test_flash_attention_bwd_bf16_rows_that_see_no_key(dev, dh):
    """The bf16 path's rows that see no key (the first 60 causal rows):
    their dq is exactly 0, and no gradient is NaN."""
    dq, dk, dv = _bwd_case(dev, torch.bfloat16, 2, 130, 70, 4, 2, dh, True, None, seed=5)
    assert not bool(dq[:, :60].any())
    assert all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))


def test_flash_attention_bwd_bf16_is_deterministic(dev):
    """Two launches at group 16, dh 128, causal, with sq = 300 (no multiple
    of 128) give the same bits: no atomics, every sum in a fixed order (the
    dK/dV partials of the split group included)."""
    from repro_torch.kernels.flash_attention import bwd_plan, flash_attention_bwd_cuda

    q, k, v = _attn_inputs(dev, torch.bfloat16, 2, 300, 300, 32, 2, 128, seed=7)
    dout = (torch.rand(q.shape, device=dev) * 2 - 1).to(torch.bfloat16)
    out, lse = ops.KERNELS["flash_attention"](q, k, v, True, None, return_lse=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert bwd_plan(2, 300, 300, 32, 2, 128, sms)["nsplit"] > 1
    first = flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    second = flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("window", [None, 300], ids=["causal", "window"])
def test_flash_attention_bwd_bf16_dh80_zamba2_heads(dev, window):
    """zamba2's shared attention: 32 query heads, each its own kv head, head
    dim 80 (two 64-column boxes, the second zero-filled past column 80);
    sq = sk = 333 leaves ragged query and key tiles. Within the limits
    against the plain backward, no NaN, and two launches bit-equal."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda

    first = _bwd_case(dev, torch.bfloat16, 2, 333, 333, 32, 32, 80, True, window, seed=80)
    q, k, v = _attn_inputs(dev, torch.bfloat16, 2, 333, 333, 32, 32, 80, seed=80)
    g = torch.Generator(device=dev).manual_seed(81)
    dout = (torch.rand(q.shape, generator=g, device=dev) * 2 - 1).to(torch.bfloat16)
    out, lse = ops.KERNELS["flash_attention"](q, k, v, True, window, return_lse=True)
    second = flash_attention_bwd_cuda(q, k, v, out, lse, dout, True, window)
    for a, b in zip(first, second):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, b)


def test_flash_attention_bwd_bf16_strided_views(dev):
    """q, dout and out as strided views of packed buffers and k, v as views
    of one (b, sk, 2, hkv, dh) tensor: read through their strides by TMA (no
    copy) and equal to the contiguous launch; a view with a stride TMA
    cannot describe (an odd number of elements) is copied first."""
    from repro_torch.kernels.flash_attention import (_tma_ready, flash_attention_bwd_cuda,
                                                     flash_attention_bwd_torch)

    g = torch.Generator(device=dev).manual_seed(3)
    b, sq, sk, hq, hkv, dh = 2, 150, 200, 8, 2, 64
    qbuf = torch.randn(b, sq, 2, hq, dh, generator=g, device=dev).to(torch.bfloat16)
    kv = torch.randn(b, sk, 2, hkv, dh, generator=g, device=dev).to(torch.bfloat16)
    dbuf = (torch.rand(b, sq, hq, 2, dh, generator=g, device=dev) * 2 - 1).to(torch.bfloat16)
    q, k, v, dout = qbuf[:, :, 1], kv[:, :, 0], kv[:, :, 1], dbuf[:, :, :, 0]
    out, lse = ops.KERNELS["flash_attention"](q, k, v, True, 70, return_lse=True)
    obuf = torch.zeros(b, sq, hq, dh + 8, dtype=torch.bfloat16, device=dev)
    obuf[..., :dh] = out
    out_view = obuf[..., :dh]
    assert all(_tma_ready(t) for t in (q, k, v, dout, out_view))
    got = flash_attention_bwd_cuda(q, k, v, out_view, lse, dout, True, 70)
    want = flash_attention_bwd_torch(q, k, v, out, lse, dout, True, 70)
    _check_grads(got, want, torch.bfloat16, "strided")
    same = flash_attention_bwd_cuda(*(t.contiguous() for t in (q, k, v, out, lse, dout)), True, 70)
    for a, c in zip(got, same):
        assert torch.equal(a, c)
    odd = torch.zeros(b, sq, hq * dh + 1, dtype=torch.bfloat16, device=dev)
    odd[..., :hq * dh] = dout.reshape(b, sq, hq * dh)
    dout_odd = odd[..., :hq * dh].unflatten(-1, (hq, dh))
    assert not _tma_ready(dout_odd)
    copied = flash_attention_bwd_cuda(q, k, v, out, lse, dout_odd, True, 70)
    for a, c in zip(copied, same):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_autograd_launches_both_kernels(dev, dtype):
    """``ops.flash_attention`` on CUDA tensors that need a gradient goes
    through ``FlashAttention``: one forward and one backward launch, the
    gradients those of autograd over the plain forward. Without a gradient
    only the forward runs."""
    q, k, v = _attn_inputs(dev, dtype, 2, 96, 96, 8, 2, 64, seed=11)
    dout = (torch.rand(q.shape, device=dev) * 2 - 1).to(dtype)
    grads = []
    for impl in (None, "torch"):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        before = ops.launch_counts()
        out = ops.flash_attention(*leaves, causal=True, window=40, impl=impl)
        out.backward(dout)
        after = ops.launch_counts()
        launched = {n: after[n] - before[n] for n in ("flash_attention", "flash_attention_bwd")}
        assert launched == ({"flash_attention": 1, "flash_attention_bwd": 1} if impl is None
                            else {"flash_attention": 0, "flash_attention_bwd": 0})
        grads.append([t.grad for t in leaves])
    _check_grads(grads[0], grads[1], dtype, "autograd")
    before = ops.launch_counts()["flash_attention_bwd"]
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention_bwd"] == before


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


PQ_M = (1, 5, 8, 32)
PQ_C = (16, 64, 200, 256)


@pytest.mark.parametrize("n", [1, 3, 4, 255, 4097])
@pytest.mark.parametrize("q", [1, 3, 5, 13, 1023])
@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8], ids=["int32", "uint8"])
def test_pq_adc_kernel_ragged_tiles(dev, q, n, dtype):
    """Query counts that fill no whole tile of the interleaved tables, rows
    that fill no whole chunk and output rows that are not 16-byte aligned
    (n % 4 != 0), at every m in PQ_M and c in PQ_C (c = 200: not a multiple
    of 4 tables' width; c = 16: small tables)."""
    for m in PQ_M:
        for c in PQ_C:
            g = torch.Generator(device=dev).manual_seed(q * n + m * c)
            lut = torch.randn(q, m, c, generator=g, device=dev)
            codes = torch.randint(0, c, (n, m), generator=g, device=dev).to(dtype)
            got = ops.pq_adc(lut, codes)
            torch.testing.assert_close(got, ops.pq_adc(lut, codes, impl="torch"), rtol=0, atol=0,
                                       msg=lambda s: f"m={m} c={c}: {s}")


@pytest.mark.parametrize("m", [1, 5, 8])
def test_pq_adc_kernel_unaligned_byte_codes(dev, m):
    """uint8 codes from a contiguous view at an odd storage offset: the
    kernel reads them as they lie (data_ptr not 4-byte aligned)."""
    g = torch.Generator(device=dev).manual_seed(m)
    n = 1001
    big = torch.randint(0, 256, (n * m + 1,), generator=g, device=dev).to(torch.uint8)
    codes = big[1:].view(n, m)
    assert codes.is_contiguous() and codes.data_ptr() % 4 == 1
    lut = torch.randn(37, m, 256, generator=g, device=dev)
    torch.testing.assert_close(ops.pq_adc(lut, codes), ops.pq_adc(lut, codes, impl="torch"),
                               rtol=0, atol=0)


@pytest.mark.parametrize("where", ["first", "last"])
@pytest.mark.parametrize("bad", [64, -1, 1 << 20])
def test_pq_adc_kernel_flags_a_code_out_of_range(dev, where, bad):
    """One int32 code outside [0, c) in the first or the last row raises;
    the kernel clamps its reads into the tables, so a good call on the same
    device afterwards still gives the plain version's result."""
    from repro_torch.kernels._build import KernelContractError

    g = torch.Generator(device=dev).manual_seed(7)
    lut = torch.randn(40, 5, 64, generator=g, device=dev)
    codes = torch.randint(0, 64, (4097, 5), generator=g, device=dev, dtype=torch.int32)
    bad_codes = codes.clone()
    bad_codes[0 if where == "first" else -1, 4 if where == "first" else 0] = bad
    with pytest.raises(KernelContractError, match="outside"):
        ops.pq_adc(lut, bad_codes)
    torch.cuda.synchronize()
    torch.testing.assert_close(ops.pq_adc(lut, codes), ops.pq_adc(lut, codes, impl="torch"),
                               rtol=0, atol=0)
    if bad == 64:  # the same code as a byte, at c = 64 < 256
        with pytest.raises(KernelContractError, match="outside"):
            ops.pq_adc(lut, bad_codes.to(torch.uint8))


def test_pq_adc_kernel_synchronises_only_to_read_its_flag(dev):
    """uint8 codes at c = 256 make no host synchronisation; int32 codes make
    one (the read of the kernel's range flag)."""
    import warnings

    g = torch.Generator(device=dev).manual_seed(3)
    lut = torch.randn(128, 8, 256, generator=g, device=dev)
    codes = torch.randint(0, 256, (8192, 8), generator=g, device=dev, dtype=torch.int32)
    codes8 = codes.to(torch.uint8)
    ops.pq_adc(lut, codes8), ops.pq_adc(lut, codes)  # build and plan outside the count
    torch.cuda.synchronize()
    counts = {}
    for name, cc in (("uint8", codes8), ("int32", codes)):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                ops.pq_adc(lut, cc)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts[name] = [str(w.message) for w in seen
                        if "called a synchronizing CUDA operation" in str(w.message)]
    assert {k: len(v) for k, v in counts.items()} == {"uint8": 0, "int32": 1}, counts


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


@pytest.mark.parametrize("name", ["default", "random_lhs", "ottertune", "qehvi", "opentuner"])
def test_baseline_runs_in_wall_mode_on_card(dev, name):
    """Each baseline of ``ALL_BASELINES`` for a short wall-mode session over a
    small glove_like set on the card: no evaluation fails, every QPS is
    positive, and the GP baselines fit on the card."""
    from repro_torch.bench.common import make_env, run_method
    from repro_torch.core import ALL_BASELINES
    from repro_torch.vdms import make_space

    assert name in ALL_BASELINES
    env = make_env("glove_like", seed=0, mode="wall", n=4096, device=dev)
    tuner, wall, session = run_method(name, env, make_space(), 8, seed=0, device=dev,
                                      **({"n_init": 4} if name in ("ottertune", "qehvi") else {}))
    assert tuner.history and wall > 0
    assert not env.failures and not any(o.failed for o in tuner.history)
    assert all(o.raw["speed"] > 0 and 0.0 <= o.raw["recall"] <= 1.0 for o in tuner.history)
    assert session.ledger_dict()["totals"]["n_evals"] == len(tuner.history)
    if name in ("ottertune", "qehvi"):
        assert tuner.device.type == "cuda"


@pytest.mark.parametrize("index_type", ["FLAT", "IVF_SQ8", "IVF_PQ"])
def test_live_replay_runs_kernels_on_card(dev, index_type):
    """A delete-heavy replay in wall mode on the card: the family's kernel
    launches on the live path, segments are compacted (``-1`` rows that the
    kernels score with ``mask_dead=False``), and the final live state
    answers with the composed pipeline's result sets."""
    from repro_torch.vdms import make_space, make_trace, replay_trace, set_search_pipeline

    trace = make_trace("glove_like", n_base=2048, n_ops=2048, mix=(0.3, 0.3, 0.4), dim=100,
                       seed=1)
    cfg = dict(make_space().default_config(index_type), segment_max_size=256,
               seal_proportion=1.0, nlist=16)
    name = {"FLAT": "distance", "IVF_SQ8": "fused_ivf_sq8_topk",
            "IVF_PQ": "fused_ivf_pq_topk"}[index_type]
    before = ops.launch_counts()[name]
    result, live = replay_trace(trace, cfg, mode="wall", with_live=True, device=dev)
    assert ops.launch_counts()[name] > before
    assert result["n_compactions"] > 0 and 0.0 < result["recall"] <= 1.0
    assert bool((live.bundle.arrays["gids"] < 0).any())
    out = {}
    for mode in ("composed", "fused"):
        set_search_pipeline(mode)
        out[mode] = live.search(trace.queries[:64], 10, mode="wall")[0]
    set_search_pipeline("fused")
    alive = live.alive
    for a, b in zip(out["composed"], out["fused"]):
        assert set(a[a >= 0]) == set(b[b >= 0])
        assert alive[b[b >= 0]].all()


def test_pipeline_over_flash_blocks(dev):
    """``pipeline_apply`` over two reduced glm4-9b blocks in bf16 (head dim
    32) on the card: the flash forward and backward kernels run, and the
    output and every gradient equal the sequential stack's within bf16's
    limit (2**-6 relative L2, as phase 12 of ``chip_smoke.py`` holds a step)."""
    import dataclasses

    from repro_torch.configs import get_arch, reduce
    from repro_torch.distributed.pipeline import (module_block_fn, pipeline_apply,
                                                  sequential_apply, stack_blocks)
    from repro_torch.models import build_model

    cfg = dataclasses.replace(reduce(get_arch("glm4-9b")), n_layers=2, param_dtype="bfloat16")
    params = build_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    stacked = {n: t.detach().requires_grad_() for n, t in stack_blocks(params.blocks).items()}
    fn = module_block_fn(params.blocks[0])
    x = torch.randn(4, 128, cfg.d_model, device=dev).to(torch.bfloat16).requires_grad_()

    def run(apply):
        ops.reset_launch_counts()
        out = apply()
        grads = torch.autograd.grad(out.float().square().mean(), [x] + list(stacked.values()))
        return out.detach().float(), [g.float() for g in grads], ops.launch_counts()

    want, want_g, _ = run(lambda: sequential_apply(stacked, x, fn))
    got, got_g, launches = run(lambda: pipeline_apply(stacked, x, fn, 2, 2))
    # 3 slots of both stages' one layer each; the backward of the 2
    # microbatches' blocks (the bubbles' zeros reach no loss)
    assert launches["flash_attention"] == 3 * 2 and launches["flash_attention_bwd"] == 2 * 2
    assert float((got - want).norm() / want.norm()) <= 2.0**-6
    for a, b in zip(got_g, want_g):
        assert float((a - b).norm() / b.norm()) <= 2.0**-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 48)])
def test_flash_meta_route_shapes_match_cuda(dev, dtype, causal, window):
    """``ops.flash_attention``'s meta route gives the CUDA route's output
    shape and dtype, and under autograd its gradients' shapes and dtypes."""
    shapes = ((2, 100, 8, 64), (2, 128, 2, 64), (2, 128, 2, 64))
    for device in (dev, torch.device("meta")):
        q, k, v = (torch.randn(s, device=device, dtype=dtype).requires_grad_() for s in shapes)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        grads = torch.autograd.grad(out.float().sum(), (q, k, v))
        with torch.no_grad():
            plain = ops.flash_attention(q, k, v, causal=causal, window=window)
        got = [(tuple(t.shape), t.dtype) for t in (out, plain, *grads)]
        if device.type == "meta":
            assert got == want
        want = got
