"""Kernel-level parity of the PyTorch port (``repro_torch.kernels.ops``, plain
versions on the CPU) against the JAX package's ``repro.kernels.ops`` run as
its own tests run it: ``impl="xla"`` and the Pallas kernel in interpret mode.
The CUDA kernels themselves are held to the same plain versions on the card
by ``chip_smoke.py`` and ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from torch_parity import TOL, assert_topk_match
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)

IMPLS = ("xla", "pallas_interpret")


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# distance
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", ["ip", "l2"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_distance_parity(impl, kind, bf16):
    rng = np.random.default_rng(1)
    q, x = _unit(rng, 16, 64), _unit(rng, 3, 200, 64)  # 3 stacked segments
    xj = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    x_np = np.array(xj.astype(jnp.float32))  # the stored values, exactly
    jfn = jops.batched_ip if kind == "ip" else jops.l2_distance
    want = np.stack([np.asarray(jfn(jnp.asarray(q), xj[z], impl=impl)) for z in range(3)])
    xt = torch.from_numpy(x_np).to(torch.bfloat16 if bf16 else torch.float32)
    tfn = ops.batched_ip if kind == "ip" else ops.l2_distance
    got = tfn(torch.from_numpy(q), xt)
    assert got.shape == (3, 16, 200) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # the flat (n, d) form of the same call
    np.testing.assert_allclose(tfn(torch.from_numpy(q), xt[1]).numpy(), want[1], atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# fused IVF kernels
# ---------------------------------------------------------------------------
def _ivf_inputs(seed=3, n_seg=2, s=256, d=32, nlist=8, nprobe=3, dead_tail=20, holes=0.0):
    """Segments, k-means-like centroids, capacity-bound member lists and gids
    with dead (-1) slots, as the IVF builds lay them out; with ``holes``, each
    list's slots shuffled and that share of them set to -1, so padding sits
    anywhere in a list."""
    from repro.vdms.indexes import _ivf_cap, _member_lists

    rng = np.random.default_rng(seed)
    segs = _unit(rng, n_seg, s, d)
    assign = rng.integers(0, nlist, (n_seg, s))
    cents = np.stack([
        np.stack([segs[z][assign[z] == l].mean(0) for l in range(nlist)]) for z in range(n_seg)
    ]).astype(np.float32)
    cap = _ivf_cap(s, nlist, nprobe)
    members = np.stack([_member_lists(assign[z], nlist, cap) for z in range(n_seg)])
    gids = np.arange(n_seg * s, dtype=np.int32).reshape(n_seg, s)
    gids[:, -dead_tail:] = -1
    q = _unit(rng, 16, d)
    if holes:
        members = rng.permuted(members, axis=2)
        members[rng.random(members.shape) < holes] = -1
    return q, segs, cents, members, gids, nprobe


def _sq8_args(q, segs, cents, members, gids):
    scale = (np.abs(segs).max(axis=(0, 1)) / 127.0 + 1e-12).astype(np.float32)
    codes = np.clip(np.round(segs / scale), -127, 127).astype(np.int8)
    return q, codes, scale, cents, members, gids


def _pq_args(q, segs, cents, members, gids, seed=5, m=4, c=16):
    rng = np.random.default_rng(seed)
    lut = rng.standard_normal((q.shape[0], m, c)).astype(np.float32)
    codes = rng.integers(0, c, segs.shape[:2] + (m,)).astype(np.uint8)
    return q, lut, codes, cents, members, gids


def _fused_parity(kernel, args, impl, **kw):
    jfn, tfn = ((jops.fused_ivf_sq8_topk, ops.fused_ivf_sq8_topk) if kernel == "sq8"
                else (jops.fused_ivf_pq_topk, ops.fused_ivf_pq_topk))
    want = jfn(*map(jnp.asarray, args), impl=impl, **kw)
    got = tfn(*_t(*args), **kw)
    assert_topk_match(got[0], got[1], *want)
    return got


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("mask_dead", [False, True])
def test_fused_ivf_sq8_topk_parity(impl, k, mask_dead):
    q, segs, cents, members, gids, nprobe = _ivf_inputs()
    scale = (np.abs(segs).max(axis=(0, 1)) / 127.0 + 1e-12).astype(np.float32)
    codes = np.clip(np.round(segs / scale), -127, 127).astype(np.int8)
    want = jops.fused_ivf_sq8_topk(
        *map(jnp.asarray, (q, codes, scale, cents, members, gids)),
        nprobe=nprobe, k=k, mask_dead=mask_dead, impl=impl)
    got = ops.fused_ivf_sq8_topk(*_t(q, codes, scale, cents, members, gids),
                                 nprobe=nprobe, k=k, mask_dead=mask_dead)
    assert got[0].shape == (2, 16, k) and got[0].dtype == torch.int32
    assert_topk_match(got[0], got[1], *want)
    if mask_dead:  # no dead id survives
        lids = got[0].numpy()
        g = np.take_along_axis(gids[:, None, :].repeat(16, 1), np.maximum(lids, 0), axis=2)
        assert (g[lids >= 0] >= 0).all()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("mask_dead", [False, True])
def test_fused_ivf_pq_topk_parity(impl, k, mask_dead):
    q, segs, cents, members, gids, nprobe = _ivf_inputs(seed=4)
    rng = np.random.default_rng(5)
    m, c = 4, 16
    lut = rng.standard_normal((16, m, c)).astype(np.float32)
    codes = rng.integers(0, c, (2, 256, m)).astype(np.uint8)
    want = jops.fused_ivf_pq_topk(
        *map(jnp.asarray, (q, lut, codes, cents, members, gids)),
        nprobe=nprobe, k=k, mask_dead=mask_dead, impl=impl)
    got = ops.fused_ivf_pq_topk(*_t(q, lut, codes, cents, members, gids),
                                nprobe=nprobe, k=k, mask_dead=mask_dead)
    assert_topk_match(got[0], got[1], *want)


@pytest.mark.parametrize("impl,s", [("xla", 2048), ("pallas_interpret", 512)])
@pytest.mark.parametrize("kernel", ["sq8", "pq"])
def test_fused_large_probe_corner_parity(impl, s, kernel):
    """Every list probed (nprobe = nlist) at k 128, with the engine's list
    capacity for that nprobe, so a query's member slots P = nprobe * cap
    reach past the segment (the session's corner, scaled down)."""
    nlist = 16 if s > 1024 else 8
    q, segs, cents, members, gids, nprobe = _ivf_inputs(seed=6, n_seg=1, s=s, d=16,
                                                        nlist=nlist, nprobe=nlist)
    assert nprobe * members.shape[2] >= s
    make = _sq8_args if kernel == "sq8" else _pq_args
    lids, sims = _fused_parity(kernel, make(q, segs, cents, members, gids), impl,
                               nprobe=nprobe, k=128, mask_dead=False)
    assert bool(torch.isfinite(sims).all())  # more live candidates than k everywhere


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mask_dead", [False, True])
@pytest.mark.parametrize("kernel", ["sq8", "pq"])
def test_fused_padding_anywhere_parity(impl, mask_dead, kernel):
    """-1 slots in the middle of member lists, and dead gids among the live
    slots: the plain versions drop exactly what the JAX kernels drop."""
    q, segs, cents, members, gids, nprobe = _ivf_inputs(seed=7, holes=0.3, dead_tail=0)
    gids[:, ::7] = -1  # dead points scattered through the lists
    first_hole = (members[..., :-1] < 0) & (members[..., 1:] >= 0)
    assert first_hole.any()  # some -1 is followed by a live slot
    make = _sq8_args if kernel == "sq8" else _pq_args
    lids, _ = _fused_parity(kernel, make(q, segs, cents, members, gids), impl,
                            nprobe=nprobe, k=64, mask_dead=mask_dead)
    dead = np.take_along_axis(gids[:, None, :].repeat(16, 1), np.maximum(lids.numpy(), 0), 2) < 0
    assert dead[lids.numpy() >= 0].any() != mask_dead  # dead ids survive only without the mask


def test_fused_launch_result_too_large_is_a_contract_error():
    """A launcher that finds no block shape for the sizes returns TOO_LARGE,
    which the wrappers raise as a KernelContractError (a fault of the call,
    not a bad configuration)."""
    from repro_torch.kernels._build import TOO_LARGE, KernelContractError
    from repro_torch.kernels.fused_scan import check_launch

    with pytest.raises(KernelContractError, match="shared memory"):
        check_launch(TOO_LARGE, "fused_ivf_sq8_topk", k=1 << 20)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        check_launch(700, "fused_ivf_sq8_topk", k=64)
    check_launch(0, "fused_ivf_sq8_topk", k=64)


# ---------------------------------------------------------------------------
# merge primitive: lax.top_k's tie rule, slot for slot
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 7, 24])
def test_topk_by_score_ties_match_lax(k):
    rng = np.random.default_rng(k)
    sims = rng.integers(-3, 3, (6, 40)).astype(np.float32)  # many equal scores
    sims[rng.random(sims.shape) < 0.2] = -np.inf  # and empty slots
    ids = rng.permutation(6 * 40).reshape(6, 40).astype(np.int32)
    want_ids, want_s = jops.topk_by_score(jnp.asarray(ids), jnp.asarray(sims), k)
    got_ids, got_s = ops.topk_by_score(*_t(ids, sims), k)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [3, 20, 40])
def test_topk_stable_orders_signed_zeros_like_lax(k, dtype):
    """lax.top_k (and the CUDA kernels' rank_key) rank +0.0 above -0.0;
    a plain float sort takes them as equal."""
    import jax

    rng = np.random.default_rng(k)
    x = rng.integers(-1, 2, (5, 40)).astype(np.float32)
    x[(x == 0) & (rng.random(x.shape) < 0.5)] = -0.0
    x[rng.random(x.shape) < 0.1] = -np.inf
    xj = jnp.asarray(x, getattr(jnp, dtype))
    want_s, want_i = jax.lax.top_k(xj, k)
    got_s, got_i = ops.topk_stable(torch.from_numpy(x).to(getattr(torch, dtype)), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    got_s = got_s.float().numpy()
    want_s = np.asarray(want_s.astype(jnp.float32))
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(np.signbit(got_s), np.signbit(want_s))


def test_topk_stable_rejects_k_beyond_width():
    with pytest.raises(ValueError):
        ops.topk_stable(torch.zeros(2, 3), 4)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def test_dispatch_cpu_uses_plain_version():
    q, x = torch.ones(2, 4), torch.ones(5, 4)
    before = ops.launch_counts()
    assert torch.equal(ops.batched_ip(q, x), ops.batched_ip(q, x, impl="torch"))
    assert ops.launch_counts() == before  # no kernel launched for CPU tensors
    with pytest.raises(ValueError, match="unknown impl"):
        ops.batched_ip(q, x, impl="triton")
    assert set(ops.launch_counts()) == {"distance", "fused_ivf_sq8_topk", "fused_ivf_pq_topk",
                                        "pq_adc", "flash_attention", "flash_attention_bwd"}
