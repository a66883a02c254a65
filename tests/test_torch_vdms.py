"""Parity of the port's VDMS layer (``repro_torch.vdms``) with the JAX
package: k-means, IVF list layout, quantizer encodings, the composed search
of every family on indexes carried across from the reference, fused against
composed search on the port, and the analytic cost model."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.vdms import indexes as jidx
from repro.vdms import engine as jengine
from repro.vdms import kmeans as jkm
from repro.vdms import make_dataset as j_make_dataset
from repro.vdms import make_space as j_make_space
from repro.vdms.segments import stack_sealed
from repro_torch.vdms import (
    VDMSInstance,
    analytic_build_seconds,
    analytic_chunk_seconds,
    get_search_pipeline,
    make_dataset,
    make_space,
    search_index,
    set_search_pipeline,
)
from repro_torch.vdms import indexes as tidx
from repro_torch.vdms.kmeans import init_indices, kmeans, kmeans_l2
from torch_parity import (
    SEVEN,
    TOL,
    assert_ids_match,
    assert_topk_match,
    carry,
    default_config,
    port_dataset,
    reference_dataset,
    reference_instance,
)
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)


def test_space_matches_reference():
    ref = j_make_space(include=SEVEN)
    port = make_space()
    assert port.type_names == SEVEN
    assert port.encoding_signature() == ref.encoding_signature()
    for t in SEVEN:
        assert port.default_config(t) == ref.default_config(t)


def test_make_dataset_matches_reference():
    ref = j_make_dataset("glove_like", n=1500, n_queries=16, k=10, seed=2, dim=48)
    port = make_dataset("glove_like", n=1500, n_queries=16, k=10, seed=2, dim=48, device="cpu")
    np.testing.assert_array_equal(port.data, ref.data)
    np.testing.assert_array_equal(port.queries, ref.queries)
    np.testing.assert_array_equal(port.ground_truth, ref.ground_truth)


# ---------------------------------------------------------------------------
# k-means with the reference's initial draws injected
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spherical", [True, False], ids=["kmeans", "kmeans_l2"])
def test_kmeans_matches_reference(spherical):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 600, 24)).astype(np.float32)
    if spherical:
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    k, iters = (16, 8) if spherical else (32, 6)
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    jfn = jkm.kmeans if spherical else jkm.kmeans_l2
    ref = [jfn(keys[i], jnp.asarray(x[i]), k, iters) for i in range(2)]
    init = np.stack([np.asarray(jax.random.choice(keys[i], 600, shape=(k,), replace=False))
                     for i in range(2)])
    tfn = kmeans if spherical else kmeans_l2
    cent, assign = tfn(torch.from_numpy(x), k, iters, init_idx=init)
    for i in range(2):
        np.testing.assert_array_equal(assign[i].numpy(), np.asarray(ref[i][1]))
        np.testing.assert_allclose(cent[i].numpy(), np.asarray(ref[i][0]), atol=TOL)


def test_kmeans_default_draws_are_seeded():
    x = torch.randn(3, 200, 16, generator=torch.Generator().manual_seed(0))
    x = torch.nn.functional.normalize(x, dim=-1)
    a = kmeans(x, 8, 4, init_idx=init_indices(3, 200, 8, torch.Generator().manual_seed(5)))
    b = kmeans(x, 8, 4, init_idx=init_indices(3, 200, 8, torch.Generator().manual_seed(5)))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# IVF layout and quantizer encodings
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cap", [12, 40])
def test_member_lists_match_reference(cap):
    rng = np.random.default_rng(cap)
    assign = rng.integers(0, 16, (3, 500))
    got = tidx._member_lists(torch.from_numpy(assign), 16, cap).numpy()
    for z in range(3):
        np.testing.assert_array_equal(got[z], jidx._member_lists(assign[z], 16, cap))


def test_ivf_cap_matches_reference():
    for s in (1024, 2048, 4096, 8192):
        for nlist in (16, 128, 512):
            for nprobe in (1, 8, 128):
                assert tidx._ivf_cap(s, nlist, nprobe) == jidx._ivf_cap(s, nlist, nprobe)


def _sealed(index_type):
    inst = reference_instance(index_type)
    segs, _ = stack_sealed(reference_dataset().data, inst.plan)
    return inst, torch.from_numpy(segs)


def test_sq8_encoding_matches_reference():
    inst, segs = _sealed("IVF_SQ8")
    codes, scale = tidx._sq8_encode(segs)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(inst.bundle.arrays["scale"]))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(inst.bundle.arrays["codes"]))


def test_pq_encoding_matches_reference():
    inst, segs = _sealed("IVF_PQ")
    cb = torch.from_numpy(np.array(inst.bundle.arrays["codebooks"]))
    np.testing.assert_array_equal(tidx._pq_encode(segs, cb).numpy(),
                                  np.asarray(inst.bundle.arrays["codes"]))


# ---------------------------------------------------------------------------
# composed search on carried-across indexes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("index_type", SEVEN)
def test_composed_search_matches_reference(index_type):
    inst = reference_instance(index_type)
    q = reference_dataset().queries
    k_seg = inst.k_seg
    want = jidx.search_index(inst.bundle, jnp.asarray(q), k_seg)
    got = search_index(carry(inst.bundle), torch.from_numpy(q), k_seg)
    assert got[0].shape == tuple(want[0].shape)
    assert_topk_match(got[0].numpy(), got[1].numpy(), *want)


@pytest.mark.parametrize("n", [3000, 2048], ids=["partial-seal", "clamped"])
@pytest.mark.parametrize("index_type", ["IVF_SQ8", "IVF_PQ"])
def test_fused_matches_composed_on_port(index_type, n):
    ds = make_dataset("glove_like", n=n, n_queries=24, k=10, seed=1, dim=64, device="cpu")
    cfg = default_config(index_type)
    cfg["search_batch_size"] = 8  # three chunks, flattened by the fused hook
    inst = VDMSInstance(ds, cfg, seed=0, device="cpu")
    assert inst._clamp_ok == (n == 2048)
    before = get_search_pipeline()
    try:
        set_search_pipeline("fused")
        fused = inst.search(ds.queries, ds.k)
        set_search_pipeline("composed")
        composed = inst.search(ds.queries, ds.k)
    finally:
        set_search_pipeline(before)
    assert_ids_match(fused, composed, ds.data, ds.queries)


# ---------------------------------------------------------------------------
# analytic cost model: identical arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("index_type", SEVEN)
def test_analytic_costs_equal_reference(index_type):
    inst = reference_instance(index_type)
    port = carry(inst.bundle)
    plan, ds = inst.plan, reference_dataset()
    for batch in (8, 32, 128):
        args = (plan.n_sealed, plan.seg_size, plan.growing_searched, ds.dim, batch)
        assert analytic_chunk_seconds(port.kind, port.static, port.arrays, *args) == \
            jengine.analytic_chunk_seconds(inst.bundle.kind, inst.bundle.static,
                                           inst.bundle.arrays, *args)
    cfg = default_config(index_type)
    for seg_size in (1024, 4096):
        for first in (False, True):
            assert analytic_build_seconds(index_type, cfg, seg_size, 100, first) == \
                jengine.analytic_build_seconds(index_type, cfg, seg_size, 100, first)


def test_bundle_from_numpy_keeps_dtypes_and_bytes():
    inst = reference_instance("IVF_PQ")
    port = carry(inst.bundle)
    assert port.memory_bytes() == inst.bundle.memory_bytes()
    for name, a in inst.bundle.arrays.items():
        assert port.arrays[name].numpy().dtype == np.asarray(a).dtype
    assert port.static == inst.bundle.static
    assert port_dataset().n == reference_dataset().n
