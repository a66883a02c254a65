"""``pq_adc``, IVF_PQR and the kernel benchmark of the port against the JAX
package: the plain ADC scan against ``repro.kernels.ops.pq_adc`` (XLA and
the Pallas kernel in interpret mode), its dispatch, IVF_PQR's composed
search on indexes the reference built, fused against composed on the port
(``reorder_k`` beyond the candidates included), and the benchmark twin's CLI
on the CPU.

IVF_PQR is registered into the port's registry only inside the
``port_ivf_pqr`` fixture, which unregisters it again; no test here touches
the JAX package's registry (its ``register()`` is never called)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.vdms import ivf_pqr as jpqr
from repro.vdms.segments import plan_segments, stack_sealed
from repro_torch.bench import bench_kernels
from repro_torch.kernels import ops
from repro_torch.kernels.pq_adc import pq_adc_cuda
from repro_torch.kernels._build import KernelContractError
from repro_torch.vdms import (
    VDMSInstance,
    bundle_from_numpy,
    make_space,
    set_search_pipeline,
)
from repro_torch.vdms import ivf_pqr
from repro_torch.vdms.registry import REGISTRY
from torch_parity import assert_topk_match, port_dataset, reference_dataset

# the plain version sums the m terms in order; XLA and the one-hot matrix
# products of the Pallas kernel may associate them otherwise
ADC_RTOL = 1e-5


@pytest.mark.parametrize("q,n,m,c", [(5, 1000, 4, 16), (11, 1037, 8, 64), (7, 1500, 3, 256),
                                     (2, 130, 1, 256)])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_pq_adc_plain_matches_reference(q, n, m, c, impl):
    rng = np.random.default_rng(q * n + c)
    lut = rng.standard_normal((q, m, c)).astype(np.float32)
    codes = rng.integers(0, c, (n, m)).astype(np.int32)
    want = np.asarray(jops.pq_adc(jnp.asarray(lut), jnp.asarray(codes), impl=impl))
    got = ops.pq_adc(torch.from_numpy(lut), torch.from_numpy(codes))
    np.testing.assert_allclose(got.numpy(), want, rtol=ADC_RTOL, atol=ADC_RTOL)


def test_pq_adc_blocks_and_dispatch():
    rng = np.random.default_rng(3)
    lut = torch.from_numpy(rng.standard_normal((6, 5, 32)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 32, (1001, 5)).astype(np.int32))
    before = ops.launch_counts()
    whole = ops.pq_adc(lut, codes)
    assert ops.launch_counts() == before  # CPU tensors take the plain version
    torch.testing.assert_close(ops.pq_adc(lut, codes, impl="torch"), whole, rtol=0, atol=0)
    with pytest.raises(KernelContractError, match="CUDA device"):
        pq_adc_cuda(lut, codes)  # the kernel's wrapper never falls back to the host
    with pytest.raises(ValueError, match="unknown impl"):
        ops.pq_adc(lut, codes, impl="pallas")


# ---------------------------------------------------------------------------
# IVF_PQR
# ---------------------------------------------------------------------------
@pytest.fixture
def port_ivf_pqr():
    assert "IVF_PQR" not in make_space().type_names
    ivf_pqr.register()
    ivf_pqr.register()  # idempotent
    try:
        yield
    finally:
        REGISTRY.unregister("IVF_PQR")
        set_search_pipeline("fused")


def _reference_bundle(params):
    """An IVF_PQR bundle built by the JAX package's build function over the
    parity dataset's segments (no registration needed)."""
    ds = reference_dataset()
    plan = plan_segments(ds.n, 1024, 0.75, 0.2)
    segs, gids = stack_sealed(ds.data, plan)
    sys_ = dict(kmeans_iters=4, storage_bf16=False)
    return jpqr.build_ivf_pqr(jax.random.PRNGKey(0), jnp.asarray(segs), jnp.asarray(gids),
                              params, sys_)


@pytest.mark.parametrize("nprobe,reorder_k", [(4, 64), (1, 512)], ids=["r<P", "r>P"])
def test_ivf_pqr_composed_matches_reference(nprobe, reorder_k):
    b = _reference_bundle(dict(nlist=16, nprobe=nprobe, m=8, nbits=6, reorder_k=reorder_k))
    q = reference_dataset().queries
    want = jpqr.search_ivf_pqr(jnp.asarray(q), b.arrays, k_seg=64, **b.static)
    port = bundle_from_numpy(b.kind, b.arrays, b.static, "cpu")
    got = ivf_pqr.search_ivf_pqr(torch.from_numpy(q), port.arrays, k_seg=64, **port.static)
    assert_topk_match(got[0].numpy(), got[1].numpy(), np.asarray(want[0]), np.asarray(want[1]))
    cost = jpqr._chunk_cost_ivf_pqr(b.static, b.arrays, 3, 1024, 64)
    assert ivf_pqr._chunk_cost_ivf_pqr(port.static, port.arrays, 3, 1024, 64) == cost


@pytest.mark.parametrize("nprobe,reorder_k,clamp_sys", [(8, 64, 1024), (1, 512, 1024),
                                                          (2, 32, 1000)])
def test_ivf_pqr_fused_matches_composed(port_ivf_pqr, nprobe, reorder_k, clamp_sys):
    """On the port, the fused hook (PQ kernel's plain version at width
    reorder_k, exact re-rank) returns the composed path's result sets, with
    a clamped (full segments) and an unclamped (padded partial seal) plan."""
    ds = port_dataset()
    cfg = make_space().default_config("IVF_PQR")
    cfg.update(nlist=16, nprobe=nprobe, reorder_k=reorder_k, segment_max_size=clamp_sys,
               seal_proportion=0.5)
    inst = VDMSInstance(ds, cfg, device="cpu")
    out = {}
    for mode in ("composed", "fused"):
        set_search_pipeline(mode)
        out[mode] = inst.search(ds.queries, ds.k)
    np.testing.assert_array_equal(np.sort(out["fused"], 1), np.sort(out["composed"], 1))
    assert inst.measure(mode="analytic")["recall"] > 0.5


def test_ivf_pqr_registration_is_undone(port_ivf_pqr):
    assert make_space().type_names[-1] == "IVF_PQR"


# ---------------------------------------------------------------------------
# the kernel benchmark twin
# ---------------------------------------------------------------------------
def test_bench_kernels_cli_on_the_cpu(tmp_path, capsys):
    path = tmp_path / "bench.json"
    assert bench_kernels.main(["--device", "cpu", "--quick", "--repeats", "1",
                               "--json", str(path)]) == 0
    out = capsys.readouterr().out
    assert "plain PyTorch versions only" in out
    for row in ("distance_ip_128x8192x96/plain", "pq_adc_128x8192x8x256/plain",
                "flash_fwd_b1_s1024_h8_d64/plain"):
        assert f"kernel/{row}," in out
    import json

    records = json.loads(path.read_text())
    assert set(records) == {"IVF_FLAT", "IVF_SQ8", "IVF_PQ", "IVF_PQR"}
    assert all(records[f]["same_sets_32"] for f in ("IVF_SQ8", "IVF_PQ", "IVF_PQR"))
    assert not records["IVF_FLAT"]["fused_hook"]
    assert "IVF_PQR" not in make_space().type_names  # the section undid its registration


def test_bench_kernels_needs_a_device_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("the default device is the GPU here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_kernels.main(["--ops-only"])
