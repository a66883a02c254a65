"""The evaluation path of the port as a whole against the JAX package: the
seven default configurations measured in analytic mode on identical
indexes, and the tuning environment over the port."""
import numpy as np
import pytest
import torch

from repro.vdms import VDMSTuningEnv as JEnv
from repro_torch.core import TuningFailure
from repro_torch.vdms import VDMSInstance, VDMSTuningEnv, recall_at_k
from torch_parity import (
    SEVEN,
    assert_ids_match,
    carry,
    default_config,
    port_dataset,
    reference_dataset,
    reference_instance,
)
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)


@pytest.mark.parametrize("index_type", SEVEN)
def test_default_config_measures_like_reference(index_type):
    ref = reference_instance(index_type)
    ds = port_dataset()
    port = VDMSInstance(ds, default_config(index_type), device="cpu", bundle=carry(ref.bundle))
    want = ref.measure(mode="analytic")
    got = port.measure(mode="analytic")
    assert got["speed"] == want["speed"]  # identical cost-model arithmetic
    assert got["mem_gib"] == want["mem_gib"]
    ids_ref, ids_port = ref.search(ds.queries, ds.k), port.search(ds.queries, ds.k)
    assert_ids_match(ids_port, ids_ref, ds.data, ds.queries)
    n_diff = sum(len(set(a) ^ set(b)) for a, b in zip(ids_port.tolist(), ids_ref.tolist()))
    assert abs(got["recall"] - want["recall"]) <= n_diff / ds.ground_truth.size
    assert got["recall"] == recall_at_k(ids_port, ds.ground_truth)


def test_tuning_env_runs_and_caches():
    ds = port_dataset()
    env = VDMSTuningEnv(ds, mode="analytic", device="cpu")
    cfg = default_config("IVF_SQ8")
    first = env(cfg)
    assert set(first) == {"speed", "recall", "mem_gib", "build_time", "compile_time"}
    assert 0.0 < first["recall"] <= 1.0 and np.isfinite(first["speed"])
    assert env(dict(cfg)) == first  # served from the cache
    assert env.n_evals == 1 and len(env.cache) == 1
    assert env.workload_stats() == JEnv(reference_dataset(), mode="analytic").workload_stats()


def test_tuning_env_build_timeout_is_a_tuning_failure():
    env = VDMSTuningEnv(port_dataset(), mode="analytic", device="cpu", build_timeout=-1.0)
    with pytest.raises(TuningFailure, match="exceeded"):
        env(default_config("FLAT"))
    assert not env.cache


def test_tuning_env_rejects_unported_workloads():
    # fault injection (faults=) needs the streaming workload, as in the JAX package
    from repro_torch.vdms import FaultPlan

    with pytest.raises(ValueError, match="fault injection requires the streaming workload"):
        VDMSTuningEnv(port_dataset(), device="cpu", faults=FaultPlan())
    with pytest.raises(ValueError, match="trace="):
        VDMSTuningEnv(port_dataset(), device="cpu", workload="streaming")


def test_entry_points_need_a_device_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("the default device is the GPU here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VDMSTuningEnv(port_dataset())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VDMSInstance(port_dataset(), default_config("FLAT"))


def test_kernel_contract_error_ends_an_evaluation(monkeypatch):
    """A kernel wrapper refusing its inputs is a fault of the program, not a
    bad configuration: it propagates out of the environment (a ValueError
    would have been scored as a TuningFailure)."""
    from repro_torch.kernels._build import KernelContractError
    from repro_torch.kernels.fused_scan import fused_ivf_sq8_topk_cuda
    from repro_torch.vdms import fused

    def kernel_on_host_tensors(q, codes, scale, centroids, members, gids, **kw):
        return fused_ivf_sq8_topk_cuda(q, codes, scale, centroids, members, gids, **kw)

    monkeypatch.setattr(fused.ops, "fused_ivf_sq8_topk", kernel_on_host_tensors)
    env = VDMSTuningEnv(port_dataset(), mode="analytic", device="cpu")
    with pytest.raises(KernelContractError, match="CUDA device"):
        env(default_config("IVF_SQ8"))
    assert not env.cache
