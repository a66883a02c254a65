"""Batched evaluation of the port (the twin of ``tests/test_batch_tuning.py``'s
``evaluate_batch`` cases): ``measure_batch`` and ``VDMSTuningEnv.evaluate_batch``
give the sequential results, failures come back per configuration, cache
hits are served, and a q > 1 session over the port matches the JAX
package's when the port builds with the reference's draws."""
import numpy as np
import pytest

import repro.core as jc
import repro.vdms as jv
from repro_torch.core import TuningFailure, TuningSession, VDTuner
from repro_torch.vdms import (
    VDMSInstance,
    VDMSTuningEnv,
    VectorDataset,
    batch_signature,
    make_space,
    measure_batch,
)
from repro_torch.vdms import engine
from torch_parity import ReferenceDraws
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)


@pytest.fixture(scope="module")
def dataset():
    from repro.vdms import make_dataset

    ds = make_dataset("glove_like", n=2048, n_queries=32, k=10, seed=0)
    return VectorDataset(ds.name, ds.data, ds.queries, ds.ground_truth, ds.k)


def _configs():
    space = make_space()
    base = space.default_config("IVF_FLAT")
    return [
        dict(base),                       # a same-signature group ...
        dict(base, kmeans_iters=16),      # ... same shapes, other centroids
        dict(base, nprobe=16),            # another static: its own search
        space.default_config("HNSW"),     # heterogeneous leftovers
        space.default_config("FLAT"),
        dict(base),                       # an in-batch duplicate (deduped)
    ]


def test_evaluate_batch_matches_sequential(dataset):
    cfgs = _configs()
    env_b = VDMSTuningEnv(dataset, mode="analytic", seed=0, device="cpu")
    out_b = env_b.evaluate_batch(cfgs)
    env_s = VDMSTuningEnv(dataset, mode="analytic", seed=0, device="cpu")
    out_s = [env_s(c) for c in cfgs]
    for i, (b, s) in enumerate(zip(out_b, out_s)):
        assert not isinstance(b, Exception), (i, b)
        for k in ("speed", "recall", "mem_gib"):
            assert b[k] == s[k], (i, k)
    assert env_b.n_evals == env_s.n_evals == 5  # the duplicate deduped in both paths


def test_evaluate_batch_matches_reference(dataset, small_dataset):
    """The JAX package's batch over the same configurations; the port builds
    with the reference's draws, so every speed and recall is equal."""
    cfgs = _configs()
    want = jv.VDMSTuningEnv(small_dataset, mode="analytic", seed=0).evaluate_batch(cfgs)
    env = VDMSTuningEnv(dataset, mode="analytic", seed=0, device="cpu", draws=ReferenceDraws)
    got = env.evaluate_batch(cfgs, max_workers=2)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("speed", "recall", "mem_gib"):
            assert g[k] == w[k], (i, k)


@pytest.mark.parametrize("family", ["FLAT", "IVF_SQ8", "IVF_PQ"])
def test_measure_batch_equals_measure(dataset, family, monkeypatch):
    """Same-signature instances measured together: each recall and analytic
    speed equals its own ``measure``; the SQ8 scales agree, so those
    instances fold into one search; PQ codebooks trained with other k-means
    settings differ, and each instance is searched on its own."""
    base = make_space().default_config(family)
    cfgs = [dict(base, kmeans_iters=it, graceful_time=g)
            for it, g in ((4, 0.2), (8, 0.5), (16, 0.2))]
    insts = [VDMSInstance(dataset, c, seed=0, device="cpu") for c in cfgs]
    assert len({batch_signature(i) for i in insts}) == 1
    searches = []
    search_index = engine.search_index
    monkeypatch.setattr(engine, "search_index",
                        lambda b, q, k: searches.append(b.arrays["gids"].shape[0])
                        or search_index(b, q, k))
    got = measure_batch(insts, mode="analytic")
    n_chunks = -(-dataset.queries.shape[0] // base["search_batch_size"])
    n_seg = insts[0].bundle.arrays["gids"].shape[0]
    folded = family != "IVF_PQ"
    assert searches == ([3 * n_seg] * n_chunks if folded else [n_seg] * (3 * n_chunks))
    for inst, g in zip(insts, got):
        want = inst.measure(mode="analytic")
        for k in ("speed", "recall", "mem_gib"):
            assert g[k] == want[k], k
    wall = measure_batch(insts, mode="wall", repeats=2)
    assert wall[0]["speed"] == wall[1]["speed"] == wall[2]["speed"] > 0  # an equal share
    assert [w["recall"] for w in wall] == [g["recall"] for g in got]


def test_measure_batch_rejects_mixed_instances(dataset):
    space = make_space()
    a = VDMSInstance(dataset, space.default_config("FLAT"), device="cpu")
    b = VDMSInstance(dataset, dict(space.default_config("FLAT"), search_batch_size=8),
                     device="cpu")
    with pytest.raises(ValueError, match="shape-identical"):
        measure_batch([a, b])
    other = VectorDataset(dataset.name, dataset.data, dataset.queries, dataset.ground_truth,
                          dataset.k)
    c = VDMSInstance(other, space.default_config("FLAT"), device="cpu")
    with pytest.raises(ValueError, match="shared dataset"):
        measure_batch([a, c])
    assert measure_batch([]) == []


def test_evaluate_batch_reports_failures_per_config(dataset):
    space = make_space()
    env = VDMSTuningEnv(dataset, mode="analytic", seed=0, device="cpu", build_timeout=0.0)
    out = env.evaluate_batch([space.default_config("FLAT"), space.default_config("HNSW")])
    assert all(isinstance(o, TuningFailure) for o in out)
    assert len(env.failures) == 2 and not env.cache


def test_evaluate_batch_serves_cache_hits(dataset):
    env = VDMSTuningEnv(dataset, mode="analytic", seed=0, device="cpu")
    cfg = make_space().default_config("IVF_FLAT")
    first = env(cfg)
    n = env.n_evals
    again = env.evaluate_batch([cfg, cfg])
    assert env.n_evals == n
    assert again[0]["speed"] == first["speed"] == again[1]["speed"]


@pytest.fixture
def seven_builtins():
    """Both registries with just their seven built-ins for the test (another
    module on this worker may have left IVF_PQR or a test family registered,
    which would change the search space of one package only)."""
    from repro.vdms.registry import REGISTRY as JREG
    from repro_torch.vdms.registry import REGISTRY

    held = [(reg, dict(reg._families)) for reg in (JREG, REGISTRY)]
    for reg, families in held:
        for name in list(families)[7:]:
            del reg._families[name]
    try:
        yield
    finally:
        for reg, families in held:
            reg._families.clear()
            reg._families.update(families)


def test_batched_session_matches_reference(dataset, small_dataset, seven_builtins):
    """VDTuner at q = 3 over ``evaluate_batch`` in both packages: the first
    rounds (the seven defaults, then a GP round) choose the same
    configurations with the same speeds and recalls."""
    n_iters = 10
    assert jv.make_space().type_names == make_space().type_names
    jt = jc.VDTuner(jv.make_space(), jv.VDMSTuningEnv(small_dataset, mode="analytic", seed=0),
                    seed=0, q=3, n_candidates=64, mc_samples=16, gp_fit_steps=30)
    jc.TuningSession(jt).run(n_iters)
    env = VDMSTuningEnv(dataset, mode="analytic", seed=0, device="cpu", draws=ReferenceDraws)
    t = VDTuner(make_space(), env, seed=0, q=3, n_candidates=64, mc_samples=16,
                gp_fit_steps=30, device="cpu")
    TuningSession(t).run(n_iters)
    assert len(t.history) == len(jt.history) == n_iters
    for o, jo in zip(t.history, jt.history):
        assert o.config == jo.config
        np.testing.assert_array_equal(o.y, jo.y)
