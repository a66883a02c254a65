"""Streaming workload traces of the port against the JAX package: the same
seed gives the same trace arrays, the time-aware ground truth is equal, and
the trace helpers (windows, phases, masked recall, the Poisson serving
driver) behave as the reference's (the twin of ``tests/test_workload.py``)."""
import numpy as np
import pytest

import repro.vdms as jv
import repro.vdms.workload as jw
from repro_torch.vdms import (
    LiveVDMS,
    blend_vectors,
    dataset_names,
    exact_topk_masked,
    make_trace,
    recall_at_k_masked,
    replay_query_streams,
    replay_trace,
    time_aware_ground_truth,
)
from repro_torch.vdms import workload as tw
from repro_torch.vdms.datasets import default_dim, raw_vectors
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)

FIELDS = ("base", "kinds", "payload", "times", "inserts", "queries")
FLAT_CFG = dict(
    index_type="FLAT",
    segment_max_size=256,
    seal_proportion=0.5,
    graceful_time=0.0,
    search_batch_size=8,
    topk_merge_width=64,
    kmeans_iters=4,
    storage_bf16=False,
)


def _both(**kw):
    return jv.make_trace("glove_like", **kw), make_trace("glove_like", **kw)


def _assert_same_trace(a, b):
    assert (a.name, a.dim, a.k) == (b.name, b.dim, b.k)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)


@pytest.mark.parametrize("kw", [
    dict(n_base=400, n_ops=160, seed=3, mix=(0.3, 0.55, 0.15)),
    dict(n_base=64, n_ops=600, seed=0, drift="ramp", mix=(0.05, 0.9, 0.05),
         mix_to=(0.7, 0.2, 0.1)),
    dict(n_base=200, n_ops=300, seed=5, drift="sine", drift_to="georadius_like", dim=32),
    dict(n_base=4, n_ops=200, mix=(0.0, 0.4, 0.6), dim=16, seed=0),  # victims run out
], ids=["mixed", "mix-drift", "sine", "exhausted"])
def test_make_trace_matches_reference(kw):
    _assert_same_trace(*_both(**kw))


def test_schedules_and_errors_match_reference():
    assert tw.DRIFT_SCHEDULES.keys() == jw.DRIFT_SCHEDULES.keys()
    tau = np.linspace(0.0, 1.0, 101)
    for name, fn in tw.DRIFT_SCHEDULES.items():
        np.testing.assert_array_equal(fn(tau), jw.DRIFT_SCHEDULES[name](tau))
    assert (tw.OP_INSERT, tw.OP_SEARCH, tw.OP_DELETE) == (jw.OP_INSERT, jw.OP_SEARCH,
                                                          jw.OP_DELETE)
    for kw in (dict(drift="warp"), dict(mix=(1.0, -0.5, 0.5)), dict(n_base=0)):
        args = dict(dict(n_base=10, n_ops=10), **kw)
        with pytest.raises(ValueError) as want:
            jv.make_trace("glove_like", **args)
        with pytest.raises(ValueError) as got:
            make_trace("glove_like", **args)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(n_base=150, n_ops=120, seed=3, mix=(0.3, 0.55, 0.15)),
    dict(n_base=4, n_ops=200, mix=(0.0, 0.4, 0.6), dim=16, seed=0),
    dict(n_base=300, n_ops=200, seed=1, mix=(0.2, 0.6, 0.2), drift="step"),
], ids=["mixed", "exhausted", "step"])
def test_time_aware_ground_truth_matches_reference(kw):
    jt, t = _both(**kw)
    want = jv.time_aware_ground_truth(jt)
    got = time_aware_ground_truth(t, device="cpu")
    assert got.shape == want.shape and got.dtype == np.int32
    for row, (a, b) in enumerate(zip(got.tolist(), want.tolist())):
        assert set(a) == set(b), row
        assert a.count(-1) == b.count(-1), row
    k5 = time_aware_ground_truth(t, k=5, device="cpu")
    np.testing.assert_array_equal(k5, got[:, :5])  # the first five, best first


def test_windows_and_phases_match_reference():
    jt, t = _both(n_base=200, n_ops=150, seed=3, mix=(0.3, 0.55, 0.15))
    _assert_same_trace(jt.window(40, 120), t.window(40, 120))
    for a, b in zip(jt.split(3), t.split(3)):
        _assert_same_trace(a, b)
    np.testing.assert_array_equal(t.all_vectors(), jt.all_vectors())
    with pytest.raises(ValueError):
        t.window(5, 3)
    with pytest.raises(ValueError):
        t.split(0)


def test_dataset_helpers_match_reference():
    from repro.vdms import datasets as jd

    assert dataset_names() == jd.dataset_names()
    for name in dataset_names():
        assert default_dim(name) == jd.default_dim(name)
        a = raw_vectors(name, np.random.default_rng(4), 20, 12)
        np.testing.assert_array_equal(a, jd.raw_vectors(name, np.random.default_rng(4), 20, 12))
    a, b = raw_vectors("glove_like", np.random.default_rng(0), 30, 8), raw_vectors(
        "keyword_like", np.random.default_rng(1), 30, 8)
    w = np.linspace(0, 1, 30)
    np.testing.assert_array_equal(blend_vectors(a, b, w), jd.blend_vectors(a, b, w))
    rng = np.random.default_rng(2)
    data, queries = rng.standard_normal((50, 8)).astype(np.float32), rng.standard_normal(
        (7, 8)).astype(np.float32)
    for n_dead in (0, 20, 46, 50):
        dead = np.zeros(50, bool)
        dead[rng.permutation(50)[:n_dead]] = True
        np.testing.assert_array_equal(exact_topk_masked(data, queries, dead, 5),
                                      jd.exact_topk_masked(data, queries, dead, 5))


def test_recall_at_k_masked_padding():
    gt = np.array([[0, 1, -1], [-1, -1, -1]], np.int32)
    pred = np.array([[0, 1, 2], [5, 6, 7]], np.int32)
    assert recall_at_k_masked(pred, gt) == 1.0  # the all-pad row drops out
    pred2 = np.array([[0, 9, 9], [5, 6, 7]], np.int32)
    assert recall_at_k_masked(pred2, gt) == 0.5 == jv.recall_at_k_masked(pred2, gt)


def test_replay_flat_graceful0_is_exact():
    t = make_trace("glove_like", n_base=300, n_ops=120, seed=3, mix=(0.3, 0.55, 0.15))
    r = replay_trace(t, FLAT_CFG, mode="analytic", device="cpu")
    assert r["recall"] == pytest.approx(1.0)
    assert r["speed"] > 0 and r["mem_gib"] > 0


def test_poisson_streams_match_reference():
    np.testing.assert_array_equal(tw.poisson_arrivals(50.0, 40, seed=3, t0=1.0),
                                  jw.poisson_arrivals(50.0, 40, seed=3, t0=1.0))
    q = np.random.default_rng(0).standard_normal((9, 4)).astype(np.float32)
    for (ta, ra), (tb, rb) in zip(tw.make_query_streams(q, 3, 30.0, 11, seed=2),
                                  jw.make_query_streams(q, 3, 30.0, 11, seed=2)):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(ra, rb)
    with pytest.raises(ValueError):
        tw.poisson_arrivals(0.0, 3)
    with pytest.raises(ValueError):
        tw.make_query_streams(q, 0, 1.0, 3)


def test_replay_query_streams_matches_reference():
    """The serving driver on live instances holding the same vectors: with
    FLAT (no build draws) the analytic service times and so every number of
    the report are equal."""
    base = make_trace("glove_like", n_base=300, n_ops=40, seed=2).base
    queries = make_trace("glove_like", n_base=8, n_ops=60, seed=4).queries
    engines = []
    for cls, kw in ((jv.LiveVDMS, {}), (LiveVDMS, {"device": "cpu"})):
        live = cls(FLAT_CFG, dim=base.shape[1], capacity=400, **kw)
        live.bootstrap(base)
        engines.append(live)
    want = jw.replay_query_streams(engines[0], queries, rate=2000.0, n_streams=4,
                                   n_per_stream=12, seed=1)
    got = replay_query_streams(engines[1], queries, rate=2000.0, n_streams=4,
                               n_per_stream=12, seed=1)
    assert got == want
