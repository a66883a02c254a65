"""The port's live VDMS lifecycle, streaming tuning environment and drift
re-tuning against the JAX package (the twin of ``tests/test_streaming.py``):
``replay_trace`` of all eight families with the reference's build draws
folded per seal and compaction gives the same result ids, recall, analytic
speed, seal and compaction counts and history."""
import json

import numpy as np
import pytest

import repro.vdms as jv
from repro import core as jc
from repro.vdms import ivf_pqr as j_pqr
from repro_torch.core import (
    DriftDetector,
    TuningFailure,
    TuningSession,
    VDTuner,
    streaming_sustained,
)
from repro_torch.vdms import (
    LiveVDMS,
    VDMSInstance,
    VDMSTuningEnv,
    exact_topk_masked,
    ivf_pqr,
    live_seg_size,
    make_dataset,
    make_space,
    make_trace,
    registered_names,
    replay_trace,
    unregister_family,
)
from torch_parity import ReferenceDraws
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)

LIVE_CFG = dict(
    index_type="IVF_FLAT",
    nlist=16,
    nprobe=16,
    segment_max_size=256,
    seal_proportion=0.5,
    graceful_time=0.0,
    search_batch_size=8,
    topk_merge_width=64,
    kmeans_iters=4,
    storage_bf16=False,
)


def _vectors(n, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _live(cfg=LIVE_CFG, capacity=1024, **kw):
    return LiveVDMS(cfg, dim=16, capacity=capacity, device="cpu", **kw)


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------
def test_seal_fires_exactly_at_threshold():
    s = live_seg_size(256, 0.5)
    assert s == 128 == jv.live_seg_size(256, 0.5)
    live = _live()
    live.insert(_vectors(s - 1))
    assert live.n_sealed == 0 and len(live.tail) == s - 1
    live.insert(_vectors(1, seed=1))
    assert live.n_sealed == 1 and len(live.tail) == 0
    assert live.seal_history == [1]


def test_bulk_insert_seals_multiple_segments():
    live = _live()
    live.bootstrap(_vectors(300))
    assert live.n_sealed == 2 and len(live.tail) == 300 - 2 * 128
    assert live.seal_build_s == 0.0  # bootstrap seals are initial build time
    assert live.build_time > 0.0
    assert live.bundle.arrays["data"].shape == (2, 128, 16)


def test_capacity_guard_and_unknown_family():
    with pytest.raises(ValueError, match="capacity exceeded"):
        _live(capacity=100).insert(_vectors(101))
    with pytest.raises(ValueError, match="unknown index family"):
        _live(dict(LIVE_CFG, index_type="NOPE"))


def test_tombstoned_ids_never_returned():
    live = _live()
    data = _vectors(200)
    live.insert(data)  # 128 sealed + 72 growing
    victims = [3, 150]  # one sealed, one in the tail
    for v in victims:
        assert live.delete(v)
        assert not live.delete(v)  # a second delete is a no-op
    ids, _ = live.search(data[victims], topk=10)
    assert not set(victims) & set(ids.ravel().tolist())


@pytest.mark.parametrize("index_type", ["IVF_FLAT", "IVF_SQ8", "IVF_PQ"])
def test_compaction_triggers_and_preserves_visible_set(index_type):
    cfg = dict(LIVE_CFG, index_type=index_type, m=4, nbits=4)
    live = _live(cfg, compact_threshold=0.2)
    live.insert(_vectors(128))  # exactly one sealed segment
    for gid in range(40):  # > 20% of the segment
        live.delete(gid)
    assert live.n_compactions >= 1
    assert set(live.visible_ids().tolist()) == set(range(40, 128))
    row = live.bundle.arrays["gids"][0].tolist()  # survivors first, then -1 padding
    n_pad = row.count(-1)
    assert n_pad > 0 and row[128 - n_pad:] == [-1] * n_pad
    assert set(row[: 128 - n_pad]) >= set(range(40, 128))
    # the compacted segment still answers and never returns a dead id
    ids, _ = live.search(_vectors(8, seed=2), topk=10)
    returned = set(ids.ravel().tolist()) - {-1}
    assert returned and returned <= set(range(40, 128))


def test_live_search_exact_with_flat_and_zero_graceful():
    live = _live(dict(LIVE_CFG, index_type="FLAT"))
    data = _vectors(300)
    live.insert(data)
    for gid in (5, 17, 200):
        live.delete(gid)
    queries = _vectors(20, seed=9)
    ids, _ = live.search(queries, topk=5)
    dead = np.ones(300, bool)
    dead[live.visible_ids()] = False
    want = exact_topk_masked(data, queries, dead, 5)
    for got_row, want_row in zip(ids, want):
        assert set(got_row.tolist()) == set(want_row.tolist())


def test_search_before_the_first_seal_and_graceful_window():
    live = _live(dict(LIVE_CFG, graceful_time=0.5))
    data = _vectors(100)
    live.insert(data)  # all in the tail; the newest half is invisible
    assert live.bundle is None
    ids, _ = live.search(data[:4], topk=3)
    assert set(ids.ravel().tolist()) <= set(range(50))
    np.testing.assert_array_equal(live.searchable_ids(), np.arange(50))
    assert live.last_coverage == 1.0
    empty = _live(dict(LIVE_CFG, graceful_time=1.0))
    empty.insert(data[:10])
    assert (empty.search(data[:2], topk=3)[0] == -1).all()


def test_incremental_builds_freeze_shared_calibration():
    cfg = dict(LIVE_CFG, index_type="IVF_SQ8")
    live = _live(cfg)
    live.insert(_vectors(128))
    scale_first = live.bundle.arrays["scale"].clone()
    live.insert(_vectors(128, seed=5) * 0.5)  # a different dynamic range
    assert live.n_sealed == 2
    assert live.bundle.arrays["scale"].equal(scale_first)


def test_live_search_records_per_query_latencies():
    live = _live()
    live.bootstrap(_vectors(300))
    seen = []
    live.search_hooks.append(lambda nq, lat, elapsed: seen.append((nq, lat.copy(), elapsed)))
    _, elapsed = live.search(_vectors(20, seed=7), topk=5)
    assert live.queries_served == 20
    assert live.last_latencies.shape == (20,)
    assert float(live.last_latencies.sum()) == pytest.approx(elapsed, rel=1e-6)
    (nq, lat, el), = seen
    assert nq == 20 and el == elapsed
    np.testing.assert_array_equal(lat, live.last_latencies)


def test_live_stats_match_reference():
    """The same operations on both engines: every count of ``stats()`` and
    the analytic elapsed time agree, and the port's snapshot is JSON-safe."""
    lives = [jv.LiveVDMS(LIVE_CFG, dim=16, capacity=1024),
             _live(draws=ReferenceDraws)]
    elapsed = []
    for live in lives:
        live.bootstrap(_vectors(300))
        live.insert(_vectors(10, seed=3))
        live.delete(0)
        elapsed.append(live.search(_vectors(4, seed=4), topk=5)[1])
    want, got = lives[0].stats(), lives[1].stats()
    assert set(want) <= set(got) and "upload_s" in got
    timed = {"seal_build_s", "build_time", "compile_s"}
    for key in set(want) - timed:
        assert got[key] == want[key], key
    assert got["n_total"] == 310 and got["tombstone_fraction"] == pytest.approx(1 / 310)
    assert elapsed[1] == elapsed[0]
    json.dumps(got)
    assert all(isinstance(v, (int, float)) for v in got.values())


def test_replay_trace_reports_latency_percentiles_and_hooks():
    trace = make_trace("glove_like", n_base=400, n_ops=120, seed=3, mix=(0.3, 0.6, 0.1))
    calls = []
    result = replay_trace(trace, LIVE_CFG, mode="analytic", device="cpu",
                          search_hooks=[lambda nq, lat, elapsed: calls.append(nq)])
    assert 0.0 < result["lat_p50_s"] <= result["lat_p95_s"] <= result["lat_p99_s"]
    assert sum(calls) == trace.n_searches
    assert result["tombstone_fraction"] >= 0.0 and result["upload_s"] >= 0.0


# ---------------------------------------------------------------------------
# the alive-gated merge and the bundle lifecycle ops against the reference
# ---------------------------------------------------------------------------
def _candidates(seed=0, n_seg=3, b=4, k=6, capacity=40):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, capacity, (n_seg, b, k)).astype(np.int32)
    # rounded to make ties, -0.0 against 0.0 among them
    sims = np.round(rng.standard_normal((n_seg, b, k)), 1).astype(np.float32)
    sims[ids < 0] = -np.inf
    alive = rng.random(capacity + 1) < 0.7
    alive[-1] = False  # the sentinel
    q = rng.standard_normal((b, 8)).astype(np.float32)
    growing = rng.standard_normal((5, 8)).astype(np.float32)
    ggids = np.array([30, 31, -1, 33, -1], np.int32)
    return ids, sims, alive, q, growing, ggids


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_and_partial_topk_match_reference(seed):
    import jax.numpy as jnp
    import torch

    from repro.vdms import merge as jm
    from repro_torch.vdms import merge as tm

    arrays = _candidates(seed)
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    for alive in (None, "live"):
        ja = j[2] if alive else None
        ta = t[2] if alive else None
        for topk in (5, 30):
            want_ids, want_s = jm.merge_topk(j[0], j[1], j[3], j[4], j[5], topk, alive=ja,
                                             return_scores=True)
            got_ids, got_s = tm.merge_topk(t[0], t[1], t[3], t[4], t[5], topk, alive=ta,
                                           return_scores=True)
            np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
            np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6, atol=1e-6)
        want = jm.partial_topk(j[0], j[1], 7, alive=ja)
        got = tm.partial_topk(t[0], t[1], 7, alive=ta)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("index_type", ["IVF_SQ8", "IVF_PQ", "SCANN", "HNSW"])
def test_bundle_lifecycle_ops_match_reference(index_type):
    """One-segment builds with the reference's draws, the second with the
    first's frozen calibration, then ``concat_bundles`` and
    ``replace_segment``: the port's arrays equal the JAX package's."""
    import jax
    import torch

    from repro.vdms import indexes as ji
    from repro_torch.vdms import indexes as ti

    cfg = _family_config(index_type)
    sys = {"kmeans_iters": 4, "storage_bf16": False}
    x = _vectors(384, seed=4).reshape(3, 128, 16)
    gids = np.arange(384, dtype=np.int32).reshape(3, 128)
    gids[2, 100:] = -1
    key = jax.random.PRNGKey(0)
    draws = ReferenceDraws(0, "cpu")
    jb, tb = [], []
    frozen_j = frozen_t = None
    for z in range(3):
        jb.append(ji.build_index(jax.random.fold_in(key, z), x[z : z + 1], gids[z : z + 1],
                                 index_type, cfg, sys, frozen=frozen_j))
        tb.append(ti.build_index(draws.fold(z), torch.from_numpy(x[z : z + 1]),
                                 torch.from_numpy(gids[z : z + 1]), index_type, cfg, sys,
                                 frozen=frozen_t))
        if z == 0:
            frozen_j, frozen_t = ji.frozen_state(jb[0]), ti.frozen_state(tb[0])
            assert set(frozen_t) == set(frozen_j)
    want = ji.replace_segment(ji.concat_bundles(jb[0], jb[1]), 1, jb[2])
    got = ti.replace_segment(ti.concat_bundles(tb[0], tb[1]), 1, tb[2])
    assert got.static == want.static and set(got.arrays) == set(want.arrays)
    for name, a in want.arrays.items():
        np.testing.assert_allclose(got.arrays[name].numpy(), np.asarray(a), atol=1e-5,
                                   err_msg=name)
    with pytest.raises(ValueError, match="mismatch"):
        ti.concat_bundles(tb[0], ti.IndexBundle(tb[1].kind, tb[1].arrays, {"nprobe": -1}))


# ---------------------------------------------------------------------------
# replay parity, all eight families
# ---------------------------------------------------------------------------
EIGHT = ("FLAT", "IVF_FLAT", "IVF_SQ8", "IVF_PQ", "HNSW", "SCANN", "AUTOINDEX", "IVF_PQR")
# 300 base vectors and 300 ops at a third deletes: two seals in the
# bootstrap, one in the replay, and compactions at a 0.1 dead fraction
TRACE = dict(n_base=300, n_ops=300, seed=3, mix=(0.35, 0.35, 0.30), dim=16)
COMPACT = 0.1


def _family_config(index_type):
    cfg = make_space().default_config("IVF_PQ" if index_type == "IVF_PQR" else index_type)
    cfg.update(index_type=index_type, segment_max_size=256, seal_proportion=0.5,
               graceful_time=0.25, search_batch_size=8, kmeans_iters=4)
    if "nlist" in cfg:
        cfg.update(nlist=16, nprobe=4)
    if index_type in ("IVF_PQ", "IVF_PQR"):
        cfg.update(m=4, nbits=6)
    if index_type == "IVF_PQR":
        cfg["reorder_k"] = 32
    return cfg


def _recording(cls, store):
    search = cls.search

    def recorded(self, queries, topk, mode="analytic"):
        ids, elapsed = search(self, queries, topk, mode=mode)
        store.append(np.array(ids))
        return ids, elapsed

    return recorded


@pytest.fixture
def with_pqr():
    """IVF_PQR registered in both packages for the test only."""
    added = [reg for reg, names in ((j_pqr, jv.registered_names()), (ivf_pqr, registered_names()))
             if reg.FAMILY.name not in names]
    for reg in added:
        reg.register()
    yield
    if ivf_pqr in added:
        unregister_family(ivf_pqr.FAMILY.name)
    if j_pqr in added:
        jv.unregister_family(j_pqr.FAMILY.name)


@pytest.mark.parametrize("index_type", EIGHT)
def test_replay_trace_matches_reference(index_type, with_pqr, monkeypatch):
    jt, t = jv.make_trace("glove_like", **TRACE), make_trace("glove_like", **TRACE)
    cfg = _family_config(index_type)
    j_ids, t_ids = [], []
    monkeypatch.setattr(jv.LiveVDMS, "search", _recording(jv.LiveVDMS, j_ids))
    monkeypatch.setattr(LiveVDMS, "search", _recording(LiveVDMS, t_ids))
    want, jlive = jv.replay_trace(jt, cfg, mode="analytic", compact_threshold=COMPACT,
                                  with_live=True)
    got, live = replay_trace(t, cfg, mode="analytic", compact_threshold=COMPACT, with_live=True,
                             device="cpu", draws=ReferenceDraws)
    assert live.n_seals > 2 and live.n_compactions > 0  # seals in the replay, compactions
    assert live.seal_history == jlive.seal_history
    for key in ("n_seals", "n_compactions", "n_searches", "tombstone_fraction"):
        assert got[key] == want[key], key
    for key in ("recall", "speed", "seal_build_s", "mem_gib", "lat_p50_s", "lat_p99_s"):
        assert got[key] == pytest.approx(want[key], rel=1e-6), key
    assert len(t_ids) == len(j_ids)
    for n, (a, b) in enumerate(zip(t_ids, j_ids)):
        for row, (x, y) in enumerate(zip(a.tolist(), b.tolist())):
            assert set(x) == set(y), (n, row)
    np.testing.assert_array_equal(live.visible_ids(), jlive.visible_ids())


def test_replay_flat_at_graceful_zero_is_exact():
    t = make_trace("glove_like", **TRACE)
    cfg = dict(_family_config("FLAT"), graceful_time=0.0)
    r = replay_trace(t, cfg, mode="analytic", compact_threshold=COMPACT, device="cpu")
    assert r["recall"] == 1.0


# ---------------------------------------------------------------------------
# streaming environment
# ---------------------------------------------------------------------------
ENV_TRACE = dict(n_base=500, n_ops=150, seed=1, mix=(0.3, 0.6, 0.1))


def _streaming_env(n_phases=2, pkg="port", **kw):
    if pkg == "port":
        trace = make_trace("glove_like", **ENV_TRACE)
        return VDMSTuningEnv(trace=trace, workload="streaming", mode="analytic", seed=0,
                             n_phases=n_phases, device="cpu", **kw)
    return jv.VDMSTuningEnv(trace=jv.make_trace("glove_like", **ENV_TRACE), workload="streaming",
                            mode="analytic", seed=0, n_phases=n_phases)


def test_env_constructor_validation():
    with pytest.raises(ValueError):
        VDMSTuningEnv(workload="static", device="cpu")  # needs a dataset
    with pytest.raises(ValueError):
        VDMSTuningEnv(workload="streaming", device="cpu")  # needs a trace
    with pytest.raises(ValueError):
        VDMSTuningEnv(make_dataset("glove_like", n=256, n_queries=8, device="cpu"),
                      workload="bogus", device="cpu")


def test_env_phase_keyed_cache_matches_reference():
    env, jenv = _streaming_env(draws=ReferenceDraws), _streaming_env(pkg="ref")
    cfg = make_space().default_config("IVF_FLAT")
    r0 = env(cfg)
    assert env.n_evals == 1
    env(cfg)
    assert env.n_evals == 1  # cached within the phase
    env.set_phase(1)
    r1 = env(cfg)
    assert env.n_evals == 2  # the workload moved: a genuine re-evaluation
    assert r0 != r1
    with pytest.raises(ValueError):
        env.set_phase(2)
    for phase, got in ((0, r0), (1, r1)):
        env.set_phase(phase)
        jenv.set_phase(phase)
        want = jenv(cfg)
        for key in ("speed", "recall", "n_seals", "n_compactions", "seal_build_s"):
            assert got[key] == pytest.approx(want[key], rel=1e-6), (phase, key)
        assert env.workload_stats() == jenv.workload_stats()
    kind, phase_trace = env.current_workload()
    assert kind == "streaming" and phase_trace.n_ops == jenv.current_workload()[1].n_ops


def test_env_streaming_evaluate_batch_dedupes():
    env = _streaming_env(n_phases=1)
    space = make_space()
    a = space.default_config("FLAT")
    b = space.default_config("IVF_FLAT")
    out = env.evaluate_batch([a, b, dict(a)])
    assert env.n_evals == 2
    assert out[0] == out[2]
    assert {"speed", "recall", "mem_gib", "seal_build_s"} <= set(out[1])


def test_static_mode_results_and_cache_keys_unchanged():
    ds = make_dataset("glove_like", n=2048, n_queries=32, seed=0, device="cpu")
    env = VDMSTuningEnv(ds, mode="analytic", seed=0, device="cpu")
    cfg = make_space().default_config("IVF_FLAT")
    got = env(cfg)
    want = VDMSInstance(ds, cfg, seed=0, device="cpu").measure(repeats=env.repeats,
                                                               mode="analytic")
    for key in ("speed", "recall", "mem_gib"):
        assert got[key] == want[key], key
    (key,) = env.cache  # static cache keys carry no phase prefix
    assert all(isinstance(k, str) and k != "__phase__" for k, _ in key)
    with pytest.raises(ValueError):
        env.set_phase(0)


# ---------------------------------------------------------------------------
# drift detection + re-tuning
# ---------------------------------------------------------------------------
PROBES = [
    {"speed": 100.0, "recall": 0.9},
    {"speed": 110.0, "recall": 0.9},
    {"speed": 120.0, "recall": 0.9},
    {"speed": 60.0, "recall": 0.9},
    {"speed": 61.0, "recall": 0.5},
]


@pytest.mark.parametrize("kw", [dict(metrics=("speed", "recall"), rel_threshold=0.2, warmup=2),
                                dict(rel_threshold=0.1), dict(rel_threshold=0.25, warmup=3)])
def test_drift_detector_matches_reference(kw):
    det, jdet = DriftDetector(**kw), jc.DriftDetector(**kw)
    for p in PROBES:
        assert det.observe(p) == jdet.observe(p)
        assert det.reference == jdet.reference
    assert det.n_fired == jdet.n_fired and det.log == jdet.log
    assert json.loads(json.dumps(det.state_dict())) == json.loads(json.dumps(jdet.state_dict()))


def test_drift_detector_fires_on_relative_change():
    det = DriftDetector(metrics=("speed", "recall"), rel_threshold=0.2, warmup=2)
    assert not det.observe({"speed": 100.0, "recall": 0.9})
    assert not det.observe({"speed": 110.0, "recall": 0.9})  # still warming up
    assert det.reference == {"speed": 105.0, "recall": 0.9}
    assert not det.observe({"speed": 120.0, "recall": 0.9})  # +14% < 20%
    assert det.observe({"speed": 60.0, "recall": 0.9})  # -43% fires
    assert det.n_fired == 1
    det.reset()
    assert det.reference is None
    assert not det.observe({"speed": 60.0, "recall": 0.9})  # a new reference


def test_drift_detector_roundtrip_mid_warmup_and_strict_threshold():
    det = DriftDetector(rel_threshold=0.25, warmup=3)
    det.observe({"speed": 10.0, "recall": 0.5})
    det.observe({"speed": 14.0, "recall": 0.5})
    det2 = DriftDetector().load_state_dict(json.loads(json.dumps(det.state_dict())))
    assert det2.reference is None and len(det2._ref_buf) == 2
    det2.observe({"speed": 12.0, "recall": 0.5})
    assert det2.reference == {"speed": 12.0, "recall": 0.5}
    strict = DriftDetector(metrics=("speed",), rel_threshold=0.25, warmup=1)
    strict.observe({"speed": 1.0})
    assert not strict.observe({"speed": 1.25})  # rel == threshold does not fire
    assert strict.observe({"speed": 1.2500001})


def test_drift_detector_resume_then_probe_bit_identical():
    a = DriftDetector(rel_threshold=0.2, warmup=2)
    for p in PROBES:
        a.observe(p)
    b = DriftDetector(rel_threshold=0.2, warmup=2)
    for p in PROBES[:2]:
        b.observe(p)
    b = DriftDetector().load_state_dict(json.loads(json.dumps(b.state_dict())))
    for p in PROBES[2:]:
        b.observe(p)
    assert b.log == a.log and b.n_fired == a.n_fired and b.reference == a.reference


class _FakeBackend:
    """A deterministic cheap objective, so the session tests need no replay."""

    def __init__(self):
        self.n_evals = 0

    def __call__(self, cfg):
        self.n_evals += 1
        rng = np.random.default_rng(sum(map(ord, cfg["index_type"])))
        return {"speed": 100.0 + 50.0 * rng.random(), "recall": 0.5 + 0.4 * rng.random()}


def _tuned_session(n=9):
    backend = _FakeBackend()
    tuner = VDTuner(make_space(), backend, seed=0, warm_start=True, device="cpu",
                    gp_fit_steps=20, n_candidates=64, mc_samples=16)
    session = TuningSession(tuner)
    session.run(n)
    return session, tuner, backend


def test_retune_drops_stale_and_keeps_warm_gp():
    session, tuner, _ = _tuned_session(9)
    assert tuner._gp_warm is not None  # warm GP state exists before the drift
    assert session.retune() == 9
    assert tuner.history == [] and session.n_observations == 0
    assert tuner._gp_warm is not None  # hyperparameters survive the reset
    assert tuner.abandon.remaining == list(tuner.space.type_names)


def test_retune_keep_stale_demotes_to_bootstrap():
    session, tuner, _ = _tuned_session(9)
    assert session.retune(keep_stale=True) == 9
    assert len(tuner.history) == 9 and all(o.bootstrap for o in tuner.history)
    assert session.n_observations == 0


def test_retune_reanchors_and_tops_up_budget():
    session, tuner, backend = _tuned_session(9)
    anchors = tuner.pareto_configs(max_n=2)
    n_before = backend.n_evals
    session.retune(5, reanchor=anchors)
    assert session.n_observations >= 5 and backend.n_evals > n_before
    for obs, cfg in zip(tuner.history, anchors):  # the anchors landed first, fresh
        assert obs.config == cfg and not obs.bootstrap


def test_probe_drift_counts_backend_failure_as_drift():
    session, tuner, _ = _tuned_session(9)

    class Failing:
        def __call__(self, cfg):
            raise TuningFailure("gone")

    session.backend = Failing()
    det = DriftDetector()
    assert session.probe_drift(det, tuner.best_config())
    assert det.n_fired == 1


def test_best_config_and_pareto_configs():
    _, tuner, _ = _tuned_session(9)
    assert tuner.best_config()["index_type"] in tuner.space.type_names
    floor = float(np.median(tuner.Y[:, 1]))
    feas_best = tuner.best_config(rlim=floor)
    got = [o for o in tuner.history if o.config == feas_best]
    assert got and got[0].y[1] >= floor
    assert 1 <= len(tuner.pareto_configs(max_n=3)) <= 3


def test_streaming_objective_charges_ingest_overhead():
    raw = {"speed": 1000.0, "recall": 0.9, "n_searches": 100.0, "search_s": 0.1,
           "seal_build_s": 0.1}
    for alpha in (1.0, 0.5, 0.0):
        assert streaming_sustained(alpha=alpha)(raw) == jc.streaming_sustained(alpha=alpha)(raw)
    assert streaming_sustained(alpha=1.0)(raw)[0] == pytest.approx(500.0)
    assert streaming_sustained()({"speed": 1234.0, "recall": 0.8}) == (1234.0, 0.8)
