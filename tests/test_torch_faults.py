"""Fault injection, degraded-mode serving and the failure taxonomy of the
port (the twin of ``tests/test_faults.py``), plus parity with the JAX
package: an armed ``replay_trace`` of FLAT, IVF_SQ8 and IVF_PQ under each
canned plan, with the reference's build draws injected, gives the same
result dict and the same injector log as the reference's."""
import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.vdms as jv
from repro_torch.core import RetryPolicy, TuningFailure, TuningSession, VDTuner
from repro_torch.core.baselines import RandomLHS
from repro_torch.core.space import Param, SearchSpace
from repro_torch.serving import (
    ControllerParams,
    ServingController,
    SLOSpec,
    attach_straggler,
    serving_ledger,
)
from repro_torch.vdms import (
    BuildCrashFault,
    FaultEvent,
    FaultInjector,
    FaultPlan,
    LiveVDMS,
    ShadowBuildOOM,
    TransientEngineFault,
    VDMSTuningEnv,
    canned_fault_plans,
    classify_eval_error,
    make_space,
    make_trace,
    replay_trace,
)
from repro_torch.vdms.faults import FAULT_KINDS, HEALTH_CODE, HEALTH_STATES
from torch_parity import ReferenceDraws
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)

#: wall-clock result keys (differ run to run even in analytic mode)
WALL_KEYS = {"build_time", "compile_time", "upload_s"}
CPU = "cpu"


def _det(result):
    return {k: v for k, v in result.items() if k not in WALL_KEYS}


def _trace(n_base=400, n_ops=200, seed=0, drift=None):
    kw = {"drift": drift} if drift else {}
    return make_trace("glove_like", n_base=n_base, n_ops=n_ops, seed=seed,
                      mix=(0.3, 0.6, 0.1), **kw)


def _cfg(family="FLAT", **over):
    cfg = dict(make_space().default_config(family), segment_max_size=128, graceful_time=0.0)
    cfg.update(over)
    return cfg


def _live(cfg, dim, capacity, **kw):
    return LiveVDMS(cfg, dim, capacity, seed=0, device=CPU, **kw)


# ---------------------------------------------------------------------------
# FaultPlan: data, validation, generation
# ---------------------------------------------------------------------------
def test_fault_plan_json_round_trip_exact():
    plan = canned_fault_plans(200)["latency_storm"]
    assert FaultPlan.from_json(plan.to_json()) == plan
    assert FaultPlan.from_dict(json.loads(plan.to_json())) == plan
    d = plan.to_dict()
    assert all(set(e) == {f.name for f in dataclasses.fields(FaultEvent)} for e in d["events"])
    # the same plan, field for field, as the JAX package's
    assert plan.to_json() == jv.canned_fault_plans(200)["latency_storm"].to_json()
    assert FAULT_KINDS == jv.faults.FAULT_KINDS and HEALTH_STATES == jv.faults.HEALTH_STATES
    assert HEALTH_CODE == jv.faults.HEALTH_CODE


def test_fault_plan_validation():
    with pytest.raises(ValueError):
        FaultEvent(kind="quantum_flip")
    with pytest.raises(ValueError):
        FaultEvent(kind="build_crash", fails=0)
    with pytest.raises(ValueError):
        FaultEvent(kind="latency_storm", duration_ticks=0)
    with pytest.raises(ValueError):
        FaultPlan(backoff_base_ticks=0)
    with pytest.raises(ValueError):
        FaultInjector(FaultPlan(), scope="tertiary")


def test_fault_plan_generate_is_reproducible():
    a = FaultPlan.generate(7, horizon_ticks=300)
    b = FaultPlan.generate(7, horizon_ticks=300)
    assert a == b and len(a.events) == 3
    assert FaultPlan.generate(8, horizon_ticks=300) != a
    assert a.to_json() == jv.FaultPlan.generate(7, horizon_ticks=300).to_json()


# ---------------------------------------------------------------------------
# the unarmed path stays as it was
# ---------------------------------------------------------------------------
def test_unarmed_and_empty_plan_replay_identical():
    trace = _trace()
    cfg = _cfg("IVF_SQ8")
    plain = replay_trace(trace, cfg, device=CPU)
    empty = replay_trace(trace, cfg, fault_injector=FaultInjector(FaultPlan()), device=CPU)
    assert "coverage_min" not in plain and "n_quarantines" not in plain
    assert empty["coverage_min"] == 1.0 and empty["n_quarantines"] == 0
    for k in _det(plain):
        assert empty[k] == plain[k], f"fast path drifted on {k!r}"


def test_same_plan_replay_is_deterministic():
    trace = _trace()
    cfg = _cfg("FLAT")
    plan = canned_fault_plans(120)["segment_loss"]
    a = replay_trace(trace, cfg, fault_injector=FaultInjector(plan), device=CPU)
    b = replay_trace(trace, cfg, fault_injector=FaultInjector(plan), device=CPU)
    assert _det(a) == _det(b)
    assert a["n_quarantines"] >= 1


def test_no_retry_session_ledger_has_no_retry_keys():
    tuner = RandomLHS(_tiny_space(), lambda cfg: {"speed": 1.0, "recall": 0.9}, seed=0)
    session = TuningSession(tuner)
    session.run(3)
    led = session.ledger_dict()
    assert "n_retries" not in led["totals"]
    assert all("retries" not in e for r in led["rounds"] for e in r["evals"])


# ---------------------------------------------------------------------------
# degraded mode: quarantine, partial serving, exact rebuild
# ---------------------------------------------------------------------------
def test_segment_loss_serves_partial_results_from_searchable_set():
    trace = _trace(n_base=512)
    live = _live(_cfg("FLAT"), trace.dim, trace.capacity)
    live.bootstrap(trace.base)
    plan = FaultPlan(events=(FaultEvent(kind="segment_loss", at_tick=2, segment=0),),
                     backoff_base_ticks=1000)
    live.arm_faults(FaultInjector(plan))
    q = trace.queries[:16]
    ids0, _ = live.search(q, trace.k, mode="analytic")
    assert live.last_coverage == 1.0
    ids1, _ = live.search(q, trace.k, mode="analytic")  # tick 2: the loss fires
    assert 0.0 < live.last_coverage < 1.0
    assert live.health() == "rebuilding"
    assert live.quarantined and live.stats()["n_quarantines"] == 1
    svis = live.searchable_ids()
    got = np.unique(ids1[ids1 >= 0])
    assert np.isin(got, svis).all(), "served ids outside the searchable set"
    assert not np.array_equal(ids0, ids1)
    # the uploaded alive mask is the masked copy: same shape, dead sentinel
    alive_t = live.search_inputs()[2]
    assert alive_t.shape == (trace.capacity + 1,) and not bool(alive_t[-1])
    lost = live.seg_gids[0]
    assert not bool(alive_t[torch.from_numpy(lost[lost >= 0]).long()].any())
    assert live.alive[lost[lost >= 0]].all()  # the store's own mask is untouched


def _replay_ops(live, trace):
    for i in range(trace.n_ops):
        kind, row = int(trace.kinds[i]), int(trace.payload[i])
        if kind == 0:
            live.insert(trace.inserts[row])
        elif kind == 1:
            live.search(trace.queries[row][None, :], trace.k, mode="analytic")
        else:
            live.delete(row)


@pytest.mark.parametrize("family", ["FLAT", "IVF_SQ8"])
def test_rebuild_restores_exact_prefault_results(family):
    trace = _trace(n_base=512, n_ops=160, seed=3)
    cfg = _cfg(family)
    plan = FaultPlan(
        events=(
            FaultEvent(kind="segment_loss", at_tick=30, segment=0),
            FaultEvent(kind="segment_corruption", at_tick=50, segment=1),
        ),
        backoff_base_ticks=2,
    )
    engines = []
    for injector in (None, FaultInjector(plan)):
        live = _live(cfg, trace.dim, trace.capacity)
        live.bootstrap(trace.base)
        if injector is not None:
            live.arm_faults(injector)
        _replay_ops(live, trace)
        engines.append(live)
    clean, faulted = engines
    assert faulted.stats()["n_rebuilds"] == 2
    assert faulted.health() == "healthy" and not faulted.quarantined
    ids_clean, _ = clean.search(trace.queries[:32], trace.k, mode="analytic")
    ids_fault, _ = faulted.search(trace.queries[:32], trace.k, mode="analytic")
    assert np.array_equal(ids_clean, ids_fault)
    assert faulted.last_coverage == 1.0


@pytest.mark.parametrize("family", ["FLAT", "IVF_SQ8", "IVF_PQ"])
def test_rebuild_replays_segment_arrays_bit_for_bit(family):
    """The quarantine rebuild replays the segment's recorded draws and
    calibration choice: every array of the rebuilt segment equals the one
    it replaced, segment 0 (the first build, calibration not frozen) too."""
    seg = 128 if family != "IVF_PQ" else 512
    trace = _trace(n_base=3 * seg, n_ops=40, seed=4)
    live = _live(_cfg(family, segment_max_size=seg), trace.dim, trace.capacity)
    live.bootstrap(trace.base)
    before = {k: v.clone() for k, v in live.bundle.arrays.items()}
    plan = FaultPlan(events=(FaultEvent(kind="segment_loss", at_tick=1, segment=0),
                             FaultEvent(kind="segment_corruption", at_tick=2, segment=2)),
                     backoff_base_ticks=1)
    live.arm_faults(FaultInjector(plan))
    for _ in range(6):
        live.search(trace.queries[:4], trace.k, mode="analytic")
    assert live.n_rebuilds == 2 and live.health() == "healthy"
    for k, v in live.bundle.arrays.items():
        assert torch.equal(v, before[k]), k


def test_seal_crash_retries_with_backoff_then_succeeds():
    live = _live(_cfg("FLAT", segment_max_size=64), 16, 1024)
    rng = np.random.default_rng(0)
    live.bootstrap(rng.standard_normal((16, 16)).astype(np.float32))
    plan = FaultPlan(events=(FaultEvent(kind="build_crash", at_tick=1, fails=2),),
                     backoff_base_ticks=2, max_seal_retries=6)
    live.arm_faults(FaultInjector(plan))
    for _ in range(120):  # each insert ticks the fault clock
        live.insert(rng.standard_normal((16,)).astype(np.float32))
    st = live.stats()
    assert st["n_seal_retries"] == 2
    assert st["n_seals"] >= 1
    assert live._pending_seal is None and live.health() == "healthy"


def test_seal_retry_budget_exhaustion_raises_transient():
    live = _live(_cfg("FLAT", segment_max_size=64), 16, 1024)
    rng = np.random.default_rng(0)
    live.bootstrap(rng.standard_normal((16, 16)).astype(np.float32))
    plan = FaultPlan(events=(FaultEvent(kind="build_crash", at_tick=1, fails=50),),
                     backoff_base_ticks=1, max_seal_retries=2)
    live.arm_faults(FaultInjector(plan))
    with pytest.raises(TransientEngineFault):
        for _ in range(200):
            live.insert(rng.standard_normal((16,)).astype(np.float32))


def test_rebuild_budget_exhaustion_goes_permanently_degraded():
    trace = _trace(n_base=512)
    live = _live(_cfg("FLAT"), trace.dim, trace.capacity)
    live.bootstrap(trace.base)
    plan = FaultPlan(
        events=(
            FaultEvent(kind="segment_loss", at_tick=2, segment=0),
            FaultEvent(kind="build_crash", at_tick=1, fails=100),
        ),
        backoff_base_ticks=1, max_rebuild_retries=2,
    )
    live.arm_faults(FaultInjector(plan))
    q = trace.queries[:4]
    for _ in range(30):
        live.search(q, trace.k, mode="analytic")
    assert live.health() == "degraded"
    assert live.stats()["n_rebuild_failures"] == 1
    assert live.stats()["health_code"] == HEALTH_CODE["degraded"]
    assert 0.0 < live.last_coverage < 1.0


def test_generated_plans_replay_bit_identical():
    hyp = pytest.importorskip("hypothesis", reason="optional test dep")
    from hypothesis import given, settings, strategies as st

    trace = _trace(n_base=256, n_ops=96, seed=1)
    cfg = _cfg("FLAT", segment_max_size=64)

    @settings(max_examples=5, deadline=None)
    @given(seed=st.integers(min_value=0, max_value=2**20))
    def prop(seed):
        plan = FaultPlan.generate(seed, horizon_ticks=80)
        try:
            a = replay_trace(trace, cfg, fault_injector=FaultInjector(plan), device=CPU)
        except TransientEngineFault:
            with pytest.raises(TransientEngineFault):
                replay_trace(trace, cfg, fault_injector=FaultInjector(plan), device=CPU)
            return
        b = replay_trace(trace, cfg, fault_injector=FaultInjector(plan), device=CPU)
        assert _det(a) == _det(b)

    prop()
    assert hyp


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------
PARITY_TRACE = dict(n_base=1200, n_ops=800, seed=0, mix=(0.5, 0.4, 0.1))
PARITY_SEG = {"FLAT": 128, "IVF_SQ8": 128, "IVF_PQ": 512}


def _recording(cls, sink):
    search = cls.search

    def wrapped(self, queries, topk, mode="analytic"):
        ids, secs = search(self, queries, topk, mode=mode)
        sink.append(ids.copy())
        return ids, secs

    return wrapped


@pytest.mark.parametrize("plan_name", ["segment_loss", "flaky_builds", "latency_storm"])
@pytest.mark.parametrize("family", ["FLAT", "IVF_SQ8", "IVF_PQ"])
def test_armed_replay_matches_reference(family, plan_name, monkeypatch):
    cfg = _cfg(family, segment_max_size=PARITY_SEG[family])
    plan, jplan = canned_fault_plans(200)[plan_name], jv.canned_fault_plans(200)[plan_name]
    t_inj, j_inj = FaultInjector(plan), jv.FaultInjector(jplan)
    t_ids, j_ids = [], []
    monkeypatch.setattr(jv.LiveVDMS, "search", _recording(jv.LiveVDMS, j_ids))
    monkeypatch.setattr(LiveVDMS, "search", _recording(LiveVDMS, t_ids))
    want, jlive = jv.replay_trace(jv.make_trace("glove_like", **PARITY_TRACE), cfg,
                                  fault_injector=j_inj, with_live=True)
    got, live = replay_trace(make_trace("glove_like", **PARITY_TRACE), cfg,
                             fault_injector=t_inj, with_live=True, device=CPU,
                             draws=ReferenceDraws)
    assert got["n_quarantines"] >= 1 and got["n_rebuilds"] >= 1 and got["coverage_min"] < 1.0
    assert live.n_seals > PARITY_TRACE["n_base"] // live.seg_size  # seals in the replay
    assert set(_det(got)) == set(_det(want))
    for key in _det(want):
        assert got[key] == pytest.approx(want[key], rel=1e-6), key
    assert t_inj.fired == j_inj.fired and t_inj.tick == j_inj.tick
    assert t_inj.n_injected == j_inj.n_injected and t_inj.n_builds == j_inj.n_builds
    st, jst = live.stats(), jlive.stats()
    for key in ("n_seals", "n_compactions", "n_quarantines", "n_rebuilds", "n_rebuild_failures",
                "n_seal_retries", "n_faults_injected", "health_code", "coverage"):
        assert st[key] == jst[key], key
    assert live.seal_history == jlive.seal_history
    assert len(t_ids) == len(j_ids)
    for n, (a, b) in enumerate(zip(t_ids, j_ids)):
        for row, (x, y) in enumerate(zip(a.tolist(), b.tolist())):
            assert set(x) == set(y), (n, row)
    np.testing.assert_array_equal(live.searchable_ids(), jlive.searchable_ids())


def test_flaky_builds_crash_a_seal_in_parity_trace():
    """The parity trace puts seals inside the replay, so ``flaky_builds``'
    crash budget lands on seals (retried with backoff), not only on
    rebuilds."""
    cfg = _cfg("FLAT", segment_max_size=PARITY_SEG["FLAT"])
    inj = FaultInjector(canned_fault_plans(200)["flaky_builds"])
    _, live = replay_trace(make_trace("glove_like", **PARITY_TRACE), cfg, fault_injector=inj,
                           with_live=True, device=CPU)
    hits = [f["note"] for f in inj.fired if f["kind"] == "build_crash_hit"]
    assert "seal" in hits and live.n_seal_retries >= 1 and live.health() == "healthy"


def test_unarmed_and_empty_armed_replays_equal_reference():
    """Neither an unarmed engine nor one armed with an empty plan moves: both
    give the same search ids and deterministic results as each other and as
    the reference's unarmed replay."""
    cfg = _cfg("IVF_SQ8")
    outs = []
    for inj in (None, FaultInjector(FaultPlan())):
        sink = []
        orig = LiveVDMS.search
        LiveVDMS.search = _recording(LiveVDMS, sink)
        try:
            r = replay_trace(_trace(), cfg, fault_injector=inj, device=CPU, draws=ReferenceDraws)
        finally:
            LiveVDMS.search = orig
        outs.append((r, sink))
    (plain, ids_a), (empty, ids_b) = outs
    assert len(ids_a) == len(ids_b) and all(np.array_equal(a, b) for a, b in zip(ids_a, ids_b))
    want = jv.replay_trace(jv.make_trace("glove_like", n_base=400, n_ops=200, seed=0,
                                         mix=(0.3, 0.6, 0.1)), cfg)
    for key in _det(want):
        assert plain[key] == pytest.approx(want[key], rel=1e-6), key
        assert empty[key] == plain[key], key


# ---------------------------------------------------------------------------
# failure taxonomy + session retries
# ---------------------------------------------------------------------------
def test_classify_eval_error_taxonomy():
    tf = TuningFailure("already classified")
    assert classify_eval_error(tf) is tf
    out = classify_eval_error(TransientEngineFault("gave up"))
    assert isinstance(out, TuningFailure) and out.transient
    out = classify_eval_error(BuildCrashFault("boom"))
    assert isinstance(out, TuningFailure) and out.transient
    out = classify_eval_error(ValueError("bad shape"))
    assert isinstance(out, TuningFailure) and not out.transient
    out = classify_eval_error(ZeroDivisionError("div"))
    assert isinstance(out, TuningFailure) and not out.transient
    # a configuration that exhausts the card's memory is the config's failure
    out = classify_eval_error(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert isinstance(out, TuningFailure) and not out.transient
    assert classify_eval_error(TypeError("programmer error")) is None
    assert classify_eval_error(KeyError("programmer error")) is None


def test_env_routes_faults_and_propagates_programmer_errors(monkeypatch):
    import repro_torch.vdms.tuning_env as te

    env = VDMSTuningEnv(trace=_trace(n_base=256, n_ops=64), workload="streaming",
                        mode="analytic", seed=0, n_phases=1, device=CPU)
    cfg = _cfg("FLAT")

    def boom_type(*a, **kw):
        raise TypeError("programmer error")

    monkeypatch.setattr(te, "replay_trace", boom_type)
    with pytest.raises(TypeError):
        env(dict(cfg))

    def boom_value(*a, **kw):
        raise ValueError("config-dependent crash")

    monkeypatch.setattr(te, "replay_trace", boom_value)
    with pytest.raises(TuningFailure) as ei:
        env(dict(cfg, nprobe=1) if "nprobe" in cfg else dict(cfg))
    assert not ei.value.transient


def test_env_with_fault_plan_raises_transient_failure():
    trace = make_trace("glove_like", n_base=256, n_ops=200, seed=0, mix=(0.8, 0.15, 0.05))
    plan = FaultPlan(events=(FaultEvent(kind="build_crash", at_tick=1, fails=100),),
                     backoff_base_ticks=1, max_seal_retries=1)
    env = VDMSTuningEnv(trace=trace, workload="streaming", mode="analytic", seed=0,
                        n_phases=1, faults=plan, device=CPU)
    with pytest.raises(TuningFailure) as ei:
        env(_cfg("FLAT", segment_max_size=64))
    assert ei.value.transient
    assert env.cache == {}  # a faulted evaluation is never cached
    with pytest.raises(ValueError):
        VDMSTuningEnv(trace=trace, workload="static", faults=plan, device=CPU)


def test_env_with_injector_recovers_on_retry():
    """A persistent injector's fail-count budget runs out across
    evaluations: the retried evaluation of the same configuration succeeds."""
    trace = make_trace("glove_like", n_base=256, n_ops=200, seed=0, mix=(0.8, 0.15, 0.05))
    plan = FaultPlan(events=(FaultEvent(kind="build_crash", at_tick=1, fails=2),),
                     backoff_base_ticks=1, max_seal_retries=1)
    env = VDMSTuningEnv(trace=trace, workload="streaming", mode="analytic", seed=0,
                        n_phases=1, faults=FaultInjector(plan), device=CPU)
    cfg = _cfg("FLAT", segment_max_size=64)
    with pytest.raises(TuningFailure) as ei:
        env(cfg)
    assert ei.value.transient
    r = env(cfg)
    assert r["n_quarantines"] == 0 and r["coverage_min"] == 1.0 and r["n_seals"] > 0


class _FlakyBackend:
    """Transient-fails the first ``fail_times`` calls, then succeeds."""

    def __init__(self, fail_times):
        self.calls = 0
        self.fail_times = fail_times

    def __call__(self, cfg):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise TuningFailure("injected flake", transient=True)
        return {"speed": 10.0, "recall": 0.9, "build_time": 1.0}


def _tiny_space():
    return SearchSpace(
        index_types={"A": [Param("ka", "grid", choices=(1, 2), default=1)]},
        system_params=[Param("s1", "float", 0.0, 1.0, default=0.5)],
    )


def test_session_retries_transient_and_charges_cost():
    backend = _FlakyBackend(fail_times=2)
    tuner = RandomLHS(_tiny_space(), backend, seed=0)
    session = TuningSession(tuner, retry=RetryPolicy(max_retries=2, backoff_s=0.0))
    session.run(1)
    assert backend.calls == 3
    obs = tuner.history[0]
    assert not obs.failed
    led = session.ledger_dict()
    assert led["totals"]["n_retries"] == 2
    rows = [e for r in led["rounds"] for e in r["evals"]]
    assert rows[0]["retries"] == 2
    assert rows[0]["eval_s"] > 0.0


def test_session_retry_budget_exhausts_to_failure_feedback():
    backend = _FlakyBackend(fail_times=99)
    tuner = RandomLHS(_tiny_space(), backend, seed=0)
    session = TuningSession(tuner, retry=RetryPolicy(max_retries=2, backoff_s=0.0))
    session.run(1)
    assert backend.calls == 3
    assert tuner.history[0].failed


def test_session_checkpoint_round_trips_mid_retry():
    backend = _FlakyBackend(fail_times=99)
    tuner = RandomLHS(_tiny_space(), backend, seed=0)
    session = TuningSession(tuner, retry=RetryPolicy(max_retries=5, backoff_s=0.125))
    cfg = {"index_type": "A", "ka": 1, "s1": 0.5}
    session._pending = [cfg]
    session._pending_recommend_s = 0.0
    session._drain()
    assert session._pending == [cfg]
    state = session.state_dict()
    key = TuningSession._cfg_key(cfg)
    assert state["retry"][key]["attempts"] == 1
    assert state["retry"][key]["backoff_s"] == pytest.approx(0.125)
    fresh = TuningSession(RandomLHS(_tiny_space(), backend, seed=0),
                          retry=RetryPolicy(max_retries=5, backoff_s=0.125))
    fresh.load_state_dict(copy.deepcopy(state))
    assert fresh._retry_state == session._retry_state
    assert fresh.state_dict()["retry"] == state["retry"]
    old = {k: v for k, v in state.items() if k != "retry"}
    fresh.load_state_dict(copy.deepcopy(old))
    assert fresh._retry_state == {}


def test_retry_policy_validation_and_backoff():
    with pytest.raises(ValueError):
        RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError):
        RetryPolicy(backoff_factor=0.5)
    with pytest.raises(ValueError):
        RetryPolicy(eval_timeout_s=0.0)
    p = RetryPolicy(backoff_s=0.5, backoff_factor=2.0)
    assert [p.backoff(i) for i in (1, 2, 3)] == [0.5, 1.0, 2.0]


def test_eval_timeout_is_transient():
    import time as _time

    def slow(cfg):
        _time.sleep(0.5)
        return {"speed": 1.0, "recall": 0.9}

    tuner = RandomLHS(_tiny_space(), slow, seed=0)
    session = TuningSession(
        tuner, retry=RetryPolicy(max_retries=0, backoff_s=0.0, eval_timeout_s=0.05))
    session.run(1)
    assert tuner.history[0].failed


# ---------------------------------------------------------------------------
# controller hardening + straggler wiring
# ---------------------------------------------------------------------------
def test_rollback_cooldown_hysteresis_grows_and_caps():
    ctrl = ServingController(
        SLOSpec(recall_floor=0.9),
        params=ControllerParams(cooldown_ops=48, storm_cooldown_factor=2.0,
                                storm_cooldown_cap_ops=100),
        device=CPU,
    )
    expected = {0: 48, 1: 48, 2: 96, 3: 100, 7: 100}
    for n, want in expected.items():
        ctrl._consec_rollbacks = n
        assert ctrl._rollback_cooldown() == want
    with pytest.raises(ValueError):
        ControllerParams(storm_cooldown_factor=0.5)


def test_shadow_scope_injector_only_serves_oom():
    plan = canned_fault_plans(200)["latency_storm"]
    shadow = FaultInjector(plan, scope="shadow")
    assert shadow.advance() == []
    with pytest.raises(ShadowBuildOOM):
        shadow.on_bootstrap(64)
    shadow.on_bootstrap(64)
    primary = FaultInjector(plan, scope="primary")
    primary.on_bootstrap(64)


def test_guarded_serve_aborts_canary_on_shadow_oom():
    trace = _trace(n_base=400, n_ops=260, seed=2, drift="step")
    env = VDMSTuningEnv(trace=trace.window(0, 100), workload="streaming", mode="analytic",
                        seed=2, n_phases=1, device=CPU)
    session = TuningSession(VDTuner(make_space(), env, seed=2, warm_start=True, device=CPU))
    session.run(4)
    plan = FaultPlan(events=(FaultEvent(kind="shadow_oom", at_tick=0),))
    cfg = _cfg("FLAT", segment_max_size=256, graceful_time=0.4)
    ctrl = ServingController(
        SLOSpec(recall_floor=0.999, min_samples=8), session=session,
        params=ControllerParams(
            check_every=24, canary_queries=16, retune_iters=4, retune_window_ops=128,
            cooldown_ops=48, min_window_searches=8, repair_anchors=False, floor_margin=0.0,
        ),
        seed=2, device=CPU,
    )
    report = ctrl.serve(trace, cfg, guard=True, fault_plan=plan)
    events = [e["event"] for e in report["timeline"]]
    assert "canary_aborted_oom" in events
    assert report["n_rollbacks"] >= 1
    assert ctrl.ledger.counter("vdms_canary_fault_abort_total").value >= 1
    assert report["fault"]["n_injected"] >= 1


def test_straggler_monitor_flags_latency_storm():
    trace = _trace(n_base=512)
    live = _live(_cfg("FLAT"), trace.dim, trace.capacity)
    live.bootstrap(trace.base)
    plan = FaultPlan(events=(FaultEvent(kind="latency_storm", at_tick=12, duration_ticks=100,
                                        latency_mult=50.0, latency_add_s=1e-3),))
    live.arm_faults(FaultInjector(plan))
    ledger = serving_ledger()
    monitor = attach_straggler(ledger, live)
    q = trace.queries[:8]
    for _ in range(24):
        live.search(q, trace.k, mode="analytic")
    assert any(s.flagged for s in monitor.history)
    assert ledger.gauge("vdms_straggler_flagged").value > 0
    assert attach_straggler(ledger, live, monitor) is monitor
