"""The port's serving control plane (the twin of ``tests/test_serving.py``):
metrics ledger, SLO guardrails, the shadow/canary loop; plus parity with
the JAX package. With the reference's build draws injected, the unguarded
chaos serve of each canned plan at ``bench_chaos``'s quick sizes reports
what the reference reports, and the guarded serve at ``bench_serving``'s
quick sizes takes the reference's decisions. The controller's visible-set
oracle on the device equals the numpy ``exact_topk_masked``. The launch
twins ``serve_chaos`` and ``serve_controlled`` run on the CPU."""
import copy
import json

import numpy as np
import pytest
import torch

import repro.serving as js
import repro.vdms as jv
from benchmarks import bench_chaos as j_chaos
from benchmarks import bench_serving as j_serving
from repro_torch.bench import bench_chaos, bench_serving
from repro_torch.core import TuningSession, VDTuner, promotion_score
from repro_torch.launch import serve_chaos, serve_controlled
from repro_torch.serving import (
    ControllerParams,
    GidMappedVDMS,
    Histogram,
    MetricsLedger,
    ServingController,
    SLOMonitor,
    SLOSpec,
    attach_live,
    ledger_table,
    observe_stats,
    serving_ledger,
)
from repro_torch.serving.controller import mirror_count, visible_topk
from repro_torch.vdms import (
    FaultEvent,
    FaultInjector,
    FaultPlan,
    LiveVDMS,
    VDMSTuningEnv,
    canned_fault_plans,
    exact_topk_masked,
    make_space,
    make_trace,
)
from repro_torch.vdms.workload import time_aware_ground_truth
from torch_parity import ReferenceDraws
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)

CPU = "cpu"
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


def _ctrl(slo, **kw):
    return ServingController(slo, device=CPU, **kw)


# ---------------------------------------------------------------------------
# metrics ledger
# ---------------------------------------------------------------------------
def test_counter_monotone_and_gauge_free():
    led = MetricsLedger()
    c = led.counter("x_total")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = led.gauge("x_now")
    g.set(4.0)
    g.inc(-1.0)
    assert g.value == 3.0


def test_histogram_buckets_percentiles_and_exposition():
    h = Histogram("lat_seconds", "latency", buckets=(0.01, 0.1, 1.0), window=100)
    h.observe_many([0.005, 0.05, 0.5, 5.0])
    assert h.count == 4 and h.bucket_counts == [1, 1, 1, 1]
    assert h.percentile(0.0) == 0.005 and h.percentile(100.0) == 5.0
    text = "\n".join(h.exposition())
    assert "# TYPE lat_seconds histogram" in text
    assert 'lat_seconds_bucket{le="0.1"} 2' in text
    assert 'lat_seconds_bucket{le="+Inf"} 4' in text
    assert "lat_seconds_count 4" in text
    with pytest.raises(ValueError):
        Histogram("bad", buckets=(1.0, 0.5))


def test_ledger_get_or_create_and_kind_mismatch():
    led = MetricsLedger()
    assert led.counter("a_total") is led.counter("a_total")
    with pytest.raises(ValueError):
        led.gauge("a_total")
    assert "a_total" in led and led.names() == ["a_total"]


def test_ledger_json_is_strict_and_text_scrapes(tmp_path):
    led = serving_ledger()
    led.histogram("vdms_query_latency_seconds").observe(float("inf"))
    led.counter("vdms_queries_total").inc(3)
    path = tmp_path / "ledger.json"
    led.dump_json(str(path))
    dumped = json.loads(path.read_text())
    assert dumped["vdms_queries_total"]["value"] == 3.0
    text = led.to_text()
    assert "# TYPE vdms_queries_total counter" in text
    assert "vdms_rollback_total 0" in text


def test_ledger_instruments_match_reference():
    assert ledger_table() == js.ledger_table()
    assert serving_ledger().to_text() == js.serving_ledger().to_text()


def test_attach_live_feeds_ledger_and_observe_stats_syncs():
    led = serving_ledger()
    live = LiveVDMS(LIVE_CFG, dim=16, capacity=1024, device=CPU)
    attach_live(led, live)
    live.bootstrap(_vectors(300))
    live.search(_vectors(10, seed=1), topk=5)
    assert led.counter("vdms_queries_total").value == 10
    assert led.histogram("vdms_query_latency_seconds").count == 10
    assert led.gauge("vdms_qps").value > 0
    observe_stats(led, live.stats())
    assert led.counter("vdms_seals_total").value == 2
    assert led.gauge("vdms_sealed_segments").value == 2
    observe_stats(led, live.stats())  # idempotent re-sync
    assert led.counter("vdms_seals_total").value == 2
    assert led.gauge("vdms_mem_gib").value > 0


# ---------------------------------------------------------------------------
# SLO guardrails
# ---------------------------------------------------------------------------
def test_slo_spec_validation_and_objective_mapping():
    with pytest.raises(ValueError):
        SLOSpec()
    with pytest.raises(ValueError):
        SLOSpec(recall_floor=1.5)
    with pytest.raises(ValueError):
        SLOSpec(p99_latency_s=-1.0)
    obj = SLOSpec(recall_floor=0.9).objective_spec(alpha=0.5)
    assert obj.rlim == 0.9 and obj.names == ("sustained_qps", "recall")


def test_slo_monitor_latency_guardrail_arms_after_min_samples():
    mon = SLOMonitor(SLOSpec(p99_latency_s=0.01, min_samples=8, latency_window=32))
    mon.observe_query([0.5] * 4)
    assert mon.evaluate().ok
    mon.observe_query([0.5] * 8)
    status = mon.evaluate(at_time=0.25)
    assert not status.ok and status.breaches == ("p99_latency",)
    assert status.at_time == 0.25 and len(mon.events) == 1
    mon.reset()
    assert mon.evaluate().ok


def test_slo_monitor_recall_and_mem_guardrails():
    mon = SLOMonitor(SLOSpec(recall_floor=0.9, mem_gib_cap=1.0))
    assert mon.evaluate().ok
    mon.observe_recall(0.85)
    mon.observe_mem(2.0)
    assert set(mon.evaluate().breaches) == {"recall_floor", "mem_cap"}
    mon.observe_recall(0.99)
    mon.observe_recall(0.99)
    mon.observe_mem(0.5)
    assert "mem_cap" not in mon.evaluate().breaches


def test_promotion_score_is_lexicographic_on_feasibility():
    feas = {"speed": 100.0, "recall": 0.95, "n_searches": 10.0, "search_s": 0.1,
            "seal_build_s": 0.0}
    fast_infeas = {"speed": 900.0, "recall": 0.5, "n_searches": 10.0, "search_s": 0.01,
                   "seal_build_s": 0.0}
    assert promotion_score(feas, rlim=0.9) > promotion_score(fast_infeas, rlim=0.9)
    faster = dict(feas, search_s=0.05)
    assert promotion_score(faster, rlim=0.9) > promotion_score(feas, rlim=0.9)
    less_bad = dict(fast_infeas, recall=0.7)
    assert promotion_score(less_bad, rlim=0.9) > promotion_score(fast_infeas, rlim=0.9)
    assert promotion_score(fast_infeas)[0] == 1.0


# ---------------------------------------------------------------------------
# gid-mapped instances
# ---------------------------------------------------------------------------
def test_gid_mapped_vdms_speaks_global_ids():
    data = _vectors(120, seed=3)
    gids = np.arange(1000, 1120)
    inst = GidMappedVDMS(dict(LIVE_CFG, index_type="FLAT"), dim=16, capacity=512, device=CPU)
    inst.bootstrap(data, gids)
    assert set(inst.visible_gids().tolist()) == set(gids.tolist())
    inst.insert(5000, _vectors(1, seed=4)[0])
    assert inst.delete(1003) and not inst.delete(1003)
    assert not inst.delete(777)
    ids, _ = inst.search(data[:8], topk=5)
    returned = set(ids.ravel().tolist()) - {-1}
    assert returned <= (set(gids.tolist()) | {5000}) - {1003}
    assert ids[0, 0] == 1000


def test_gid_mapped_bootstrap_validates_lengths():
    inst = GidMappedVDMS(LIVE_CFG, dim=16, capacity=64, device=CPU)
    with pytest.raises(ValueError):
        inst.bootstrap(_vectors(4), np.arange(5))


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------
def _drifted_trace(n_base=800, n_ops=400, seed=0):
    return make_trace("glove_like", n_base=n_base, n_ops=n_ops, drift="step", seed=seed,
                      mix=(0.3, 0.6, 0.1))


def _served_session(trace, n_pre_ops=150, n_iters=6, seed=0):
    env = VDMSTuningEnv(trace=trace.window(0, n_pre_ops), workload="streaming",
                        mode="analytic", seed=seed, n_phases=1, device=CPU)
    session = TuningSession(VDTuner(make_space(), env, seed=seed, warm_start=True, device=CPU))
    session.run(n_iters)
    return session, env


def test_unguarded_serve_reports_and_is_deterministic():
    trace = _drifted_trace(n_base=400, n_ops=200)
    slo = SLOSpec(recall_floor=0.99, min_samples=8)
    cfg = dict(LIVE_CFG, index_type="FLAT", graceful_time=0.4)
    reports = [_ctrl(slo, params=ControllerParams(check_every=24), seed=0).serve(
        trace, cfg, guard=False) for _ in range(2)]
    a, b = reports
    assert a["violation_minutes"] == b["violation_minutes"]
    assert a["recall"] == b["recall"] and a["n_retunes"] == 0
    assert a["n_breach_events"] > 0
    assert a["violation_time"] * 60.0 == pytest.approx(a["violation_minutes"])
    assert a["config_history"] == [{"op": 0, "time": 0.0, "config": cfg}]
    assert a["final_stats"]["queries_served"] == a["n_searches"]


def test_guarded_serve_requires_session():
    with pytest.raises(ValueError):
        _ctrl(SLOSpec(recall_floor=0.9)).serve(_drifted_trace(400, 50), LIVE_CFG, guard=True)


def _losing_params(**over):
    return ControllerParams(**dict(
        check_every=24, canary_queries=16, retune_iters=4, retune_window_ops=128,
        cooldown_ops=48, min_window_searches=8, repair_anchors=False, floor_margin=0.0,
        **over))


def test_losing_canary_rolls_back_bit_identical():
    trace = _drifted_trace(n_base=400, n_ops=260, seed=2)
    session, _ = _served_session(trace, n_pre_ops=100, n_iters=4, seed=2)
    cfg = dict(LIVE_CFG, index_type="FLAT", graceful_time=0.4)
    ctrl = _ctrl(SLOSpec(recall_floor=0.999, min_samples=8), session=session,
                 params=_losing_params(canary_feedback=False), seed=2)
    state_before = copy.deepcopy(session.state_dict())
    backend_before = session.backend
    report = ctrl.serve(trace, cfg, guard=True)
    assert report["n_retunes"] > 0
    assert report["n_promotes"] == 0
    assert report["n_rollbacks"] == report["n_retunes"]
    assert session.state_dict() == state_before
    assert session.backend is backend_before
    assert [e["event"] for e in report["timeline"] if e["event"] == "rollback"]


def test_mirror_count_honors_fraction_on_small_flushes():
    credit, mirrored, total = 0.0, 0, 0
    for _ in range(40):
        m, credit = mirror_count(credit, 0.25, 3)
        mirrored += m
        total += 3
    assert mirrored == int(0.25 * total)
    assert mirror_count(0.0, 1.0, 7) == (7, 0.0)
    m, credit = mirror_count(0.0, 0.1, 3)
    assert m == 0 and credit == pytest.approx(0.3)


def test_fractional_mirror_still_reaches_decisions():
    trace = _drifted_trace(n_base=400, n_ops=260, seed=2)
    session, _ = _served_session(trace, n_pre_ops=100, n_iters=4, seed=2)
    cfg = dict(LIVE_CFG, index_type="FLAT", graceful_time=0.4)
    ctrl = _ctrl(SLOSpec(recall_floor=0.999, min_samples=8), session=session,
                 params=ControllerParams(
                     check_every=24, canary_queries=8, retune_iters=4, retune_window_ops=128,
                     cooldown_ops=48, min_window_searches=8, repair_anchors=False,
                     floor_margin=0.0, canary_feedback=False, traffic_mirror=0.5),
                 seed=2)
    report = ctrl.serve(trace, cfg, guard=True)
    assert report["n_promotes"] + report["n_rollbacks"] > 0


def test_canary_feedback_feeds_gp_outside_budget():
    trace = _drifted_trace(n_base=400, n_ops=260, seed=2)
    session, _ = _served_session(trace, n_pre_ops=100, n_iters=4, seed=2)
    cfg = dict(LIVE_CFG, index_type="FLAT", graceful_time=0.4)
    n_obs_before = session.n_observations
    hist_before = len(session.tuner.history)
    outcomes = []
    ctrl = _ctrl(SLOSpec(recall_floor=0.999, min_samples=8), session=session,
                 params=_losing_params(), seed=2,
                 outcome_hook=lambda kind, c, raw: outcomes.append((kind, c, raw)))
    report = ctrl.serve(trace, cfg, guard=True)
    decisions = report["n_promotes"] + report["n_rollbacks"]
    assert decisions > 0
    assert report["n_promotes"] == 0
    fed = session.tuner.history[hist_before:]
    assert len(fed) == 2 * decisions
    assert all(o.bootstrap and not o.failed for o in fed)
    assert all({"speed", "recall"} <= set(o.raw) for o in fed)
    assert session.n_observations == n_obs_before
    assert [k for k, _, _ in outcomes].count("rollback") == report["n_rollbacks"]
    assert len(outcomes) == decisions
    assert all({"speed", "recall"} <= set(raw) for _, _, raw in outcomes)


def test_breach_triggers_canary_and_promotion_repairs_recall():
    trace = make_trace("glove_like", n_base=800, n_ops=640, drift="step", seed=0,
                       mix=(0.2, 0.75, 0.05), mix_to=(0.65, 0.3, 0.05))
    cfg = dict(make_space().default_config("FLAT"), segment_max_size=256, graceful_time=0.4)
    session, _ = _served_session(trace)
    slo = SLOSpec(recall_floor=0.9, min_samples=16)
    ctrl = _ctrl(slo, session=session,
                 params=ControllerParams(retune_iters=6, check_every=24, canary_queries=24,
                                         retune_window_ops=112, cooldown_ops=48,
                                         floor_margin=0.02),
                 seed=0)
    guarded = ctrl.serve(trace, cfg, guard=True)
    baseline = _ctrl(slo, params=ControllerParams(check_every=24), seed=0).serve(
        trace, cfg, guard=False)
    assert guarded["n_promotes"] >= 1
    events = [e["event"] for e in guarded["timeline"]]
    assert "breach" in events and "canary_start" in events and "promote" in events
    assert len(guarded["config_history"]) == 1 + guarded["n_promotes"]
    assert guarded["violation_minutes"] < baseline["violation_minutes"]
    assert guarded["recall"] > baseline["recall"]
    led = ctrl.ledger
    assert led.counter("vdms_promote_total").value == guarded["n_promotes"]
    assert led.counter("vdms_retune_total").value == guarded["n_retunes"]
    assert led.counter("vdms_slo_breach_total").value == guarded["n_breach_events"]
    assert led.histogram("vdms_query_latency_seconds").count > 0
    json.dumps(led.to_json())


def test_serve_with_precomputed_ground_truth_matches():
    trace = _drifted_trace(n_base=400, n_ops=150)
    gt = time_aware_ground_truth(trace, trace.k, device=CPU)
    slo = SLOSpec(recall_floor=0.5, min_samples=8)
    cfg = dict(LIVE_CFG, index_type="FLAT")
    a = _ctrl(slo, seed=0).serve(trace, cfg, guard=False)
    b = _ctrl(slo, seed=0).serve(trace, cfg, ground_truth=gt, guard=False)
    assert a["recall"] == b["recall"] and a["lat_p99_s"] == b["lat_p99_s"]


# ---------------------------------------------------------------------------
# the device oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_visible", [0, 3, 700])
def test_visible_topk_matches_numpy_oracle(n_visible):
    """The controller's visible-set oracle (a matrix product on the device)
    against the JAX package's numpy ``exact_topk_masked``, with fewer
    visible rows than k and with many."""
    rng = np.random.default_rng(n_visible)
    data = _vectors(1000, dim=24, seed=1)
    q = _vectors(37, dim=24, seed=2)
    dead = np.ones(1000, bool)
    dead[rng.choice(1000, n_visible, replace=False)] = False
    want = exact_topk_masked(data, q, dead, 10)
    got = visible_topk(torch.from_numpy(data), q, ~dead, 10)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, jv.exact_topk_masked(data, q, dead, 10))


def test_visible_topk_breaks_ties_to_the_lower_row():
    """Equal scores keep the lower row first, as ``topk_stable`` (and
    ``lax.top_k``) order them: at the top and at the k-th place."""
    data = np.zeros((6, 2), np.float32)
    data[[1, 4], 0] = 1.0  # a tie at the top; rows 0 and 3 tie at the cut
    data[2, 0] = 0.5
    q = np.array([[1.0, 0.0]], np.float32)
    got = visible_topk(torch.from_numpy(data), q, np.array([1, 1, 1, 1, 1, 0], bool), 4)
    np.testing.assert_array_equal(got, [[1, 4, 2, 0]])


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------
#: report keys measured on the wall clock (differ run to run in analytic mode)
WALL_KEYS = {"build_time", "compile_s", "upload_s", "seal_build_s"}


def assert_same(got, want, path="report"):
    """Recursive equality; floats to rel 1e-9, wall-clock keys skipped."""
    if isinstance(want, dict):
        assert set(got) - WALL_KEYS == set(want) - WALL_KEYS, path
        for k in want:
            if k not in WALL_KEYS:
                assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-9, abs=1e-12), path
    else:
        assert got == want, path


def _chaos_case(pkg, plan_name):
    quick = j_serving._sizes(True)
    trace = pkg[0].make_trace("glove_like", n_base=quick["n_base"], n_ops=quick["n_ops"],
                              drift="step", seed=0, mix=j_serving.MIX0, mix_to=j_serving.MIX1)
    plan = pkg[0].canned_fault_plans(j_chaos._fault_horizon(quick["n_ops"]))[plan_name]
    slo = pkg[1].SLOSpec(recall_floor=j_serving.RECALL_FLOOR, min_samples=16)
    params = pkg[1].ControllerParams(check_every=j_serving._controller_params(True).check_every)
    return trace, plan, slo, params


@pytest.mark.parametrize("plan_name", ["segment_loss", "flaky_builds", "latency_storm"])
def test_unguarded_chaos_serve_matches_reference(plan_name):
    import repro_torch.serving as ts
    import repro_torch.vdms as tv

    jtrace, jplan, jslo, jparams = _chaos_case((jv, js), plan_name)
    trace, plan, slo, params = _chaos_case((tv, ts), plan_name)
    cfg = j_serving._incumbent_config()
    jctrl = js.ServingController(jslo, params=jparams, seed=0)
    want = jctrl.serve(jtrace, cfg, guard=False, fault_plan=jplan)
    ctrl = ServingController(slo, params=params, seed=0, device=CPU, draws=ReferenceDraws)
    got = ctrl.serve(trace, cfg, guard=False, fault_plan=plan)
    assert got["fault"]["n_quarantines"] >= 1 and got["fault"]["coverage_min"] < 1.0
    assert got["health"] == "healthy" and got["visible_recall"] == 1.0
    assert_same(got, want)
    assert_same(ctrl.ledger.to_json(), jctrl.ledger.to_json(), "ledger")


def test_guarded_serve_decisions_match_reference(monkeypatch):
    """The guarded loop at ``bench_serving``'s quick sizes: the tuned
    session, each breach, retune, canary and decision, and the configs
    served equal the reference's (the retune windows replay with the
    reference's draws)."""
    want, _ = j_serving.run_schedule("step", seed=0, quick=True)
    got, _ = bench_serving.run_schedule("step", seed=0, quick=True, device=CPU,
                                        draws=ReferenceDraws)
    for arm in ("frozen", "guarded"):
        assert [(e["op"], e["event"]) for e in got[arm]["timeline"]] == \
               [(e["op"], e["event"]) for e in want[arm]["timeline"]], arm
        for key in ("n_retunes", "n_promotes", "n_rollbacks", "n_configs_served",
                    "n_breach_events"):
            assert got[arm][key] == want[arm][key], (arm, key)
        for key in ("violation_minutes", "recall", "lat_p99_s"):
            assert got[arm][key] == pytest.approx(want[arm][key], rel=1e-9), (arm, key)
    assert got["guarded"]["n_retunes"] >= 1


def test_chaos_oracle_exactness_matches_reference():
    got = bench_chaos.oracle_exactness_check(quick=True, device=CPU)
    want = j_chaos.oracle_exactness_check(quick=True)
    assert got == want
    assert got["subset_ok"] and got["exact_ok"] and got["degraded_engaged"]


# ---------------------------------------------------------------------------
# launch twins of the examples
# ---------------------------------------------------------------------------
def test_serve_chaos_launch_on_cpu(capsys):
    assert serve_chaos.main(["--device", "cpu"]) == 0
    assert "ok: degraded, rebuilt, recovered" in capsys.readouterr().out


def test_serve_controlled_launch_on_cpu(tmp_path, capsys):
    path = tmp_path / "ledger.json"
    assert serve_controlled.main(["--device", "cpu", "--ledger-json", str(path)]) == 0
    out = capsys.readouterr().out
    assert "control loop: retunes=" in out
    assert json.loads(path.read_text())["vdms_retune_total"]["value"] >= 1


def test_searchable_mask_matches_searchable_gids():
    """The controller's mask of the searchable set, on the identity-mapped
    primary and on a shadow whose local ids are not its global ids, equals
    the reference's ``searchable_gids`` scattered into a mask."""
    trace = _drifted_trace(n_base=400, n_ops=120)
    cfg = dict(LIVE_CFG, index_type="FLAT", graceful_time=0.4)
    plan = FaultPlan(events=(FaultEvent(kind="segment_loss", at_tick=1, segment=0),),
                     backoff_base_ticks=1000)
    primary = GidMappedVDMS(cfg, trace.dim, trace.capacity, device=CPU)
    primary.bootstrap(trace.base, np.arange(trace.n_base))
    gids = np.arange(trace.n_base)[::-1].copy()
    shadow = GidMappedVDMS(cfg, trace.dim, trace.capacity, device=CPU)
    shadow.bootstrap(trace.base[gids], gids)
    for inst in (primary, shadow):
        inst.live.arm_faults(FaultInjector(plan))
        for j in range(trace.n_inserts):
            inst.insert(trace.n_base + j, trace.inserts[j])
        inst.delete(7)
        inst.search(trace.queries[:2], trace.k)
        assert inst.live.quarantined
        want = np.zeros(trace.capacity, bool)
        want[inst.searchable_gids()] = True
        np.testing.assert_array_equal(inst.searchable_mask(trace.capacity), want)
    assert primary._identity and not shadow._identity


def test_shadow_injector_survives_canaries():
    """The shadow-scoped injector of a guarded serve under ``latency_storm``
    fires its OOM on the first canary's bootstrap and is the same object
    for every later canary."""
    trace = make_trace("glove_like", n_base=800, n_ops=640, drift="step", seed=0,
                       mix=(0.2, 0.75, 0.05), mix_to=(0.65, 0.3, 0.05))
    session, _ = _served_session(trace)
    ctrl = _ctrl(SLOSpec(recall_floor=0.9, min_samples=16), session=session,
                 params=bench_serving._controller_params(True), seed=0)
    report = ctrl.serve(trace, bench_serving._incumbent_config(), guard=True,
                        fault_plan=canned_fault_plans(320)["latency_storm"])
    events = [e["event"] for e in report["timeline"]]
    assert events.count("canary_aborted_oom") == 1
    assert isinstance(ctrl._shadow_injector, FaultInjector)
    assert ctrl._shadow_injector.n_injected == 1
