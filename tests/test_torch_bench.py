"""The port's paper-figure benchmarks (``repro_torch.bench``) against the JAX
package's ``benchmarks/``: the pure helpers give equal results on one shared
history, each suite's ``run`` completes on the CPU at a tiny size (1,024
vectors, 8 observations) and returns the reference's keys, the efficiency
and ablation suites give the reference's tables when the port builds with
the reference's draws, and ``run``'s ``--index-types`` is validated with the
reference's errors."""
import json

import numpy as np
import pytest

import repro.core as jc
from benchmarks import bench_ablation as j_ablation
from benchmarks import bench_autoconfig as j_autoconfig
from benchmarks import bench_chaos as j_chaos
from benchmarks import bench_efficiency as j_efficiency
from benchmarks import bench_preference as j_preference
from benchmarks import bench_serving as j_serving
from benchmarks import bench_streaming as j_streaming
from benchmarks import common as j_common
from repro_torch import core as tc
from repro_torch.bench import (
    bench_ablation,
    bench_autoconfig,
    bench_chaos,
    bench_costaware,
    bench_efficiency,
    bench_overhead,
    bench_preference,
    bench_serving,
    bench_streaming,
    common,
)
from repro_torch.bench import run as bench_run
from repro_torch.vdms import registered_names
from test_torch_tuner import _space, _toy_objective
from torch_parity import SEVEN, ReferenceDraws
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)


# ---------------------------------------------------------------------------
# the pure helpers on one shared history
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def histories():
    """One history (failures and bootstrap observations included) loaded
    into a tuner of each package."""

    def flaky(cfg):
        if cfg["s1"] > 0.85:
            raise jc.TuningFailure("flaky")
        return _toy_objective(cfg)

    src = jc.RandomLHS(_space(jc), seed=5)
    jc.TuningSession(src, backend=flaky).run(18)
    state = json.loads(json.dumps(src.state_dict()))
    for d in state["history"][:3]:
        d["bootstrap"] = True
    j = jc.RandomLHS(_space(jc), seed=5).load_state_dict(state)
    t = tc.RandomLHS(_space(tc), seed=5).load_state_dict(state)
    assert any(o.failed for o in t.history)
    return j, t


def test_pure_helpers_match_reference(histories):
    j, t = histories
    ys = j.Y
    for i in (0, 4, 9):
        got = bench_autoconfig.best_without_sacrifice(t, ys[i])
        np.testing.assert_equal(got, j_autoconfig.best_without_sacrifice(j, ys[i]))
    np.testing.assert_equal(bench_efficiency.speed_at_floors(t), j_efficiency.speed_at_floors(j))
    floors = (0.5, 0.7, 0.9, 0.99)
    for floor in floors:
        for target in (0.0, 20.0, 45.0, 1e9):
            assert bench_efficiency.iters_to_reach(t, floor, target) == \
                j_efficiency.iters_to_reach(j, floor, target)
            assert bench_preference.iters_to_speed(t, floor, target) == \
                j_preference.iters_to_speed(j, floor, target)
    for ymax in ([100.0, 1.0], ys.max(axis=0)):
        assert common.norm_hv(t, ymax) == j_common.norm_hv(j, ymax)


def test_scale_knobs_match_reference():
    for name in ("FULL", "N_VECTORS", "N_ITERS", "MODE", "DATASETS", "RECALL_FLOORS"):
        assert getattr(common, name) == getattr(j_common, name), name
    assert bench_efficiency.METHODS == j_efficiency.METHODS
    assert set(common.TUNERS) == set(jc.ALL_BASELINES) | {"vdtuner"}


# ---------------------------------------------------------------------------
# every suite at a tiny size
# ---------------------------------------------------------------------------
@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(common, "N_VECTORS", 1024)
    monkeypatch.setattr(bench_autoconfig, "DATASETS", ("glove_like",))
    return dict(n_iters=8, device="cpu")


SESSION = {"schema", "tuner", "executor", "rounds", "totals"}


def test_autoconfig_suite(tiny):
    rows = bench_autoconfig.run(**tiny)
    assert set(rows) == {"glove_like"}
    assert set(rows["glove_like"]) == {
        "speed_improvement_pct", "recall_improvement_pct", "best_index", "best_config",
        "pareto_index_types", "ivf_pqr_on_front", "wall_s"}
    assert registered_names() == SEVEN  # IVF_PQR's registration was scoped to the suite


def test_autoconfig_suite_with_index_types(tiny):
    rows = bench_autoconfig.run(index_types=("IVF_PQR", "FLAT"), **tiny)
    assert set(rows["glove_like"]["pareto_index_types"]) <= {"IVF_PQR", "FLAT"}
    assert registered_names() == SEVEN


def test_efficiency_suite_through_its_cli(tiny, tmp_path, capsys):
    path = tmp_path / "eff.json"
    assert bench_efficiency.main(["--device", "cpu", "--iters", "8", "--dataset", "glove_like",
                                  "--json", str(path)]) == 0
    assert "efficiency/glove_like/vdtuner," in capsys.readouterr().out
    runs = json.loads(path.read_text())
    assert set(runs) == {"glove_like"}
    out = runs["glove_like"]
    assert set(out) == {"speed_at_floor", "iters_to_match_best_baseline", "tradeoff_std",
                        "wall_s", "session", "failures"}
    for key in ("speed_at_floor", "tradeoff_std", "wall_s", "session"):
        assert set(out[key]) == set(bench_efficiency.METHODS), key
    floors = {str(r) for r in common.RECALL_FLOORS}  # JSON keys
    assert set(out["iters_to_match_best_baseline"]) == floors
    for m, ledger in out["session"].items():
        assert set(ledger) == SESSION and ledger["totals"]["n_evals"] == 8, m
        assert set(out["speed_at_floor"][m]) == floors
    assert out["failures"] == []


def test_ablation_suite(tiny):
    out = bench_ablation.run(**tiny)
    assert set(out) == {"vdtuner", "round_robin", "native_gp"}
    for v in out.values():
        assert set(v) == {"speed_at_floor", "abandoned", "score_log_len", "session"}
    assert out["round_robin"]["abandoned"] == []


def test_native_gp_variant_restores_npi_normalize():
    import repro_torch.core.tuner as tuner_mod

    orig = tuner_mod.npi_normalize
    t = bench_ablation.VDTunerNativeGP(_space(tc), seed=0, device="cpu", n_candidates=32,
                                       gp_fit_steps=8, mc_samples=8)
    tc.TuningSession(t, backend=_toy_objective).run(4)
    assert tuner_mod.npi_normalize is orig


def test_preference_suite(tiny):
    out = bench_preference.run(**tiny)
    assert set(out["rlim_0.85"]) == {"no_constraint_best", "constraint_best",
                                     "constraint_iters_to_match"}
    assert set(out["rlim_0.9"]) == {"cold_best", "warm_best", "cold_iters_to_best",
                                    "warm_iters_to_match_cold"}


def test_costaware_suite(tiny):
    out = bench_costaware.run(**tiny)
    assert set(out) == {"optimize_qps", "optimize_qpd"}
    for v in out.values():
        assert set(v) == {"mem_mean", "mem_std", "best_qps", "best_qpd"}
        assert v["best_qps"] > 0 and v["mem_mean"] > 0


def test_overhead_table_vi_suite(tiny):
    out = bench_overhead.run(**tiny)
    assert set(out) == set(bench_overhead.METHODS)
    for v in out.values():
        assert set(v) == {"recommend_s", "replay_s", "total_s", "recommend_pct", "session"}
        assert v["replay_s"] > 0


def test_ask_overhead_engines(tmp_path, capsys):
    path, baseline = tmp_path / "ask.json", tmp_path / "baseline.json"
    baseline.write_text(json.dumps({"recommend_s_per_iter_q4": 1e-9}))
    assert bench_overhead.main(["--device", "cpu", "--n-obs", "12", "--qs", "1", "4",
                                "--n-ask", "1", "--n-candidates", "32", "--mc-samples", "8",
                                "--json", str(path), "--check-against", str(baseline)]) == 1
    assert "FAIL: torch q=4" in capsys.readouterr().out
    out = json.loads(path.read_text())
    assert set(out) == {"schema", "device", "n_obs", "n_ask", "n_candidates", "mc_samples",
                        "seed", "warm_start", "engines", "speedup_per_iter"}
    assert set(out["engines"]) == set(bench_overhead.ENGINES) == {"numpy", "torch"}
    assert set(out["speedup_per_iter"]) == {"q1", "q4"}


# ---------------------------------------------------------------------------
# the JAX package's registry at its seven built-ins
# ---------------------------------------------------------------------------
@pytest.fixture
def jax_builtins_only():
    """The JAX package's registry with just its seven built-ins for the test
    (another module on this worker may have left IVF_PQR registered)."""
    from repro.vdms.registry import REGISTRY

    held = dict(REGISTRY._families)
    for name in set(held) - set(SEVEN):
        del REGISTRY._families[name]
    try:
        yield
    finally:
        REGISTRY._families.clear()
        REGISTRY._families.update(held)


# ---------------------------------------------------------------------------
# the efficiency and ablation suites against the reference's, analytic mode
# ---------------------------------------------------------------------------
N_COMPARE = 11  # a GP round past the baselines' ten initial samples


@pytest.fixture
def both_tiny(monkeypatch, jax_builtins_only):
    """Both packages' suites at 1,024 vectors and ``N_COMPARE``
    observations over the seven built-in families; the port's environments
    build with the reference's draws."""
    assert registered_names() == SEVEN
    for mod in (common, j_common):
        monkeypatch.setattr(mod, "N_VECTORS", 1024)
    for mod in (j_efficiency, j_ablation):
        monkeypatch.setattr(mod, "N_ITERS", N_COMPARE)

    def make_env(*args, **kw):
        env = common.make_env(*args, **kw)
        env.draws = ReferenceDraws
        return env

    for mod in (bench_efficiency, bench_ablation):
        monkeypatch.setattr(mod, "make_env", make_env)
    return dict(n_iters=N_COMPARE, device="cpu")


def test_efficiency_suite_matches_reference(both_tiny):
    want = j_efficiency.run(datasets=("glove_like",))["glove_like"]
    got = bench_efficiency.run(datasets=("glove_like",), **both_tiny)["glove_like"]
    assert got["failures"] == []
    np.testing.assert_equal(got["speed_at_floor"], want["speed_at_floor"])
    assert got["iters_to_match_best_baseline"] == want["iters_to_match_best_baseline"]
    np.testing.assert_equal(got["tradeoff_std"], want["tradeoff_std"])
    for m in bench_efficiency.METHODS:
        g, w = got["session"][m], want["session"][m]
        assert g["tuner"] == w["tuner"], m
        for key in ("n_rounds", "n_evals", "n_failures"):
            assert g["totals"][key] == w["totals"][key], (m, key)


def test_ablation_suite_matches_reference(both_tiny):
    want = j_ablation.run()
    got = bench_ablation.run(**both_tiny)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        np.testing.assert_equal(g["speed_at_floor"], w["speed_at_floor"], err_msg=name)
        assert g["abandoned"] == w["abandoned"], name
        assert g["score_log_len"] == w["score_log_len"], name
        assert g["session"]["totals"]["n_evals"] == w["session"]["totals"]["n_evals"], name


def test_run_batched_matches_reference(both_tiny, monkeypatch):
    """The batched-tuning axis at q = 1 and 4 in both packages: the same
    rounds and evaluation counts and the same front's hypervolume."""
    monkeypatch.setattr(bench_efficiency, "make_env", _reference_draws_env)
    want = j_efficiency.run_batched(batch_sizes=(1, 4), n_iters=N_COMPARE)
    got = bench_efficiency.run_batched(batch_sizes=(1, 4), n_iters=N_COMPARE, device="cpu")
    assert set(got) == set(want) == {"1", "4"}
    for q in ("1", "4"):
        g, w = got[q], want[q]
        assert set(g) == set(w)
        assert (g["q"], g["n_iters"], g["n_evals"]) == (w["q"], w["n_iters"], w["n_evals"])
        assert g["hv_norm"] == w["hv_norm"], q
        assert g["session"]["totals"]["n_rounds"] == w["session"]["totals"]["n_rounds"], q
        assert [(r["n_asked"], [e["failed"] for e in r["evals"]]) for r in g["session"]["rounds"]] \
            == [(r["n_asked"], [e["failed"] for e in r["evals"]]) for r in w["session"]["rounds"]], q


def test_batched_axis_cli(tiny, tmp_path, capsys):
    path = tmp_path / "batched.json"
    assert bench_efficiency.main(["--device", "cpu", "--batch-sizes", "1", "2", "--iters", "9",
                                  "--json", str(path)]) == 0
    assert "q=2: wall=" in capsys.readouterr().out
    assert set(json.loads(path.read_text())) == {"1", "2"}
    with pytest.raises(SystemExit):
        bench_efficiency.main(["--device", "cpu", "--check-speedup"])


def _reference_draws_env(*args, **kw):
    env = common.make_env(*args, **kw)
    env.draws = ReferenceDraws
    return env


# ---------------------------------------------------------------------------
# the streaming suite against the reference's
# ---------------------------------------------------------------------------
STREAMING_SIZES = dict(n_base=600, n_ops=240, n_phases=2, n_init=8, n_retune=4, front_n=3)


def test_streaming_suite_matches_reference(monkeypatch, jax_builtins_only):
    """``run(quick=True)`` of both packages on one schedule at a reduced trace
    (the suite's own sizes are a CPU-minute each); the port's environments
    build with the reference's draws."""
    for mod in (bench_streaming, j_streaming):
        monkeypatch.setattr(mod, "_sizes", lambda quick: dict(STREAMING_SIZES))
    make_env = bench_streaming._make_env

    def env_with_reference_draws(*args):
        env = make_env(*args)
        env.draws = ReferenceDraws
        return env

    monkeypatch.setattr(bench_streaming, "_make_env", env_with_reference_draws)
    want = j_streaming.run(quick=True, schedules=("step",))["step"]
    got = bench_streaming.run(quick=True, schedules=("step",), device="cpu")["step"]
    assert set(got) == set(want)
    assert (got["trace"], got["n_phases"]) == (want["trace"], want["n_phases"])
    for arm in ("frozen", "retuned"):
        assert set(got[arm]) == set(want[arm]), arm
        assert got[arm]["n_evals"] == want[arm]["n_evals"], arm
        np.testing.assert_allclose(got[arm]["phase_hv"], want[arm]["phase_hv"], rtol=1e-6)
        np.testing.assert_allclose(np.asarray(got[arm]["points"], dtype=object).tolist(),
                                   want[arm]["points"], rtol=1e-6)
    assert got["retuned"]["drift_fired"] == want["retuned"]["drift_fired"]
    assert got["retuned"]["n_retunes"] == want["retuned"]["n_retunes"]


def test_streaming_invariants_match_reference():
    failures, summary = bench_streaming.check_invariants(device="cpu")
    j_failures, j_summary = j_streaming.check_invariants()
    assert failures == j_failures == []
    assert summary["stats"]["n_seals"] >= 1
    for key in ("n_seals", "n_compactions", "n_sealed", "n_alive", "tail_size"):
        assert summary["stats"][key] == j_summary["stats"][key], key
    # the default build draws differ from JAX's, so IVF_FLAT's recall and
    # speed are close, not equal
    assert summary["recall"] == pytest.approx(j_summary["recall"], abs=0.05)
    assert summary["qps"] == pytest.approx(j_summary["qps"], rel=1e-6)  # the analytic model


def test_streaming_cli(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(bench_streaming, "_sizes", lambda quick: dict(STREAMING_SIZES))
    path = tmp_path / "streaming.json"
    assert bench_streaming.main(["--device", "cpu", "--quick", "--check-invariants",
                                 "--schedules", "step", "--index-types", "FLAT,IVF_PQR",
                                 "--json", str(path)]) == 0
    out = json.loads(path.read_text())
    assert out["invariants"]["ok"] and set(out["schedules"]) == {"step"}
    assert "invariants replay: qps=" in capsys.readouterr().out
    assert registered_names() == SEVEN  # IVF_PQR's registration was scoped to the run


# ---------------------------------------------------------------------------
# the serving and chaos suites at their quick sizes
# ---------------------------------------------------------------------------
def test_serving_suite_cli(tmp_path, capsys):
    path, ledger = tmp_path / "serving.json", tmp_path / "ledger.json"
    assert bench_serving.main(["--device", "cpu", "--quick", "--check-improvement",
                               "--json", str(path), "--ledger-json", str(ledger)]) == 0
    out = json.loads(path.read_text())
    assert set(out["schedules"]) == {"step", "ramp"}
    assert set(json.loads(ledger.read_text())) == {"step", "ramp"}
    assert "step: frozen viol_min=" in capsys.readouterr().out


def test_chaos_suite_cli(tmp_path, capsys):
    path = tmp_path / "chaos.json"
    assert bench_chaos.main(["--device", "cpu", "--quick", "--check-resilience",
                             "--json", str(path)]) == 0
    out = json.loads(path.read_text())
    assert len(out["cases"]) == 6 and not any(c[arm]["crashed"] for c in out["cases"]
                                              for arm in ("guarded", "unguarded"))
    assert "check oracle_exact: ok" in capsys.readouterr().out


def test_chaos_suite_matches_reference():
    """Every case of the step schedule (both arms, all three plans) reports
    what the reference reports, the port's builds using the reference's
    draws."""
    want = j_chaos.run(quick=True, schedules=("step",))
    got = bench_chaos.run(quick=True, schedules=("step",), device="cpu", draws=ReferenceDraws)
    assert got["oracle"] == want["oracle"]
    for g, w in zip(got["cases"], want["cases"]):
        assert (g["schedule"], g["plan"], g["fault_plan"]) == (w["schedule"], w["plan"],
                                                               w["fault_plan"])
        for arm in ("unguarded", "guarded"):
            assert set(g[arm]) == set(w[arm]), arm
            for key, v in w[arm].items():
                if isinstance(v, float):
                    assert g[arm][key] == pytest.approx(v, rel=1e-9), (g["plan"], arm, key)
                else:
                    assert g[arm][key] == v, (g["plan"], arm, key)


def test_serving_scale_knobs_match_reference():
    for quick in (True, False):
        assert bench_serving._sizes(quick) == j_serving._sizes(quick)
        assert repr(bench_serving._controller_params(quick)) == repr(
            j_serving._controller_params(quick))
    assert bench_serving._incumbent_config() == j_serving._incumbent_config()
    assert (bench_serving.MIX0, bench_serving.MIX1) == (j_serving.MIX0, j_serving.MIX1)
    assert bench_chaos._fault_horizon(640) == j_chaos._fault_horizon(640)


# ---------------------------------------------------------------------------
# run.py: --index-types
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("value", ["IVF_FLAT,FOO", "BAR,FOO", ["HNSW", "NOPE"]])
def test_parse_index_types_errors_match_reference(value, jax_builtins_only):
    with pytest.raises(ValueError) as want:
        j_streaming.parse_index_types(value)
    with pytest.raises(ValueError) as got:
        bench_run.parse_index_types(value)
    assert str(got.value) == str(want.value)


def test_run_cli_rejects_unknown_index_types(capsys):
    with pytest.raises(SystemExit) as e:
        bench_run.main(["--index-types", "IVF_PQR,BAR", "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "unknown index types ['BAR']; registered families: [" in err and "'IVF_PQR'" in err
    assert bench_run.parse_index_types(" IVF_PQR, FLAT") == ("IVF_PQR", "FLAT")
    assert bench_run.parse_index_types(None) is None
    assert registered_names() == SEVEN
