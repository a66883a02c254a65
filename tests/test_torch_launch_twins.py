"""The port's launch twins of ``examples/tune_constrained.py``,
``tune_streaming.py`` and ``custom_index_family.py`` on the CPU.

``tune_constrained`` and ``custom_index_family`` run with the reference's
build draws injected (``ReferenceDraws``) and are held, observation for
observation, against the JAX example's own calls: the configurations, the
(speed, recall) pairs and the replay's objectives equal. GP fits can part
the packages at a near-tie of the acquisition (ROADMAP Queue 3); none does
at these sizes, so the test holds every observation. ``tune_constrained``
runs 12 + 8 of its 25 + 20 rounds here, for the tier-1 clock.
``tune_streaming`` runs at its example's 9 + 8 + 8 rounds with the
reference's draws and is held the same way, its probes, incumbents and
final replay too; the test also checks which phases fire and that each
retune finds its incumbent.
"""
import contextlib
import io

import numpy as np
import pytest

import repro.vdms as jv
import repro_torch.vdms as V
from repro.core import DriftDetector as JDriftDetector
from repro.core import TuningSession as JSession
from repro.core import VDTuner as JVDTuner
from repro.core import pareto_front as j_pareto_front
from repro.core import recall_floor as j_recall_floor
from repro.core import streaming_sustained as j_streaming_sustained
from repro.vdms import ivf_pqr as j_pqr
from repro_torch.launch import custom_index_family, tune_constrained, tune_streaming
from repro_torch.vdms import ivf_pqr
from torch_parity import ReferenceDraws
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)

CPU = "cpu"
CONSTRAINED_ROUNDS = (12, 8)


@pytest.fixture
def fresh_registries():
    """Each package's registry as a fresh process has it, as the examples
    run: IVF_PQR unregistered for the test (another module on the same
    worker may have left it registered, and the example's space would then
    hold an eighth family), then put back as it was."""
    had = {pkg: reg.FAMILY.name in pkg.registered_names()
           for reg, pkg in ((j_pqr, jv), (ivf_pqr, V))}
    for reg, pkg in ((j_pqr, jv), (ivf_pqr, V)):
        if had[pkg]:
            pkg.unregister_family(reg.FAMILY.name)
    yield
    for reg, pkg in ((j_pqr, jv), (ivf_pqr, V)):
        now = reg.FAMILY.name in pkg.registered_names()
        if had[pkg] and not now:
            reg.register()
        elif now and not had[pkg]:
            pkg.unregister_family(reg.FAMILY.name)


def _quiet(fn, **kw):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = fn(**kw)
    return res, out.getvalue()


def _hold(port_tuner, ref_tuner):
    assert len(port_tuner.history) == len(ref_tuner.history)
    for i, (a, b) in enumerate(zip(port_tuner.history, ref_tuner.history)):
        assert a.config == b.config, f"observation {i}"
        assert a.bootstrap == b.bootstrap and a.failed == b.failed, i
        assert tuple(a.y) == tuple(b.y), f"observation {i}: {a.y} against {b.y}"


def test_tune_constrained_matches_the_example(fresh_registries):
    """Both sessions of the example (recall >= 0.85, then >= 0.92
    bootstrapped from the first) against the JAX package's same calls."""
    got, text = _quiet(tune_constrained.run, device=CPU, draws=ReferenceDraws,
                       rounds=CONSTRAINED_ROUNDS)
    ds = jv.make_dataset("keyword_like", n=6144, n_queries=128, k=10, seed=1)
    env = jv.VDMSTuningEnv(ds, mode="analytic", seed=1)
    space = jv.make_space()
    t1 = JVDTuner(space, seed=1, objective_spec=j_recall_floor(0.85))
    JSession(t1, backend=env).run(CONSTRAINED_ROUNDS[0])
    t2 = JVDTuner(space, seed=2, objective_spec=j_recall_floor(0.92),
                  bootstrap_history=t1.history)
    JSession(t2, backend=env).run(CONSTRAINED_ROUNDS[1])
    _hold(got["phase1"], t1)
    _hold(got["phase2"], t2)
    assert got["phase1"].best_speed_at_recall(0.85) == t1.best_speed_at_recall(0.85)
    assert got["phase2"].best_speed_at_recall(0.92) == t2.best_speed_at_recall(0.92)
    fresh = [o for o in t2.history if not o.bootstrap]
    assert got["fresh"] == len(fresh) == CONSTRAINED_ROUNDS[1]
    assert got["feasible"] == sum(1 for o in fresh if o.y[1] >= 0.92)
    assert "phase 2: recall >= 0.92, bootstrapped from phase 1" in text


def test_custom_index_family_matches_the_example(fresh_registries):
    """IVF_PQR registered through the hook, tuned against IVF_PQ and SCANN
    for 12 rounds and replayed on a 300-op trace, against the JAX
    example's same calls: every observation, the Pareto front and the
    replay's objectives equal."""
    got, text = _quiet(custom_index_family.run, device=CPU, draws=ReferenceDraws)
    assert got["ok"] and "IVF_PQR" in V.registered_names()
    j_pqr.register()
    sub = jv.make_space(include=("IVF_PQ", "SCANN", "IVF_PQR"))
    ds = jv.make_dataset("glove_like", n=3072, n_queries=64, k=10, seed=0)
    tuner = JVDTuner(sub, jv.VDMSTuningEnv(ds, mode="analytic", seed=0), seed=0)
    JSession(tuner).run(custom_index_family.ROUNDS)
    _hold(got["tuner"], tuner)
    assert np.array_equal(got["front"], j_pareto_front(tuner.Y))
    trace = jv.make_trace("glove_like", n_base=1024, n_ops=300, seed=0, mix=(0.3, 0.6, 0.1))
    cfg = dict(sub.default_config("IVF_PQR"), segment_max_size=512, seal_proportion=0.5)
    want = jv.replay_trace(trace, cfg, seed=0, mode="analytic")
    for key in ("speed", "recall", "n_seals", "n_compactions"):
        assert got["replay"][key] == pytest.approx(want[key], rel=1e-12), key
    assert got["replay"]["n_seals"] >= 1
    assert "derived space: 34 dims over 8 families" in text


def test_tune_streaming_fires_and_retunes(fresh_registries):
    """The step-drift trace with the reference's draws, against the JAX
    example's same calls: every observation of the tuner, each phase's
    probe (relative change and whether it fired), the incumbents and the
    final replay equal. The probe fires in phases 1 and 2 (relative change
    past 0.12), each retune's incumbent is the tuner's best configuration
    after it, and the final replay measures it."""
    got, text = _quiet(tune_streaming.run, device=CPU, draws=ReferenceDraws)
    trace = jv.make_trace("glove_like", n_base=2048, n_ops=900, seed=0, drift="step",
                          mix=(0.05, 0.90, 0.05), mix_to=(0.60, 0.30, 0.10))
    env = jv.VDMSTuningEnv(trace=trace, workload="streaming", mode="analytic", seed=0,
                           n_phases=3)
    spec = j_streaming_sustained()
    ref = JVDTuner(jv.make_space(), env, seed=0, warm_start=True, objective_spec=spec)
    session = JSession(ref)
    session.run(tune_streaming.ROUNDS)
    incumbents = [ref.best_config()]
    detector = JDriftDetector(metrics=("speed", "recall"), rel_threshold=0.12)
    session.probe_drift(detector, incumbents[-1])
    probes = []
    for phase in range(1, env.n_phases):
        env.set_phase(phase)
        fired = session.probe_drift(detector, incumbents[-1])
        probes.append(dict(phase=phase, rel=detector.log[-1]["rel"], fired=fired))
        if fired:
            session.retune(tune_streaming.RETUNE_ROUNDS, reanchor=ref.pareto_configs(max_n=3))
            incumbents.append(ref.best_config())
            detector.reset()
            session.probe_drift(detector, incumbents[-1])
    want = env(incumbents[-1])
    _hold(got["tuner"], ref)
    assert got["probes"] == probes
    assert got["incumbents"] == incumbents
    for key in ("speed", "recall", "n_seals"):
        assert got["final"][key] == want[key], key
    assert got["env"].n_evals == env.n_evals

    assert [p["phase"] for p in got["probes"]] == [1, 2]
    assert all(p["fired"] and p["rel"] > 0.12 for p in got["probes"])
    tuner = got["tuner"]
    assert len(got["incumbents"]) == 3  # phase 0's, then one a retune
    assert got["incumbents"][-1] == tuner.best_config()
    assert got["incumbents"][1] != got["incumbents"][0]  # the drift moved the choice
    n_obs = tune_streaming.ROUNDS + 2 * tune_streaming.RETUNE_ROUNDS
    assert len([o for o in tuner.history if not o.bootstrap]) >= tune_streaming.RETUNE_ROUNDS
    assert got["env"].n_evals >= n_obs
    assert got["final"]["speed"] > 0 and 0.0 < got["final"]["recall"] <= 1.0
    assert text.count("re-tuned incumbent") == 2
