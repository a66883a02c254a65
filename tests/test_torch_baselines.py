"""The baseline tuners of the port (``repro_torch.core.baselines``) against
the JAX package's: the same trajectories on the deterministic toy backend of
``test_torch_tuner.py``, OpenTunerLike's bandit state included, and exact
resumes from JSON checkpoints. Everything runs on the CPU."""
import json

import pytest
import torch

import repro.core as jc
from repro_torch import core as tc
from test_torch_tuner import _space, _toy_objective, _trajectory
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)

# the GP baselines at a reduced candidate set so that their five GP rounds
# stay cheap (120 fit steps, as in the paper's setting); one seed each for
# them, two for the numpy-only baselines
_GP_KW = dict(n_init=4, n_candidates=128)
CASES = [
    ("default", {}, 9, 0),
    ("default", {}, 9, 3),
    ("random_lhs", {}, 12, 0),
    ("random_lhs", {}, 12, 3),
    ("ottertune", _GP_KW, 9, 0),
    ("qehvi", dict(_GP_KW, mc_samples=32), 9, 3),
    ("opentuner", {}, 15, 0),
    ("opentuner", {}, 15, 3),
]


def _port_kw(name, kw):
    return dict(kw, device="cpu") if name in ("ottertune", "qehvi") else dict(kw)


def test_all_baselines_are_exported():
    assert list(tc.ALL_BASELINES) == list(jc.ALL_BASELINES)
    for name, cls in tc.ALL_BASELINES.items():
        assert cls.name == name and getattr(tc, cls.__name__) is cls


@pytest.mark.parametrize("name,kw,n_iters,seed", CASES, ids=[f"{c[3]}-{c[0]}" for c in CASES])
def test_baseline_trajectory_matches_reference(name, kw, n_iters, seed):
    j = jc.ALL_BASELINES[name](_space(jc), seed=seed, **kw)
    jc.TuningSession(j, backend=_toy_objective).run(n_iters)
    t = tc.ALL_BASELINES[name](_space(tc), seed=seed, **_port_kw(name, kw))
    tc.TuningSession(t, backend=_toy_objective).run(n_iters)
    assert _trajectory(t) == _trajectory(j)
    assert len(t.history) == (2 if name == "default" else n_iters)  # default: one per type
    if name == "opentuner":
        assert t._uses == j._uses and t._credits == j._credits and t._temp == j._temp
    assert t.rng.bit_generator.state == j.rng.bit_generator.state


def _stop_at(k):
    def cb(sess, obs):
        if sess.n_observations >= k:
            raise tc.StopSession
    return cb


@pytest.mark.parametrize("name,kw", [("opentuner", {}),
                                     ("ottertune", dict(_GP_KW, warm_start=True))],
                         ids=["opentuner", "ottertune-warm"])
def test_baseline_resumes_exactly_from_json(name, kw):
    cls = tc.ALL_BASELINES[name]
    kw = _port_kw(name, kw)
    whole = cls(_space(tc), seed=2, **kw)
    tc.TuningSession(whole, backend=_toy_objective).run(11)
    part = tc.TuningSession(cls(_space(tc), seed=2, **kw), backend=_toy_objective,
                            callbacks=[_stop_at(7)]).run(11)
    assert part.n_observations == 7
    ckpt = json.loads(json.dumps(part.state_dict()))
    extra = ckpt["tuner"]["extra"]
    if name == "ottertune":
        assert extra["gp_warm"] is not None  # the warm GP state rode through JSON
    else:
        assert len(extra["uses"]) == len(extra["credits"]) > 0
    resumed = tc.TuningSession.restore(ckpt, cls(_space(tc), seed=2, **kw),
                                       backend=_toy_objective)
    resumed.run(11)
    assert _trajectory(resumed.tuner) == _trajectory(whole)
    if name == "opentuner":
        assert resumed.tuner._uses == whole._uses and resumed.tuner._credits == whole._credits


def test_gp_baselines_need_a_device_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("the default device is the GPU here")
    for cls in (tc.OtterTuneLike, tc.QEHVI):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(_space(tc))
