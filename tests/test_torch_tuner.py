"""The tuner core of the port (``repro_torch.core``) against the JAX
package's ``repro.core``: the numpy modules on seeded inputs, the PyTorch GP
(fitted from the same data, and with the JAX GP's state carried across),
the fused acquisition, VDTuner + TuningSession trajectories on a
deterministic toy backend, a JAX checkpoint restored into the port, and the
port's quickstart resuming bit-identically. Everything runs on the CPU."""
import json

import numpy as np
import pytest
import torch

import repro.core as jc
from repro.core import acquisition_jax as jacq
from repro.core.gp import GP as JGP
from repro_torch import core as tc
from repro_torch.core import acquisition_torch as tacq
from repro_torch.core.gp import GP, GPParams, GPState, _posterior_padded
from repro_torch.launch import quickstart
from repro_torch.vdms import make_dataset
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)


def _toy_objective(cfg):
    """A deterministic numpy backend (a copy of ``tests/test_session.py``'s)."""
    t = cfg["index_type"]
    k = cfg.get("ka", cfg.get("kb", 0.5))
    k = k / 8.0 if t == "A" else k
    sysq = 1.0 - (cfg["s1"] - 0.6) ** 2
    if t == "A":
        return {"speed": 80 * (1 - k) * sysq, "recall": 0.5 + 0.45 * k, "mem_gib": 1.0}
    return {"speed": 50 * (1 - k) * sysq, "recall": 0.6 + 0.39 * k, "mem_gib": 0.5}


# the fits and the Adam loop are hundreds of tiny ops; threads only add
# contention on a shared host
def _front_data(seed, n=40):
    rng = np.random.default_rng(seed)
    Y = rng.random((n, 2)) * np.array([1000.0, 1.0])
    Y[rng.random(n) < 0.2] = Y[0]  # duplicates
    types = rng.choice(np.array(["A", "B", "C"]), n)
    return Y, types


# ---------------------------------------------------------------------------
# numpy modules: the same code, so the same numbers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_modules_match_reference(seed):
    Y, types = _front_data(seed)
    np.testing.assert_array_equal(tc.non_dominated_mask(Y), jc.non_dominated_mask(Y))
    np.testing.assert_array_equal(tc.pareto_front(Y), jc.pareto_front(Y))
    ref = np.array([100.0, 0.1])
    front = jc.pareto_front(Y)
    assert tc.hv_2d(front, ref) == jc.hv_2d(front, ref)
    np.testing.assert_array_equal(tc.hvi_2d(Y, front[:3], ref), jc.hvi_2d(Y, front[:3], ref))
    for mode in ("balanced", "max"):
        yt, bt = tc.npi_normalize(Y, types, mode=mode)
        yj, bj = jc.npi_normalize(Y, types, mode=mode)
        np.testing.assert_array_equal(yt, yj)
        assert {k: v.tolist() for k, v in bt.items()} == {k: v.tolist() for k, v in bj.items()}
    assert tc.scores_by_hv_influence(Y, types, ["A", "B", "C"]) == jc.scores_by_hv_influence(
        Y, types, ["A", "B", "C"])
    sa_t, sa_j = tc.SuccessiveAbandon(["A", "B", "C"], 2), jc.SuccessiveAbandon(["A", "B", "C"], 2)
    for k in range(10, len(Y)):
        assert sa_t.step(Y[:k], types[:k]) == sa_j.step(Y[:k], types[:k])
    assert sa_t.state_dict() == sa_j.state_dict()
    rng = np.random.default_rng(seed)
    mean, std = rng.random((30, 2)), rng.random((30, 2)) * 0.2
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(tc.ehvi_mc(mean, std, front / [1000, 1], [0.1, 0.1], a),
                                  jc.ehvi_mc(mean, std, front / [1000, 1], [0.1, 0.1], b))
    np.testing.assert_array_equal(tc.cei(mean[:, 0], std[:, 0], mean[:, 1], std[:, 1], 0.5, 0.6),
                                  jc.cei(mean[:, 0], std[:, 0], mean[:, 1], std[:, 1], 0.5, 0.6))


def test_objectives_match_reference():
    raw = {"speed": 1200.0, "recall": 0.91, "mem_gib": 2.0, "n_searches": 10.0,
           "search_s": 0.5, "seal_build_s": 0.25}
    for name in ("speed_recall", "cost_aware", "streaming"):
        assert tc.OBJECTIVES[name]()(raw) == jc.OBJECTIVES[name]()(raw)
    assert tc.recall_floor(0.9).rlim == jc.recall_floor(0.9).rlim
    assert tc.promotion_score(raw, 0.95) == jc.promotion_score(raw, 0.95)
    assert isinstance(tc.as_eval_backend(_toy_objective), tc.EvalBackend)


# ---------------------------------------------------------------------------
# GP
# ---------------------------------------------------------------------------
def _gp_data(seed, n, d=5):
    rng = np.random.default_rng(seed)
    X = rng.random((n, d)).astype(np.float32)
    Y = np.stack([np.sin(3 * X[:, 0]) + X[:, 1], X[:, 2] ** 2 - X[:, 0]], 1)
    Y = (Y + 0.05 * rng.standard_normal(Y.shape)).astype(np.float32)
    return X, Y, rng.random((64, d)).astype(np.float32)


def _carry(j: JGP) -> GP:
    """The port's GP holding the JAX GP's fitted state, array for array."""
    s = j.state

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    g = GP(device="cpu")
    g.state = GPState(params=GPParams(t(s.params.log_ls), t(s.params.log_sf),
                                      t(s.params.log_noise)),
                      x=t(s.x), y=t(s.y), mask=t(s.mask), chol=t(s.chol), alpha=t(s.alpha),
                      y_mean=np.asarray(s.y_mean), y_std=np.asarray(s.y_std), n_real=j.n_real)
    return g


def _prior_scale(gp):
    """Per-output prior standard deviation in the original units."""
    return gp.state.y_std * np.exp(gp.params.log_sf.numpy())


@pytest.mark.parametrize("n", [9, 40])
def test_gp_fit_matches_reference(n):
    """Fitted from the same data: log-hyperparameters within 1e-3 (the f32
    gradients differ in the last bits and 120 Adam steps amplify that);
    predictions within 1e-4 relative to each output's prior scale."""
    X, Y, Xt = _gp_data(n, n)
    j = JGP(fit_steps=120).fit(X, Y)
    t = GP(fit_steps=120, device="cpu").fit(X, Y)
    for name in ("log_ls", "log_sf", "log_noise"):
        np.testing.assert_allclose(getattr(t.params, name).numpy(),
                                   np.asarray(getattr(j.params, name)), atol=1e-3, rtol=0)
    (mj, sj), (mt, st) = j.predict(Xt), t.predict(Xt)
    scale = _prior_scale(t)
    assert np.all(np.abs(mt - mj) <= 1e-4 * scale)
    assert np.all(np.abs(st - sj) <= 1e-4 * scale)


def test_gp_carried_state_predicts_like_reference():
    """The JAX GP's arrays in the port's GP: predictions within 1e-4 of each
    output's prior scale. Not closer: XLA's f32 ``exp`` differs from
    PyTorch's in the last bit for about a tenth of arguments, which moves the
    kernel values by ~1e-6 relative, and the posterior mean sums them against
    weights whose magnitudes add up to a few hundred (measured: 3e-5)."""
    X, Y, Xt = _gp_data(3, 30)
    j = JGP(fit_steps=60).fit(X, Y)
    t = _carry(j)
    (mj, sj), (mt, st) = j.predict(Xt), t.predict(Xt)
    scale = _prior_scale(t)
    assert np.all(np.abs(mt - mj) <= 1e-4 * scale) and np.all(np.abs(st - sj) <= 1e-4 * scale)
    # the hyperparameters travel as JSON lists in the JAX package's form
    lists = j.params.to_lists()
    assert json.loads(json.dumps(GPParams.from_lists(lists).to_lists())) == lists
    # a refit from the carried hyperparameters (no Adam step) factorizes alike
    r = GP(device="cpu").fit(X, Y, init=GPParams.from_lists(lists), steps=0)
    (mr, sr) = r.predict(Xt)
    assert np.all(np.abs(mr - mj) <= 1e-4 * scale) and np.all(np.abs(sr - sj) <= 1e-4 * scale)


def test_gp_condition_on_and_capacity_are_exact():
    X, Y, Xt = _gp_data(4, 30)
    gp = GP(fit_steps=30, device="cpu").fit(X, Y)
    big = gp.with_capacity(70)
    assert big.state.x.shape[0] == 96 and big.n_real == 30
    for a, b in zip(gp.predict(Xt), big.predict(Xt)):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(0)
    Xn, Yn = rng.random((5, X.shape[1])).astype(np.float32), rng.random((5, 2)).astype(np.float32)
    cond = gp.condition_on(Xn, Yn)  # grows 32 -> 64 rows on the way
    assert cond.n_real == 35 and gp.n_real == 30
    # refit: the same hyperparameters and standardization, one full factorization
    s = cond.state
    chol, alpha = _posterior_padded(s.params, s.x, s.y, s.mask)
    ref = GP(device="cpu")
    ref.state = GPState(params=s.params, x=s.x, y=s.y, mask=s.mask, chol=chol, alpha=alpha,
                        y_mean=s.y_mean, y_std=s.y_std, n_real=35)
    scale = _prior_scale(gp)  # f32: the bordered append and a full factorization round apart
    for a, b in zip(ref.predict(Xt), cond.predict(Xt)):
        assert np.all(np.abs(a - b) <= 1e-4 * scale)


@pytest.mark.parametrize("q", [1, 4])
def test_fused_acquisition_matches_reference(q):
    """On a carried GP state: identical picks for q-EHVI and q-CEI, and MC
    EHVI / CEI scores within 1e-5 relative."""
    X, Y, _ = _gp_data(6, 25)
    Y = np.abs(Y) + 0.1
    j = JGP(fit_steps=40).fit(X, Y)
    t = _carry(j)
    Xc = np.random.default_rng(7).random((96, X.shape[1])).astype(np.float32)
    front = jc.pareto_front(Y)
    ref = np.array([0.2, 0.2])
    picks_j = jacq.fused_qehvi_select(j, Xc, front, ref, np.random.default_rng(9), q, 32)
    picks_t = tacq.fused_qehvi_select(t, Xc, front, ref, np.random.default_rng(9), q, 32)
    assert picks_t == picks_j
    assert tacq.fused_cei_select(t, Xc, 0.9, 0.8, q) == jacq.fused_cei_select(j, Xc, 0.9, 0.8, q)
    assert tacq.fused_cei_select(t, Xc, float("-inf"), 0.8, q) == jacq.fused_cei_select(
        j, Xc, float("-inf"), 0.8, q)
    mean, std = t.predict(Xc)
    eps = np.random.default_rng(2).standard_normal((32, Xc.shape[0], 2))
    fp, fm = tacq._padded_front(front, 0)
    got = tacq.ehvi_mc_torch(*(torch.from_numpy(a.astype(np.float64)) for a in (mean, std)),
                             torch.from_numpy(fp), torch.from_numpy(fm), torch.from_numpy(ref),
                             torch.from_numpy(eps)).numpy()
    with jacq.enable_x64():  # the JAX package scores in f64 inside this scope
        want = np.asarray(jacq.ehvi_mc_jax(mean.astype(np.float64), std.astype(np.float64), fp,
                                           fm, ref, eps))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    got = tacq.cei_torch(*(torch.from_numpy(a.astype(np.float64)) for a in
                           (mean[:, 0], std[:, 0], mean[:, 1], std[:, 1])), 1.0, 0.8).numpy()
    want = jc.cei(mean[:, 0], std[:, 0], mean[:, 1], std[:, 1], 1.0, 0.8)
    # 1 - Phi(z) cancels in the far tail, where scipy's and PyTorch's erf part
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


# ---------------------------------------------------------------------------
# VDTuner + TuningSession
# ---------------------------------------------------------------------------
def _space(pkg):
    P = pkg.Param
    return pkg.SearchSpace(
        index_types={"A": [P("ka", "grid", choices=(1, 2, 4, 8), default=2)],
                     "B": [P("kb", "float", 0.0, 1.0, default=0.5)]},
        system_params=[P("s1", "float", 0.0, 1.0, default=0.5),
                       P("s2", "cat", choices=(False, True), default=False)],
    )


_FAST = dict(gp_fit_steps=24, n_candidates=48, mc_samples=16)


def _trajectory(tuner):
    return [(o.config, tuple(o.y), o.failed) for o in tuner.history]


@pytest.mark.parametrize("seed,kw", [(0, {}), (1, {}), (2, {}), (0, {"rlim": 0.8}),
                                     (0, dict(_FAST, q=3)),
                                     (1, dict(_FAST, q=3, engine="numpy"))],
                         ids=["s0", "s1", "s2", "s0-cei", "s0-q3", "s1-q3-numpy"])
def test_session_trajectory_matches_reference(seed, kw):
    """The fused acquisition by default; the host-side numpy acquisition
    (``GP.predict`` + ``GP.condition_on`` per pick) with engine="numpy".
    q-EHVI seeds 0-2 and q-CEI seed 0 run at the tuner's defaults (120 fit
    steps, 512 candidates, 64 MC samples). CEI seed 0 reaches, at
    observation 14, a round whose scores are all zero in the JAX package and
    where, without the port's flush to zero, one candidate scores a subnormal
    6e-322 (see ``test_subnormal_scores_flush_like_xla``)."""
    j = jc.VDTuner(_space(jc), seed=seed, **kw)
    jc.TuningSession(j, backend=_toy_objective).run(15)
    t = tc.VDTuner(_space(tc), seed=seed, device="cpu", **kw)
    tc.TuningSession(t, backend=_toy_objective).run(15)
    assert _trajectory(t) == _trajectory(j)


def test_subnormal_scores_flush_like_xla():
    """EI far in the tail (z = -38.3): ``std * phi(z)`` is subnormal, which
    XLA flushes to zero; the port's scores must be zero too."""
    mean, std, best = np.array([0.00135, 0.5]), np.array([0.0253, 0.1]), 0.9714
    with jacq.enable_x64():
        want = np.asarray(jacq.ei_jax(mean, std, best))
    got = tacq.ei_torch(torch.from_numpy(mean), torch.from_numpy(std), best).numpy()
    assert want[0] == 0.0 and got[0] == 0.0
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12)


def test_reference_checkpoint_restores_into_the_port():
    def stop_at(k):
        def cb(sess, obs):
            if sess.n_observations >= k:
                raise jc.StopSession
        return cb

    j = jc.VDTuner(_space(jc), seed=4, warm_start=True, **_FAST)
    part = jc.TuningSession(j, backend=_toy_objective, callbacks=[stop_at(9)]).run(15)
    ckpt = json.loads(json.dumps(part.state_dict()))
    resumed = tc.TuningSession.restore(
        ckpt, tc.VDTuner(_space(tc), seed=4, warm_start=True, device="cpu", **_FAST),
        backend=_toy_objective)
    resumed.run(15)
    whole = tc.VDTuner(_space(tc), seed=4, warm_start=True, device="cpu", **_FAST)
    tc.TuningSession(whole, backend=_toy_objective).run(15)
    assert _trajectory(resumed.tuner) == _trajectory(whole)
    assert json.dumps(resumed.state_dict()["tuner"]["extra"]["gp_warm"])  # JSON all the way


def test_quickstart_resumes_bit_identically_on_the_cpu():
    ds = make_dataset("glove_like", n=1500, n_queries=16, k=10, seed=1, dim=32, device="cpu")
    out = quickstart.run(dataset=ds, n_iters=9, interrupt_at=8, device="cpu")
    assert out["resumed_identical"] and out["interrupted_at"] == 8
    assert len(out["history"]) == 9 and not out["failures"]
    rows = quickstart.rounds(out)
    assert [r["index_type"] for r in rows[:7]] == list(quickstart.make_space().type_names)
    assert rows[-1]["recommend_s"] > 0.0 and all(r["eval_s"] > 0.0 for r in rows)
    assert out["front"] == jc.pareto_front(np.array([h[1] for h in out["history"]])).tolist()


def test_tuner_needs_a_device_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("the default device is the GPU here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.VDTuner(_space(tc))
