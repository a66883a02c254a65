"""The GP's ``prior_mean`` of the port against the JAX package's: the fit
models the residuals, ``predict`` adds the prior back, ``condition_on`` and
``with_capacity`` carry it; without a prior the fit is what it was."""
import numpy as np
import pytest

from repro.core.gp import GP as JGP
from repro_torch.core.gp import GP, GPParams
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)

STEPS = 60  # one Adam length for every fit: one compiled fit in the JAX package


def _data(seed, n, d=3):
    rng = np.random.default_rng(seed)
    X = rng.random((n, d)).astype(np.float32)
    Y = np.stack([3.0 + 2.0 * X[:, 0] + 0.3 * np.sin(5 * X[:, 1]),
                  1.0 - X[:, 2] ** 2 + 0.2 * X[:, 0]], 1).astype(np.float32)
    return X, Y, rng.random((48, d)).astype(np.float32)


def _prior(A):
    A = np.asarray(A)
    return np.stack([3.0 + 2.0 * A[:, 0], 1.0 - A[:, 2] ** 2], 1)


def _scale(gp):
    """Per-output prior standard deviation in the original units."""
    return gp.state.y_std * np.exp(gp.params.log_sf.numpy())


def _at_reference_params(j, X, Y):
    """The port's GP factorized at the JAX GP's fitted hyperparameters (no
    Adam step), with the same prior: what is left to compare is the prior
    handling, apart from the Adam loop's f32 drift."""
    init = GPParams.from_lists(j.params.to_lists())
    return GP(device="cpu").fit(X, Y, init=init, steps=0, prior_mean=_prior)


#: cross-package tolerance, relative to each output's prior scale (the plain
#: fit's parity tolerance). At the same hyperparameters the two packages'
#: posteriors differ by XLA's and PyTorch's f32 ``exp`` (the last bit for
#: about a tenth of arguments), scaled by the posterior weights: measured
#: 2.8e-5 at n = 6 and 3.5e-5 at n = 30, and 2.9e-5 / 3.4e-5 for the plain GP
#: on the residuals Y - prior(X), so the prior adds nothing to it.
REL_TOL = 1e-4
COND_TOL = 2e-3


def _resid(X, Y):
    return Y - np.asarray(_prior(X), np.float32).reshape(Y.shape)


@pytest.mark.parametrize("n", [6, 30])
def test_prior_mean_is_a_fit_of_the_residuals(n):
    """In both packages, a fit with a prior IS the plain fit of the
    residuals with the prior added back to the mean, bit for bit."""
    X, Y, Xt = _data(n, n)
    for make in (lambda: GP(fit_steps=STEPS, device="cpu"), lambda: JGP(fit_steps=STEPS)):
        with_prior = make().fit(X, Y, prior_mean=_prior)
        plain = make().fit(X, _resid(X, Y))
        for name in ("log_ls", "log_sf", "log_noise"):
            assert np.array_equal(np.asarray(getattr(with_prior.params, name)),
                                  np.asarray(getattr(plain.params, name)))
        (m, s), (mp, sp) = with_prior.predict(Xt), plain.predict(Xt)
        assert np.array_equal(m, mp + np.asarray(_prior(Xt), np.float32)) and np.array_equal(s, sp)
        Xn = Xt[:5]
        Yn = np.asarray(_prior(Xn), np.float32) + 0.1
        (m, s) = with_prior.condition_on(Xn, Yn).predict(Xt)
        (mp, sp) = plain.condition_on(Xn, _resid(Xn, Yn)).predict(Xt)
        assert np.array_equal(m, mp + np.asarray(_prior(Xt), np.float32)) and np.array_equal(s, sp)


def _at_reference_params(j, X, Y):
    """The port's GP factorized at the JAX GP's fitted hyperparameters (no
    Adam step), with the same prior, apart from the Adam loop's f32 drift."""
    init = GPParams.from_lists(j.params.to_lists())
    return GP(device="cpu").fit(X, Y, init=init, steps=0, prior_mean=_prior)


@pytest.mark.parametrize("n", [6, 30])
def test_prior_mean_fit_matches_reference(n):
    """Same data and prior: log-hyperparameters within 1e-3 (the plain
    fit's parity tolerance: the Adam steps amplify the ``exp`` drift); at
    the reference's hyperparameters, predictions within ``REL_TOL`` of each
    output's prior scale, the prior added back; far from the data the mean
    follows the prior."""
    X, Y, Xt = _data(n, n)
    j = JGP(fit_steps=STEPS).fit(X, Y, prior_mean=_prior)
    t = GP(fit_steps=STEPS, device="cpu").fit(X, Y, prior_mean=_prior)
    for name in ("log_ls", "log_sf", "log_noise"):
        np.testing.assert_allclose(getattr(t.params, name).numpy(),
                                   np.asarray(getattr(j.params, name)), atol=1e-3, rtol=0)
    r = _at_reference_params(j, X, Y)
    np.testing.assert_allclose(r.state.y_mean, np.asarray(j.state.y_mean), rtol=1e-6, atol=1e-6)
    scale = _scale(r)
    (mj, sj), (mr, sr) = j.predict(Xt), r.predict(Xt)
    assert np.all(np.abs(mr - mj) <= REL_TOL * scale)
    assert np.all(np.abs(sr - sj) <= REL_TOL * scale)
    far = np.array([[0.95, 0.9, 0.05]], np.float32)
    cold, _ = GP(fit_steps=STEPS, device="cpu").fit(X[:3], Y[:3]).predict(far)
    warm, _ = GP(fit_steps=STEPS, device="cpu").fit(X[:3], Y[:3], prior_mean=_prior).predict(far)
    true = _prior(far)
    assert abs(warm[0, 0] - true[0, 0]) < abs(cold[0, 0] - true[0, 0])


def test_prior_mean_condition_on_and_capacity_match_reference():
    X, Y, Xt = _data(1, 20)
    j = JGP(fit_steps=STEPS).fit(X, Y, prior_mean=_prior)
    t = _at_reference_params(j, X, Y)
    rng = np.random.default_rng(2)
    Xn = rng.random((14, 3)).astype(np.float32)  # grows the padding on the way
    # Kriging-believer fantasies, the batch acquisition's use of condition_on
    Yn = j.predict(Xn)[0] + np.float32(0.01)
    jc, tc = j.condition_on(Xn, Yn), t.condition_on(Xn, Yn)
    assert tc.n_real == 34 and t.n_real == 20
    # the two packages' f32 bordered appends part further than their fits:
    # measured 1.08e-3 of the prior scale here, and 1.28e-3 for the plain GP
    # conditioned on the residuals (no prior), so COND_TOL is the packages'
    # conditioning tolerance, not the prior's
    scale = _scale(t)
    (mj, sj), (mt, st) = jc.predict(Xt), tc.predict(Xt)
    assert np.all(np.abs(mt - mj) <= COND_TOL * scale)
    assert np.all(np.abs(st - sj) <= COND_TOL * scale)
    big = t.with_capacity(100)
    for a, b in zip(t.predict(Xt), big.predict(Xt)):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_without_prior_the_fit_is_unchanged():
    """``prior_mean=None`` is the plain fit bit for bit, and a zero prior
    changes no bit of it either."""
    X, Y, Xt = _data(3, 17)
    plain = GP(fit_steps=STEPS, device="cpu").fit(X, Y)
    none = GP(fit_steps=STEPS, device="cpu").fit(X, Y, prior_mean=None)
    zero = GP(fit_steps=STEPS, device="cpu").fit(X, Y, prior_mean=lambda A: np.zeros((len(A), 2)))
    for other in (none, zero):
        for name in ("log_ls", "log_sf", "log_noise"):
            assert np.array_equal(getattr(plain.params, name).numpy(),
                                  getattr(other.params, name).numpy())
        for a, b in zip(plain.predict(Xt), other.predict(Xt)):
            assert np.array_equal(a, b)
        for a, b in zip(plain.condition_on(Xt[:3], Y[:3]).predict(Xt),
                        other.condition_on(Xt[:3], Y[:3]).predict(Xt)):
            assert np.array_equal(a, b)
