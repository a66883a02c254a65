"""Gaussian-process surrogate in PyTorch (the counterpart of the JAX
package's ``core/gp.py``, same arithmetic in f32).

Matérn-5/2 ARD kernel (paper §IV-B chooses Matérn 5/2 "owing to its excellent
ability to balance flexibility and smoothness"). Multi-output is handled by
independent per-output hyperparameters (the paper's multi-output GP "assumes
each output to be independent"); the outputs are a batch dimension here
where the JAX package ``vmap``s over them.

Implementation notes
--------------------
* Inputs live on the unit cube (``SearchSpace.encode``); outputs are
  standardized per-output before fitting, so float32 + adaptive jitter is
  numerically fine at the ≤ a-few-hundred-points scale BO operates at.
* X/Y are padded to the next multiple of ``PAD``, as in the JAX package
  (whose padding keeps ``jit`` cache hits). Padded rows are *exactly inert*:
  kernel cross-terms are masked to zero and the pad diagonal is the constant
  ``_BIG_NOISE``, so the padded posterior equals the unpadded one, growing
  capacity is an exact block extension of the Cholesky, and conditioning on
  an extra observation is an exact O(n²) bordered-Cholesky append into the
  first free pad row — ``condition_on`` never refactorizes.
* The hyperparameters are fitted by Adam on the negative log marginal
  likelihood, with gradients from ``torch.autograd``. A Cholesky that fails
  (a matrix that is not positive definite) gives NaN, as ``jnp.linalg.cholesky``
  does, so the step's NaN guard zeroes that output's gradient; the factor
  comes from ``cholesky_ex``, which reports the failure on the device instead
  of raising (and so needs no host synchronisation per step).
* ``fit`` supports warm starts: pass ``init`` (the ``GPParams`` of a
  previous fit) and the optimizer runs ``warm_fit_steps`` Adam steps from
  there instead of ``fit_steps`` from the default initialization.
* ``device`` defaults to the GPU (and raises without one); the count of real
  rows is kept on the host, so appending a row needs no device read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

PAD = 32
_BIG_NOISE = 1e4
_JITTER = 1e-5
_NOISE_FLOOR = 1e-4  # variance floor keeps f32 Cholesky well-conditioned

# f32 bounds of the log-hyperparameters
_LOG_LS = (math.log(0.05), math.log(20.0))
_LOG_SF_NLL = (math.log(0.05), math.log(4.0))  # inside the NLL and the Adam step
_LOG_SF = (math.log(0.05), math.log(20.0))  # the final clamp, as in the JAX package
_LOG_NOISE = (math.log(1e-3), math.log(1.0))


@dataclasses.dataclass
class GPParams:
    log_ls: torch.Tensor  # (m, d) per-output ARD lengthscales
    log_sf: torch.Tensor  # (m,)  signal stddev
    log_noise: torch.Tensor  # (m,) observation noise stddev

    # --- serialization (JSON-compatible; exact f32 round-trip) -----------
    def to_lists(self) -> Dict[str, Any]:
        return {
            "log_ls": self.log_ls.detach().cpu().numpy().astype(np.float64).tolist(),
            "log_sf": self.log_sf.detach().cpu().numpy().astype(np.float64).tolist(),
            "log_noise": self.log_noise.detach().cpu().numpy().astype(np.float64).tolist(),
        }

    @classmethod
    def from_lists(cls, d: Dict[str, Any]) -> "GPParams":
        return cls(
            log_ls=torch.from_numpy(np.asarray(d["log_ls"], np.float32)),
            log_sf=torch.from_numpy(np.asarray(d["log_sf"], np.float32)),
            log_noise=torch.from_numpy(np.asarray(d["log_noise"], np.float32)),
        )


@dataclasses.dataclass
class GPState:
    params: GPParams
    x: torch.Tensor  # (n_pad, d)
    y: torch.Tensor  # (n_pad, m) standardized
    mask: torch.Tensor  # (n_pad,) 1.0 for real rows
    chol: torch.Tensor  # (m, n_pad, n_pad)
    alpha: torch.Tensor  # (m, n_pad)
    y_mean: np.ndarray  # (m,) f32
    y_std: np.ndarray  # (m,) f32
    n_real: int


def _clip(x: torch.Tensor, bounds: Tuple[float, float]) -> torch.Tensor:
    """``jnp.clip``: max then min, so a value on a bound passes half its
    gradient, as in JAX."""
    lo, hi = (torch.tensor(b, dtype=x.dtype, device=x.device) for b in bounds)
    return torch.minimum(torch.maximum(x, lo), hi)


def _sqdist(a: torch.Tensor, b: torch.Tensor, inv_ls: torch.Tensor) -> torch.Tensor:
    """Batched over outputs: a (t, d), b (n, d), inv_ls (m, d) -> (m, t, n)."""
    a = a[None] * inv_ls[:, None, :]
    b = b[None] * inv_ls[:, None, :]
    d2 = (a * a).sum(-1)[:, :, None] + (b * b).sum(-1)[:, None, :] - 2.0 * a @ b.transpose(1, 2)
    return torch.maximum(d2, torch.zeros((), dtype=d2.dtype, device=d2.device))


def matern52(a, b, log_ls, log_sf):
    """Matérn-5/2 kernel per output: a (t, d), b (n, d), log_ls (m, d),
    log_sf (m,) -> (m, t, n)."""
    inv_ls = torch.exp(-log_ls)
    r = torch.sqrt(_sqdist(a, b, inv_ls) + 1e-12)
    s5 = math.sqrt(5.0) * r
    sf2 = torch.exp(2.0 * log_sf)[:, None, None]
    return sf2 * (1.0 + s5 + (5.0 / 3.0) * r * r) * torch.exp(-s5)


def _kernel_matrix(x, mask, log_ls, log_sf, log_noise, noise_scale=1.0):
    """K̃ per output (m, n, n) with exactly-inert padding: masked cross-terms,
    constant BIG pad diagonal. ``noise_scale`` (a scalar or an (n,) vector)
    multiplies the learned observation-noise variance per row."""
    sf2 = torch.exp(2.0 * log_sf)[:, None]
    k = matern52(x, x, log_ls, log_sf) * (mask[:, None] * mask[None, :])
    noise = (
        sf2 * _NOISE_FLOOR + torch.exp(2.0 * log_noise)[:, None] * noise_scale + _JITTER * sf2
    ) * mask + _BIG_NOISE * (1.0 - mask)
    return k + torch.diag_embed(noise)


def _cholesky(k: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky factor; NaN for a matrix that is not positive
    definite (as ``jnp.linalg.cholesky``), with no host synchronisation."""
    chol, info = torch.linalg.cholesky_ex(k)
    return torch.where((info == 0)[:, None, None], chol, torch.full_like(chol, float("nan")))


def _cho_solve(chol: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(L Lᵀ)⁻¹ y per output: chol (m, n, n), y (m, n) -> (m, n)."""
    z = torch.linalg.solve_triangular(chol, y[..., None], upper=False)
    return torch.linalg.solve_triangular(chol.transpose(1, 2), z, upper=True)[..., 0]


def _nll(log_ls, log_sf, log_noise, x, y, mask, noise_scale=1.0):
    """Negative log marginal likelihood per output (m,), padded rows inert."""
    n = x.shape[0]
    log_ls = _clip(log_ls, _LOG_LS)
    log_sf = _clip(log_sf, _LOG_SF_NLL)
    k = _kernel_matrix(x, mask, log_ls, log_sf, log_noise, noise_scale)
    chol = _cholesky(k)
    yt = y.T  # (m, n)
    alpha = _cho_solve(chol, yt)
    # padded rows: y=0 and zero cross-terms, so the quadratic term is exactly
    # 0 there; logdet picks up the constant 0.5*log(BIG_NOISE) per pad row,
    # which does not affect gradients w.r.t. hyperparameters.
    logdet = torch.log(torch.diagonal(chol, dim1=1, dim2=2)).sum(-1)
    nll = 0.5 * (yt * alpha).sum(-1) + logdet + 0.5 * n * math.log(2 * math.pi)
    # weak log-normal priors keep hyperparameters in a sane band
    prior = (0.05 * ((log_ls - math.log(0.5)) ** 2).sum(-1) + 0.05 * log_sf**2
             + 0.02 * (log_noise - math.log(0.05)) ** 2)
    return nll + prior, torch.isfinite(chol).all(-1).all(-1)


def _fit_padded(x, y, mask, ls0, sf0, nz0, steps: int, noise_scale=1.0):
    """Adam on the NLL (each output on its own: the outputs' NLLs share no
    parameter), starting from (ls0, sf0, nz0). Returns the clamped params."""
    params = [p.clone().requires_grad_(True) for p in (ls0, sf0, nz0)]
    moments = [(torch.zeros_like(p), torch.zeros_like(p)) for p in params]
    bounds = (_LOG_LS, _LOG_SF_NLL, _LOG_NOISE)
    lr = 0.05
    for i in range(steps):
        nll, ok = _nll(*params, x, y, mask, noise_scale)
        grads = torch.autograd.grad(nll.sum(), params)
        with torch.no_grad():
            new_params, new_moments = [], []
            for p, g, (m1, m2), (lo, hi) in zip(params, grads, moments, bounds):
                # NaN-guard the step; a failed Cholesky makes the whole
                # output's gradient NaN in JAX, so zero all of it here too
                bad = ~ok.reshape(-1, *([1] * (g.dim() - 1)))
                g = torch.where(torch.isfinite(g) & ~bad, g, torch.zeros_like(g))
                m1 = 0.9 * m1 + 0.1 * g
                m2 = 0.999 * m2 + 0.001 * g * g
                m1h = m1 / (1 - 0.9 ** (i + 1))
                m2h = m2 / (1 - 0.999 ** (i + 1))
                new_params.append(_clip(p - lr * m1h / (torch.sqrt(m2h) + 1e-8), (lo, hi)))
                new_moments.append((m1, m2))
        params = [p.requires_grad_(True) for p in new_params]
        moments = new_moments
    log_ls, log_sf, log_noise = (p.detach() for p in params)
    # clamp for safety (posterior uses these values directly)
    return _clip(log_ls, _LOG_LS), _clip(log_sf, _LOG_SF), _clip(log_noise, _LOG_NOISE)


def _posterior_padded(params: GPParams, x, y, mask, noise_scale=1.0):
    """Cholesky + weights per output for fixed hyperparameters (padded rows
    exactly inert). Full refactorization, used after ``fit``."""
    k = _kernel_matrix(x, mask, params.log_ls, params.log_sf, params.log_noise, noise_scale)
    chol = _cholesky(k)
    return chol, _cho_solve(chol, y.T)


def _predict_padded(params: GPParams, chol, alpha, x_train, mask, x_test):
    ks = matern52(x_test, x_train, params.log_ls, params.log_sf) * mask[None, None, :]  # (m, t, n)
    mean = (ks @ alpha[..., None])[..., 0]  # (m, t)
    v = torch.linalg.solve_triangular(chol, ks.transpose(1, 2), upper=False)  # (m, n, t)
    kss = torch.exp(2.0 * params.log_sf)[:, None]
    var = torch.clamp_min(kss - (v * v).sum(1), 1e-10)
    return mean.T, var.T  # (t, m)


def _append_rows(params: GPParams, x, y, mask, chol, n_real: int, x_new, y_new):
    """Insert rows ``x_new`` (k, d) / ``y_new`` (k, m; standardized) into the
    first free pad slots, updating the Cholesky by one bordered row each —
    O(n²) per row. Exact because pad rows are inert: the new row's
    cross-terms to later pad rows are zero, so no row below it changes.
    Returns new (x, y, mask, chol, alpha); the inputs are not modified."""
    x, y, mask, chol = x.clone(), y.clone(), mask.clone(), chol.clone()
    sf2 = torch.exp(2.0 * params.log_sf)
    row_noise = sf2 * (_NOISE_FLOOR + _JITTER) + torch.exp(2.0 * params.log_noise)  # (m,)
    for j in range(x_new.shape[0]):
        r = n_real + j  # first free pad row
        xn = x_new[j : j + 1]
        kv = matern52(xn, x, params.log_ls, params.log_sf)[:, 0, :] * mask[None, :]  # (m, n_pad)
        w = torch.linalg.solve_triangular(chol, kv[..., None], upper=False)[..., 0]
        kself = matern52(xn, xn, params.log_ls, params.log_sf)[:, 0, 0]
        l_rr = torch.sqrt(torch.clamp_min(kself + row_noise - (w * w).sum(1), 1e-10))
        chol[:, r, :] = w  # w is 0 at rows >= r (inert pads)
        chol[:, r, r] = l_rr
        x[r] = xn[0]
        y[r] = y_new[j]
        mask[r] = 1.0
    return x, y, mask, chol, _cho_solve(chol, y.T)


def _extend_padding(chol: torch.Tensor, alpha: torch.Tensor, n_new: int):
    """Exact capacity growth: block-extend the Cholesky with the constant
    pad diagonal sqrt(BIG_NOISE) and zero-pad the weights."""
    m, n, _ = chol.shape
    c = torch.zeros((m, n_new, n_new), dtype=chol.dtype, device=chol.device)
    c[:, :n, :n] = chol
    idx = torch.arange(n, n_new, device=chol.device)
    c[:, idx, idx] = math.sqrt(_BIG_NOISE)
    a = torch.zeros((m, n_new), dtype=alpha.dtype, device=alpha.device)
    a[:, :n] = alpha
    return c, a


class GP:
    """Exact multi-output GP with Matérn-5/2 ARD kernel.

    fit(X (n,d), Y (n,m)) then predict(Xt) -> (mean, std), numpy arrays in
    the original Y units (standardization handled internally). ``seed`` is
    accepted for the JAX package's signature; the fit draws no random
    numbers.
    """

    def __init__(self, seed: int = 0, fit_steps: int = 120, warm_fit_steps: int = 30,
                 device=None):
        self.seed = seed
        self.fit_steps = fit_steps
        self.warm_fit_steps = warm_fit_steps
        self.device = resolve_device(device)
        self.state: GPState | None = None
        # optional prior mean callable X (n,d) -> (n,m) in original Y units;
        # the GP then models the residuals Y - mu(X)
        self._prior_mean = None

    @property
    def params(self) -> GPParams:
        assert self.state is not None, "fit() first"
        return self.state.params

    @property
    def n_real(self) -> int:
        assert self.state is not None, "fit() first"
        return self.state.n_real

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

    def fit(
        self,
        X: np.ndarray,
        Y: np.ndarray,
        init: Optional[GPParams] = None,
        steps: Optional[int] = None,
        noise_scale: Optional[np.ndarray] = None,
        prior_mean=None,
    ) -> "GP":
        """Fit hyperparameters by Adam on the NLL.

        ``init`` warm-starts the optimizer from a previous fit's
        hyperparameters (running ``warm_fit_steps`` instead of ``fit_steps``
        unless ``steps`` overrides); shape-mismatched ``init`` (e.g. a
        checkpoint from a different space) silently falls back to a cold fit.
        ``noise_scale`` is an optional (n,) per-row multiplier on the learned
        observation-noise variance. ``prior_mean`` is an optional callable
        ``X (n,d) -> (n,m)`` in original Y units: the GP fits the residuals
        and ``predict`` adds the prior back. Both default to the plain fit.
        """
        X = np.asarray(X, np.float32)
        Y = np.asarray(Y, np.float32)
        if Y.ndim == 1:
            Y = Y[:, None]
        n, d = X.shape
        m = Y.shape[1]
        self._prior_mean = prior_mean
        if prior_mean is not None:
            Y = Y - np.asarray(prior_mean(X), np.float32).reshape(n, m)
        y_mean = Y.mean(axis=0)
        y_std = Y.std(axis=0) + 1e-8
        Yn = (Y - y_mean) / y_std
        n_pad = int(np.ceil(max(n, 1) / PAD) * PAD)
        xp = np.zeros((n_pad, d), np.float32)
        yp = np.zeros((n_pad, m), np.float32)
        maskp = np.zeros((n_pad,), np.float32)
        xp[:n] = X
        yp[:n] = Yn
        maskp[:n] = 1.0
        if init is not None and tuple(init.log_ls.shape) != (m, d):
            init = None
        if init is None:
            ls0 = np.full((m, d), np.log(0.5), np.float32)
            sf0 = np.zeros((m,), np.float32)
            nz0 = np.full((m,), np.log(0.1), np.float32)
            n_steps = self.fit_steps if steps is None else steps
        else:
            ls0, sf0, nz0 = (p.detach().cpu().numpy() for p in (init.log_ls, init.log_sf,
                                                               init.log_noise))
            n_steps = self.warm_fit_steps if steps is None else steps
        if noise_scale is None:
            scale: Any = 1.0
        else:
            sp = np.ones((n_pad,), np.float32)
            sp[:n] = np.asarray(noise_scale, np.float32).reshape(n)
            scale = self._tensor(sp)
        x, y, mask = self._tensor(xp), self._tensor(yp), self._tensor(maskp)
        params = GPParams(*_fit_padded(x, y, mask, self._tensor(ls0), self._tensor(sf0),
                                       self._tensor(nz0), int(n_steps), scale))
        chol, alpha = _posterior_padded(params, x, y, mask, scale)
        self.state = GPState(params=params, x=x, y=y, mask=mask, chol=chol, alpha=alpha,
                             y_mean=y_mean, y_std=y_std, n_real=n)
        return self

    def predict(self, Xt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        assert self.state is not None, "fit() first"
        s = self.state
        # rows past the last PAD block holding a real row are inert (zero
        # cross-terms, zero weights): leaving them out keeps the f32 sums
        # grouped as they were before ``with_capacity`` grew the arrays
        n = int(np.ceil(max(s.n_real, 1) / PAD) * PAD)
        mean, var = _predict_padded(s.params, s.chol[:, :n, :n], s.alpha[:, :n], s.x[:n],
                                    s.mask[:n], self._tensor(Xt))
        mean = mean.cpu().numpy() * s.y_std + s.y_mean
        std = np.sqrt(var.cpu().numpy()) * s.y_std
        if self._prior_mean is not None:
            Xt = np.asarray(Xt, np.float32)
            mean = mean + np.asarray(self._prior_mean(Xt), np.float32).reshape(mean.shape)
        return mean, std

    def _derived(self, state: GPState) -> "GP":
        out = GP(seed=self.seed, fit_steps=self.fit_steps, warm_fit_steps=self.warm_fit_steps,
                 device=self.device)
        out.state = state
        out._prior_mean = self._prior_mean
        return out

    def with_capacity(self, n_total: int) -> "GP":
        """A GP whose padded arrays hold at least ``n_total`` rows (self if
        they already do). Growth is the exact block extension — no
        refactorization, identical posterior."""
        assert self.state is not None, "fit() first"
        s = self.state
        n_pad = s.x.shape[0]
        if n_total <= n_pad:
            return self
        n_new = int(np.ceil(n_total / PAD) * PAD)
        grow = n_new - n_pad
        x = torch.nn.functional.pad(s.x, (0, 0, 0, grow))
        y = torch.nn.functional.pad(s.y, (0, 0, 0, grow))
        mask = torch.nn.functional.pad(s.mask, (0, grow))
        chol, alpha = _extend_padding(s.chol, s.alpha, n_new)
        return self._derived(dataclasses.replace(s, x=x, y=y, mask=mask, chol=chol, alpha=alpha))

    def condition_on(self, X_new: np.ndarray, Y_new: np.ndarray) -> "GP":
        """Posterior conditioning on extra observations (original Y units)
        without refitting hyperparameters: each new point is a rank-1
        bordered-Cholesky append into a free pad row (O(n²) per output),
        growing the padding by an exact block extension when the PAD block
        is full. Returns a new GP; self is untouched."""
        assert self.state is not None, "fit() first"
        d = self.state.x.shape[1]
        m = self.state.y.shape[1]
        X_new = np.asarray(X_new, np.float32).reshape(-1, d)
        Y_new = np.asarray(Y_new, np.float32).reshape(-1, m)
        s = self.with_capacity(self.n_real + X_new.shape[0]).state
        if self._prior_mean is not None:
            Y_new = Y_new - np.asarray(self._prior_mean(X_new), np.float32).reshape(Y_new.shape)
        Yn_new = (Y_new - s.y_mean) / s.y_std
        x, y, mask, chol, alpha = _append_rows(s.params, s.x, s.y, s.mask, s.chol, s.n_real,
                                               self._tensor(X_new), self._tensor(Yn_new))
        return self._derived(dataclasses.replace(s, x=x, y=y, mask=mask, chol=chol, alpha=alpha,
                                                 n_real=s.n_real + X_new.shape[0]))
