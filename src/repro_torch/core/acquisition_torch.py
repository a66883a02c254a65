"""Device-resident acquisition engine in PyTorch (the counterpart of the JAX
package's ``core/acquisition_jax.py``).

Ports of the acquisition stack (2-D staircase HVI, MC-EHVI, EI,
constrained EI) plus the sequential-greedy batch selectors: for each of the
q picks, the GP posterior over the candidate matrix, the acquisition scores,
the availability-masked argmax, the Kriging-believer fantasy (an exact
rank-1 bordered-Cholesky append that reuses the prediction's triangular
solve) and the running front / feasible-incumbent update stay on the GP's
device. The JAX package's ``lax.scan`` over the picks is a Python loop
here. The numpy implementations in :mod:`.acquisition` /
:mod:`.hypervolume` are the references it is tested against.

Numerics
--------
The GP math runs in float32 with the same operation sequence as
``gp._predict_padded`` / ``gp._append_rows``; acquisition scores are then
computed in float64, like the numpy path, which scores the float32
posterior in float64. Fronts are padded to multiples of ``FRONT_PAD`` with a
validity mask (dominated or masked points never change the staircase, so
fantasies are appended without re-filtering).

XLA on the CPU flushes subnormal results to zero and PyTorch keeps them.
Deep in a tail, EI's ``std * phi(z)`` is subnormal (z = -38 gives about
1e-321), so a round whose scores are all zero in the JAX package would pick
the one candidate with a subnormal score here instead of index 0. The
density and the scores are therefore flushed like XLA's (``_ftz``).
"""
from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch

from .gp import _JITTER, _NOISE_FLOOR, _cho_solve, matern52

FRONT_PAD = 16

_SQRT2 = math.sqrt(2.0)


def _ftz(x):
    """Subnormal values to zero, as XLA's flush-to-zero gives them."""
    return torch.where(x.abs() < torch.finfo(x.dtype).tiny, torch.zeros_like(x), x)


def _phi(z):
    return _ftz(torch.exp(-0.5 * z * z)) / math.sqrt(2.0 * math.pi)


def _Phi(z):
    return 0.5 * (1.0 + torch.special.erf(z / _SQRT2))


# ---------------------------------------------------------------------------
# hypervolume improvement (2-D staircase, fixed padded front)
# ---------------------------------------------------------------------------
def hvi_2d_torch(points, front, front_mask, ref):
    """Exclusive HVI of each point w.r.t. the masked ``front`` (2-D).

    Mirrors ``hypervolume.hvi_2d``; masked-out (and below-ref) front rows are
    pinned to ``ref`` where they form zero-width segments, so a padded front
    gives the unpadded numpy staircase's results.
    """
    valid = front_mask & (front > ref[None, :]).all(1)
    f1 = torch.where(valid, front[:, 0], ref[0])
    f2 = torch.where(valid, front[:, 1], ref[1])
    order = torch.sort(-f1, stable=True).indices  # f1 descending
    f1s, f2s = f1[order], f2[order]
    heights = torch.cummax(f2s, 0).values  # max f2 among points with f1 >= f1s[i]
    xs = torch.cat([ref[:1], f1s.flip(0)])  # ascending breakpoints
    a = torch.cat([xs[:-1], xs[-1:]])
    b = torch.cat([xs[1:], torch.full((1,), float("inf"), dtype=xs.dtype, device=xs.device)])
    h = torch.cat([heights.flip(0), ref[1:]])
    y1 = torch.maximum(points[:, 0], ref[0])[:, None]
    y2 = points[:, 1][:, None]
    overlap = torch.clamp_min(torch.minimum(y1, b[None, :]) - a[None, :], 0.0)
    gain = torch.clamp_min(y2 - torch.maximum(h, ref[1])[None, :], 0.0)
    hvi = (overlap * gain).sum(1)
    return torch.where((points > ref[None, :]).all(1), hvi, torch.zeros_like(hvi))


def ehvi_mc_torch(mean, std, front, front_mask, ref, eps):
    """MC-EHVI with externally supplied normal draws ``eps`` (S, c, 2): the
    host draws them from the tuner's generator, so the generator is consumed
    exactly as on the numpy path."""
    samples = mean[None] + std[None] * eps  # (S, c, 2)
    hvi = hvi_2d_torch(samples.reshape(-1, 2), front, front_mask, ref).reshape(eps.shape[0], -1)
    return hvi.mean(0)


def ei_torch(mean, std, best):
    """Closed-form expected improvement (maximization)."""
    std = torch.clamp_min(std, 1e-12)
    z = (mean - best) / std
    return (mean - best) * _Phi(z) + std * _phi(z)


def cei_torch(mean_spd, std_spd, mean_rec, std_rec, best_feasible: float, rlim: float):
    """Constrained EI (paper Eq. 7): EI(speed) * Pr(recall > rlim)."""
    p_feas = 1.0 - _Phi((rlim - mean_rec) / torch.clamp_min(std_rec, 1e-12))
    if not math.isfinite(best_feasible):
        return p_feas  # no feasible observation yet: chase feasibility only
    return ei_torch(mean_spd, std_spd, best_feasible) * p_feas


# ---------------------------------------------------------------------------
# sequential-greedy selection
# ---------------------------------------------------------------------------
def _posterior_stats(params, x, mask, chol, alpha, Xc):
    """(mean, var, v) over candidates — the operation sequence of
    ``gp._predict_padded`` (f32); ``v`` is reused for the rank-1 append."""
    ks = matern52(Xc, x, params.log_ls, params.log_sf) * mask[None, None, :]  # (m, c, n)
    mean = (ks @ alpha[..., None])[..., 0]  # (m, c)
    v = torch.linalg.solve_triangular(chol, ks.transpose(1, 2), upper=False)  # (m, n, c)
    sf2 = torch.exp(2.0 * params.log_sf)
    var = torch.clamp_min(sf2[:, None] - (v * v).sum(1), 1e-10)
    return mean, var, v


def _greedy(gp, Xc: np.ndarray, q: int,
            score_fn: Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor],
            update_fn: Callable[[torch.Tensor], None]) -> List[int]:
    """q picks: predict -> score -> masked argmax -> append the fantasy
    (rank-1, exact). ``score_fn(mean64, std64, j)`` returns f64 scores of
    the candidates for pick ``j``; ``update_fn(fantasy64)`` folds the pick's
    fantasy into the incumbent state."""
    g = gp.with_capacity(gp.n_real + q)  # pre-grown so all fantasies fit
    s = g.state
    p = s.params
    dev = s.x.device
    x, y, mask, chol, alpha = s.x.clone(), s.y.clone(), s.mask.clone(), s.chol.clone(), s.alpha
    y_mean = torch.tensor(s.y_mean, dtype=torch.float32, device=dev)
    y_std = torch.tensor(s.y_std, dtype=torch.float32, device=dev)
    Xc_t = torch.from_numpy(np.ascontiguousarray(Xc, np.float32)).to(dev)
    sf2 = torch.exp(2.0 * p.log_sf)
    row_noise = sf2 * (_NOISE_FLOOR + _JITTER) + torch.exp(2.0 * p.log_noise)  # (m,)
    zero = torch.zeros((1, x.shape[1]), dtype=x.dtype, device=dev)
    kself = matern52(zero, zero, p.log_ls, p.log_sf)[:, 0, 0]
    avail = torch.ones(Xc_t.shape[0], dtype=torch.bool, device=dev)
    picks: List[int] = []
    for j in range(q):
        mean_s, var, v = _posterior_stats(p, x, mask, chol, alpha, Xc_t)
        # destandardize in f32 exactly like GP.predict, then score in f64
        mean32 = mean_s.T * y_std[None, :] + y_mean[None, :]  # (c, m)
        std32 = torch.sqrt(var).T * y_std[None, :]
        mean64, std64 = mean32.double(), std32.double()
        acq = torch.where(avail, _ftz(score_fn(mean64, std64, j)),
                          torch.tensor(float("-inf"), dtype=torch.float64, device=dev))
        i = int(torch.argmax(acq))  # first maximum, as jnp.argmax
        picks.append(i)
        if j + 1 == q:
            break
        avail[i] = False
        update_fn(mean64[i])
        # Kriging-believer fantasy: standardize the f32 posterior mean like
        # condition_on does and append it as a bordered-Cholesky row (w = the
        # prediction solve's column i, so no second triangular solve)
        r = s.n_real + j
        w = v[:, :, i]  # (m, n_pad); 0 at rows >= r (inert pads)
        l_rr = torch.sqrt(torch.clamp_min(kself + row_noise - (w * w).sum(1), 1e-10))
        chol[:, r, :] = w
        chol[:, r, r] = l_rr
        x[r] = Xc_t[i]
        y[r] = (mean32[i] - y_mean) / y_std
        mask[r] = 1.0
        alpha = _cho_solve(chol, y.T)
    return picks


def _padded_front(front: np.ndarray, q: int):
    k0 = front.shape[0]
    k_pad = int(np.ceil((k0 + q) / FRONT_PAD) * FRONT_PAD)
    fp = np.zeros((k_pad, 2), np.float64)
    fm = np.zeros((k_pad,), bool)
    fp[:k0] = front
    fm[:k0] = True
    return fp, fm


def fused_qehvi_select(gp, Xc: np.ndarray, front: np.ndarray, ref: np.ndarray,
                       rng: np.random.Generator, q: int, n_samples: int = 64) -> List[int]:
    """Sequential-greedy q-EHVI on the GP's device. Argmax-equivalent to
    ``acquisition.qehvi_sequential_greedy`` and consumes the generator
    identically (q draws of (n_samples, c, 2) normals)."""
    q = min(int(q), Xc.shape[0])
    dev = gp.state.x.device
    eps = np.stack([rng.standard_normal((n_samples, Xc.shape[0], 2)) for _ in range(q)])
    eps_t = torch.from_numpy(eps).to(dev)
    front = np.asarray(front, np.float64).reshape(-1, 2)
    fp, fm = _padded_front(front, q)
    fr, fmask = torch.from_numpy(fp).to(dev), torch.from_numpy(fm).to(dev)
    ref_t = torch.from_numpy(np.asarray(ref, np.float64)).to(dev)
    n_added = [front.shape[0]]

    def score(mean64, std64, j):
        return ehvi_mc_torch(mean64, std64, fr, fmask, ref_t, eps_t[j])

    def update(fantasy64):
        fr[n_added[0]] = fantasy64
        fmask[n_added[0]] = True
        n_added[0] += 1

    return _greedy(gp, Xc, q, score, update)


def fused_cei_select(gp, Xc: np.ndarray, best_feasible: float, rlim_n: float,
                     q: int) -> List[int]:
    """Sequential-greedy constrained-EI batch selection on the GP's device."""
    q = min(int(q), Xc.shape[0])
    best = [float(best_feasible)]

    def score(mean64, std64, j):
        return cei_torch(mean64[:, 0], std64[:, 0], mean64[:, 1], std64[:, 1], best[0],
                         float(rlim_n))

    def update(fantasy64):
        spd, rec = (float(v) for v in fantasy64)
        if rec >= rlim_n:
            best[0] = max(best[0], spd)

    return _greedy(gp, Xc, q, score, update)
