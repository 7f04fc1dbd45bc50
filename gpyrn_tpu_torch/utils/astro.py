"""Astronomy and statistics utilities on torch tensors.

Port of :mod:`gpyrn_tpu.utils.astro`: Keplerian radial-velocity curves,
phase folding, prior-building helpers, weighted RMS and a Cholesky
multivariate-normal log-density.  What the JAX module computes on numpy
stays on numpy here; what it computes on ``jax.numpy`` runs on torch.

The Keplerian solver is the JAX package's fixed-count Newton refinement
written as a plain loop over tensors, so autograd differentiates through
all of its steps, as ``jax.grad`` does through ``lax.fori_loop``; its
parameters may be 0-d tensors that carry a gradient, or tensors of any
shape that broadcasts against ``t`` (the θ-batched mean values evaluate
every row at once with parameters of shape (rows, 1)).
"""
from __future__ import annotations

import math
from functools import wraps
from typing import Union

import numpy as np
import torch

__all__ = [
    "Array", "semi_amplitude", "keplerian", "keplerian_rv",
    "phase_folding", "truncCauchy_rvs", "invGamma", "log_sum",
    "multivariate_normal", "rms", "wrms", "anderson_darling_test",
    "_array_input",
]

# type alias for annotations
Array = Union[np.ndarray, torch.Tensor]


def _array_input(f):
    """Decorator giving ``__call__``-style methods a 1-d array input."""
    @wraps(f)
    def wrapped(self, t):
        return f(self, np.atleast_1d(t))
    return wrapped


def semi_amplitude(period, Mplanet, Mstar, ecc):
    """RV semi-amplitude K [m/s] for a planet of mass ``Mplanet`` [M_Jup]
    with ``period`` [yr] around a star of ``Mstar`` [M_Sun] and
    eccentricity ``ecc``."""
    per = np.power(1 / period, 1 / 3)
    Pmass = Mplanet / 1
    Smass = np.power(1 / Mstar, 2 / 3)
    Ecc = 1 / np.sqrt(1 - ecc ** 2)
    return 28.435 * per * Pmass * Smass * Ecc


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def _cos(x):
    return torch.cos(x) if isinstance(x, torch.Tensor) else math.cos(x)


def keplerian_rv(t, P=365.0, K=0.1, e=0.0, w=math.pi, T=0.0, phi=None,
                 gamma=0.0, n_iter=100):
    """Radial-velocity curve of a Keplerian orbit at times ``t``.

    Solves Kepler's equation E − e sin E = M by ``n_iter`` Newton steps
    from the starter E0 = M + e sin M + e²/2 sin 2M, then
    ν = 2 atan(√((1+e)/(1−e)) tan(E/2)) and γ + K (e cos w + cos(w + ν)),
    the JAX package's formula step for step.  ``t`` is a tensor (the
    result is on its device, in its dtype) or an array (float64 on the
    CPU); the parameters are numbers or tensors that broadcast against
    it."""
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t, dtype=float))
    t = torch.atleast_1d(t)
    if phi is not None:
        T = t[0] - (P * phi) / (2.0 * math.pi)
    M = 2 * math.pi * (t - T) / P
    E = M + e * torch.sin(M) + 0.5 * e ** 2 * torch.sin(2 * M)
    for _ in range(n_iter):
        E = E + (M - (E - e * torch.sin(E))) / (1 - e * torch.cos(E))
    nu = 2 * torch.arctan(_sqrt((1 + e) / (1 - e)) * torch.tan(E / 2))
    return gamma + K * (e * _cos(w) + torch.cos(w + nu))


def keplerian(P=365, K=0.1, e=0, w=np.pi, T=0, phi=None, gamma=0, t=None):
    """Returns ``(t, RV)``, the curve as a numpy array."""
    if t is None:
        raise ValueError("keplerian() requires a time array t")
    rv = keplerian_rv(t, P=P, K=K, e=e, w=w, T=T, phi=phi, gamma=gamma)
    return t, rv.detach().cpu().numpy()


def phase_folding(t, y, yerr, period):
    """Phase-fold data on a period; returns (phase, folded_y, folded_yerr)
    sorted by phase."""
    foldtimes = np.asarray(t) / period
    foldtimes = foldtimes % 1
    if yerr is None:
        yerr = 0 * np.asarray(y)
    phase, folded_y, folded_yerr = zip(*sorted(zip(foldtimes, y, yerr)))
    return phase, folded_y, folded_yerr


def truncCauchy_rvs(loc=0, scale=1, a=-1, b=1, size=None, rng=None):
    """Samples from a Cauchy truncated to [a, b]."""
    rng = np.random.default_rng() if rng is None else rng
    ua = np.arctan((a - loc) / scale) / np.pi + 0.5
    ub = np.arctan((b - loc) / scale) / np.pi + 0.5
    U = rng.uniform(ua, ub, size=size)
    return loc + scale * np.tan(np.pi * (U - 0.5))


def invGamma(lower, upper, x0=(1, 5), showit=False):
    """Inverse-gamma distribution with ~98% of its mass in [lower, upper]
    — a prior-building helper."""
    from scipy.stats import invgamma
    from scipy.optimize import minimize

    def loss(x, lims):
        d = invgamma(a=x[0], scale=x[1])
        return float(np.sum(np.array([d.cdf(lims[0]) - 0.01,
                                      d.sf(lims[1]) - 0.01]) ** 2))

    result = minimize(loss, x0=list(x0), args=([lower, upper],),
                      method="L-BFGS-B", bounds=[(0, None), (0, None)],
                      tol=1e-10)
    a, b = result.x
    if showit:  # pragma: no cover - plotting
        import matplotlib.pyplot as plt
        _, ax = plt.subplots(1, 1, constrained_layout=True)
        d = invgamma(a=a, scale=b)
        x = np.linspace(0.2 * lower, 2 * upper, 1000)
        ax.plot(x, d.pdf(x))
        ax.vlines([lower, upper], 0, d.pdf(x).max())
        plt.show()
    return invgamma(a=a, scale=b)


def _as_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=float))


def log_sum(log_summands):
    """Numerically stable log of a sum of exponentials."""
    return float(torch_logsumexp(_as_tensor(log_summands)))


def torch_logsumexp(x):
    """log Σ exp(x) over all of ``x``."""
    return torch.logsumexp(x.reshape(-1), dim=0)


def multivariate_normal(r, c, method="cholesky"):
    """Multivariate-normal log-density of residual vector ``r`` with
    covariance ``c``."""
    r = _as_tensor(r)
    c = _as_tensor(c)
    kk = r.shape[0] * math.log(2 * math.pi)
    if method == "cholesky":
        L = torch.linalg.cholesky(c)
        alpha = torch_cho_solve(L, r)
        return float(-0.5 * (kk + r @ alpha +
                             2 * torch.sum(torch.log(torch.diagonal(L)))))
    if method == "solve":
        _, d = torch.linalg.slogdet(c)
        alpha = torch.linalg.solve(c, r)
        return float(-0.5 * (kk + r @ alpha + d))
    raise ValueError(f"unknown method {method!r}")


def torch_cho_solve(L, b):
    """Solve (L Lᵀ) x = b for a lower factor ``L`` and a vector or matrix
    ``b``."""
    if b.ndim == 1:
        return torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.cholesky_solve(b, L)


def rms(array):
    """Root mean square about the mean."""
    array = np.asarray(array)
    mu = np.average(array)
    return np.sqrt(np.sum((array - mu) ** 2) / array.size)


def wrms(array, weights):
    """Weighted RMS about the weighted mean, weights = 1/err²."""
    array = np.asarray(array)
    weights = np.asarray(weights)
    mu = np.average(array, weights=weights)
    return np.sqrt(np.sum(weights * (array - mu) ** 2) / np.sum(weights))


def anderson_darling_test(r):
    """Anderson-Darling normality test with a compact label.

    scipy ≥ 1.17 deprecates the critical-value attributes in favour of
    a ``method`` argument returning a p-value; both result shapes are
    handled."""
    import warnings
    from scipy.stats import anderson
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        result = anderson(r)
    if hasattr(result, "significance_level"):
        s = result.significance_level[
            result.statistic > result.critical_values]
        if s.size == 0:
            return result, f"A-D: {result.significance_level[-1]:.0f}%"
        return result, f"A-D: {s.max():.0f}%"
    return result, f"A-D p: {result.pvalue:.2f}"  # pragma: no cover
