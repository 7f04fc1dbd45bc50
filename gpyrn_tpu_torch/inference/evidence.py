"""Bayesian evidence (marginal-likelihood) estimators.

Port of :mod:`gpyrn_tpu.inference.evidence`: the port keeps its own copy
of the estimators, which are numpy and scipy code on the host: the
Perrakis et al. (2014) importance estimator, the harmonic-mean estimator
(Kass & Raftery 1995) and the Chib & Jeliazkov (2001) estimator, with a
numerically stable ``logsumexp`` and the CJ posterior-ordinate numerator
``log q(θ_s)`` (the reference module, adapted from exord/bayev, was never
importable; the JAX package's docstring lists what it repaired).

The likelihood in all estimators is a callable over parameter batches;
for GPRN model comparison pass the batched ELBO surrogate,
``lambda thetas: batch_elbo(gprn, thetas)``, which fits every θ of the
batch in one pass of :meth:`Engine.elbo_fit_batch` on the inference's
device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import stats as _st

__all__ = [
    "compute_perrakis_estimate", "compute_harmonicmean", "run_hme_mc",
    "compute_cj_estimate", "estimate_density", "make_marginal_samples",
    "log_sum", "metropolis_ratio", "get_fixed_point",
    "MultivariateGaussian", "batch_elbo",
]


def log_sum(log_summands):
    """log Σ exp(xᵢ), numerically stable (scipy's logsumexp; the
    reference shuffled until finite)."""
    x = np.asarray(log_summands, dtype=float)
    if x.size == 0:
        return -np.inf
    from scipy.special import logsumexp
    return float(logsumexp(x))


class MultivariateGaussian:
    """Multivariate normal with ``pdf``/``logpdf``/``rvs`` — the proposal
    object the reference referenced but never defined (evidence.py:309)."""

    def __init__(self, mean, cov, rng=None):
        self.mean = np.atleast_1d(np.asarray(mean, dtype=float))
        cov = np.asarray(cov, dtype=float)
        if cov.ndim == 0:
            cov = cov[None, None]
        self.cov = cov
        self._dist = _st.multivariate_normal(self.mean, self.cov,
                                             allow_singular=True)
        self._rng = rng

    def pdf(self, x):
        return self._dist.pdf(np.asarray(x))

    def logpdf(self, x):
        return self._dist.logpdf(np.asarray(x))

    def rvs(self, size=1):
        out = np.asarray(self._dist.rvs(size=size, random_state=self._rng))
        # scipy returns (size,) for 1-D spaces and (k,) for size=1:
        # normalize to (size, k) so downstream batch evaluation is uniform
        return out.reshape(size, self.mean.size)


def estimate_density(x, method: str = "histogram", **kwargs):
    """Density of a 1-D sample evaluated at the sample points.

    Methods (reference evidence.py:128-158): 'histogram' (default,
    ``nbins`` bins), 'kde' (gaussian KDE), 'normal' (moment-matched
    normal)."""
    x = np.asarray(x, dtype=float)
    nbins = kwargs.pop("nbins", 100)
    if method == "normal":
        return _st.norm.pdf(x, loc=x.mean(), scale=np.sqrt(x.var()))
    if method == "kde":
        return _st.gaussian_kde(x)(x)
    if method == "histogram":
        density, bin_edges = np.histogram(x, nbins, density=True)
        idx = np.searchsorted(bin_edges, x, side="left")
        idx = np.where(idx > 0, idx, idx + 1)
        return density[idx - 1]
    raise ValueError(f"unknown density estimation method {method!r}")


def make_marginal_samples(joint_samples, nsamples: Optional[int] = None,
                          rng=None):
    """Per-column reshuffle of joint posterior samples → samples from the
    product of marginals (reference evidence.py:161-180)."""
    joint_samples = np.asarray(joint_samples)
    if nsamples is None or nsamples > len(joint_samples):
        nsamples = len(joint_samples)
    rng = np.random.default_rng() if rng is None else rng
    marginal = joint_samples[-nsamples:, :].copy()
    for k in range(marginal.shape[1]):
        rng.shuffle(marginal[:, k])
    return marginal


def compute_perrakis_estimate(marginal_sample, lnlikefunc, lnpriorfunc,
                              nsamples: int = 1000, lnlikeargs=(),
                              lnpriorargs=(),
                              densityestimation: str = "histogram",
                              errorestimation: bool = False, rng=None,
                              **kwargs):
    """Perrakis et al. (2014; arXiv:1311.0674) evidence estimate from
    joint posterior samples (reference evidence.py:11-88).

    ``lnlikefunc``/``lnpriorfunc`` map an (n, k) parameter batch to (n,)
    log-densities.  With ``errorestimation=True`` returns
    ``(logZ, std)`` from K=10 batch re-estimates."""
    rng = np.random.default_rng() if rng is None else rng
    initial_sample = np.asarray(marginal_sample, dtype=float)
    sample = make_marginal_samples(initial_sample, nsamples, rng=rng)

    dens = np.empty_like(sample)
    for k in range(sample.shape[1]):
        dens[:, k] = estimate_density(sample[:, k],
                                      method=densityestimation, **kwargs)
    log_prod_dens = np.sum(np.log(dens), axis=1)
    log_prior = np.asarray(lnpriorfunc(sample, *lnpriorargs))
    log_like = np.asarray(lnlikefunc(sample, *lnlikeargs))
    cond = (log_like != 0) & np.isfinite(log_prod_dens) \
        & np.isfinite(log_like) & np.isfinite(log_prior)
    log_summands = log_like[cond] + log_prior[cond] - log_prod_dens[cond]
    if len(log_summands) == 0:
        raise ValueError("no valid Perrakis summands: likelihood/prior/"
                         "density non-finite on every marginal sample")
    perr = log_sum(log_summands) - np.log(len(log_summands))

    if errorestimation:
        K = 10
        batch = len(initial_sample) // K
        if batch < 2:
            return perr, np.nan
        estimates = []
        for i in range(K):
            sub = initial_sample[i * batch:(i + 1) * batch, :]
            estimates.append(compute_perrakis_estimate(
                sub, lnlikefunc, lnpriorfunc, nsamples=nsamples,
                lnlikeargs=lnlikeargs, lnpriorargs=lnpriorargs,
                densityestimation=densityestimation, rng=rng, **kwargs))
        return perr, float(np.std(estimates))
    return perr


def compute_harmonicmean(lnlike_post=(), posterior_sample=None,
                         lnlikefunc=None, lnlikeargs=(), rng=None, **kwargs):
    """Harmonic-mean evidence estimate (Kass & Raftery 1995; reference
    evidence.py:193-236)."""
    rng = np.random.default_rng() if rng is None else rng
    lnlike_post = np.asarray(lnlike_post, dtype=float)
    if lnlike_post.size == 0 and posterior_sample is not None:
        posterior_sample = np.asarray(posterior_sample)
        size = kwargs.pop("size", len(posterior_sample))
        if size < len(posterior_sample):
            idx = rng.choice(len(posterior_sample), size=size, replace=False)
            posterior_sample = posterior_sample[idx]
        log_like = np.asarray(lnlikefunc(posterior_sample, *lnlikeargs))
    else:
        size = kwargs.pop("size", lnlike_post.size)
        if size < lnlike_post.size:
            log_like = rng.choice(lnlike_post, size=size, replace=False)
        else:
            log_like = lnlike_post
    return -log_sum(-log_like) + np.log(len(log_like))


def run_hme_mc(log_likelihood, nmc: int, samplesize: int, rng=None):
    """Monte-Carlo repetitions of the harmonic-mean estimate (reference
    evidence.py:239-244)."""
    rng = np.random.default_rng() if rng is None else rng
    return np.array([compute_harmonicmean(log_likelihood, size=samplesize,
                                          rng=rng) for _ in range(nmc)])


def metropolis_ratio(lnpost0, lnpost1):
    """min(lnpost1 - lnpost0, 0) (reference evidence.py:352-365)."""
    a0, a1 = np.asarray(lnpost0), np.asarray(lnpost1)
    if a0.ndim and a1.ndim and a0.shape != a1.shape:
        raise ValueError("lnpost0 and lnpost1 have different lengths.")
    return np.minimum(a1 - a0, 0.0)


def get_fixed_point(posterior_samples, param_post, lnlike, lnprior,
                    lnlikeargs=(), lnpriorargs=()):
    """Posterior point nearest the median of ``param_post`` and its
    log(prior × likelihood) (reference evidence.py:368-424)."""
    posterior_samples = np.asarray(posterior_samples)
    if param_post is None:
        raise NotImplementedError(
            "automatic fixed-point selection requires param_post")
    param_post = np.asarray(param_post)
    ind0 = int(np.argmin(np.abs(param_post - np.median(param_post))))
    fixed_point = posterior_samples[ind0, :]
    if hasattr(lnlike, "__iter__"):
        lnlike = np.asarray(lnlike)
        if len(lnlike) != len(posterior_samples):
            raise IndexError("lnlike array length must match posterior")
        lnlike0 = lnlike[ind0]
    else:
        lnlike0 = float(np.asarray(
            lnlike(fixed_point[None, :], *lnlikeargs)).ravel()[0])
    if hasattr(lnprior, "__iter__"):
        lnprior = np.asarray(lnprior)
        if len(lnprior) != len(posterior_samples):
            raise IndexError("lnprior array length must match posterior")
        lnprior0 = lnprior[ind0]
    else:
        lnprior0 = float(np.asarray(
            lnprior(fixed_point[None, :], *lnpriorargs)).ravel()[0])
    return fixed_point, lnlike0 + lnprior0


def compute_cj_estimate(posterior_sample, lnlikefunc, lnpriorfunc,
                        param_post, nsamples: int, qprob=None, lnlikeargs=(),
                        lnpriorargs=(), lnlike_post=None, lnprior_post=None,
                        rng=None):
    """Chib & Jeliazkov (2001) evidence estimate (reference
    evidence.py:247-349, with the :345 density/log-density defect fixed)."""
    rng = np.random.default_rng() if rng is None else rng
    posterior_sample = np.asarray(posterior_sample, dtype=float)

    fp, lnpost0 = get_fixed_point(
        posterior_sample, param_post,
        lnlike_post if lnlike_post is not None else lnlikefunc,
        lnprior_post if lnprior_post is not None else lnpriorfunc,
        lnlikeargs=lnlikeargs, lnpriorargs=lnpriorargs)

    if qprob is None:
        k = np.cov(posterior_sample.T)
        qprob = MultivariateGaussian(fp, k, rng=rng)
    else:
        for method in ("pdf", "rvs"):
            att = getattr(qprob, method, None)
            if att is None:
                raise AttributeError(f"qprob does not have method {method!r}")
            if not callable(att):
                raise TypeError(f"{method} method of qprob is not callable")

    log_q_post = np.log(np.asarray(qprob.pdf(posterior_sample)))
    if lnlike_post is None:
        lnlike_post = np.asarray(lnlikefunc(posterior_sample, *lnlikeargs))
    if lnprior_post is None:
        lnprior_post = np.asarray(lnpriorfunc(posterior_sample, *lnpriorargs))

    lnalpha_post = metropolis_ratio(lnprior_post + lnlike_post, lnpost0)

    proposal_sample = np.atleast_2d(qprob.rvs(nsamples))
    lnprior_prop = np.asarray(lnpriorfunc(proposal_sample, *lnpriorargs))
    if np.all(lnprior_prop == -np.inf):
        raise ValueError("All samples from proposal density have zero prior "
                         "probability. Increase nsamples.")
    lnlike_prop = np.full_like(lnprior_prop, -np.inf)
    ind = lnprior_prop != -np.inf
    lnlike_prop[ind] = np.asarray(
        lnlikefunc(proposal_sample[ind, :], *lnlikeargs))
    lnalpha_prop = metropolis_ratio(lnpost0, lnprior_prop + lnlike_prop)

    num = log_sum(lnalpha_post + log_q_post) - np.log(len(posterior_sample))
    den = log_sum(lnalpha_prop) - np.log(len(proposal_sample))
    return lnpost0 - (num - den)


# ---------------------------------------------------------------------------
# GPRN bridge: batched ELBO surrogate likelihood
# ---------------------------------------------------------------------------

def batch_elbo(gprn, thetas, max_iter: int = 100, mesh=None):
    """ELBO surrogate log-likelihood for a batch of full hyperparameter
    vectors (the estimators' ``lnlikefunc``), as a numpy array: every row
    fitted from the heuristic start under the reference rule, at most
    ``max_iter`` sweeps, in one :meth:`Engine.elbo_fit_batch` call on the
    inference's device.  Frozen parameters in ``thetas`` columns are taken
    as given; pass full-width vectors.  ``mesh`` (the batch sharded over
    several devices) is not ported and raises."""
    if mesh is not None:
        raise NotImplementedError("mesh= (the batch sharded over a device "
                                  "mesh) is not ported yet: ROADMAP A15")
    eng = gprn.engine
    thetas = gprn._tensor(np.atleast_2d(np.asarray(thetas, dtype=float)))
    mu0, var0 = eng.init_mu_var(thetas, gprn._tensor(gprn.y))
    elbo, *_ = eng.elbo_fit_batch(thetas, *gprn._data(), mu0, var0,
                                  int(max_iter))
    return elbo.cpu().numpy()
