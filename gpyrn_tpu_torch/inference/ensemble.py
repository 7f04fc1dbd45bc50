"""Affine-invariant ensemble MCMC over the hyperparameters, the ELBO as the
log-likelihood.

Port of :mod:`gpyrn_tpu.inference.ensemble`.  The reference samples with
emcee, one host-side ELBO fit per walker step.  Here the walker population
is the batch axis of the engine: every half-step fits the ELBO of all
proposal walkers in one :meth:`Engine.elbo_fit_batch` call on the device,
each warm-started from that walker's cached variational state.

The move is the Goodman & Weare (2010) stretch move with a = 2 (emcee's
algorithm); the convergence rule is the reference's autocorrelation
criterion (τ·100 < iteration and |Δτ|/τ < 1%, checked every
``check_every`` steps); checkpoints are compressed npz files with the JAX
package's keys, so a chain saved by either package loads in the other.

Two modes, as in the JAX package:

* the **host loop** (scipy priors, or ``device_chain=False``): numpy's
  ``default_rng(seed)`` draws on the host in the JAX package's order
  (initial walkers, then per half-step the stretch factors, the partners
  and, after the fit, the acceptance uniforms) and one batched fit per
  half-step runs on the device: given the same ELBOs, the JAX host loop's
  chain;
* the **device chain** (every prior from :mod:`.priors`): the draws come
  from a ``torch.Generator`` on the inference's device, the priors, the
  fits and the accept/reject updates stay there, and the chain comes to
  the host once per segment of ``check_every`` steps.

Proposals whose prior density is zero skip their fit: they cannot be
accepted, and no output reads their ELBO.

With ``mesh=`` (the device chain only; called by every rank of the mesh)
the fits of each batch of walkers are split over the mesh's ``dp`` axis
when the batch divides by it, and gathered: every rank draws the same
numbers from the same seeded generator and keeps the whole chain, so the
chain is the unsharded one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gpyrn_tpu_torch.parallel.mesh import dp_rows

__all__ = ["run_ensemble", "EnsembleResult", "autocorr_time",
           "init_walkers"]

_MESH_MESSAGE = ("mesh= requires the device chain (the port's traceable "
                 "priors); the host loop cannot shard walkers")


# --------------------------------------------------------------------------
# integrated autocorrelation time (FFT method, Goodman-Weare windowing)
# --------------------------------------------------------------------------

def _next_pow_two(n: int) -> int:
    i = 1
    while i < n:
        i = i << 1
    return i


def _autocorr_1d(x: np.ndarray) -> np.ndarray:
    x = np.atleast_1d(np.asarray(x, dtype=float))
    n = _next_pow_two(len(x))
    f = np.fft.fft(x - np.mean(x), n=2 * n)
    acf = np.fft.ifft(f * np.conjugate(f))[: len(x)].real
    if acf[0] == 0:
        return np.ones_like(acf)
    return acf / acf[0]


def autocorr_time(chain: np.ndarray, c: float = 5.0) -> np.ndarray:
    """Integrated autocorrelation time per parameter.

    chain: (n_steps, n_walkers, ndim).  Averages the per-walker
    autocorrelation functions, then applies the automated windowing
    τ(M) with M the smallest index such that M >= c·τ(M).
    """
    chain = np.asarray(chain, dtype=float)
    n_steps, n_walkers, ndim = chain.shape
    taus = np.empty(ndim)
    for k in range(ndim):
        acf = np.zeros(n_steps)
        for w in range(n_walkers):
            acf += _autocorr_1d(chain[:, w, k])
        acf /= n_walkers
        tau_cum = 2.0 * np.cumsum(acf) - 1.0
        window = np.arange(len(tau_cum)) >= c * tau_cum
        idx = np.argmax(window) if window.any() else len(tau_cum) - 1
        taus[k] = tau_cum[idx]
    return taus


def _autocorr_converged(chain, steps, old_tau):
    """(the reference's convergence rule, the new τ)."""
    tau = autocorr_time(chain)
    ok = np.all(tau * 100 < steps)
    ok &= np.all(np.abs(old_tau - tau) / tau < 0.01)
    return bool(ok), tau


# --------------------------------------------------------------------------
# result container
# --------------------------------------------------------------------------

@dataclass
class EnsembleResult:
    """Chain container with emcee-like accessors."""
    chain: np.ndarray            # (n_steps, n_walkers, ndim)
    log_prob: np.ndarray         # (n_steps, n_walkers)
    elbo: np.ndarray             # (n_steps, n_walkers)
    parameter_names: Sequence[str] = field(default_factory=list)
    converged: bool = False
    acceptance: float = float("nan")

    @property
    def iteration(self) -> int:
        return self.chain.shape[0]

    def get_chain(self, discard: int = 0, thin: int = 1, flat: bool = False):
        c = self.chain[discard::thin]
        if flat:
            return c.reshape(-1, c.shape[-1])
        return c

    def get_log_prob(self, discard: int = 0, thin: int = 1,
                     flat: bool = False):
        lp = self.log_prob[discard::thin]
        return lp.reshape(-1) if flat else lp

    def get_autocorr_time(self, discard: int = 0, c: float = 5.0):
        return autocorr_time(self.chain[discard:], c=c)

    def save(self, filename: str):
        np.savez_compressed(
            filename, chain=self.chain, log_prob=self.log_prob,
            elbo=self.elbo, converged=self.converged,
            acceptance=self.acceptance,
            parameter_names=np.array(list(self.parameter_names)))

    @classmethod
    def load(cls, filename: str) -> "EnsembleResult":
        import os
        if not os.path.exists(filename) and \
                os.path.exists(str(filename) + ".npz"):
            filename = str(filename) + ".npz"   # savez appends .npz
        z = np.load(filename, allow_pickle=False)
        return cls(chain=z["chain"], log_prob=z["log_prob"], elbo=z["elbo"],
                   parameter_names=[str(s) for s in z["parameter_names"]],
                   converged=bool(z["converged"]),
                   acceptance=float(z["acceptance"]))


# --------------------------------------------------------------------------
# the log-posterior of a walker batch
# --------------------------------------------------------------------------

def _prior_logpdf(priors: Dict, names, x: np.ndarray) -> np.ndarray:
    """Σ log p(θ) per walker on the host (scipy or :mod:`.priors`)."""
    lp = np.zeros(x.shape[0])
    for k, name in enumerate(names):
        lp += np.asarray(priors[name].logpdf(x[:, k]), dtype=float)
    return lp


def _traceable_priors(priors: Dict, names) -> bool:
    from gpyrn_tpu_torch.inference.priors import _Prior
    return all(isinstance(priors[n], _Prior) for n in names)


def _host_logprior(gprn, priors: Dict, names):
    """``logprior(x) -> (W,)``: the priors (scipy or :mod:`.priors`)
    evaluated on the host, the sum returned on the inference's device."""
    def logprior(x):
        return gprn._tensor(_prior_logpdf(priors, names, x.cpu().numpy()))
    return logprior


def _device_logprior(priors: Dict, names):
    """``logprior(x) -> (W,)``: the priors of :mod:`.priors` evaluated on
    ``x``'s device."""
    prior_list = [priors[n] for n in names]

    def logprior(x):
        return sum(pr.logpdf(x[:, k]) for k, pr in enumerate(prior_list))
    return logprior


def _theta_rows(gprn):
    """``rows(x)``: the full (W, n_par) parameter rows of the walkers ``x``
    (W, ndim) of free parameters, on the inference's device."""
    theta_full = gprn._theta()
    free_idx = torch.as_tensor(np.flatnonzero(~gprn.frozen_mask),
                               device=theta_full.device)

    def rows(x):
        theta = theta_full.expand(x.shape[0], -1).clone()
        theta[:, free_idx] = x
        return theta
    return rows


def _batch_fit(gprn, elbo_max_iter, mesh):
    """``fit(theta, mu, var) -> (elbo, mu, var, n_iter, converged)``: one
    :meth:`Engine.elbo_fit_batch` of the rows, split over the mesh's
    ``dp`` axis when there is one and the rows divide by it."""
    eng, data = gprn.engine, gprn._data()

    def fit_rows(theta, mu, var):
        return eng.elbo_fit_batch(theta, *data, mu, var, elbo_max_iter)

    def fit(theta, mu, var):
        return dp_rows(fit_rows, mesh, theta, mu, var)
    return fit


def _logpost(gprn, logprior, elbo_max_iter, mesh=None):
    """``logpost(x, mu, var, skip=True) -> (lp, elbo, mu, var, converged)``
    of the walkers ``x`` (W, ndim) from their states, tensors on the
    inference's device: ``logprior(x)`` plus the ELBO of one batched fit
    (:func:`_batch_fit`), a non-finite ELBO taken as −inf.  With ``skip``
    the walkers whose prior density is zero skip their fit (one host read
    of that mask): they keep their state and get a −inf ELBO,
    unconverged."""
    fit = _batch_fit(gprn, elbo_max_iter, mesh)
    theta_rows = _theta_rows(gprn)

    def logpost(x, mu, var, skip=True):
        lp_pri = logprior(x)
        theta = theta_rows(x)
        run = torch.isfinite(lp_pri).cpu().numpy() if skip else None
        if run is None or run.all():
            elbo, mu_o, var_o, _, conv = fit(theta, mu, var)
        else:
            elbo = torch.full((x.shape[0],), -math.inf, dtype=x.dtype,
                              device=x.device)
            mu_o, var_o = mu.clone(), var.clone()
            conv = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
            if run.any():
                rows = torch.as_tensor(np.flatnonzero(run), device=x.device)
                e, m, v, _, c = fit(theta[rows], mu[rows], var[rows])
                elbo[rows], mu_o[rows], var_o[rows], conv[rows] = e, m, v, c
        elbo = torch.where(torch.isfinite(elbo), elbo,
                           torch.full_like(elbo, -math.inf))
        lp = torch.where(torch.isfinite(lp_pri), lp_pri + elbo,
                         torch.full_like(elbo, -math.inf))
        return lp, elbo, mu_o, var_o, conv
    return logpost


def _half_step(logpost, x, lp, elbo, mu, var, S, C, z, partners, u, ndim):
    """One stretch-move half-step of the walkers ``S`` against the
    complementary set ``C`` (index tensors) with the draws ``z`` (stretch
    factors), ``partners`` (indices into ``C``) and ``u`` (acceptance
    uniforms).  ``logpost(prop, mu, var) -> (lp, elbo, mu, var,
    converged)``.  Returns the updated ``(x, lp, elbo, mu, var)`` and the
    number of accepted moves (a 0-d tensor)."""
    xS, xP = x[S], x[C][partners]
    prop = xP + z[:, None] * (xS - xP)
    lp_p, elbo_p, mu_p, var_p, conv_p = logpost(prop, mu[S], var[S])
    log_acc = (ndim - 1) * torch.log(z) + lp_p - lp[S]
    accept = torch.log(u) < log_acc
    upd = (accept & conv_p & torch.isfinite(lp_p))[:, None]
    x = x.index_copy(0, S, torch.where(accept[:, None], prop, xS))
    lp = lp.index_copy(0, S, torch.where(accept, lp_p, lp[S]))
    elbo = elbo.index_copy(0, S, torch.where(accept, elbo_p, elbo[S]))
    mu = mu.index_copy(0, S, torch.where(upd, mu_p, mu[S]))
    var = var.index_copy(0, S, torch.where(upd, var_p, var[S]))
    return x, lp, elbo, mu, var, accept.sum()


def _host_draws(rng, half, a, like):
    """``draws()``: one half-step's draws from numpy's ``rng`` in the JAX
    host loop's order (stretch factors, partners, acceptance uniforms; the
    uniforms do not depend on the fit, so drawing them before it keeps the
    order), as tensors like ``like``."""
    def draws():
        z = ((a - 1.0) * rng.random(half) + 1.0) ** 2 / a
        partners = rng.integers(0, half, size=half)
        u = rng.random(half)
        return (torch.as_tensor(z).to(like),
                torch.as_tensor(partners, device=like.device),
                torch.as_tensor(u).to(like))
    return draws


def _device_draws(gen, half, a, like):
    """``draws()``: one half-step's draws from the device generator
    ``gen``, in the host loop's order."""
    def draws():
        z = ((a - 1.0) * torch.rand(half, generator=gen, dtype=like.dtype,
                                    device=like.device) + 1.0) ** 2 / a
        partners = torch.randint(0, half, (half,), generator=gen,
                                 device=like.device)
        u = torch.rand(half, generator=gen, dtype=like.dtype,
                       device=like.device)
        return z, partners, u
    return draws


def _crossed(steps: int, k: int, every: int) -> bool:
    """The last ``k`` of ``steps`` steps passed a multiple of ``every``."""
    return steps // every > (steps - k) // every


# --------------------------------------------------------------------------
# sampler
# --------------------------------------------------------------------------

def _run_chain(logpost, x, mu, var, niter, draws, seg_len, check,
               free_names, checkpoint, progress) -> "EnsembleResult":
    """The chain of both modes, its state on the inference's device: the
    walkers' initial fits and warm-start caches, then segments of
    ``seg_len`` steps, ``draws()`` giving each half-step's draws.  Each
    segment's walkers, log-probs, ELBOs and accepted count come to the
    host in one transfer; then the progress line (every 10 steps), the
    checkpoint (every 50) and, after the segments where ``check(steps)``
    holds, the reference's autocorrelation rule."""
    nwalkers, ndim = x.shape
    half = nwalkers // 2
    dev, dtype = x.device, x.dtype
    lp, elbo, mu_n, var_n, conv = logpost(x, mu, var, skip=False)
    upd = (conv & torch.isfinite(lp))[:, None]
    mu = torch.where(upd, mu_n, mu)
    var = torch.where(upd, var_n, var)

    sets = (torch.arange(half, device=dev),
            torch.arange(half, nwalkers, device=dev))
    chain_parts, lp_parts, elbo_parts = [], [], []
    n_accept = 0
    old_tau = np.inf
    converged = False
    steps_done = 0
    while steps_done < niter:
        # the final partial segment runs exactly the remaining steps
        k = min(seg_len, niter - steps_done)
        rows, accepted = [], torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(k):
            for s in (0, 1):
                x, lp, elbo, mu, var, acc = _half_step(
                    logpost, x, lp, elbo, mu, var, sets[s], sets[1 - s],
                    *draws(), ndim)
                accepted = accepted + acc
            rows.append(torch.cat([x.reshape(-1), lp, elbo]))
        seg = torch.cat([torch.stack(rows).reshape(-1),
                         accepted.to(dtype).reshape(1)]).cpu().numpy()
        n_accept += int(seg[-1])
        seg = seg[:-1].reshape(k, nwalkers * (ndim + 2))
        chain_parts.append(seg[:, :nwalkers * ndim].reshape(k, nwalkers,
                                                            ndim))
        lp_parts.append(seg[:, nwalkers * ndim:-nwalkers])
        elbo_parts.append(seg[:, -nwalkers:])
        steps_done += k
        if progress and _crossed(steps_done, k, 10):
            print(f'step {steps_done}/{niter}  max logp='
                  f'{lp_parts[-1][-1].max():.2f}', flush=True)
        chain = np.concatenate(chain_parts)
        if checkpoint is not None and _crossed(steps_done, k, 50):
            EnsembleResult(chain, np.concatenate(lp_parts),
                           np.concatenate(elbo_parts), free_names, False,
                           n_accept / (steps_done * nwalkers)
                           ).save(checkpoint)
        if check(steps_done):
            ok, tau = _autocorr_converged(chain, steps_done, old_tau)
            if ok:
                converged = True
                break
            old_tau = tau

    chain = np.concatenate(chain_parts)
    acc = n_accept / (chain.shape[0] * nwalkers)
    result = EnsembleResult(chain, np.concatenate(lp_parts),
                            np.concatenate(elbo_parts), free_names,
                            converged, acc)
    if checkpoint is not None:
        result.save(checkpoint)
    return result


def init_walkers(p0, priors: Dict, free_names, nwalkers: int, rng):
    """Initial walker positions, reference semantics.

    ``p0=None``: every walker drawn from the priors.  1-D ``p0``:
    emcee's ``sample_ellipsoid(p0, diag(sigma)/100)``, a Gaussian
    ellipsoid centred on ``p0`` whose covariance is ``diag(sigma)/100``
    (per-coordinate stddev ``sqrt(sigma_i/100)``, sigma_i the prior
    stddev), with outside-prior-support draws replaced by prior samples.
    2-D ``p0``: used as-is, one row per walker."""
    if p0 is None:
        return np.array([[priors[n].rvs() for n in free_names]
                         for _ in range(nwalkers)])
    p0 = np.asarray(p0, dtype=float)
    if p0.ndim != 1:
        return p0.copy()
    ndim = p0.shape[0]
    sigma = []
    for name in free_names:
        try:
            sigma.append(priors[name].std())
        except TypeError:
            sigma.append(priors[name].std)
    sigma = np.array(sigma, dtype=float)
    # heavy-tailed priors have infinite std: fall back to a 10% ball.
    # sigma is a variance scaled by 1/100 below, so the fallback stddev
    # 0.1·|p0|+1e-3 is stored as 100·stddev² for sqrt(sigma/100) to come
    # out at the intended 10% of |p0|
    bad_sig = ~np.isfinite(sigma)
    sigma[bad_sig] = 100.0 * (np.abs(p0[bad_sig]) * 0.1 + 1e-3) ** 2
    x = p0[None, :] + rng.standard_normal((nwalkers, ndim)) * \
        np.sqrt(sigma[None, :] / 100.0)
    bad = ~np.isfinite(_prior_logpdf(priors, free_names, x))
    for i in np.where(bad)[0]:
        x[i] = [priors[n].rvs() for n in free_names]
    return x


def run_ensemble(gprn, priors: Dict, free_names, p0=None, niter: int = 500,
                 nwalkers: Optional[int] = None, elbo_max_iter: int = 100,
                 a: float = 2.0, seed: int = 0, check_every: int = 10,
                 checkpoint: Optional[str] = None,
                 progress: bool = False,
                 device_chain: Optional[bool] = None,
                 mesh=None) -> EnsembleResult:
    """Run the native ensemble sampler on a port ``inference`` object.

    The device chain runs by default whenever every prior comes from
    :mod:`gpyrn_tpu_torch.inference.priors`; scipy priors, or
    ``device_chain=False``, run the host loop (see the module docstring).
    Both implement the Goodman-Weare stretch move and the reference's
    autocorrelation stopping rule.  ``mesh`` (a
    :func:`gpyrn_tpu_torch.parallel.make_mesh` mesh, the call made by
    every rank): the walkers' fits split over its ``dp`` axis (see the
    module docstring); the device chain only, and the checkpoint and the
    progress lines come from global rank 0 alone."""
    free_names = list(free_names)
    ndim = len(free_names)
    n_free = int(np.count_nonzero(~gprn.frozen_mask))
    if n_free != ndim:
        raise ValueError(
            f"free_names has {ndim} entries but the model has {n_free} "
            "unfrozen parameters — freeze/thaw so they match (mcmc's "
            "vars= does this automatically)")
    if nwalkers is None:
        nwalkers = 2 * ndim
    if nwalkers % 2:
        nwalkers += 1
    rng = np.random.default_rng(seed)
    x = gprn._tensor(init_walkers(p0, priors, free_names, nwalkers, rng))
    mu, var = gprn.engine.init_mu_var(_theta_rows(gprn)(x),
                                      gprn._tensor(gprn.y))
    half = nwalkers // 2
    use_device = device_chain if device_chain is not None else \
        _traceable_priors(priors, free_names)
    if mesh is not None:
        if not use_device:
            raise ValueError(_MESH_MESSAGE)
        if dist.get_rank() != 0:
            checkpoint, progress = None, False
    if use_device:
        # a device generator, segments of check_every steps, the JAX
        # device chain's rule: a check after every segment past the first
        gen = torch.Generator(device=x.device)
        gen.manual_seed(int(seed))
        logprior = _device_logprior(priors, free_names)
        draws = _device_draws(gen, half, a, x)
        seg_len = check_every

        def check(steps):
            return steps > check_every
    else:
        # numpy's draws, step by step, the JAX host loop's rule: a check
        # every check_every steps from the third on
        logprior = _host_logprior(gprn, priors, free_names)
        draws = _host_draws(rng, half, a, x)
        seg_len = 1

        def check(steps):
            return steps % check_every == 0 and steps > 2
    return _run_chain(_logpost(gprn, logprior, elbo_max_iter, mesh), x, mu,
                      var, niter, draws, seg_len, check, free_names,
                      checkpoint, progress)
