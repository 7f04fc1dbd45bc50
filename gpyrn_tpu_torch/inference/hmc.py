"""Hamiltonian Monte Carlo over GPRN hyperparameters, on the device.

Port of :mod:`gpyrn_tpu.inference.hmc`.  Sampling happens in log-space
z = log θ (every GPRN hyperparameter is positive), with the Jacobian Σz
folded into the target density.  The chains are the batch axis of the
engine: every gradient of the log-posterior is one autograd pass through
``Engine.elbo_fixed_batch`` over the chains still moving, so the
leapfrog's ELBO fits and B1′'s backward run once for all of them.

* ``algorithm='hmc'``: fixed ``n_leapfrog`` trajectories, n_leapfrog + 1
  gradient calls per step, Metropolis accept with the JAX package's two
  guards (a non-finite proposal is rejected; an invalid current state
  accepts any finite proposal).
* ``algorithm='nuts'``: the multinomial no-U-turn transition with the
  iterative tree and its checkpoint stack, batched over chains as the
  JAX package's ``vmap`` of ``while_loop`` runs it: the depth and the
  leaf index are shared, each chain stops on its own turning or
  divergence flag, and a chain that has stopped keeps its state and gets
  no further gradient call.  One deliberate deviation: a leaf whose
  energy error is NaN (an ELBO that is not finite) counts as infinitely
  divergent, as in Stan, so it adds 0 to the acceptance statistic; the
  JAX package adds NaN, and its dual averaging then makes the step size
  NaN.

Warmup is dual averaging of the step size in two phases around a mass
matrix estimated from phase 1's second half ('diag', 'dense' or
'identity'), as in the JAX package; the dual averaging and the mass
estimate run on the host, the chains on the device.

Draws.  ``jax.random`` cannot be reproduced in torch, so every random
quantity of a step comes through one small interface (``momentum``,
``accept``, ``direction``, ``across``, ``leaf``).  The default source is
a ``torch.Generator`` on the inference's device (:class:`DeviceDraws`);
:class:`GivenDraws` takes arrays, segment by segment, and serves them in
the order the sampler consumes them: fed the draws of the JAX package's
key tree it gives the JAX chain.
"""
from __future__ import annotations

import math
import os
import warnings
from dataclasses import dataclass, field
from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ["run_hmc", "HMCResult", "DeviceDraws", "GivenDraws"]

# a leaf whose energy error exceeds this ends its trajectory as divergent
_DIVERGENCE = 1000.0


@dataclass
class HMCResult:
    chain: np.ndarray           # (n_samples, n_chains, ndim) in θ-space
    log_prob: np.ndarray        # (n_samples, n_chains)
    acceptance: float
    step_size: float
    parameter_names: Sequence[str] = field(default_factory=list)

    def get_chain(self, discard: int = 0, thin: int = 1,
                  flat: bool = False):
        c = self.chain[discard::thin]
        return c.reshape(-1, c.shape[-1]) if flat else c

    def save(self, filename):
        np.savez_compressed(
            filename, chain=self.chain, log_prob=self.log_prob,
            acceptance=self.acceptance, step_size=self.step_size,
            parameter_names=np.array(list(self.parameter_names)))

    @classmethod
    def load(cls, filename) -> "HMCResult":
        if not os.path.exists(filename) and \
                os.path.exists(str(filename) + ".npz"):
            filename = str(filename) + ".npz"   # savez appends .npz
        z = np.load(filename, allow_pickle=False)
        return cls(chain=z["chain"], log_prob=z["log_prob"],
                   acceptance=float(z["acceptance"]),
                   step_size=float(z["step_size"]),
                   parameter_names=[str(s) for s in z["parameter_names"]])


# --------------------------------------------------------------------------
# draws
# --------------------------------------------------------------------------

class _GeneratorStep:
    """One step's draws from a generator, made when asked for."""

    def __init__(self, gen, like):
        self._gen, self._like = gen, like

    def _uniform(self):
        like = self._like
        return torch.rand(like.shape[0], generator=self._gen,
                          dtype=like.dtype, device=like.device)

    def momentum(self):
        like = self._like
        return torch.randn(like.shape, generator=self._gen, dtype=like.dtype,
                           device=like.device)

    def accept(self):
        return self._uniform()

    def direction(self, depth):
        return self._uniform() < 0.5

    def across(self, depth):
        return self._uniform()

    def leaf(self, depth, i):
        return self._uniform()


class DeviceDraws:
    """Every draw from a ``torch.Generator`` on the chains' device, seeded
    with ``seed``."""

    def __init__(self, seed):
        self.seed = int(seed)
        self._gen = None

    def segment(self, n_steps, like):
        """The draws of ``n_steps`` steps of chains shaped like ``like``
        (n_chains, ndim)."""
        if self._gen is None:
            self._gen = torch.Generator(device=like.device)
            self._gen.manual_seed(self.seed)
        return [_GeneratorStep(self._gen, like) for _ in range(n_steps)]


class _GivenStep:
    def __init__(self, seg, k):
        self._seg, self._k = seg, k

    def momentum(self):
        return self._seg["xi"][self._k]

    def accept(self):
        return self._seg["u"][self._k]

    def direction(self, depth):
        return self._seg["kd"][self._k, depth]

    def across(self, depth):
        return self._seg["kb"][self._k, depth]

    def leaf(self, depth, i):
        return self._seg["ka"][self._k, depth, i]


class GivenDraws:
    """Draws given as arrays, one dict per segment in the order the
    sampler runs them: warmup phase 1, warmup phase 2, then each sampling
    chunk (a segment that does not run has no dict).  Each dict holds,
    with a leading axis of the segment's steps,

    * ``xi`` (n, n_chains, ndim): the standard-normal momentum draws;
    * for HMC, ``u`` (n, n_chains): the accept uniforms;
    * for NUTS, per depth d < max_depth, ``kd`` (n, max_depth, n_chains)
      the direction bits (True: forward), ``kb`` (n, max_depth, n_chains)
      the uniforms of the choice across subtrees, and ``ka`` (n,
      max_depth, 2^(max_depth-1), n_chains) one uniform per leaf i < 2^d.
    """

    def __init__(self, segments):
        self._segments = list(segments)

    def segment(self, n_steps, like):
        if not self._segments:
            raise ValueError("GivenDraws: no segment left for a run of "
                             f"{n_steps} steps")
        seg = self._segments.pop(0)
        xi = np.asarray(seg["xi"])
        if xi.shape != (n_steps, *like.shape):
            raise ValueError(f"GivenDraws: a segment of {n_steps} steps of "
                             f"chains {tuple(like.shape)} needs xi of shape "
                             f"{(n_steps, *like.shape)}, got {xi.shape}")
        out = {k: torch.as_tensor(np.array(v), device=like.device,
                                  dtype=torch.bool if k == "kd"
                                  else like.dtype)
               for k, v in seg.items()}
        return [_GivenStep(out, k) for k in range(n_steps)]


# --------------------------------------------------------------------------
# the mass matrix: a vector (diagonal M⁻¹) or a matrix (dense M⁻¹)
# --------------------------------------------------------------------------

def _minv(m, r):
    """M⁻¹ r for each row of ``r`` (C, ndim)."""
    return r @ m.T if m.ndim == 2 else m * r


def _draw_r(m_draw, xi):
    """r = A ξ (A Aᵀ = M) for each row of ``xi``."""
    return xi @ m_draw.T if m_draw.ndim == 2 else m_draw * xi


def _kinetic(r, m_inv):
    return 0.5 * torch.sum(r * _minv(m_inv, r), dim=-1)


def _turning(dz, r_a, r_b, m_inv):
    return (torch.sum(dz * _minv(m_inv, r_a), dim=-1) < 0) | \
        (torch.sum(dz * _minv(m_inv, r_b), dim=-1) < 0)


def _popcount(n: int) -> int:
    return bin(n).count("1")


def _ctz(n: int) -> int:
    return (n & -n).bit_length() - 1


def _rows(mask):
    """The indices where a device boolean mask holds (one host read)."""
    return torch.as_tensor(np.flatnonzero(mask.cpu().numpy()),
                           device=mask.device)


# --------------------------------------------------------------------------
# transitions
# --------------------------------------------------------------------------

def _hmc_step(vg, n_leapfrog, d, z, lp, eps, m_inv, m_draw):
    """One HMC step of every chain: n_leapfrog + 1 gradient calls."""
    r0 = _draw_r(m_draw, d.momentum())
    _, g = vg(z)
    r = r0 + 0.5 * eps * g
    z_new = z
    for _ in range(n_leapfrog - 1):
        z_new = z_new + eps * _minv(m_inv, r)
        _, g = vg(z_new)
        r = r + eps * g
    z_new = z_new + eps * _minv(m_inv, r)
    lp_new, g = vg(z_new)           # the final value is lp(z_new)
    r = r + 0.5 * eps * g
    log_accept = (lp_new - _kinetic(r, m_inv)) - (lp - _kinetic(r0, m_inv))
    # reject non-finite proposals; an invalid current state accepts any
    # finite proposal, so a chain can leave it
    ok_new = torch.isfinite(lp_new)
    inf = torch.full_like(log_accept, math.inf)
    log_accept = torch.where(ok_new & torch.isfinite(log_accept), log_accept,
                             -inf)
    log_accept = torch.where(torch.isfinite(lp) | ~ok_new, log_accept, inf)
    accept = torch.log(d.accept()) < log_accept
    z = torch.where(accept[:, None], z_new, z)
    lp = torch.where(accept, lp_new, lp)
    return z, lp, torch.clamp(torch.exp(log_accept), max=1.0)


def _subtree(vg, d, depth, rows, z, r, g, direction, energy0, eps, m_inv,
             max_depth):
    """2^depth leapfrog steps from (z, r, g) of the chains ``rows``, each
    chain stopping on its own turning or divergence flag; only the live
    chains are evaluated.  Returns the far edge (z, r, g), the multinomial
    proposal (zp, lpp), its log-weight, the flags and the
    acceptance-statistic sums, all (A, ...) over ``rows``."""
    A, ndim = z.shape
    z, r, g = z.clone(), r.clone(), g.clone()
    zp = z.clone()
    lpp = torch.full((A,), -math.inf, dtype=z.dtype, device=z.device)
    logw = lpp.clone()
    s_a = torch.zeros_like(lpp)
    n_a = torch.zeros_like(lpp)
    turning = torch.zeros(A, dtype=torch.bool, device=z.device)
    diverging = torch.zeros_like(turning)
    ck_z = torch.zeros((A, max_depth + 1, ndim), dtype=z.dtype,
                       device=z.device)
    ck_r = torch.zeros_like(ck_z)
    for i in range(1 << depth):
        live = _rows(~turning & ~diverging)
        if live.numel() == 0:
            break
        ka = d.leaf(depth, i)[rows[live]]
        step = (direction[live] * eps)[:, None]
        r_s = r[live] + 0.5 * step * g[live]
        z_s = z[live] + step * _minv(m_inv, r_s)
        lp_s, g_s = vg(z_s)
        r_s = r_s + 0.5 * step * g_s
        denergy = (-lp_s + _kinetic(r_s, m_inv)) - energy0[live]
        # a NaN energy error counts as an infinite one (Stan's rule): the
        # leaf diverges and adds 0 to the acceptance statistic, where the
        # JAX package's adds NaN and so poisons the dual averaging
        denergy = torch.where(torch.isnan(denergy),
                              torch.full_like(denergy, math.inf), denergy)
        div_s = ~torch.isfinite(denergy) | (denergy > _DIVERGENCE)
        w = torch.where(div_s, torch.full_like(denergy, -math.inf), -denergy)
        # progressive multinomial proposal within the subtree
        logw_new = torch.logaddexp(logw[live], w)
        take = torch.log(ka) < (w - logw_new)
        zp[live] = torch.where(take[:, None], z_s, zp[live])
        lpp[live] = torch.where(take, lp_s, lpp[live])
        logw[live] = logw_new
        s_a[live] = s_a[live] + torch.clamp(torch.exp(-denergy), max=1.0)
        n_a[live] = n_a[live] + 1.0
        # the checkpointed U-turn checks: even leaf n is stored at slot
        # popcount(n); odd leaf n checks slots
        # [popcount(n) - ctz(n+1), popcount(n) - 1]
        if i % 2 == 0:
            ck_z[live, _popcount(i)] = z_s
            ck_r[live, _popcount(i)] = r_s
        else:
            hi = _popcount(i) - 1
            turn_now = torch.zeros_like(div_s)
            for k in range(hi - _ctz(i + 1) + 1, hi + 1):
                # the displacement in trajectory time: a backward subtree
                # is integrated time-reversed
                turn_now = turn_now | _turning(
                    direction[live, None] * (z_s - ck_z[live, k]),
                    ck_r[live, k], r_s, m_inv)
            turning[live] = turning[live] | turn_now
        diverging[live] = div_s
        z[live], r[live], g[live] = z_s, r_s, g_s
    return z, r, g, zp, lpp, logw, turning, diverging, s_a, n_a


def _nuts_step(vg, max_depth, d, z, lp, eps, m_inv, m_draw):
    """One multinomial NUTS transition of every chain (the JAX package's
    ``vmap`` of its iterative tree)."""
    C = z.shape[0]
    r0 = _draw_r(m_draw, d.momentum())
    lp0 = torch.where(torch.isfinite(lp), lp,
                      torch.full_like(lp, -math.inf))
    energy0 = -lp0 + _kinetic(r0, m_inv)
    _, g0 = vg(z)
    z_l, r_l, g_l = z.clone(), r0.clone(), g0.clone()
    z_r, r_r, g_r = z.clone(), r0.clone(), g0.clone()
    zp, lpp = z.clone(), lp0.clone()
    logw = torch.zeros_like(lp)
    s_a, n_a = torch.zeros_like(lp), torch.zeros_like(lp)
    turning = torch.zeros(C, dtype=torch.bool, device=z.device)
    diverging = torch.zeros_like(turning)
    for depth in range(max_depth):
        rows = _rows(~turning & ~diverging)
        if rows.numel() == 0:
            break
        right = d.direction(depth)[rows]
        kb = d.across(depth)[rows]
        sel = right[:, None]
        direction = torch.where(right, 1.0, -1.0).to(z.dtype)
        (z_e, r_e, g_e, zp_s, lpp_s, logw_s, turn_s, div_s, sa_s,
         na_s) = _subtree(
            vg, d, depth, rows,
            torch.where(sel, z_r[rows], z_l[rows]),
            torch.where(sel, r_r[rows], r_l[rows]),
            torch.where(sel, g_r[rows], g_l[rows]),
            direction, energy0[rows], eps, m_inv, max_depth)
        s_a[rows] = s_a[rows] + sa_s
        n_a[rows] = n_a[rows] + na_s
        ok = ~turn_s & ~div_s
        # biased progressive sampling across the doubling
        take = ok & (torch.log(kb) < (logw_s - logw[rows]))
        zp[rows] = torch.where(take[:, None], zp_s, zp[rows])
        lpp[rows] = torch.where(take, lpp_s, lpp[rows])
        logw[rows] = torch.where(ok, torch.logaddexp(logw[rows], logw_s),
                                 logw[rows])
        for edge, new in ((z_l, z_e), (r_l, r_e), (g_l, g_e)):
            edge[rows] = torch.where((ok & ~right)[:, None], new, edge[rows])
        for edge, new in ((z_r, z_e), (r_r, r_e), (g_r, g_e)):
            edge[rows] = torch.where((ok & right)[:, None], new, edge[rows])
        turn_tree = _turning(z_r[rows] - z_l[rows], r_l[rows], r_r[rows],
                             m_inv)
        turning[rows] = turn_s | (ok & turn_tree)
        diverging[rows] = div_s
    # an invalid current state accepts any finite proposal
    valid = torch.isfinite(lpp)
    zp = torch.where(valid[:, None], zp, z)
    lpp = torch.where(valid, lpp, lp)
    alpha = torch.where(n_a > 0, s_a / torch.clamp(n_a, min=1.0),
                        torch.zeros_like(s_a))
    return zp, lpp, alpha


# --------------------------------------------------------------------------
# the sampler
# --------------------------------------------------------------------------

def _log_posterior(gprn, prior_list, free_idx, n_sweeps):
    """``(logpost, value_and_grad)`` over a (C, ndim) batch of z = log θ:
    the priors summed per row, Σz, and the ELBO after ``n_sweeps`` sweeps
    from the inference's cached state; the gradient is one autograd pass
    through ``Engine.elbo_fixed_batch`` of the row sum (the rows are
    independent)."""
    eng = gprn.engine
    data = gprn._data()
    base = gprn._theta()
    mu0, var0 = gprn._resolve_mu_var('previous', 'previous', base)
    idx = torch.as_tensor(free_idx, device=base.device)

    def logpost(z):
        theta_free = torch.exp(z)
        theta = base.expand(z.shape[0], -1).clone()
        theta[:, idx] = theta_free
        lp = sum(pr.logpdf(theta_free[:, j])
                 for j, pr in enumerate(prior_list))
        elbo = eng.elbo_fixed_batch(theta, *data, mu0, var0, n_sweeps)
        return lp + torch.sum(z, dim=-1) + elbo   # + log-Jacobian of e^z

    def value_and_grad(z):
        z = z.detach().requires_grad_(True)
        with torch.enable_grad():
            value = logpost(z)
            (grad,) = torch.autograd.grad(value.sum(), z)
        return value.detach(), grad

    return logpost, value_and_grad


def _initial_positions(prior_list, free_names, n_chains, ndim, seed, p0):
    """θ of every chain from numpy's ``default_rng(seed)``, as the JAX
    package draws them, folded into θ > 0."""
    rng = np.random.default_rng(seed)
    if p0 is None:
        th0 = np.array([[pr.rvs(rng=rng) for pr in prior_list]
                        for _ in range(n_chains)])
    else:
        p0 = np.atleast_2d(np.asarray(p0, dtype=float))
        th0 = np.repeat(p0, n_chains, axis=0)[:n_chains] * \
            np.exp(0.01 * rng.standard_normal((n_chains, ndim)))
    # z = log θ needs θ > 0: |θ| is the same model state for a parameter
    # that enters squared (a jitter, an amplitude); for one that enters
    # linearly (a constant mean) the fold flips its sign, so name it
    neg = th0 < 0
    if np.any(neg):
        folded = sorted({free_names[j]
                         for j in np.unique(np.nonzero(neg)[1])})
        warnings.warn(
            "run_hmc samples in log-space (theta > 0): folding "
            f"nonpositive initial values of {folded} into the support "
            "via |theta|.  Exact for parameters entering the model "
            "squared (jitters, amplitudes); sign-flipping for linear "
            "ones (e.g. constant means) — freeze or reparameterize "
            "those.", RuntimeWarning, stacklevel=3)
    th0 = np.abs(th0)
    return np.where(th0 > 1e-8, th0, 1e-8)


def _mass_estimate(zs2, mass_matrix, ndim):
    """``(m_inv, m_draw)`` as numpy from phase 1's second-half draws
    ``zs2`` (n, ndim): the clipped variance, or Stan's regularized
    covariance with its Cholesky (diagonal when that fails)."""
    var_z = np.var(zs2, axis=0)
    scale = np.median(var_z[var_z > 0]) if np.any(var_z > 0) else 1.0
    var_c = np.clip(var_z, 1e-2 * scale, 1e2 * scale)
    if mass_matrix == "dense" and ndim > 1:
        # shrink towards a small multiple of the identity, weight n/(n+5)
        n_s = zs2.shape[0]
        w = n_s / (n_s + 5.0)
        cov = w * np.cov(zs2.T) + (1 - w) * 1e-3 * np.eye(ndim)
        cov[np.arange(ndim), np.arange(ndim)] = np.maximum(
            np.diag(cov), 1e-2 * scale)
        try:
            C = np.linalg.cholesky(cov)          # Σ = C Cᵀ, M = Σ⁻¹
            # r ~ N(0, M): r = C⁻ᵀ ξ, since C⁻ᵀ C⁻¹ = M
            return cov, np.linalg.solve(C.T, np.eye(ndim))
        except np.linalg.LinAlgError:
            pass                                 # fall back to diagonal
    return var_c, None


def run_hmc(gprn, priors: Dict, n_samples: int = 500, n_warmup: int = 100,
            n_chains: int = 4, n_leapfrog: int = 8, n_sweeps: int = 15,
            target_accept: float = 0.8, initial_step: float = 0.02,
            seed: int = 0, p0=None, checkpoint=None,
            mass_matrix: str = "diag", chunk: int = 50,
            algorithm: str = "hmc", max_depth: int = 8, draws=None):
    """Sample the hyperparameter posterior (the ELBO as the likelihood
    surrogate) with HMC or NUTS, every chain on the inference's device.

    Args as in the JAX package: ``gprn`` a fitted ``inference`` (its
    cached variational state warm-starts every ELBO of ``n_sweeps``
    sweeps); ``priors`` name → prior from :mod:`.priors` (a ``logpdf``
    that runs on tensors) for every free parameter; ``mass_matrix``
    'diag' | 'dense' | 'identity'; ``chunk`` sampling steps per host
    transfer and checkpoint; ``algorithm`` 'hmc' | 'nuts' (up to
    ``max_depth`` doublings).  ``draws`` is the draw source:
    ``DeviceDraws(seed)`` by default, or a :class:`GivenDraws`.

    Returns an :class:`HMCResult` (the chain in θ-space, numpy).
    """
    gprn._require_components()
    all_names = np.array(list(gprn.parameters_dict.keys()))
    frozen = gprn.frozen_mask
    free_names = [str(n) for n in all_names[~frozen]]
    ndim = len(free_names)
    missing = [n for n in free_names if n not in priors]
    if missing:
        raise ValueError(f"missing priors for parameters: {missing}")
    if algorithm not in ("hmc", "nuts"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    prior_list = [priors[n] for n in free_names]
    logpost, vg = _log_posterior(gprn, prior_list, np.where(~frozen)[0],
                                 n_sweeps)

    def step(d, z, lp, eps, m_inv, m_draw):
        if algorithm == "hmc":
            return _hmc_step(vg, n_leapfrog, d, z, lp, eps, m_inv, m_draw)
        return _nuts_step(vg, max_depth, d, z, lp, eps, m_inv, m_draw)

    if draws is None:
        draws = DeviceDraws(seed)

    th0 = _initial_positions(prior_list, free_names, n_chains, ndim, seed,
                             p0)
    z = gprn._tensor(np.log(th0))
    with torch.no_grad():
        lp = logpost(z)

    def warmup(z, lp, m_inv, m_draw, n_steps, eps0):
        """Dual averaging of the step size over ``n_steps`` steps; returns
        the state, the averaged step size and the positions (host)."""
        mu_da = math.log(10.0 * eps0)
        h_bar, log_eps, log_eps_bar = 0.0, math.log(eps0), math.log(eps0)
        zs = []
        for i, d in enumerate(draws.segment(n_steps, z)):
            z, lp, alpha = step(d, z, lp, math.exp(log_eps), m_inv, m_draw)
            a = float(torch.mean(alpha))
            frac = 1.0 / (i + 1.0 + 10.0)
            h_bar = (1 - frac) * h_bar + frac * (target_accept - a)
            log_eps = mu_da - math.sqrt(i + 1.0) / 0.05 * h_bar
            w = (i + 1.0) ** -0.75
            log_eps_bar = w * log_eps + (1 - w) * log_eps_bar
            zs.append(z)
        return z, lp, math.exp(log_eps_bar), torch.stack(zs).cpu().numpy()

    # phase 1 with identity mass; phase 2 re-adapts the step size around
    # the mass estimated from phase 1's second half
    m_inv = torch.ones(ndim, dtype=z.dtype, device=z.device)
    m_draw = torch.ones_like(m_inv)     # A with A Aᵀ = M (vector: diagonal)
    n1 = n_warmup if mass_matrix == "identity" else n_warmup // 2
    eps = float(initial_step)
    if n1 > 0:
        z, lp, eps, zs = warmup(z, lp, m_inv, m_draw, n1, eps)
        zs2 = zs[n1 // 2:].reshape(-1, ndim)
    else:       # n_warmup=0: no adaptation, sample at initial_step
        zs2 = np.zeros((0, ndim))
    if mass_matrix in ("diag", "dense") and n_warmup > 1 \
            and zs2.shape[0] >= 50:
        # only with enough draws: a variance from a barely-moved short
        # chain is near zero, and the step size then inflates to a
        # degenerate scale
        m_inv_np, m_draw_np = _mass_estimate(zs2, mass_matrix, ndim)
        m_inv = gprn._tensor(m_inv_np)
        m_draw = 1.0 / torch.sqrt(m_inv) if m_draw_np is None \
            else gprn._tensor(m_draw_np)
    if n_warmup - n1 > 0:
        # with too few phase-1 draws for an estimate, the rest of the
        # warmup budget runs with identity mass
        z, lp, eps, _ = warmup(z, lp, m_inv, m_draw, n_warmup - n1, eps)

    chain_parts, lp_parts = [], []
    acc, done = 0.0, 0
    while done < n_samples:
        k = min(chunk, n_samples - done)
        zs, lps, alphas = [], [], []
        for d in draws.segment(k, z):
            z, lp, alpha = step(d, z, lp, eps, m_inv, m_draw)
            zs.append(z)
            lps.append(lp)
            alphas.append(torch.mean(alpha))
        chain_parts.append(np.exp(torch.stack(zs).cpu().numpy()))
        lp_parts.append(torch.stack(lps).cpu().numpy())
        acc += float(torch.sum(torch.stack(alphas)))
        done += k
        if checkpoint is not None:
            HMCResult(np.concatenate(chain_parts), np.concatenate(lp_parts),
                      acc / done, eps, free_names).save(checkpoint)

    result = HMCResult(chain=np.concatenate(chain_parts),
                       log_prob=np.concatenate(lp_parts),
                       acceptance=acc / max(n_samples, 1), step_size=eps,
                       parameter_names=free_names)
    if checkpoint is not None:
        result.save(checkpoint)
    return result
