"""Nonparametric variational inference for GPRNs, on the device.

Port of :mod:`gpyrn_tpu.inference.nonparametric`.  The variational family
is a uniform mixture of k isotropic Gaussians over the stacked latent
vector u = (f, w) (Gershman, Hoffman & Blei 2012),

    q(u) = (1/k) Σ_j N(u; μ_j, s_j² I),   u ∈ R^d,  d = N·q·(p+1).

The ELBO combines per-component closed-form expectations of the GPRN
log-likelihood and GP log-prior with the mixture entropy lower bound

    H[q] ≥ -(1/k) Σ_i log[(1/k) Σ_j N(μ_i; μ_j, (s_i²+s_j²) I)].

The kernel matrices come from ``linalg.kernel_matrix_stack`` with the
training nugget (on the card, B1 writes the q·(1+p) lattice into one
buffer), then one batched Cholesky and the traces of K⁻¹.  Those depend
on θ alone, so a fit builds them once and runs adam (torch.optim.Adam
with optax.adam's defaults) over (μ, log s) on them.

API surface as in the JAX package: ``inference(num_nodes, time, k,
*args)`` with ``ELBOcalc(nodes, weights, means, jitters, iterations)``
returning ``(ELBO, mu, var)``, plus ``predict`` and
``resample_components``; results come back as numpy, as there.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from gpyrn_tpu_torch.config import DEFAULT_DTYPE
from gpyrn_tpu_torch.models import gprn as _core
from gpyrn_tpu_torch.ops import blocked as _blocked
from gpyrn_tpu_torch.ops import kernels as kernels_mod
from gpyrn_tpu_torch.ops import means as means_mod
from gpyrn_tpu_torch.ops.linalg import TRAIN_NUGGET, kernel_matrix_stack

__all__ = ["inference", "npv_elbo", "make_npv_engine", "NPVEngine"]

LOG_2PI = math.log(2 * math.pi)


class NPVEngine(NamedTuple):
    spec: _core.GPRNSpec
    k: int
    elbo: object          # (theta, t, y, yerr2, mu(k,d), logs(k)) -> 0-d
    terms: object         # same args -> (loglike (k,), logprior (k,), entropy)
    fit: object           # adam loop; returns (elbo, mu, logs, trajectory)


class _Prior(NamedTuple):
    """What the ELBO needs of θ: the factors, the traces, the data."""
    Lf: torch.Tensor          # (q, N, N)
    Lw: torch.Tensor          # (q, p, N, N)
    logdet: torch.Tensor      # log det Kf + log det Kw
    tr_inv: torch.Tensor      # Σ tr Kf⁻¹ + Σ tr Kw⁻¹
    y_c: torch.Tensor         # (p, N) data minus means
    variance: torch.Tensor    # (p, N) jitter² + yerr²


@functools.lru_cache(maxsize=64)
def make_npv_engine(spec: _core.GPRNSpec, k: int,
                    core_maps=None) -> NPVEngine:
    """ELBO, terms and fit loop for a mixture of ``k`` isotropic
    Gaussians; every function takes tensors on one device."""
    q, p, N, d = spec.q, spec.p, spec.N, spec.d
    node_maps = weight_maps = None
    if core_maps is not None:
        node_maps, weight_maps = core_maps

    def prior(theta, t, y, yerr2):
        node_p, weight_p, mean_p, jitters = _core.unpack_parameters(
            spec, theta)
        K = kernel_matrix_stack(
            spec.node_structs + spec.weight_structs,
            _core.Engine._core(node_p, node_maps)
            + _core.Engine._core(weight_p, weight_maps), t, TRAIN_NUGGET)
        L = _blocked.cholesky_nan(K)                        # (q+qp, N, N)
        logdet = 2 * torch.sum(torch.log(torch.diagonal(L, dim1=-2,
                                                        dim2=-1)))
        eye = torch.eye(N, dtype=t.dtype, device=t.device)
        inv = torch.cholesky_solve(eye.expand(L.shape), L)
        tr_inv = torch.sum(torch.diagonal(inv, dim1=-2, dim2=-1))
        m = torch.stack([torch.zeros_like(t) if s is None
                         else means_mod.evaluate(s, mp, t)
                         for s, mp in zip(spec.mean_structs, mean_p)])
        return _Prior(L[:q], L[q:].reshape(q, p, N, N), logdet, tr_inv,
                      y - m, jitters[:, None] ** 2 + yerr2)

    def split(mu):
        """(k, d) → muF (k, q, N), muW (k, p, q, N)."""
        return (mu[:, :q * N].reshape(-1, q, N),
                mu[:, q * N:].reshape(-1, p, q, N))

    def terms_of(pr: _Prior, mu, logs):
        s2 = torch.exp(2.0 * logs)                          # (k,)
        muF, muW = split(mu)
        # expected log-likelihood: E[(y - Σ w f)²] under N(mu, s² I) is
        # resid² + Σ_q [s²(muF² + muW²) + s⁴]
        pred = torch.einsum("kpqn,kqn->kpn", muW, muF)
        resid2 = (pr.y_c - pred) ** 2
        s2b = s2[:, None, None, None]
        second = torch.sum(s2b * (muF[:, None] ** 2 + muW ** 2)
                           + s2b ** 2, dim=2)              # (k, p, N)
        quad = torch.sum((resid2 + second) / pr.variance, dim=(1, 2))
        ll = -0.5 * torch.sum(torch.log(2 * math.pi * pr.variance)) \
            - 0.5 * quad
        # expected log-prior
        kk = mu.shape[0]
        alpha_f = torch.cholesky_solve(
            muF[..., None], pr.Lf.expand(kk, q, N, N))[..., 0]
        quad_f = torch.einsum("kqn,kqn->k", muF, alpha_f)
        muW_q = muW.transpose(1, 2)                          # (k, q, p, N)
        alpha_w = torch.cholesky_solve(
            muW_q[..., None], pr.Lw.expand(kk, q, p, N, N))[..., 0]
        quad_w = torch.einsum("kqpn,kqpn->k", muW_q, alpha_w)
        lp = -0.5 * (d * LOG_2PI + pr.logdet + quad_f + quad_w
                     + s2 * pr.tr_inv)
        # mixture entropy lower bound
        diff2 = torch.sum((mu[:, None, :] - mu[None, :, :]) ** 2, dim=-1)
        ssum = s2[:, None] + s2[None, :]
        log_pair = -0.5 * diff2 / ssum \
            - 0.5 * d * torch.log(2 * math.pi * ssum)      # (k, k)
        log_qi = torch.logsumexp(log_pair, dim=1) - math.log(float(k))
        return ll, lp, -torch.mean(log_qi)

    def elbo_of(pr, mu, logs):
        ll, lp, entropy = terms_of(pr, mu, logs)
        return torch.mean(ll + lp) + entropy

    def terms(theta, t, y, yerr2, mu, logs):
        """Per-component ELBO terms at a fixed state: expected
        log-likelihood (k,), expected log-prior (k,), and the mixture
        entropy lower bound (0-d); ``elbo`` is mean(loglike + logprior)
        + entropy."""
        return terms_of(prior(theta, t, y, yerr2), mu, logs)

    def elbo(theta, t, y, yerr2, mu, logs):
        """mu: (k, d) component means; logs: (k,) log std-devs."""
        return elbo_of(prior(theta, t, y, yerr2), mu, logs)

    def fit(theta, t, y, yerr2, mu0, logs0, n_steps: int,
            learning_rate: float):
        """``n_steps`` adam steps on −ELBO over (μ, log s); returns the
        final ELBO, μ, log s and the ELBO before each step."""
        pr = prior(theta, t, y, yerr2)
        mu = mu0.detach().clone().requires_grad_(True)
        logs = logs0.detach().clone().requires_grad_(True)
        opt = torch.optim.Adam([mu, logs], lr=learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        traj = []
        for _ in range(int(n_steps)):
            opt.zero_grad()
            with torch.enable_grad():
                value = elbo_of(pr, mu, logs)
                (-value).backward()
            opt.step()
            traj.append(value.detach())
        with torch.no_grad():
            final = elbo_of(pr, mu, logs)
        traj = torch.stack(traj) if traj else mu.new_zeros(0)
        return final, mu.detach(), logs.detach(), traj

    return NPVEngine(spec=spec, k=k, elbo=elbo, terms=terms, fit=fit)


def npv_elbo(spec, theta, t, y, yerr2, mu, logs, k, core_maps=None):
    """Functional entry: nonparametric-VI ELBO for given mixture params
    (tensors on one device)."""
    eng = make_npv_engine(spec, k, core_maps)
    return eng.elbo(theta, t, y, yerr2, mu, logs)


def _core_maps(nodes, weights):
    if not any(kk.has_core_map() for kk in list(nodes) + list(weights)):
        return None
    return (tuple(kk.core_params_from if kk.has_core_map() else None
                  for kk in nodes),
            tuple(kk.core_params_from if kk.has_core_map() else None
                  for kk in weights))


class inference:
    """Nonparametric VI for GPRNs with a mixture of ``k`` isotropic
    Gaussians.

    Args:
        num_nodes: number of latent node functions
        time: time coordinates
        k: number of mixture components
        *args: data as y1, y1err, y2, y2err, ...
        device: where the data and the fits live (``"cuda"`` unless the
            caller asks for another)
    """

    def __init__(self, num_nodes: int, time, k: int, *args, device="cuda"):
        self.num_nodes = self.q = num_nodes
        self.time = np.asarray(time, dtype=float)
        self.N = self.time.size
        self.k = int(k)
        assert len(args) > 0 and len(args) % 2 == 0, \
            'Given data and number of components dont match'
        self.p = len(args) // 2
        self.qp = self.q * self.p
        self.d = self.N * self.q * (self.p + 1)
        self.tt = np.tile(self.time, self.p)
        self.y = np.stack([np.asarray(a, dtype=float) for a in args[::2]])
        self.yerr = np.stack([np.asarray(a, dtype=float)
                              for a in args[1::2]])
        self.yerr2 = self.yerr ** 2
        self.ystd = np.std(self.y, axis=1).reshape(self.p, 1)
        self.device = torch.device(device)
        self.dtype = DEFAULT_DTYPE

    def _tensor(self, x):
        return torch.tensor(np.asarray(x, dtype=float), dtype=self.dtype,
                            device=self.device)

    def _data(self):
        return (self._tensor(self.time), self._tensor(self.y),
                self._tensor(self.yerr2))

    def _u_to_fhatW(self, u):
        f = u[:self.q * self.N].reshape((1, self.q, self.N))
        w = u[self.q * self.N:].reshape((self.p, self.q, self.N))
        return f, w

    def sampleIt(self, latentFunc, time=None, rng=None):
        """A sample function drawn from a kernel's GP prior (numpy)."""
        rng = np.random.default_rng() if rng is None else rng
        if time is None:
            time = self.time
        time = self._tensor(time)
        r = time[:, None] - time[None, :]
        K = kernels_mod.evaluate(latentFunc.structure,
                                 self._tensor(latentFunc.core_params()), r=r)
        K = K.cpu().numpy() + TRAIN_NUGGET * np.eye(time.shape[0])
        w, V = np.linalg.eigh(K)
        w = np.clip(w, 0.0, None)
        return V @ (np.sqrt(w) * rng.standard_normal(time.shape[0]))

    def _normalize_means(self, means):
        """Scalar/None → per-output list (shared by ELBOcalc/ELBOaux)."""
        if isinstance(means, (int, float)) or means is None:
            means = [means]
        means = [None if isinstance(m, (int, float)) or m is None else m
                 for m in means]
        if len(means) == 1 and self.p > 1:
            means = means * self.p
        return means

    def _logs_from_std(self, var):
        """Per-component log std-devs from a std-dev scalar/vector."""
        logs = np.log(np.abs(np.atleast_1d(np.asarray(var, dtype=float)))
                      + 1e-300)
        if logs.size == 1:
            logs = np.full(self.k, float(logs[0]))
        return logs

    def _engine(self, nodes, weights, means):
        spec = _core.spec_from_components(nodes, weights, means, self.N)
        return make_npv_engine(spec, self.k, _core_maps(nodes, weights))

    def _theta(self, nodes, weights, means, jitters):
        return self._tensor(_core.pack_parameters(nodes, weights, means,
                                                  jitters))

    def ELBOaux(self, nodes, weights, means, jitters, mu, var):
        """Single ELBO evaluation at given mixture parameters; ``var``
        holds per-component standard deviations (the same convention as
        ELBOcalc's return)."""
        means = self._normalize_means(means)
        jitters = np.atleast_1d(np.asarray(jitters, dtype=float))
        eng = self._engine(nodes, weights, means)
        theta = self._theta(nodes, weights, means, jitters)
        return float(eng.elbo(theta, *self._data(), self._tensor(mu),
                              self._tensor(self._logs_from_std(var))))

    def ELBOcalc(self, nodes, weights, means, jitters, iterations: int = 500,
                 learning_rate: float = 5e-2, mu=None, var=None,
                 seed: int = 0):
        """Fit the mixture variational parameters by adam on the device
        and return ``(ELBO, mu, var)``: ``mu`` (k, d) and ``var`` the
        per-component std-dev vector (k,), as numpy.  A ``var`` input uses
        the same std-dev convention, so ``ELBOcalc(..., mu=mu, var=var)``
        resumes exactly.  The initial ``mu`` is numpy's
        ``default_rng(seed)``, as in the JAX package."""
        means = self._normalize_means(means)
        jitters = np.atleast_1d(np.asarray(jitters, dtype=float))
        eng = self._engine(nodes, weights, means)
        theta = self._theta(nodes, weights, means, jitters)

        rng = np.random.default_rng(seed)
        if mu is None:
            mu = 0.1 * rng.standard_normal((self.k, self.d))
        if var is None:
            logs = np.full(self.k, np.log(0.3))
        else:
            logs = self._logs_from_std(var)

        elbo, mu, logs, traj = eng.fit(theta, *self._data(),
                                       self._tensor(mu), self._tensor(logs),
                                       int(iterations), learning_rate)
        self._traj = traj.cpu().numpy()
        return float(elbo), mu.cpu().numpy(), np.exp(logs.cpu().numpy())

    # ------------------------------------------------------------------
    # posterior predictive & component maintenance
    # ------------------------------------------------------------------

    def predict(self, nodes, weights, means, jitters, mu, var,
                tstar=None, nn: int = 1000):
        """Mixture posterior predictive per output.

        Each component's state (μ_j, s_j²·1) defines the same GPRN
        conditionals as a mean-field state, evaluated with the mean-field
        engine; the uniform mixture then combines them:

            mean = (1/k) Σ_j mean_j
            var  = (1/k) Σ_j (var_j + mean_j²) − mean².

        ``mu`` is (k, d) and ``var`` the per-component std-dev vector
        (k,).  Returns ``(tstar, mean (n*, p), std (n*, p))`` as numpy.
        """
        means_l = self._normalize_means(means)
        jitters = np.atleast_1d(np.asarray(jitters, dtype=float))
        spec = _core.spec_from_components(nodes, weights, means_l, self.N)
        eng = _core.Engine(spec, _core_maps(nodes, weights))
        theta = self._theta(nodes, weights, means_l, jitters)
        t = self.time
        if tstar is None:
            ptp = np.ptp(t)
            tstar = np.linspace(t.min() - 0.2 * ptp,
                                t.max() + 0.2 * ptp, nn)
        tstar = np.atleast_1d(np.asarray(tstar, dtype=float))

        mu = np.asarray(mu, dtype=float).reshape(self.k, self.d)
        s2 = np.asarray(var, dtype=float).reshape(self.k) ** 2
        data = self._data()
        comp_means, comp_vars = [], []
        for j in range(self.k):
            m_out, v_out, _, _ = eng.predict(
                theta, *data, self._tensor(mu[j]),
                self._tensor(np.full(self.d, s2[j])), self._tensor(tstar))
            comp_means.append(m_out.cpu().numpy())
            comp_vars.append(v_out.cpu().numpy())
        comp_means = np.stack(comp_means)                   # (k, n*, p)
        comp_vars = np.stack(comp_vars)
        mean = comp_means.mean(axis=0)
        second = (comp_vars + comp_means ** 2).mean(axis=0)
        std = np.sqrt(np.maximum(second - mean ** 2, 0.0))
        return tstar, mean, std

    def resample_components(self, mu, var, threshold: float = 1e-2,
                            jitter_scale: float = 0.5, seed: int = 0):
        """Re-initialize COLLAPSED mixture components: any pair closer
        than ``threshold × state scale`` has its second member re-seeded
        at a randomly-perturbed copy of the pair (perturbation
        ``jitter_scale × s_i``, numpy's ``default_rng(seed)``), after
        which ``ELBOcalc(mu=, var=)`` resumes the fit.  Returns ``(mu,
        var, n_resampled)``."""
        rng = np.random.default_rng(seed)
        mu = np.array(np.asarray(mu, dtype=float).reshape(self.k, self.d))
        var = np.array(np.asarray(var, dtype=float).reshape(self.k))
        scale = max(float(np.sqrt(np.mean(mu ** 2))), 1e-12)
        n_res = 0
        for i in range(self.k):
            for j in range(i + 1, self.k):
                dist = np.sqrt(np.mean((mu[i] - mu[j]) ** 2))
                if dist < threshold * scale:
                    mu[j] = mu[i] + jitter_scale * var[i] * \
                        rng.standard_normal(self.d)
                    var[j] = var[i]
                    n_res += 1
        return mu, var, n_res
