"""Plain PyTorch GPRN mean-field fit: the benchmark's reference.

Written from the model's equations (Nguyen & Bonilla 2013, eqs. 16-19, and
the reference gpyrn's ELBO conventions), independently of the package under
test: it imports nothing of it, forms every posterior covariance as an
explicit N x N matrix,

    Sigma = (K^-1 + D^-1)^-1 = D - D (K + D)^-1 D,    mu = Sigma r,

and takes log det Sigma from a Cholesky of Sigma itself.  The conventions
of the reference gpyrn that the ELBO keeps:

* training covariance K + max(1e-6, 4 eps N k(0)) I (eps of the dtype);
* the heuristic start uses the first p weight amplitudes and reads the
  (q, p, N)-ordered weight means as (p, q, N) with a raw reshape;
* node j's prior trace term is tr(K_j^-1 sum_{k<=j} Sigma_k);
* the prior reads the (p, q, N) weight means as (q p, N) with a raw
  reshape;
* the likelihood's quadratic term uses the raw data, the updates the data
  less the means;
* the ELBO is divided by q;
* a fit stops when the relative std of its last three ELBO values is
  below 1e-3 (and not 0), tested from sweep 4 on.

Every function takes a leading row axis W (one row per hyperparameter
vector).  The GPs are visited one at a time, so a fit at N = 20,000 holds a
few N x N matrices per GP and no more.
"""
from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2 * math.pi)
TRAIN_NUGGET = 1e-6
JITTER_MULT = 4.0


def _se(p, r):
    return p[:, 0, None, None] ** 2 * torch.exp(
        -0.5 * r ** 2 / p[:, 1, None, None] ** 2)


def _periodic(p, r):
    theta, P, ell = (p[:, i, None, None] for i in range(3))
    return theta ** 2 * torch.exp(
        -2 * torch.sin(math.pi * torch.abs(r) / P) ** 2 / ell ** 2)


def _quasi_periodic(p, r):
    theta, le, P, lp = (p[:, i, None, None] for i in range(4))
    return theta ** 2 * torch.exp(
        -2 * torch.sin(math.pi * torch.abs(r) / P) ** 2 / lp ** 2
        - r ** 2 / (2 * le ** 2))


def _matern52(p, r):
    theta, ell = p[:, 0, None, None], p[:, 1, None, None]
    a = math.sqrt(5.0) * torch.abs(r) / ell
    return theta ** 2 * (1 + a + a ** 2 / 3) * torch.exp(-a)


# name -> (number of parameters, k(params (W, n), lags (N, N)) -> (W, N, N))
KERNELS = {"SquaredExponential": (2, _se), "Periodic": (3, _periodic),
           "QuasiPeriodic": (4, _quasi_periodic), "Matern52": (2, _matern52)}


def _linear(p, t):
    return p[:, 0, None] * (t - torch.mean(t)) + p[:, 1, None]


# name -> (number of parameters, m(params (W, n), t (N,)) -> (W, N))
MEANS = {"Linear": (2, _linear)}


class Model:
    """The structure of a configuration: q nodes, q p weights (node-major),
    p means (None for zero) and p jitters, in the parameter order
    nodes, weights, means, jitters."""

    def __init__(self, config):
        self.q, self.p = int(config["q"]), int(config["p"])
        self.nodes = [c["kernel"] for c in config["nodes"]]
        self.weights = [c["kernel"] for c in config["weights"]]
        self.means = [None if c is None else c["mean"]
                      for c in config["means"]]
        if len(self.nodes) != self.q or len(self.weights) != self.q * self.p \
                or len(self.means) != self.p:
            raise ValueError("a configuration has q nodes, q p weights and "
                             "p means")
        sizes = [KERNELS[k][0] for k in self.nodes + self.weights]
        sizes += [0 if m is None else MEANS[m][0] for m in self.means]
        self.sizes = sizes + [self.p]

    @property
    def n_parameters(self):
        return sum(self.sizes)

    def split(self, theta):
        """(kernel parameter blocks, mean parameter blocks, jitters) of
        theta (W, n_parameters)."""
        out, pos = [], 0
        for n in self.sizes:
            out.append(theta[:, pos:pos + n])
            pos += n
        n_k = self.q * (1 + self.p)
        return out[:n_k], out[n_k:n_k + self.p], out[-1]

    def covariance(self, g, pars, t):
        """(W, N, N) training covariance of GP g (nodes first)."""
        name = (self.nodes + self.weights)[g]
        r = t[:, None] - t[None, :]
        K = KERNELS[name][1](pars, r)
        k0 = KERNELS[name][1](pars, torch.zeros((1, 1), dtype=t.dtype,
                                                device=t.device))[:, 0, 0]
        nugget = torch.clamp(JITTER_MULT * torch.finfo(t.dtype).eps
                             * t.shape[0] * k0, min=TRAIN_NUGGET)
        return K + nugget[:, None, None] * torch.eye(
            t.shape[0], dtype=t.dtype, device=t.device)

    def mean_values(self, mean_pars, t):
        W = mean_pars[0].shape[0]
        return torch.stack([
            torch.zeros(W, t.shape[0], dtype=t.dtype, device=t.device)
            if m is None else MEANS[m][1](mp, t)
            for m, mp in zip(self.means, mean_pars)], dim=1)


def initial_state(model, theta, y):
    """The heuristic start (mu, var), each (W, N q (p + 1))."""
    q, p, N = model.q, model.p, y.shape[-1]
    kpars, _, jit = model.split(theta)
    W = theta.shape[0]
    a1 = torch.stack([kpars[j][:, 0] for j in range(q)], dim=1)     # (W, q)
    a2 = torch.stack([kpars[q + i][:, 0] for i in range(p)], dim=1)  # (W, p)
    mean1 = torch.zeros(W, q, N, dtype=y.dtype, device=y.device)
    mean2 = torch.zeros(W, q, p, N, dtype=y.dtype, device=y.device)
    for j in range(q):
        for i in range(p):
            mean1[:, j] += torch.sqrt(torch.abs(y[i]) * a1[:, j, None]
                                      / a2[:, i, None]) * torch.sign(y[i])
            mean2[:, j, i] = torch.sqrt(torch.abs(y[i]) * a2[:, i, None]
                                        / a1[:, j, None])
    mean1 = mean1 / p
    var1 = jit.mean(dim=1)[:, None].expand(W, q * N)
    var2 = jit[:, None, :, None].expand(W, q, p, N)
    mu = torch.cat([mean1.reshape(W, -1), mean2.reshape(W, -1)], dim=1)
    var = torch.cat([var1.reshape(W, -1), var2.reshape(W, -1)], dim=1)
    return mu, var


def _split_state(model, u, N):
    q, p, W = model.q, model.p, u.shape[0]
    return u[:, :q * N].reshape(W, q, N), u[:, q * N:].reshape(W, p, q, N)


def _posterior(K, d, r):
    """mu, diag Sigma, log det Sigma and Sigma for Sigma = D - D (K + D)^-1 D,
    D = diag(d), mu = Sigma r (all batched over rows)."""
    A = K + torch.diag_embed(d)
    Ainv = torch.cholesky_inverse(torch.linalg.cholesky(A))
    del A
    S = torch.diag_embed(d) - d[:, :, None] * Ainv * d[:, None, :]
    del Ainv
    mu = (S @ r[:, :, None])[:, :, 0]
    logdet = 2 * torch.log(torch.diagonal(torch.linalg.cholesky(S),
                                          dim1=-2, dim2=-1)).sum(-1)
    return mu, torch.diagonal(S, dim1=-2, dim2=-1).clone(), logdet, S


def _trace_solve(L, S):
    """tr(K^-1 S) for K = L L^T."""
    return torch.diagonal(torch.cholesky_solve(S, L), dim1=-2,
                          dim2=-1).sum(-1)


class Fit:
    """A fit of W rows of theta to the data (t, y, yerr2) on their device,
    one GP at a time."""

    def __init__(self, model, theta, t, y, yerr2):
        self.model, self.t, self.y = model, t, y
        q, p = model.q, model.p
        kpars, mpars, jit = model.split(theta)
        self.K = [model.covariance(g, kpars[g], t) for g in range(q + q * p)]
        self.L = [torch.linalg.cholesky(K) for K in self.K]
        self.y_c = y[None] - model.mean_values(mpars, t)        # (W, p, N)
        self.variance = jit[:, :, None] ** 2 + yerr2[None]      # (W, p, N)

    def sweep(self, muF, varF, muW, varW):
        """One coordinate-ascent sweep: the ELBO at the new state and the
        state (mu_f, var_f (W, q, N), mu_w, var_w (W, p, q, N))."""
        m, y_c, var = self.model, self.y_c, self.variance
        q, p, N = m.q, m.p, self.t.shape[0]
        # node updates (eqs. 16-17): precision dv and information vector
        vw = var[:, :, None, :]                                 # (W,p,1,N)
        dv = ((muW ** 2 + varW) / vw).sum(1)                    # (W, q, N)
        fit_all = torch.einsum("wpqn,wqn->wpn", muW, muF)
        pred = torch.zeros_like(muF)
        for j in range(q):
            for i in range(p):
                resid = y_c[:, i] - fit_all[:, i] + muW[:, i, j] * muF[:, j]
                pred[:, j] += resid * muW[:, i, j] / var[:, i]
        mu_f, var_f = torch.zeros_like(muF), torch.zeros_like(muF)
        logdet, node_S = [], []
        for j in range(q):
            mu, dS, ld, S = _posterior(self.K[j], 1.0 / dv[:, j], pred[:, j])
            mu_f[:, j], var_f[:, j] = mu, dS
            logdet.append(ld)
            node_S.append(S if q > 1 else None)
        # weight updates (eqs. 18-19), with the new nodes and the old weights
        dv2 = mu_f ** 2 + var_f
        fit_all = torch.einsum("wpqn,wqn->wpn", muW, mu_f)
        mu_w, var_w = torch.zeros_like(muW), torch.zeros_like(muW)
        for j in range(q):
            for i in range(p):
                resid = y_c[:, i] - fit_all[:, i] + muW[:, i, j] * mu_f[:, j]
                ratio = var[:, i] / dv2[:, j]
                mu, dS, ld, _ = _posterior(self.K[q + j * p + i], ratio,
                                           resid * mu_f[:, j] / var[:, i])
                mu_w[:, i, j], var_w[:, i, j] = mu, dS
                logdet.append(ld)
        elbo = self._elbo(mu_f, var_f, mu_w, var_w, dv, logdet, node_S)
        return elbo, mu_f, var_f, mu_w, var_w

    def _elbo(self, mu_f, var_f, mu_w, var_w, dv, logdet, node_S):
        m, var = self.model, self.variance
        q, p, N = m.q, m.p, self.t.shape[0]
        W = mu_f.shape[0]
        G = q * (1 + p)
        ent = 0.5 * sum(logdet) + 0.5 * G * N * (1 + LOG_2PI)
        # prior: the weight means read raw as (q p, N)
        mus = [mu_f[:, j] for j in range(q)] + list(
            mu_w.reshape(W, q * p, N).unbind(1))
        logp = -0.5 * N * G * LOG_2PI
        for g in range(G):
            L = self.L[g]
            half_logdet_K = torch.log(torch.diagonal(L, dim1=-2,
                                                     dim2=-1)).sum(-1)
            mKm = (mus[g] * torch.cholesky_solve(mus[g][:, :, None],
                                                 L)[:, :, 0]).sum(-1)
            if g < q:
                # tr(K_j^-1 Sigma_j) = N - tr(D_j^-1 Sigma_j), and the
                # earlier nodes' Sigma_k by a solve
                tr = N - (var_f[:, g] * dv[:, g]).sum(-1)
                for k in range(g):
                    tr = tr + _trace_solve(L, node_S[k])
            else:
                a = g - q
                j, i = divmod(a, p)
                ratio = var[:, i] / (mu_f[:, j] ** 2 + var_f[:, j])
                tr = N - (var_w[:, i, j] / ratio).sum(-1)
            logp = logp - half_logdet_K - 0.5 * (mKm + tr)
        # likelihood, on the raw data
        y = self.y[None]
        res = y - torch.einsum("wpqn,wqn->wpn", mu_w, mu_f)
        logl = -0.5 * torch.log(2 * math.pi * var).sum((-2, -1)) \
            - 0.5 * (res ** 2 / var).sum((-2, -1))
        for j in range(q):
            for i in range(p):
                logl = logl - 0.5 * ((
                    var_f[:, j] * mu_w[:, i, j] ** 2
                    + var_w[:, i, j] * mu_f[:, j] ** 2
                    + var_f[:, j] * var_w[:, i, j]) / var[:, i]).sum(-1)
        return (logl + logp + ent) / q


def _stops(hist):
    """The reference rule on the last three ELBO values of each row."""
    h = torch.stack(hist[-3:], dim=1)
    crit = torch.abs(torch.std(h, dim=1, correction=0) / torch.mean(h, dim=1))
    return (crit < 1e-3) & (crit != 0)


def elbo_fit(model, theta, t, y, yerr2, max_iter, start=None):
    """Each row's fit under the reference rule, to at most ``max_iter``
    sweeps, from ``start`` = (mu0, var0) (W, d) where given, else from the
    heuristic start: ``(elbo (W,), mu (W, d), var (W, d), n_iter (W,),
    converged (W,))``, each row as it stood at the sweep where it stopped,
    ``converged`` where the rule stopped it.  Rows that stopped sweep on
    with the others and are not read again."""
    N = t.shape[0]
    fit = Fit(model, theta, t, y, yerr2)
    mu0, var0 = initial_state(model, theta, y) if start is None else start
    muF, muW = _split_state(model, mu0, N)
    varF, varW = _split_state(model, var0, N)
    W = theta.shape[0]
    out_elbo = torch.full((W,), float("nan"), dtype=t.dtype, device=t.device)
    out_mu, out_var = mu0.clone(), var0.clone()
    n_iter = torch.zeros(W, dtype=torch.int64, device=t.device)
    done = torch.zeros(W, dtype=torch.bool, device=t.device)
    converged = torch.zeros_like(done)
    hist = []
    for it in range(1, max_iter + 1):
        elbo, muF, varF, muW, varW = fit.sweep(muF, varF, muW, varW)
        hist.append(elbo)
        stop = _stops(hist) if it > 3 else torch.zeros_like(done)
        take = ~done & (stop | (it == max_iter))
        out_elbo = torch.where(take, elbo, out_elbo)
        out_mu[take] = torch.cat([muF.reshape(W, -1), muW.reshape(W, -1)],
                                 dim=1)[take]
        out_var[take] = torch.cat([varF.reshape(W, -1),
                                   varW.reshape(W, -1)], dim=1)[take]
        n_iter = torch.where(take, torch.full_like(n_iter, it), n_iter)
        converged = converged | (take & stop)
        done = done | take
        if bool(done.all()):
            break
    return out_elbo, out_mu, out_var, n_iter, converged


def walker_states(model, walkers, t, y, yerr2, max_iter):
    """The ensemble sampler's cached states of ``walkers``: each walker's
    fit from the heuristic start where it converged, else that start."""
    mu0, var0 = initial_state(model, walkers, y)
    _, mu, var, _, conv = elbo_fit(model, walkers, t, y, yerr2, max_iter)
    keep = conv[:, None]
    return torch.where(keep, mu, mu0), torch.where(keep, var, var0)
