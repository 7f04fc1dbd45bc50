"""Plain PyTorch GPRN mean-field fit: the benchmark's reference.

Written from the model's equations (Nguyen & Bonilla 2013, eqs. 16-19, and
the reference gpyrn's ELBO conventions), independently of the package under
test: it imports nothing of it, and takes its kernels and means from the
component files of :mod:`components`.  Each GP's posterior

    Sigma = (K^-1 + D^-1)^-1 = D - D A^-1 D,   A = K + D,   mu = Sigma r,

comes from the Cholesky factor of A: mu = d r - d A^-1 (d r), and
diag Sigma = d - d^2 diag(A^-1) from the columns of A's inverse factor.
log det Sigma comes from the determinant lemma,

    log det Sigma = log det K + sum log d - log det A,

from the factors of K and A that the prior and the update form anyway:
a Cholesky of Sigma would form Sigma as one more N x N matrix and factor
it, N^3 / 3 more a GP and sweep.  The conventions of the reference gpyrn
that the ELBO keeps:

* training covariance K + max(1e-6, 4 eps tr K) I (eps of the dtype),
  unless the kernel's component file says the package adds none;
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

**Memory.**  Every function takes a leading row axis W (one row per
hyperparameter vector).  A row holds the N x N matrices of one GP at a
time: its covariance, built in blocks of rows and turned into A in place,
and A's factor; A's inverse factor is taken in blocks of columns.  Only
for q > 1 are the first q - 1 nodes' Sigma kept, for the cross traces
(which are taken in blocks of columns too).  The prior's factor of K is
formed again, one GP at a time, where the ELBO needs it.  Rows are fitted
in chunks whose working set fits in ``MEMORY_SHARE`` of the free memory
(all rows at once at N = 1000).  So one row holds q + 1 N x N matrices at
its peak: two at N = 50,000, q = 1, and three at q = 2.
"""
from __future__ import annotations

import math

import torch

from h100_bench.reference import components

LOG_2PI = math.log(2 * math.pi)
TRAIN_NUGGET = 1e-6
JITTER_MULT = 4.0
# the largest block of rows or columns (W x N x b) formed at once; a
# kernel's formula holds a few such blocks alive while it is evaluated
BLOCK_BYTES = 1 << 29
# of the device's free memory, what a chunk of rows may take; the rest is
# room for the blocks and the libraries' workspace
MEMORY_SHARE = 0.75


def free_bytes(device):
    """The memory free for the reference on ``device``: the card's free
    memory and what torch's allocator holds unused; None off a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device)


def _blocks(W, N, dtype):
    """Slices [s, e) of at most ``BLOCK_BYTES`` / (W N itemsize) of N."""
    itemsize = torch.finfo(dtype).bits // 8
    b = max(1, BLOCK_BYTES // (W * N * itemsize))
    return [(s, min(s + b, N)) for s in range(0, N, b)]


class Model:
    """The structure of a configuration: q nodes, q p weights (node-major),
    p means (None for zero) and p jitters, in the parameter order
    nodes, weights, means, jitters; the components from their files."""

    def __init__(self, config):
        self.q, self.p = int(config["q"]), int(config["p"])
        self.kernels = [components.Kernel(c)
                        for c in config["nodes"] + config["weights"]]
        self.means = [None if c is None else components.Mean(c)
                      for c in config["means"]]
        if len(config["nodes"]) != self.q \
                or len(config["weights"]) != self.q * self.p \
                or len(self.means) != self.p:
            raise ValueError("a configuration has q nodes, q p weights and "
                             "p means")
        sizes = [k.n_parameters for k in self.kernels]
        sizes += [0 if m is None else m.n_parameters for m in self.means]
        self.sizes = sizes + [self.p]

    @property
    def n_parameters(self):
        return sum(self.sizes)

    @property
    def n_gps(self):
        return self.q * (1 + self.p)

    def split(self, theta):
        """(kernel parameter blocks, mean parameter blocks, jitters) of
        theta (W, n_parameters)."""
        out, pos = [], 0
        for n in self.sizes:
            out.append(theta[:, pos:pos + n])
            pos += n
        n_k = self.n_gps
        return out[:n_k], out[n_k:n_k + self.p], out[-1]

    def covariance(self, g, pars, t):
        """(W, N, N) training covariance of GP g (nodes first), built in
        blocks of rows."""
        kernel, W, N = self.kernels[g], pars.shape[0], t.shape[0]
        K = torch.empty(W, N, N, dtype=t.dtype, device=t.device)
        for s, e in _blocks(W, N, t.dtype):
            K[:, s:e] = kernel.value(pars, t[s:e], t)
        if kernel.nugget:
            diag = torch.diagonal(K, dim1=-2, dim2=-1)
            nugget = torch.clamp(JITTER_MULT * torch.finfo(t.dtype).eps
                                 * diag.sum(-1), min=TRAIN_NUGGET)
            diag.add_(nugget[:, None])
        return K

    def mean_values(self, mean_pars, t):
        W = mean_pars[0].shape[0]
        return torch.stack([
            torch.zeros(W, t.shape[0], dtype=t.dtype, device=t.device)
            if m is None else m.value(mp, t)
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


def _trace_solve(L, S):
    """tr(K^-1 S) for K = L L^T, in blocks of S's columns."""
    W, N = S.shape[0], S.shape[-1]
    tr = torch.zeros(W, dtype=S.dtype, device=S.device)
    for s, e in _blocks(W, N, S.dtype):
        Y = torch.cholesky_solve(S[:, :, s:e], L)
        tr = tr + torch.diagonal(Y[:, s:e], dim1=-2, dim2=-1).sum(-1)
    return tr


class Fit:
    """A fit of W rows of theta to the data (t, y, yerr2) on their device,
    one GP at a time."""

    def __init__(self, model, theta, t, y, yerr2):
        self.model, self.t, self.y = model, t, y
        self.kpars, mpars, jit = model.split(theta)
        self.y_c = y[None] - model.mean_values(mpars, t)        # (W, p, N)
        self.variance = jit[:, :, None] ** 2 + yerr2[None]      # (W, p, N)

    def prior_factor(self, g):
        """The Cholesky factor of GP g's training covariance (W, N, N)."""
        return torch.linalg.cholesky(self.model.covariance(g, self.kpars[g],
                                                           self.t))

    def posterior(self, g, d, r, with_sigma=False):
        """GP g's update for D = diag(d) and the information vector r:
        mu, diag Sigma, sum log d - log det A (the part of log det Sigma
        beside log det K) and, ``with_sigma``, Sigma itself."""
        A = self.model.covariance(g, self.kpars[g], self.t)
        torch.diagonal(A, dim1=-2, dim2=-1).add_(d)
        L = torch.linalg.cholesky(A)
        del A
        part = torch.log(d).sum(-1) - 2 * torch.log(
            torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        dr = d * r
        mu = dr - d * torch.cholesky_solve(dr[:, :, None], L)[:, :, 0]
        W, N = d.shape
        inv_diag = torch.empty_like(d)                          # diag A^-1
        S = torch.empty_like(L) if with_sigma else None
        for s, e in _blocks(W, N, d.dtype):
            E = torch.zeros(W, N, e - s, dtype=d.dtype, device=d.device)
            torch.diagonal(E[:, s:e], dim1=-2, dim2=-1).fill_(1.0)
            X = torch.linalg.solve_triangular(L, E, upper=False)
            del E
            inv_diag[:, s:e] = (X ** 2).sum(-2)
            if S is not None:
                Ainv = torch.linalg.solve_triangular(L.mT, X, upper=True)
                S[:, :, s:e] = -d[:, :, None] * Ainv * d[:, None, s:e]
        if S is not None:
            torch.diagonal(S, dim1=-2, dim2=-1).add_(d)
        return mu, d - d ** 2 * inv_diag, part, S

    def sweep(self, muF, varF, muW, varW):
        """One coordinate-ascent sweep: the ELBO at the new state and the
        state (mu_f, var_f (W, q, N), mu_w, var_w (W, p, q, N))."""
        m, y_c, var = self.model, self.y_c, self.variance
        q, p = m.q, m.p
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
        parts, node_S = [], []
        for j in range(q):
            mu, dS, part, S = self.posterior(j, 1.0 / dv[:, j], pred[:, j],
                                             with_sigma=j < q - 1)
            mu_f[:, j], var_f[:, j] = mu, dS
            parts.append(part)
            node_S.append(S)
        # weight updates (eqs. 18-19), with the new nodes and the old weights
        dv2 = mu_f ** 2 + var_f
        fit_all = torch.einsum("wpqn,wqn->wpn", muW, mu_f)
        mu_w, var_w = torch.zeros_like(muW), torch.zeros_like(muW)
        for j in range(q):
            for i in range(p):
                resid = y_c[:, i] - fit_all[:, i] + muW[:, i, j] * mu_f[:, j]
                ratio = var[:, i] / dv2[:, j]
                mu, dS, part, _ = self.posterior(
                    q + j * p + i, ratio, resid * mu_f[:, j] / var[:, i])
                mu_w[:, i, j], var_w[:, i, j] = mu, dS
                parts.append(part)
        elbo = self._elbo(mu_f, var_f, mu_w, var_w, dv, parts, node_S)
        return elbo, mu_f, var_f, mu_w, var_w

    def _elbo(self, mu_f, var_f, mu_w, var_w, dv, parts, node_S):
        m, var = self.model, self.variance
        q, p, N = m.q, m.p, self.t.shape[0]
        W = mu_f.shape[0]
        G = m.n_gps
        # entropy: 1/2 sum_g log det Sigma_g, log det K_g added below
        ent = 0.5 * sum(parts) + 0.5 * G * N * (1 + LOG_2PI)
        # prior: the weight means read raw as (q p, N)
        mus = [mu_f[:, j] for j in range(q)] + list(
            mu_w.reshape(W, q * p, N).unbind(1))
        logp = -0.5 * N * G * LOG_2PI
        for g in range(G):
            L = self.prior_factor(g)
            half_logdet_K = torch.log(torch.diagonal(L, dim1=-2,
                                                     dim2=-1)).sum(-1)
            ent = ent + half_logdet_K
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
            del L
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


def chunking(model, W, N, dtype, free):
    """The rows a chunk holds, of W rows with ``free`` bytes free (None:
    all rows).  A row's working set is q + 1 N x N matrices: A and its
    factor, or K and its factor, beside the q - 1 kept node Sigma."""
    if free is None:
        return W
    matrix = N * N * torch.finfo(dtype).bits // 8
    return max(1, min(W, int(MEMORY_SHARE * free
                             // ((model.q + 1) * matrix))))


def _fit_rows(model, theta, t, y, yerr2, max_iter, start):
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


def elbo_fit(model, theta, t, y, yerr2, max_iter, start=None):
    """Each row's fit under the reference rule, to at most ``max_iter``
    sweeps, from ``start`` = (mu0, var0) (W, d) where given, else from the
    heuristic start: ``(elbo (W,), mu (W, d), var (W, d), n_iter (W,),
    converged (W,))``, each row as it stood at the sweep where it stopped,
    ``converged`` where the rule stopped it.  Rows that stopped sweep on
    with the others of their chunk and are not read again."""
    W = theta.shape[0]
    rows = chunking(model, W, t.shape[0], t.dtype, free_bytes(t.device))
    outs = []
    for s in range(0, W, rows):
        part = None if start is None else (start[0][s:s + rows],
                                           start[1][s:s + rows])
        outs.append(_fit_rows(model, theta[s:s + rows], t, y, yerr2,
                              max_iter, part))
    return tuple(torch.cat(o) for o in zip(*outs))


def walker_states(model, walkers, t, y, yerr2, max_iter):
    """The ensemble sampler's cached states of ``walkers``: each walker's
    fit from the heuristic start where it converged, else that start."""
    mu0, var0 = initial_state(model, walkers, y)
    _, mu, var, _, conv = elbo_fit(model, walkers, t, y, yerr2, max_iter)
    keep = conv[:, None]
    return torch.where(keep, mu, mu0), torch.where(keep, var, var0)
