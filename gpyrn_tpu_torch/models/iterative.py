"""GPRN posterior prediction and prior samples through matrix-free CG and
Lanczos: the N ≫ 20k path.

Port of :mod:`gpyrn_tpu.models.iterative`.  ``engine.predict`` factors
every GP of the q·(1+p) lattice densely (O(B·N²) memory); here each GP's
conditional comes from :mod:`gpyrn_tpu_torch.ops.iterative`'s chunked
kernel matvecs and conjugate gradients (O(N·chunk) memory), on the
inference's device in float64:

* :func:`predict_iterative`: per-GP CG solves (Jacobi preconditioner),
  the variances one batched solve per ``rhs_chunk`` test points;
* :func:`build_love` / :class:`LovePredictor`: the LOVE cache, a rank-k
  Lanczos factor per GP, after which a variance costs one small product;
* :func:`sample_iterative`: prior draws K^(1/2) ξ by Lanczos, ξ from
  numpy (the JAX package's draws, given the same ``rng``).

The combine formula and the noise conventions are ``engine.predict``'s
(PREDICT_NUGGET 1.25e-12, jitter² added q times).  Like the port's
``predict``, the results are tensors on the inference's device, tstar a
numpy array.  With ``mesh=`` each CG solve of ``predict_iterative`` runs
through :func:`gpyrn_tpu_torch.parallel.cg_solve_sharded`, the matvec's
rows split over the mesh's ``dp`` axis (called by every rank).
"""
from __future__ import annotations

import numpy as np
import torch

from gpyrn_tpu_torch.models.gprn import unpack_parameters
from gpyrn_tpu_torch.ops import blocked as _blocked
from gpyrn_tpu_torch.ops.iterative import (cg_solve, kernel_matvec,
                                           lanczos_vectors, msqrt_apply)
from gpyrn_tpu_torch.ops.kernels import evaluate as _keval, is_nonstationary
from gpyrn_tpu_torch.ops.linalg import PREDICT_NUGGET, cross_kernel_matrix
from gpyrn_tpu_torch.parallel.iterative_sharded import cg_solve_sharded

__all__ = ["predict_iterative", "LovePredictor", "build_love",
           "sample_iterative"]


def _k0(structure, params):
    """k(0), the Jacobi preconditioner's kernel part (1 for the
    non-stationary kernels)."""
    if is_nonstationary(structure):
        return 1.0
    return float(_keval(structure, params, r=params.new_zeros(())))


def _kss(structure, params, tstar, k0):
    """diag K(t*, t*) + PREDICT_NUGGET, elementwise."""
    if is_nonstationary(structure):
        return torch.broadcast_to(
            _keval(structure, params, r=torch.zeros_like(tstar), t1=tstar,
                   t2=tstar), tstar.shape) + PREDICT_NUGGET
    return torch.full_like(tstar, k0 + PREDICT_NUGGET)


def _gp_matvec(structure, params, t, v_row):
    """x ↦ (K + PREDICT_NUGGET·I + diag(v_row)) x, matrix-free."""
    def matvec(x):
        base = kernel_matvec(structure, params, t, x, nugget=PREDICT_NUGGET)
        return base + (v_row[:, None] * x if x.ndim == 2 else v_row * x)
    return matvec


def _gp_conditional_cg(structure, params, t, m_row, v_row, tstar, tol,
                       maxiter, rhs_chunk, want_var, mesh=None):
    """Mean and (optionally) variance of one GP's conditional
    N(K* A⁻¹ m, diag(K** − K* A⁻¹ K*ᵀ)), A = K + diag(v) + nugget·I, every
    solve a Jacobi-preconditioned CG on chunked matvecs; with ``mesh``,
    :func:`cg_solve_sharded` over its ``dp`` axis."""
    k0 = _k0(structure, params)
    precond = k0 + v_row
    matvec = _gp_matvec(structure, params, t, v_row)

    def solve(rhs):
        if mesh is not None:
            x, _ = cg_solve_sharded(structure, params, t, rhs, mesh,
                                    d_add=v_row, nugget=PREDICT_NUGGET,
                                    tol=tol, maxiter=maxiter)
            return x
        x, _ = cg_solve(matvec, rhs, tol=tol, maxiter=maxiter,
                        precond_diag=precond)
        return x

    Kstar = cross_kernel_matrix(structure, params, tstar, t)     # (n*, N)
    mean = Kstar @ solve(m_row)
    if not want_var:
        return mean, None
    kss = _kss(structure, params, tstar, k0)
    var = torch.cat([
        kss[s0:s0 + rhs_chunk] - torch.sum(
            Kstar[s0:s0 + rhs_chunk].T * solve(
                Kstar[s0:s0 + rhs_chunk].T.contiguous()), dim=0)
        for s0 in range(0, tstar.shape[0], rhs_chunk)])
    return mean, var


def _lattice_rows(gprn):
    """(structure, core params, mu row, var row) per lattice GP in the
    engine's prediction order (q nodes, then the weights in i·q+j
    order), on the inference's device."""
    q, p, N = gprn.q, gprn.p, gprn.N
    mu = gprn._mu.reshape(-1)
    var = gprn._var.reshape(-1)
    muF, muW = mu[:q * N].reshape(q, N), mu[q * N:].reshape(p, q, N)
    varF, varW = var[:q * N].reshape(q, N), var[q * N:].reshape(p, q, N)
    rows = [(node.structure, gprn._tensor(node.core_params()), muF[j],
             varF[j]) for j, node in enumerate(gprn.nodes)]
    for j in range(q):
        for i in range(p):
            wk = gprn.weights[j * p + i]
            rows.append((wk.structure, gprn._tensor(wk.core_params()),
                         muW[i, j], varW[i, j]))
    return rows


def _tstar(gprn, tstar, nn):
    if tstar is None:
        t = gprn.time
        ptp = np.ptp(t)
        tstar = np.linspace(t.min() - 0.2 * ptp, t.max() + 0.2 * ptp, nn)
    return np.atleast_1d(np.asarray(tstar, dtype=float))


def _require_state(gprn):
    gprn._require_components()
    if gprn._mu is None:
        raise ValueError("no variational state: run ELBOcalc first")


def _combine_lattice(gprn, tstar, means, vars_):
    """Lattice conditionals → per-output predictive (the reference's
    combine formula): ``(tstar, mean (n*, p), std (n*, p), (node_pred,
    weight_pred))``."""
    q, p = gprn.q, gprn.p
    n_pred, n_var = means[:q], vars_[:q]
    w_pred = means[q:].reshape(q, p, -1)
    w_var = vars_[q:].reshape(q, p, -1)
    theta = gprn._theta()
    _, _, _, jitters = unpack_parameters(gprn.engine.spec, theta)
    m_star = gprn.engine._mean_values(theta, gprn._tensor(tstar))  # (p, n*)
    mean_out = m_star.T + torch.einsum("qn,qpn->np", n_pred, w_pred)
    var_out = torch.einsum(
        "qpn->np",
        w_pred ** 2 * n_var[:, None, :] +
        w_var * (n_var[:, None, :] + n_pred[:, None, :] ** 2)) \
        + q * (jitters ** 2)[None, :]
    std_out = torch.sqrt(torch.clamp(var_out, min=0.0))
    return tstar, mean_out, std_out, (n_pred, w_pred.reshape(q * p, -1))


def predict_iterative(gprn, tstar=None, nn: int = 1000, tol: float = 1e-8,
                      maxiter: int = 2000, rhs_chunk: int = 64,
                      variances: bool = True, mesh=None):
    """Posterior predictive per output via matrix-free CG solves, with
    ``inference.predict``'s return convention ``(tstar, mean (n*, p),
    std (n*, p), (node_preds, weight_preds))``; std is zeros when
    ``variances=False``.  ``mesh``: every solve's matvec rows split over
    its ``dp`` axis (:func:`cg_solve_sharded`; every rank calls)."""
    _require_state(gprn)
    tstar = _tstar(gprn, tstar, nn)
    t, ts = gprn._tensor(gprn.time), gprn._tensor(tstar)
    means, vars_ = [], []
    for structure, params, m_row, v_row in _lattice_rows(gprn):
        mean_b, var_b = _gp_conditional_cg(structure, params, t, m_row,
                                           v_row, ts, tol, maxiter,
                                           rhs_chunk, variances, mesh)
        means.append(mean_b)
        vars_.append(var_b if var_b is not None
                     else torch.zeros_like(mean_b))
    return _combine_lattice(gprn, tstar, torch.stack(means),
                            torch.stack(vars_))


class LovePredictor:
    """Predictive variances from a one-off Lanczos cache (LOVE, Pleiss et
    al. 2018, on the GPRN lattice).

    Per lattice GP, :func:`build_love` runs ``rank`` fully re-orthogonalized
    Lanczos steps on A = K + diag(v) + nugget·I and keeps
    R = L_T⁻¹ Q (rank, N), T = Q A Qᵀ = L_T L_Tᵀ, so that
    k*ᵀ A⁻¹ k* ≈ ‖R k*‖²: one product per call, no solves.  The mean uses
    the cached CG solve α = A⁻¹ m.  The cache belongs to the state it was
    built from."""

    def __init__(self, gprn, rows, t):
        self._rows = rows           # per-GP dicts: structure, params, …
        self._t = t
        self.q, self.p = gprn.q, gprn.p
        self._gprn = gprn

    def predict(self, tstar=None, nn: int = 1000, variances: bool = True):
        """:func:`predict_iterative`'s return convention."""
        g = self._gprn
        tstar = _tstar(g, tstar, nn)
        ts = g._tensor(tstar)
        means, vars_ = [], []
        for row in self._rows:
            Kstar = cross_kernel_matrix(row["structure"], row["params"], ts,
                                        self._t)              # (n*, N)
            mean = Kstar @ row["alpha"]
            if variances:
                V = row["R"] @ Kstar.T                         # (rank, n*)
                kss = _kss(row["structure"], row["params"], ts, row["k0"])
                var = torch.clamp(kss - torch.sum(V * V, dim=0), min=0.0)
            else:
                var = torch.zeros_like(mean)
            means.append(mean)
            vars_.append(var)
        return _combine_lattice(g, tstar, torch.stack(means),
                                torch.stack(vars_))


def build_love(gprn, rank: int = 100, tol: float = 1e-8,
               maxiter: int = 2000) -> LovePredictor:
    """The LOVE cache of the current variational state: one CG solve (the
    mean's α) and ``rank`` Lanczos steps per lattice GP."""
    _require_state(gprn)
    t = gprn._tensor(gprn.time)
    rows = []
    for structure, params, m_row, v_row in _lattice_rows(gprn):
        k0 = _k0(structure, params)
        matvec = _gp_matvec(structure, params, t, v_row)
        alpha, _ = cg_solve(matvec, m_row, tol=tol, maxiter=maxiter,
                            precond_diag=k0 + v_row)
        # the Lanczos start: the mean's right-hand side when informative,
        # else ones
        v0 = torch.where(torch.linalg.vector_norm(m_row) > 1e-12, m_row,
                         torch.ones_like(m_row))
        Q, al, be = lanczos_vectors(matvec, v0, min(rank, t.shape[0]))
        T = torch.diag(al) + torch.diag(be[:-1], 1) + torch.diag(be[:-1], -1)
        L_T = _blocked.cholesky_nan(T)
        R = torch.linalg.solve_triangular(L_T, Q, upper=False)   # (k, N)
        rows.append({"structure": structure, "params": params,
                     "alpha": alpha, "R": R, "k0": k0})
    return LovePredictor(gprn, rows, t)


def sample_iterative(gprn, time=None, rng=None, n_steps: int = 64):
    """Prior samples of all node and weight functions, matrix-free: each
    draw is K^(1/2) ξ through :func:`msqrt_apply` (``n_steps`` chunked
    matvecs on the inference's device), ξ from the numpy ``rng`` in the
    JAX package's order.  Returns numpy arrays ``(node_samples (q, n),
    weight_samples (q·p, n))``, as ``inference.sample`` does."""
    gprn._require_components()
    rng = np.random.default_rng() if rng is None else rng
    t = gprn._tensor(gprn.time if time is None else time)
    nodes, weights, _, _ = gprn._get_components()

    def draw(kernel):
        pars = gprn._tensor(kernel.core_params())
        # the dense ``sample`` adds PREDICT_NUGGET on the stationary
        # branch only (a reference quirk), and so does this
        nug = 0.0 if is_nonstationary(kernel.structure) else PREDICT_NUGGET

        def mv(x):
            return kernel_matvec(kernel.structure, pars, t, x, nugget=nug)
        xi = gprn._tensor(rng.standard_normal(t.shape[0]))
        return msqrt_apply(mv, xi, n_steps=n_steps).cpu().numpy()

    return (np.array([draw(n) for n in nodes]),
            np.array([draw(w) for w in weights]))
