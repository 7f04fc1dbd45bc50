"""GPRN mean-field variational inference — engine on torch tensors.

Port of the fit, gradient and prediction subset of
:mod:`gpyrn_tpu.models.gprn`: the closed-form coordinate-ascent sweep
(eqs. 16–19 of Nguyen & Bonilla 2013) batched over the q-node and
(q × p)-weight lattice, the three ELBO terms, the reference stopping rule,
the fixed-count sweeps and their gradient, and the posterior predictive.
The JAX package fuses the fit into one ``lax.while_loop``; here it is an
eager Python loop whose only host synchronisation is the stopping test,
once per sweep.  The fixed-count sweeps are a plain loop (the JAX
package's masked power-of-two sweep bucketing is a compile-count device
of XLA and is not ported), differentiated by autograd.

Numerical-parity notes (the JAX package's, ``gpyrn_tpu/models/gprn.py:16-33``):

* training nugget 1e-6, prediction nugget 1.25e-12;
* the expected-log-prior accumulates ``sumSigmaF`` *cumulatively* over
  nodes — node j's trace term includes Σ_{k≤j} Σ_f^{(k)};
* the expected-log-prior reinterprets the (p,q,N) weight means as (q,p,N)
  with a raw reshape, not a transpose;
* the expected-log-likelihood's quadratic term uses the *raw* data, not
  the mean-subtracted vector handed to the sweep;
* the ELBO is divided by q;
* convergence: relative std of the last three ELBO values < 1e-3, first
  checked after sweep 4;
* the heuristic mu/var initialisation uses only the first p weight
  amplitudes and flattens (q,p,N)-ordered weight means into the engine's
  (p,q,N) layout with a raw reshape.

Every function takes tensors on one device and computes in their dtype.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gpyrn_tpu_torch.ops import blocked as _blocked
from gpyrn_tpu_torch.ops import means as means_mod
from gpyrn_tpu_torch.ops.linalg import (PREDICT_NUGGET, TRAIN_NUGGET,
                                        cross_kernel_matrix, kernel_diag,
                                        kernel_matrix_stack)

__all__ = [
    "GPRNSpec", "spec_from_components", "pack_parameters",
    "unpack_parameters", "Engine",
]

LOG_2PI = math.log(2 * math.pi)


class GPRNSpec(NamedTuple):
    """Static description of a GPRN model (hashable).

    node_structs:   q kernel structure trees
    weight_structs: q·p kernel structure trees, node-major ([j*p + i])
    mean_structs:   p mean structure trees (None = zero mean)
    n_node_pars / n_weight_pars / n_mean_pars: trainable parameter counts
    """
    q: int
    p: int
    N: int
    node_structs: Tuple
    weight_structs: Tuple
    mean_structs: Tuple
    n_node_pars: Tuple[int, ...]
    n_weight_pars: Tuple[int, ...]
    n_mean_pars: Tuple[int, ...]

    @property
    def n_parameters(self) -> int:
        return (sum(self.n_node_pars) + sum(self.n_weight_pars) +
                sum(self.n_mean_pars) + self.p)

    @property
    def d(self) -> int:
        return self.N * self.q * (self.p + 1)


def spec_from_components(nodes, weights, means, N: int) -> GPRNSpec:
    """Build a spec from kernel/mean objects."""
    q = len(nodes)
    p = len(weights) // q
    mean_structs = tuple(None if m is None or isinstance(m, (int, float))
                         else m.structure for m in means)
    n_mean = tuple(0 if s is None else means_mod.n_params(s)
                   for s in mean_structs)
    return GPRNSpec(
        q=q, p=p, N=int(N),
        node_structs=tuple(n.structure for n in nodes),
        weight_structs=tuple(w.structure for w in weights),
        mean_structs=mean_structs,
        n_node_pars=tuple(n.pars.size for n in nodes),
        n_weight_pars=tuple(w.pars.size for w in weights),
        n_mean_pars=n_mean,
    )


def pack_parameters(nodes, weights, means, jitters) -> np.ndarray:
    """Flatten all trainable parameters in reference order
    nodes → weights → means → jitters."""
    chunks = [np.atleast_1d(np.asarray(k.pars, dtype=float))
              for k in list(nodes) + list(weights)]
    for m in means:
        if m is not None and not isinstance(m, (int, float)):
            chunks.append(np.atleast_1d(np.asarray(m.pars, dtype=float)))
    chunks.append(np.atleast_1d(np.asarray(jitters, dtype=float)))
    return np.concatenate(chunks)


def unpack_parameters(spec: GPRNSpec, theta):
    """Split a flat parameter tensor into per-component slices
    (node params, weight params, mean params, jitters)."""
    pos = 0
    node_p = []
    for n in spec.n_node_pars:
        node_p.append(theta[pos:pos + n])
        pos += n
    weight_p = []
    for n in spec.n_weight_pars:
        weight_p.append(theta[pos:pos + n])
        pos += n
    mean_p = []
    for n in spec.n_mean_pars:
        mean_p.append(theta[pos:pos + n])
        pos += n
    jitters = theta[pos:pos + spec.p]
    return node_p, weight_p, mean_p, jitters


def _cho_solve(L, b):
    """Solve (L Lᵀ) x = b for a batch of lower factors and vectors."""
    return torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)


class Engine:
    """Fit and prediction functions for one model structure.

    ``core_maps`` optionally carries per-kernel (trainable → core)
    parameter maps for kernels with static extras (QuasiHarmonicPeriodic):
    a pair (node maps, weight maps) of tuples of callables or None."""

    def __init__(self, spec: GPRNSpec, core_maps: Optional[Tuple] = None):
        self.spec = spec
        self.node_maps, self.weight_maps = (
            core_maps if core_maps is not None else (None, None))

    # ---- model-building helpers -------------------------------------------

    @staticmethod
    def _core(params_list, maps):
        if maps is None:
            return params_list
        return [m(pp) if m is not None else pp
                for m, pp in zip(maps, params_list)]

    def _build_matrices(self, theta, t):
        spec = self.spec
        node_p, weight_p, _, jitters = unpack_parameters(spec, theta)
        node_c = self._core(node_p, self.node_maps)
        weight_c = self._core(weight_p, self.weight_maps)
        Kf = kernel_matrix_stack(spec.node_structs, node_c, t, TRAIN_NUGGET)
        Kw_flat = kernel_matrix_stack(spec.weight_structs, weight_c, t,
                                      TRAIN_NUGGET)
        return Kf, Kw_flat, jitters

    def _mean_values(self, theta, t):
        _, _, mean_p, _ = unpack_parameters(self.spec, theta)
        rows = []
        for s, mp in zip(self.spec.mean_structs, mean_p):
            if s is None:
                rows.append(torch.zeros(t.shape, dtype=t.dtype,
                                        device=t.device))
            else:
                rows.append(means_mod.evaluate(s, mp, t))
        return torch.stack(rows)          # (p, n_t)

    # ---- heuristic initialisation -----------------------------------------

    def init_mu_var(self, theta, y):
        """(mu, var) starting state of the reference heuristic."""
        q, p, N = self.spec.q, self.spec.p, self.spec.N
        node_p, weight_p, _, jitters = unpack_parameters(self.spec, theta)
        a1 = torch.stack([pp[0] for pp in node_p])             # (q,)
        a2 = torch.stack([pp[0] for pp in weight_p[:p]])       # first p only
        ay = torch.abs(y)                                      # (p, N)
        # mean1[j] = mean_i sqrt(|y_i| a1_j / a2_i) sign(y_i)
        m1 = torch.sqrt(ay[None, :, :] * a1[:, None, None] /
                        a2[None, :, None]) * torch.sign(y)[None]  # (q,p,N)
        mean1 = torch.mean(m1, dim=1)                          # (q,N)
        # mean2[j,i] = sqrt(|y_i| a2_i / a1_j)
        mean2 = torch.sqrt(ay[None, :, :] * a2[None, :, None] /
                           a1[:, None, None])                  # (q,p,N)
        var1 = torch.mean(jitters).expand(q, N)
        var2 = jitters[None, :, None].expand(q, p, N)
        mu = torch.cat([mean1.reshape(-1), mean2.reshape(-1)])
        var = torch.cat([var1.reshape(-1), var2.reshape(-1)])
        return mu, var

    # ---- one coordinate-ascent sweep + ELBO (ELBOaux) ----------------------

    def _u_split(self, u):
        q, p, N = self.spec.q, self.spec.p, self.spec.N
        muF = u[:q * N].reshape(q, N)
        muW = u[q * N:].reshape(p, q, N)
        return muF, muW

    @staticmethod
    def _diag_sigma(d_add, dAinv, Kdiag):
        """diag Σ = d − d²·diag(A⁻¹) for Σ = K − K A⁻¹ K, A = K + diag(d),
        clamped to Σ's PSD-order envelopes Σ ⪯ diag(d), Σ ⪯ K."""
        d_sig = d_add - d_add * d_add * dAinv
        # maximum / minimum, not clamp: at a tie they split the gradient
        # in half between the two sides, as JAX's clip does
        tiny = d_sig.new_full((), torch.finfo(d_sig.dtype).tiny)
        return torch.minimum(torch.maximum(d_sig, tiny),
                             torch.minimum(Kdiag, d_add))

    def _sigma_apply(self, L, K, rhs, d_add, dAinv):
        """(Σ @ rhs, diag Σ) for Σ = K − K A⁻¹ K given chol L of
        A = K + diag(d_add) and diag(A⁻¹)."""
        Krhs = torch.einsum("bij,bj->bi", K, rhs)
        t1 = _cho_solve(L, Krhs)
        sig_rhs = Krhs - torch.einsum("bij,bj->bi", K, t1)
        d_sig = self._diag_sigma(d_add, dAinv,
                                 torch.diagonal(K, dim1=1, dim2=2))
        return sig_rhs, d_sig

    def _updates(self, Kf, Kw_flat, y_c, variance, muF, varF, muW, varW):
        """The coordinate-ascent updates (eqs. 16-19), Σ-free:

            μ          = K r − K A⁻¹ (K r)
            diag Σ     = d − d²·diag(A⁻¹),  d = diag(D⁻¹)

        Returns the new ``(mu_f, dSf, mu_w, dSw_qp)`` and the factors the
        ELBO terms reuse, ``(dv, inv_dv, Laf, dAinv_f, ratio, Law,
        dAinv_w)``.  Shapes: Kf (q,N,N), Kw_flat (q·p,N,N) [index j·p+i],
        y_c (p,N), variance (p,N), muF/varF (q,N), muW/varW (p,q,N)."""
        q, p, N = self.spec.q, self.spec.p, self.spec.N
        qp = q * p

        # -- node update (eqs. 16-17) --
        dv = torch.sum((muW * muW + varW) / variance[:, None, :], dim=0)
        inv_dv = 1.0 / dv
        Af = Kf + torch.diag_embed(inv_dv)
        Laf, dAinv_f = _blocked.blocked_chol_diag_ainv(Af)
        total = torch.einsum("pqn,qn->pn", muW, muF)
        resid = (y_c[None, :, :] - total[None, :, :] +
                 muW.permute(1, 0, 2) * muF[:, None, :])         # (q,p,N)
        pred = torch.einsum("qpn,pqn->qn", resid,
                            muW / variance[:, None, :])
        mu_f, dSf = self._sigma_apply(Laf, Kf, pred, inv_dv, dAinv_f)

        # -- weight update (eqs. 18-19); uses NEW mu_f, OLD muW --
        dv2 = mu_f * mu_f + dSf                                  # (q,N)
        ratio = (variance[None, :, :] /
                 dv2[:, None, :]).reshape(qp, N)                 # (q·p,N)
        Aw = Kw_flat + torch.diag_embed(ratio)
        Law, dAinv_w = _blocked.blocked_chol_diag_ainv(Aw)
        total2 = torch.einsum("pqn,qn->pn", muW, mu_f)
        resid2 = (y_c[None, :, :] - total2[None, :, :] +
                  muW.permute(1, 0, 2) * mu_f[:, None, :])       # (q,p,N)
        pred2 = (resid2 * mu_f[:, None, :] /
                 variance[None, :, :]).reshape(qp, N)
        mu_w_flat, dSw = self._sigma_apply(Law, Kw_flat, pred2, ratio,
                                           dAinv_w)
        mu_w = mu_w_flat.reshape(q, p, N).permute(1, 0, 2)       # (p,q,N)
        dSw_qp = dSw.reshape(q, p, N)
        return (mu_f, dSf, mu_w, dSw_qp,
                (dv, inv_dv, Laf, dAinv_f, ratio, Law, dAinv_w))

    def _sweep_updates(self, Kf, Kw_flat, y_c, variance, muF, varF, muW,
                       varW):
        """The updates alone, no ELBO terms (no Cholesky of K or Σ):
        ``(muF, varF, muW, varW)`` of the next sweep."""
        mu_f, dSf, mu_w, dSw_qp, _ = self._updates(
            Kf, Kw_flat, y_c, variance, muF, varF, muW, varW)
        return mu_f, dSf, mu_w, dSw_qp.permute(1, 0, 2)

    def _sweep(self, Kf, Kw_flat, L_all, Linv_nodes, y_c, y_raw, variance,
               muF, varF, muW, varW):
        """One ELBOaux step: the updates, then the ELBO at the new state,
        Σ-free (Σ = K − K A⁻¹ K, A = K + D⁻¹, is never formed):

            log det Σ  = log det K − log det A − log det D
            tr(K⁻¹ Σ)  = tr(A⁻¹ D⁻¹) = Σⱼ dⱼ (A⁻¹)ⱼⱼ

        Shapes as :meth:`_updates`, plus L_all (q·(1+p),N,N), Linv_nodes
        (q,N,N) [None when q == 1], y_raw (p,N)."""
        q, p, N = self.spec.q, self.spec.p, self.spec.N
        qp = q * p
        mu_f, dSf, mu_w, dSw_qp, factors = self._updates(
            Kf, Kw_flat, y_c, variance, muF, varF, muW, varW)
        dv, inv_dv, Laf, dAinv_f, ratio, Law, dAinv_w = factors

        # -- entropy: ½ Σ log det Σ by the determinant identity --
        def half_logdet(L):
            return torch.sum(torch.log(torch.diagonal(L, dim1=1, dim2=2)),
                             dim=1)

        half_ldK = half_logdet(L_all)                            # (q·(1+p),)
        ldA_f = 2.0 * half_logdet(Laf)                           # (q,)
        ldA_w = 2.0 * half_logdet(Law)                           # (q·p,)
        ldD_f = torch.sum(torch.log(dv), dim=1)                  # (q,)
        ldD_w = -torch.sum(torch.log(ratio), dim=1)              # (q·p,)
        ldSig = (2.0 * half_ldK
                 - torch.cat([ldA_f, ldA_w])
                 - torch.cat([ldD_f, ldD_w]))
        ent = 0.5 * torch.sum(ldSig) \
            + 0.5 * q * (p + 1) * N * (1 + LOG_2PI)

        # -- expected log prior: vector solves against L_all --
        # reference quirk: the (p,q,N) weight means enter the prior as a
        # RAW flatten to (q·p, N)
        muW_prior = mu_w.reshape(qp, N)
        mu_all = torch.cat([mu_f, muW_prior], dim=0)             # (q(1+p),N)
        alpha_all = _cho_solve(L_all, mu_all)
        muKmu_all = torch.einsum("an,an->a", mu_all, alpha_all)
        tr_f_same = torch.sum(inv_dv * dAinv_f, dim=1)           # (q,)
        tr_w = torch.sum(ratio * dAinv_w, dim=1)                 # (q·p,)
        # reference quirk: node j's trace term uses the CUMULATIVE sum of
        # sigma_f over nodes <= j.  Cross terms tr(K_j⁻¹ Σ_k), k < j, via
        # Woodbury Σ_k = D_k⁻¹ − D_k⁻¹ A_k⁻¹ D_k⁻¹:
        #   tr(K_j⁻¹ Σ_k) = Σₙ diag(K_j⁻¹)ₙ/dvₖₙ − ‖L_Ak⁻¹ D_k⁻¹ L_j⁻ᵀ‖²
        tr_f_rows = [tr_f_same[j] for j in range(q)]
        if q > 1:
            diag_Kinv = torch.sum(Linv_nodes * Linv_nodes, dim=1)  # (q,N)
            for j in range(1, q):
                for k in range(j):
                    term1 = torch.sum(diag_Kinv[j] * inv_dv[k])
                    T = Linv_nodes[j] * inv_dv[k][None, :]       # (N,N)
                    W = torch.linalg.solve_triangular(Laf[k], T.T,
                                                      upper=False)
                    tr_f_rows[j] = tr_f_rows[j] + term1 - torch.sum(W * W)
        tr_f = torch.stack(tr_f_rows)
        tr_all = torch.cat([tr_f, tr_w])
        logp = torch.sum(-half_ldK - 0.5 * (muKmu_all + tr_all)) \
            - 0.5 * N * q * (p + 1) * LOG_2PI

        # -- expected log likelihood (raw-y quirk) --
        logl = -0.5 * torch.sum(torch.log(2 * math.pi * variance))
        omega_nu = torch.einsum("pqn,qn->pn", mu_w, mu_f)
        res = y_raw - omega_nu
        logl = logl - 0.5 * torch.sum(res * res / variance)
        quad = (dSf[:, None, :] * (mu_w.permute(1, 0, 2) ** 2) +
                dSw_qp * (mu_f[:, None, :] ** 2) +
                dSf[:, None, :] * dSw_qp) / variance[None, :, :]
        logl = logl - 0.5 * torch.sum(quad)

        elbo = (logl + logp + ent) / q
        return elbo, mu_f, dSf, mu_w, dSw_qp.permute(1, 0, 2)

    # ---- fit --------------------------------------------------------------

    def _prepare(self, theta, t, y, yerr2):
        q, N = self.spec.q, self.spec.N
        Kf, Kw_flat, jitters = self._build_matrices(theta, t)
        # ONE batched Cholesky of the whole q·(1+p) prior lattice
        L_all = _blocked.cholesky_nan(torch.cat([Kf, Kw_flat], dim=0))
        Linv_nodes = None
        if q > 1:
            # L_f⁻¹ per node, for the cumulative-sumSigmaF cross traces
            eye = torch.eye(N, dtype=L_all.dtype, device=L_all.device)
            Linv_nodes = torch.linalg.solve_triangular(
                L_all[:q], eye.expand(q, N, N), upper=False)
        m = self._mean_values(theta, t)
        y_c = y - m
        variance = jitters[:, None] ** 2 + yerr2
        return Kf, Kw_flat, L_all, Linv_nodes, y_c, y, variance

    def sweep_once(self, theta, t, y, yerr2, mu0, var0):
        """Single ELBOaux step: ``(elbo, mu, var)``."""
        prepared = self._prepare(theta, t, y, yerr2)
        muF, muW = self._u_split(mu0.reshape(-1))
        varF, varW = self._u_split(var0.reshape(-1))
        elbo, mu_f, varf, mu_w, varw = self._sweep(*prepared, muF, varF,
                                                   muW, varW)
        mu = torch.cat([mu_f.reshape(-1), mu_w.reshape(-1)])
        var = torch.cat([varf.reshape(-1), varw.reshape(-1)])
        return elbo, mu, var

    def elbo_fit(self, theta, t, y, yerr2, mu0, var0, max_iter=10000):
        """Coordinate ascent until the relative std of the last three
        ELBO values is below 1e-3 (checked from sweep 4 on) or
        ``max_iter`` sweeps.  Returns ``(elbo, mu, var, n_iter,
        converged, trace)`` with ``trace`` the per-sweep ELBO values."""
        prepared = self._prepare(theta, t, y, yerr2)
        muF, muW = self._u_split(mu0.reshape(-1))
        varF, varW = self._u_split(var0.reshape(-1))
        dtype, device = muF.dtype, muF.device
        elbo = torch.zeros((), dtype=dtype, device=device)
        hist = torch.full((3,), float("inf"), dtype=dtype, device=device)
        trace = []
        it, done = 0, False
        while not done and it < max_iter:
            elbo, muF, varF, muW, varW = self._sweep(*prepared, muF, varF,
                                                     muW, varW)
            hist = torch.cat([hist[1:], elbo.reshape(1)])
            trace.append(elbo)
            it += 1
            if it > 3:
                crit = torch.abs(torch.std(hist, correction=0) /
                                 torch.mean(hist))
                done = bool((crit < 1e-3) & (crit != 0))
        mu = torch.cat([muF.reshape(-1), muW.reshape(-1)])
        var = torch.cat([varF.reshape(-1), varW.reshape(-1)])
        trace = torch.stack(trace) if trace else \
            torch.zeros(0, dtype=dtype, device=device)
        return elbo, mu, var, it, done, trace

    # ---- fixed sweep counts and the gradient ------------------------------

    def _static_sweeps(self, theta, t, y, yerr2, mu0, var0, n_sweeps):
        """``n_sweeps`` sweeps from (mu0, var0): n−1 updates-only sweeps,
        then one full :meth:`_sweep` whose ELBO is the result.  Returns
        ``(elbo, muF, varF, muW, varW)``."""
        n_sweeps = int(n_sweeps)
        if n_sweeps < 1:
            raise ValueError("n_sweeps must be >= 1 (an unswept ELBO is "
                             "undefined)")
        prepared = self._prepare(theta, t, y, yerr2)
        Kf, Kw_flat, _, _, y_c, _, variance = prepared
        muF, muW = self._u_split(mu0.reshape(-1))
        varF, varW = self._u_split(var0.reshape(-1))
        for _ in range(n_sweeps - 1):
            muF, varF, muW, varW = self._sweep_updates(
                Kf, Kw_flat, y_c, variance, muF, varF, muW, varW)
        return self._sweep(*prepared, muF, varF, muW, varW)

    def elbo_fixed(self, theta, t, y, yerr2, mu0, var0, n_sweeps):
        """The ELBO after exactly ``n_sweeps`` sweeps from (mu0, var0):
        a deterministic function of ``theta``, differentiable by
        autograd."""
        elbo, *_ = self._static_sweeps(theta, t, y, yerr2, mu0, var0,
                                       n_sweeps)
        return elbo

    def elbo_refine(self, theta, t, y, yerr2, mu0, var0, n_sweeps):
        """``(elbo, mu, var)`` after exactly ``n_sweeps`` sweeps."""
        elbo, muF, varF, muW, varW = self._static_sweeps(
            theta, t, y, yerr2, mu0, var0, n_sweeps)
        mu = torch.cat([muF.reshape(-1), muW.reshape(-1)])
        var = torch.cat([varF.reshape(-1), varW.reshape(-1)])
        return elbo, mu, var

    def elbo_value_and_grad(self, theta, t, y, yerr2, mu0, var0, n_sweeps):
        """``(elbo, d elbo / d theta)`` of :meth:`elbo_fixed`, by autograd
        through the ``n_sweeps`` unrolled sweeps (the starting state and
        the data are constants), in the tensors' dtype."""
        theta = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            elbo = self.elbo_fixed(theta, t, y, yerr2, mu0, var0, n_sweeps)
            (grad,) = torch.autograd.grad(elbo, theta)
        return elbo.detach(), grad

    # ---- posterior predictive ---------------------------------------------

    def predict(self, theta, t, y, yerr2, mu, var, tstar):
        """Batched GP conditionals over the whole q·(1+p) lattice:
        ``(means (n*, p), vars (n*, p), node_pred (q, n*),
        weight_pred (q·p, n*))``."""
        spec = self.spec
        q, p = spec.q, spec.p
        node_p, weight_p, _, jitters = unpack_parameters(spec, theta)
        node_c = self._core(node_p, self.node_maps)
        weight_c = self._core(weight_p, self.weight_maps)
        muF, muW = self._u_split(mu.reshape(-1))
        varF, varW = self._u_split(var.reshape(-1))
        tstar = torch.atleast_1d(tstar)
        m_star = self._mean_values(theta, tstar)                 # (p, n*)

        structs = list(spec.node_structs) + list(spec.weight_structs)
        all_params = list(node_c) + list(weight_c)
        # reference weight-lattice order in prediction is (i·q + j)
        m_rows = torch.cat([
            muF, muW.permute(1, 0, 2).reshape(q * p, -1)])       # (B, N)
        v_rows = torch.cat([
            varF, varW.permute(1, 0, 2).reshape(q * p, -1)])

        K_all = kernel_matrix_stack(structs, all_params, t, PREDICT_NUGGET)
        Ks_all = torch.stack([cross_kernel_matrix(s, cp, tstar, t)
                              for s, cp in zip(structs, all_params)])
        Kss_diag = torch.stack([kernel_diag(s, cp, tstar, PREDICT_NUGGET)
                                for s, cp in zip(structs, all_params)])

        L = _blocked.cholesky_nan(K_all + torch.diag_embed(v_rows))
        sol = _cho_solve(L, m_rows)
        means = torch.einsum("bsk,bk->bs", Ks_all, sol)          # (B, n*)
        inner = torch.cholesky_solve(Ks_all.transpose(1, 2), L)  # (B, N, n*)
        vars_ = Kss_diag - torch.einsum("bsk,bks->bs", Ks_all, inner)

        n_pred, n_var = means[:q], vars_[:q]                     # (q, n*)
        w_pred = means[q:].reshape(q, p, -1)
        w_var = vars_[q:].reshape(q, p, -1)

        jitt2 = jitters ** 2
        # the reference adds jitt² once per node — reproduced exactly
        mean_out = m_star.T + torch.einsum("qn,qpn->np", n_pred, w_pred)
        var_out = torch.einsum(
            "qpn->np",
            w_pred ** 2 * n_var[:, None, :] +
            w_var * (n_var[:, None, :] + n_pred[:, None, :] ** 2)) \
            + q * jitt2[None, :]
        return mean_out, var_out, n_pred, w_pred.reshape(q * p, -1)
