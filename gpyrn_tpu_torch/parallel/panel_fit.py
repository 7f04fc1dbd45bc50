"""Panel-distributed GPRN fit: the N axis split over the ranks of a mesh.

Port of :mod:`gpyrn_tpu.parallel.panel_fit`.  The mean-field coordinate
ascent of :mod:`gpyrn_tpu_torch.models.gprn` on the panel-sharded linear
algebra of :mod:`gpyrn_tpu_torch.parallel.panel`: every N×N kernel matrix
lives as row slabs over the ranks of one mesh axis, so a rank holds
O(N²/D), and more ranks raise the N ceiling instead of only batching the
(q × p) lattice.

Three entry points, with the lean engine's semantics:

* ``fit_state_panel``: updates-only fit on the exact-nugget matrices,
  stopped by the state rule (``Engine.fit_state_lean``);
* ``elbo_refine_panel``: ``n_sweeps`` sweeps and the ELBO at the final
  state (``Engine.elbo_refine_lean``: n−1 updates-only sweeps, then one
  full sweep), any (q, p): the q > 1 cumulative cross traces tr(K_j⁻¹Σ_k)
  stream as panel triangular inversions and Frobenius-norm solves, and
  the raw-flatten weight-prior quirk pairs μᵀK⁻¹μ against the prefactored
  prior panels;
* ``elbo_fit_panel``: the reference fit (rel-std(3) < 1e-3 ELBO rule).

Each rank's slab of a kernel matrix is built by B1's slab entry
(:func:`gpyrn_tpu_torch.ops.cuda_kernels.kernel_matrix_slab_cuda`) on a
CUDA tensor and by its plain version on a CPU tensor; a structure B1 does
not take (the non-stationary kernels) uses the plain version on every
device, as ``ops/linalg`` does.  The prior factors L_K (and for q > 1 the
node inverses) depend on θ only and are factored once per fit.

Every function is called collectively by the ranks of the axis with the
same replicated arguments (tensors on the rank's device) and returns the
same replicated results on every rank.  The small state (μ, diag Σ, the
data) is replicated; only the O(N²) work is split.  The loops are host
loops whose stopping tests read replicated values.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from gpyrn_tpu_torch.models.gprn import Engine, GPRNSpec, LOG_2PI, \
    _rel_std3_stop
from gpyrn_tpu_torch.ops import cuda_kernels as _ck
from gpyrn_tpu_torch.ops.linalg import F32_JITTER_MULT, TRAIN_NUGGET
from gpyrn_tpu_torch.parallel.mesh import LAT_AXIS, all_reduce, mesh_axis
from gpyrn_tpu_torch.parallel.panel import (
    DEFAULT_BLOCK, PanelDims, panel_cho_solve_local, panel_cholesky_local,
    panel_diag_trace_local, panel_dims, panel_fro_cross_local,
    panel_logdet_half_local, panel_matvec_local, panel_tri_inv_local,
    slab_rows)

__all__ = ["PanelEngine", "make_panel_engine"]

# kernels that get no nugget as the top-level structure (the reference
# quirk of ops/linalg.kernel_matrix)
_NO_NUGGET = ("HP", "QHP", "POLY")


class PanelEngine(NamedTuple):
    """The panel-distributed fit of one model structure."""
    spec: GPRNSpec
    dims: PanelDims
    fit_state_panel: Callable    # (theta, t, y, yerr2, mu0, var0,
    #                             max_iter, tol) -> (mu, var, it, done)
    elbo_refine_panel: Callable  # (theta, t, y, yerr2, mu0, var0,
    #                             n_sweeps) -> (elbo, mu, var)
    elbo_fit_panel: Callable     # (theta, t, y, yerr2, mu0, var0,
    #                             max_iter) -> (elbo, mu, var, it, done)


def make_panel_engine(spec: GPRNSpec, mesh, axis_name: str = LAT_AXIS,
                      block: int = DEFAULT_BLOCK,
                      core_maps=None) -> PanelEngine:
    """The panel-distributed fit for ``spec`` over ``mesh``'s
    ``axis_name`` axis; ranks along the other axis run their own copies."""
    q, p, N = spec.q, spec.p, spec.N
    axis = mesh_axis(mesh, axis_name)
    dims = panel_dims(N, axis.size, block)
    Np, Nl = dims.Np, dims.Nl
    r0, nv = slab_rows(dims, axis)
    eng = Engine(spec, core_maps)

    def _pad(v):
        return torch.nn.functional.pad(v, (0, Np - N))

    def _diag(X):
        """The real entries of the slab's diagonal (a view)."""
        return X.diagonal(r0)[:nv]

    # ---- slab assembly (parity with ops/linalg) -------------------------

    def _slab_kernel(structure, cp, t, elbo_mode: bool):
        """This rank's (Nl, Np) rows of K + jitter·I, identity in the
        padded lanes.  ``elbo_mode``: the trace-scaled jitter of
        ``kernel_matrix``, whose trace needs every rank's diagonal, so the
        slab is built without it and the jitter added after the sum;
        otherwise the exact nugget of ``kernel_matrix_plain``."""
        zero = t.new_zeros(())
        nugget = structure[0] not in _NO_NUGGET
        jitter = t.new_full((), TRAIN_NUGGET) if nugget and not elbo_mode \
            else zero
        if t.is_cuda and _ck.cuda_supported(structure):
            K = _ck.kernel_matrix_slab_cuda(structure, cp.contiguous(), t,
                                            Np, r0, Nl, jitter)
        else:
            K = _ck.kernel_matrix_slab_ref(structure, cp, t, Np, r0, Nl,
                                           jitter)
        if nugget and elbo_mode:
            tr = all_reduce(torch.sum(_diag(K)), axis)
            eps = torch.finfo(K.dtype).eps
            _diag(K).add_(torch.maximum(F32_JITTER_MULT * eps * tr,
                                        K.new_full((), TRAIN_NUGGET)))
        return K

    def _plus_diag(K, d_add):
        """A = K + diag(d_add) (d_add of length N), a new slab."""
        A = K.clone()
        _diag(A).add_(d_add[r0:r0 + nv])
        return A

    # ---- per-GP panel updates ---------------------------------------------

    def _gp_update(structure, cp, t, d_add, pred, elbo_mode):
        """One GP's coordinate update: ``(Σ·pred, diag Σ)`` at true-N
        size (``_gp_update_lean``'s, diag Σ = diag K − colsum((L⁻¹K)²))."""
        K = _slab_kernel(structure, cp, t, elbo_mode)
        L = panel_cholesky_local(_plus_diag(K, d_add), dims, axis)
        Krhs = panel_matvec_local(K, _pad(pred), dims, axis)
        t1 = panel_cho_solve_local(L, Krhs, dims, axis)
        sig_rhs = Krhs - panel_matvec_local(K, t1, dims, axis)
        dS, _ = panel_diag_trace_local(L, K, dims, axis)
        return sig_rhs[:N], dS[:N]

    def _prior_factors(theta, t):
        """The θ-only panel factors, once per fit: each GP's prior factor
        slab L_K and ½ log det K, and for q > 1 the node inverses
        G = L_f⁻¹ (row slabs) with diag(K_f⁻¹) for the cross traces."""
        node_c, weight_c = eng._lean_cores(theta)
        LKs, ldKhs, Gs, dKinvs = [], [], [], []
        for gi, (structs, cps) in enumerate(((spec.node_structs, node_c),
                                             (spec.weight_structs,
                                              weight_c))):
            for s, cp in zip(structs, cps):
                L_K = panel_cholesky_local(
                    _slab_kernel(s, cp, t, elbo_mode=True), dims, axis)
                LKs.append(L_K)
                ldKhs.append(panel_logdet_half_local(L_K, dims, axis))
                if q > 1 and gi == 0:
                    G, dKinv = panel_tri_inv_local(L_K, dims, axis)
                    Gs.append(G)
                    dKinvs.append(dKinv)
        return LKs, torch.stack(ldKhs), Gs, dKinvs, node_c, weight_c

    def _gp_free(structure, cp, t, d_add, pred, L_K, keep_LA):
        """Update and ELBO ingredients of one GP against the prefactored
        prior ``L_K``: ``(mu, dS, cn, log det A, μᵀK⁻¹μ)`` at true-N
        size, and with ``keep_LA`` the A-factor slab (the q > 1 node cross
        traces need L_{A_k})."""
        K = _slab_kernel(structure, cp, t, elbo_mode=True)
        L_A = panel_cholesky_local(_plus_diag(K, d_add), dims, axis)
        ldA = 2.0 * panel_logdet_half_local(L_A, dims, axis)
        Krhs = panel_matvec_local(K, _pad(pred), dims, axis)
        t1 = panel_cho_solve_local(L_A, Krhs, dims, axis)
        mu = Krhs - panel_matvec_local(K, t1, dims, axis)
        dS, cn = panel_diag_trace_local(L_A, K, dims, axis)
        del K
        muKmu = torch.dot(mu, panel_cho_solve_local(L_K, mu, dims, axis))
        out = (mu[:N], dS[:N], cn[:N], ldA, muKmu)
        return out + ((L_A,) if keep_LA else ())

    # ---- sweeps (mirrors of the lean sweeps) ----------------------------------

    def _sweep_updates(theta, t, y_c, variance, muF, varF, muW, varW,
                       elbo_mode=False):
        node_c, weight_c = eng._lean_cores(theta)
        dv, pred = eng._node_stats(y_c, variance, muF, muW, varW)
        outs = [_gp_update(s, node_c[j], t, 1.0 / dv[j], pred[j], elbo_mode)
                for j, s in enumerate(spec.node_structs)]
        mu_f = torch.stack([o[0] for o in outs])
        dSf = torch.stack([o[1] for o in outs])
        ratio, pred2 = eng._weight_stats(y_c, variance, muW, mu_f, dSf)
        outs = [_gp_update(s, weight_c[a], t, ratio[a], pred2[a], elbo_mode)
                for a, s in enumerate(spec.weight_structs)]
        mu_w = torch.stack([o[0] for o in outs]).reshape(q, p, N) \
            .transpose(0, 1)
        dSw = torch.stack([o[1] for o in outs]).reshape(q, p, N)
        return mu_f, dSf, mu_w, dSw.transpose(0, 1)

    def _sweep_free(priors, t, y_c, y_raw, variance, muF, varF, muW, varW):
        """One reference-semantics sweep and its ELBO, any (q, p), against
        the prior factors of :func:`_prior_factors` (the JAX package's
        panel ``_sweep_free``)."""
        LKs, ldKh, Gs, dKinvs, node_c, weight_c = priors
        dv, pred = eng._node_stats(y_c, variance, muF, muW, varW)
        inv_dv = 1.0 / dv
        n_out = [_gp_free(s, node_c[j], t, inv_dv[j], pred[j], LKs[j],
                          keep_LA=q > 1)
                 for j, s in enumerate(spec.node_structs)]

        def stack(rows, k):
            return torch.stack([r[k] for r in rows])

        mu_f, dSf = stack(n_out, 0), stack(n_out, 1)
        ratio, pred2 = eng._weight_stats(y_c, variance, muW, mu_f, dSf)
        w_out = [_gp_free(s, weight_c[a], t, ratio[a], pred2[a],
                          LKs[q + a], keep_LA=False)
                 for a, s in enumerate(spec.weight_structs)]
        mu_w = stack(w_out, 0).reshape(q, p, N).transpose(0, 1)
        dSw_qp = stack(w_out, 1).reshape(q, p, N)
        muKmu_w = stack(w_out, 4)
        if q > 1:
            # reference quirk: the weight means enter the prior RAW-
            # flattened (p,q,N) → (q·p,N), row a paired with weight GP
            # a's kernel: μᵀK⁻¹μ again against the prefactored panels
            muW_prior = mu_w.reshape(q * p, N)
            muKmu_w = torch.stack([
                torch.dot(m, panel_cho_solve_local(LKs[q + a], m, dims,
                                                   axis))
                for a, m in enumerate(_pad(muW_prior))])

        # entropy: ½ Σ log det Σ by the determinant identity
        ldD_f = torch.sum(torch.log(dv), dim=-1)
        ldD_w = -torch.sum(torch.log(ratio), dim=-1)
        ldSig = (2.0 * ldKh - torch.cat([stack(n_out, 3), stack(w_out, 3)])
                 - torch.cat([ldD_f, ldD_w]))
        ent = 0.5 * torch.sum(ldSig) + 0.5 * q * (p + 1) * N * (1 + LOG_2PI)

        # expected log prior; node j's trace term uses the CUMULATIVE sum
        # of Σ_f over nodes <= j: cross terms tr(K_j⁻¹Σ_k) =
        # Σ diag(K_j⁻¹)·inv_dv_k − ‖L_{A_k}⁻¹ D_k⁻¹ L_j⁻ᵀ‖²_F
        cn_f = stack(n_out, 2)
        tr_f_rows = [torch.sum(cn_f[j] * dv[j]) for j in range(q)]
        for j in range(1, q):
            for k in range(j):
                term1 = torch.dot(dKinvs[j][:N], inv_dv[k])
                term2 = panel_fro_cross_local(n_out[k][5], Gs[j],
                                              _pad(inv_dv[k]), dims, axis)
                tr_f_rows[j] = tr_f_rows[j] + term1 - term2
        tr_w = torch.sum(stack(w_out, 2) / ratio, dim=1)
        muKmu_all = torch.cat([stack(n_out, 4), muKmu_w])
        tr_all = torch.cat([torch.stack(tr_f_rows), tr_w])
        logp = torch.sum(-ldKh - 0.5 * (muKmu_all + tr_all)) \
            - 0.5 * N * q * (p + 1) * LOG_2PI

        # expected log likelihood (raw-y quirk)
        logl = -0.5 * torch.sum(torch.log(2 * math.pi * variance))
        res = y_raw - torch.einsum("pqn,qn->pn", mu_w, mu_f)
        logl = logl - 0.5 * torch.sum(res * res / variance)
        quad = (dSf[:, None, :] * (mu_w.transpose(0, 1) ** 2) +
                dSw_qp * (mu_f[:, None, :] ** 2) +
                dSf[:, None, :] * dSw_qp) / variance[None, :, :]
        logl = logl - 0.5 * torch.sum(quad)

        elbo = (logl + logp + ent) / q
        return elbo, mu_f, dSf, mu_w, dSw_qp.transpose(0, 1)

    # ---- entry points -----------------------------------------------------------

    def _start(mu0, var0):
        muF, muW = eng._u_split(mu0.reshape(-1))
        varF, varW = eng._u_split(var0.reshape(-1))
        return muF, varF, muW, varW

    def fit_state_panel(theta, t, y, yerr2, mu0, var0, max_iter, tol):
        """Updates-only sweeps on the exact-nugget matrices until
        max |Δμ| / (1 + max |μ|) < ``tol`` or ``max_iter`` sweeps:
        ``(mu, var, n_iter, converged)``."""
        y_c, _, variance = eng._prepare_lean(theta, t, y, yerr2)
        muF, varF, muW, varW = _start(mu0, var0)
        tol = torch.as_tensor(tol, dtype=muF.dtype, device=muF.device)
        it, done = 0, False
        while not done and it < max_iter:
            mu_f, varF, mu_w, varW = _sweep_updates(
                theta, t, y_c, variance, muF, varF, muW, varW)
            done = bool(eng._state_delta(mu_f, mu_w, muF, muW) < tol)
            muF, muW = mu_f, mu_w
            it += 1
        return eng._u_join(muF, muW), eng._u_join(varF, varW), it, done

    def elbo_refine_panel(theta, t, y, yerr2, mu0, var0, n_sweeps):
        """``(elbo, mu, var)`` after exactly ``n_sweeps`` sweeps: n−1
        updates-only on the ELBO path's matrices, then one full sweep."""
        n_sweeps = int(n_sweeps)
        if n_sweeps < 1:
            raise ValueError("n_sweeps must be >= 1 (an unswept ELBO is "
                             "undefined)")
        y_c, y_raw, variance = eng._prepare_lean(theta, t, y, yerr2)
        state = _start(mu0, var0)
        for _ in range(n_sweeps - 1):
            state = _sweep_updates(theta, t, y_c, variance, *state,
                                   elbo_mode=True)
        elbo, muF, varF, muW, varW = _sweep_free(
            _prior_factors(theta, t), t, y_c, y_raw, variance, *state)
        return elbo, eng._u_join(muF, muW), eng._u_join(varF, varW)

    def elbo_fit_panel(theta, t, y, yerr2, mu0, var0, max_iter=10000):
        """The reference fit: full sweeps until the relative std of the
        last three ELBOs is below 1e-3 (from sweep 4 on) or ``max_iter``:
        ``(elbo, mu, var, n_iter, converged)``."""
        y_c, y_raw, variance = eng._prepare_lean(theta, t, y, yerr2)
        priors = _prior_factors(theta, t)
        muF, varF, muW, varW = _start(mu0, var0)
        elbo = muF.new_zeros(())
        hist = muF.new_full((3,), float("inf"))
        it, done = 0, False
        while not done and it < max_iter:
            elbo, muF, varF, muW, varW = _sweep_free(
                priors, t, y_c, y_raw, variance, muF, varF, muW, varW)
            hist = torch.cat([hist[1:], elbo.reshape(1)])
            it += 1
            if it > 3:
                done = bool(_rel_std3_stop(hist))
        return (elbo, eng._u_join(muF, muW), eng._u_join(varF, varW), it,
                done)

    return PanelEngine(spec=spec, dims=dims,
                       fit_state_panel=fit_state_panel,
                       elbo_refine_panel=elbo_refine_panel,
                       elbo_fit_panel=elbo_fit_panel)
