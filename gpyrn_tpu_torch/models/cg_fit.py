"""Matrix-free (CG) GPRN coordinate-ascent fit: the N ≫ 20k path.

Port of :mod:`gpyrn_tpu.models.cg_fit`.  The update map of
``Engine.fit_state_lean`` (models/gprn.py ``_sweep_updates_lean``), with
every N×N object replaced by matrix-free pieces:

* μ = K·pred − K·A⁻¹(K·pred) through chunked kernel matvecs
  (``ops/iterative.kernel_matvec``) and a preconditioned CG solve on
  A = K + diag(d);
* diag Σ from the pivoted-Cholesky compression K ≈ U Uᵀ + diag(g) by the
  closed-form Woodbury product identity (deterministic, O(N·m²));
* the same U preconditions CG (M = U Uᵀ + diag(h), ``split_precond``).

The factors U depend only on (θ, t) and are computed once per fit call.
Per sweep the cost is q·(1+p) CG solves, each a few chunked matvecs, with
O(N·(m + chunk)) peak memory.  The fit is a host loop: one boolean per
sweep for the state rule, and one per CG iteration inside each solve.

The agreement with the lean engine is set by the rank-m truncation of
diag Σ and the CG tolerance (the JAX package's bar: 1e-4 relative state
error at overlapping N, one float64 sweep).

With ``mesh=`` every kernel matvec's rows are split over one mesh axis
(``parallel.iterative_sharded.gathered_matvec``): the fit itself
runs replicated on every rank, called by all of them, and only the O(N²)
matvec work divides by the axis size.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gpyrn_tpu_torch.models.gprn import GPRNSpec, Engine
from gpyrn_tpu_torch.ops import blocked as _blocked
from gpyrn_tpu_torch.ops.iterative import (cg_solve, kernel_diag,
                                           kernel_matvec, pivoted_cholesky,
                                           split_precond)
from gpyrn_tpu_torch.ops.linalg import F32_JITTER_MULT, TRAIN_NUGGET
from gpyrn_tpu_torch.parallel.iterative_sharded import gathered_matvec
from gpyrn_tpu_torch.parallel.mesh import mesh_axis

__all__ = ["CGFitEngine", "make_cg_fit"]


class CGFitEngine(NamedTuple):
    """The matrix-free fit of one model structure."""
    spec: GPRNSpec
    rank: int
    fit_state_cg: Callable   # (theta, t, y, yerr2, mu0, var0, max_iter,
    #                          tol) -> (mu, var, it, done, relres): relres
    #                          the achieved TRUE relative residual, the
    #                          max over the last sweep's CG solves
    factors: Callable        # (theta, t) -> (U (q·(1+p), N, m), g, nu)


def make_cg_fit(spec: GPRNSpec, rank: int = 128, cg_tol: float = 1e-6,
                cg_maxiter: int = 200, chunk: int = 2048,
                core_maps=None, mesh=None,
                axis_name: str = "dp") -> CGFitEngine:
    """Build the matrix-free fit for ``spec``.

    Args:
        rank: pivoted-Cholesky rank m of each GP's K.
        cg_tol / cg_maxiter: the inner solves' control.
        chunk: the kernel matvec's row chunk (memory against speed; the
            results do not depend on it beyond rounding).
        core_maps: per-kernel (trainable → core) parameter maps, as for
            ``Engine``.
        mesh / axis_name: split every kernel matvec's rows over this
            mesh axis (the fit is then called by every rank of the mesh);
            N must divide by the axis size.
    """
    q, p, N = spec.q, spec.p, spec.N
    eng = Engine(spec, core_maps)
    if mesh is not None:
        axis = mesh_axis(mesh, axis_name)
        if N % axis.size:
            raise ValueError(f"sharded CG fit needs N ({N}) divisible by the "
                             f"'{axis_name}' axis size ({axis.size})")
        rows = slice(axis.rank * (N // axis.size),
                     (axis.rank + 1) * (N // axis.size))

    def _kmv(structure, cp, t, x, nu):
        """(K + nu·I) @ x: chunked on one device, or this rank's rows and
        a gather when built with a mesh."""
        if mesh is None:
            return kernel_matvec(structure, cp, t, x, nugget=nu, chunk=chunk)
        xm = x[:, None] if x.ndim == 1 else x
        y = gathered_matvec(structure, cp, t, xm, rows.start,
                            rows.stop - rows.start, axis, chunk) \
            + nu * xm
        return y[:, 0] if x.ndim == 1 else y

    def factors(theta, t):
        """Per-GP pivoted-Cholesky factors of the smooth kernel (no
        nugget: a νI term has no low-rank structure) and the residual
        diagonals with the nugget added exactly: K + νI ≈ U Uᵀ + diag(g).
        ν follows the dense engine's dtype-aware policy,
        max(TRAIN_NUGGET, F32_JITTER_MULT·eps·tr K)."""
        node_c, weight_c = eng._lean_cores(theta)
        structs = list(spec.node_structs) + list(spec.weight_structs)
        cores = node_c + weight_c
        outs = [pivoted_cholesky(s, cp, t, rank, 0.0)
                for s, cp in zip(structs, cores)]
        eps = torch.finfo(t.dtype).eps
        nus = torch.stack([
            torch.clamp(F32_JITTER_MULT * eps
                        * torch.sum(kernel_diag(s, cp, t, 0.0)),
                        min=TRAIN_NUGGET)
            for s, cp in zip(structs, cores)])     # (q·(1+p),)
        Us = torch.stack([o[0] for o in outs])     # (q·(1+p), N, m)
        gs = torch.stack([o[1] + nu for o, nu in zip(outs, nus)])
        return Us, gs, nus

    def _gp_update_cg(structure, cp, t, U, g, nu, d_add, pred):
        """One GP's update, matrix-free: ``(Σ·pred, diag Σ, relres)``.

        μ uses the exact kernel (chunked matvecs and CG preconditioned by
        M = U Uᵀ + diag(h), h = g + a, a = d_add).  diag Σ uses
        B = U Uᵀ + diag(g) ≈ K + νI through the product identity, every
        term positive (no cancellation at any a/diag(B) ratio):

            diag Σ_B = a·g/h + a²·colsum(V₂²),
            V₂ = L₂⁻¹ (U/h)ᵀ,  L₂L₂ᵀ = I + Uᵀ diag(1/h) U."""
        Krhs = _kmv(structure, cp, t, pred, nu)
        h = g + d_add
        Uh = U / h[:, None]
        C2 = torch.eye(rank, dtype=U.dtype, device=U.device) + U.T @ Uh
        L2 = _blocked.cholesky_nan(C2)
        precond = split_precond(U, h)

        def mv(x):
            return _kmv(structure, cp, t, x, nu) + d_add[:, None] * x

        t1, _, rres = cg_solve(mv, Krhs[:, None], tol=cg_tol,
                               maxiter=cg_maxiter, precond_apply=precond,
                               refresh_every=8, return_relres=True)
        sig_rhs = Krhs - _kmv(structure, cp, t, t1[:, 0], nu)
        V2 = torch.linalg.solve_triangular(L2, Uh.T, upper=False)  # (m, N)
        dS = d_add * g / h + (d_add * d_add) * torch.sum(V2 * V2, dim=0)
        dS = torch.clamp(dS, min=torch.finfo(U.dtype).tiny)
        return sig_rhs, dS, rres

    def _sweep(theta, t, y_c, variance, Us, gs, nus, muF, varF, muW, varW):
        """One coordinate-ascent sweep (``_sweep_updates_lean``'s map,
        each GP's update matrix-free); also the max relres of its solves."""
        node_c, weight_c = eng._lean_cores(theta)
        dv, pred = eng._node_stats(y_c, variance, muF, muW, varW)
        outs = [_gp_update_cg(s, node_c[j], t, Us[j], gs[j], nus[j],
                              1.0 / dv[j], pred[j])
                for j, s in enumerate(spec.node_structs)]
        mu_f = torch.stack([o[0] for o in outs])
        dSf = torch.stack([o[1] for o in outs])
        rres = torch.max(torch.stack([o[2] for o in outs]))

        ratio, pred2 = eng._weight_stats(y_c, variance, muW, mu_f, dSf)
        outs = [_gp_update_cg(s, weight_c[a], t, Us[q + a], gs[q + a],
                              nus[q + a], ratio[a], pred2[a])
                for a, s in enumerate(spec.weight_structs)]
        mu_w = torch.stack([o[0] for o in outs]).reshape(q, p, N) \
            .transpose(0, 1)
        dSw = torch.stack([o[1] for o in outs]).reshape(q, p, N)
        rres = torch.maximum(rres, torch.max(torch.stack([o[2]
                                                          for o in outs])))
        return mu_f, dSf, mu_w, dSw.transpose(0, 1), rres

    def fit_state_cg(theta, t, y, yerr2, mu0, var0, max_iter, tol):
        """Iterate the matrix-free sweep until max |Δμ| / (1 + max |μ|) <
        ``tol`` or ``max_iter`` sweeps: ``(mu, var, n_iter, converged,
        relres)``, relres a 0-d tensor (inf when no sweep ran)."""
        y_c, _, variance = eng._prepare_lean(theta, t, y, yerr2)
        muF, muW = eng._u_split(mu0.reshape(-1))
        varF, varW = eng._u_split(var0.reshape(-1))
        Us, gs, nus = factors(theta, t)
        tol = torch.as_tensor(tol, dtype=muF.dtype, device=muF.device)
        rres = torch.full((), float("inf"), dtype=muF.dtype,
                          device=muF.device)
        it, done = 0, False
        while not done and it < max_iter:
            mu_f, varF, mu_w, varW, rres = _sweep(
                theta, t, y_c, variance, Us, gs, nus, muF, varF, muW, varW)
            done = bool(eng._state_delta(mu_f, mu_w, muF, muW) < tol)
            muF, muW = mu_f, mu_w
            it += 1
        return (eng._u_join(muF, muW), eng._u_join(varF, varW), it, done,
                rres)

    return CGFitEngine(spec=spec, rank=rank, fit_state_cg=fit_state_cg,
                       factors=factors)
