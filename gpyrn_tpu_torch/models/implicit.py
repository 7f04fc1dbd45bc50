"""Implicit (fixed-point) differentiation of the converged ELBO.

Port of :mod:`gpyrn_tpu.models.implicit`.  The coordinate-ascent sweep is
a fixed-point map s ← T(θ, s) over the variational state s = (μ, σ²), and
the ELBO reported at convergence is E(θ, s*), the terms of one sweep at
the post-sweep state.  Its total derivative is

    dG/dθ = ∂E/∂θ + (∂E/∂s)ᵀ · ds*/dθ ,
    ds*/dθ = (I − ∂T/∂s)⁻¹ · ∂T/∂θ        (implicit function theorem),

well-defined because the stable fixed point has ρ(∂T/∂s) < 1.  The
engine's unrolled ``elbo_value_and_grad`` keeps the graph of every sweep
alive for its backward pass, and its gradient only approaches dG/dθ as
the count grows.  This module computes dG/dθ at the fixed point from the
graph of ONE sweep:

* one forward of ``engine.sweep_once`` under autograd at (θ, μ*, σ²*);
* v = ∂E/∂s and ∂E/∂θ from one pull-back of the ELBO output;
* the adjoint solve  (I − Jᵀ) w = v,  J = ∂T/∂s, where every operator
  application is one pull-back of a state cotangent through the kept
  graph (``torch.autograd.grad`` with ``retain_graph=True``), asked for
  the state alone: autograd then never walks into the kernel matrices or
  the prior's Cholesky, whose backward (B1′ on the card) runs twice per
  call and not once per Krylov step;
* grad = ∂E/∂θ + (∂T/∂θ)ᵀ w  by one more pull-back, which also yields
  Jᵀw for the adjoint residual.

Plain iteration of the adjoint fixed point u ← v + Jᵀu converges at the
sweep map's own rate, hundreds of terms at large N, so the default solver
is restarted GMRES (written here on tensors: torch has none), which needs
a few dozen pull-backs; the truncated Neumann series is kept for the
strongly contractive regime.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["ImplicitGrad", "make_implicit_value_and_grad",
           "implicit_value_and_grad_for", "gmres"]


class ImplicitGrad(NamedTuple):
    """Result of one implicit value-and-grad evaluation.

    ``elbo`` is E(θ, s*) at the supplied state, ``grad`` the total
    derivative dG/dθ, ``adjoint_residual`` the relative residual
    ‖(I−Jᵀ)w − v‖/‖v‖ of the adjoint solve (a small value certifies the
    gradient; a large one means the supplied state was not a fixed point
    or ``maxiter`` was too small), ``state_residual`` the relative sweep
    residual max|T(s*)−s*| / (1+max|s*|) (how converged the supplied
    state was), and ``pullbacks`` the number of pull-backs through the
    sweep's graph (an int; the first four are 0-d or 1-d tensors).
    """
    elbo: torch.Tensor
    grad: torch.Tensor
    adjoint_residual: torch.Tensor
    state_residual: torch.Tensor
    pullbacks: int


def gmres(A, b, x0, tol, restart, maxiter):
    """Restarted GMRES for ``A(x) = b`` on 1-D tensors: at most
    ``maxiter`` cycles of at most ``restart`` Arnoldi steps from ``x0``,
    until ‖b − A x‖ ≤ ``tol``·‖b‖.

    The Krylov basis stays on the device (classical Gram-Schmidt, applied
    twice); each step brings one column of the Hessenberg matrix to the
    host, where Givens rotations keep the least-squares problem
    triangular and give the residual norm, so a cycle ends as soon as the
    tolerance is met.  A cycle that took less than a tenth off the true
    residual ends the solve: the residual has reached the floor the
    arithmetic leaves (at N = 1000 in float64 some 1e-10 of ‖b‖, above
    the default target), where every further cycle would meet its own
    estimate after a few steps and change nothing.  Returns ``x``."""
    x = x0
    target = tol * float(torch.linalg.vector_norm(b))
    previous = np.inf
    for _ in range(maxiter):
        r = b - A(x)
        beta = float(torch.linalg.vector_norm(r))
        if not np.isfinite(beta) or beta <= target or beta > 0.9 * previous:
            break
        previous = beta
        V = torch.empty((restart + 1, b.numel()), dtype=b.dtype,
                        device=b.device)
        V[0] = r / beta
        H = np.zeros((restart + 1, restart))        # after the rotations
        cs, sn = np.zeros(restart), np.zeros(restart)
        g = np.zeros(restart + 1)
        g[0] = beta
        k = 0
        while k < restart:
            w = A(V[k])
            h = V[:k + 1] @ w
            w = w - h @ V[:k + 1]
            h2 = V[:k + 1] @ w                      # second pass
            w = w - h2 @ V[:k + 1]
            h_next = torch.linalg.vector_norm(w)
            col = torch.cat([h + h2, h_next.reshape(1)]).double().cpu().numpy()
            for i in range(k):
                col[i], col[i + 1] = (cs[i] * col[i] + sn[i] * col[i + 1],
                                      -sn[i] * col[i] + cs[i] * col[i + 1])
            rho = np.hypot(col[k], col[k + 1])
            if not np.isfinite(rho) or rho == 0.0:
                break                               # nothing left to add
            cs[k], sn[k] = col[k] / rho, col[k + 1] / rho
            H[:k + 1, k] = col[:k + 1]
            H[k, k] = rho
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            happy = col[k + 1] <= 1e-14 * rho
            if not happy:
                V[k + 1] = w / h_next
            k += 1
            if happy or abs(g[k]) <= target:
                break
        if k == 0:
            break
        yk = np.linalg.solve(np.triu(H[:k, :k]), g[:k])
        x = x + torch.as_tensor(yk, dtype=b.dtype, device=b.device) @ V[:k]
    return x


def make_implicit_value_and_grad(engine):
    """Build the implicit (ELBO, dELBO/dθ) evaluator for an engine.

    Returns ``ivag(theta, t, y, yerr2, mu_star, var_star, *, adjoint,
    maxiter, restart, tol) -> ImplicitGrad`` where ``(mu_star, var_star)``
    is a converged variational state (from ``engine.fit_state`` or the
    Anderson polish).  ``adjoint`` selects the solver of (I − Jᵀ)w = v:

    * ``'gmres'`` (default): restarted GMRES from ``x0 = v``, robust at
      any contraction rate; ``maxiter`` cycles of ``restart`` Arnoldi
      steps; ``tol`` the relative residual target (1e-10 in float64,
      1e-5 in float32 when None);
    * ``'neumann'``: the truncated series Σₖ (Jᵀ)ᵏ v with ``maxiter``
      terms, one pull-back per term; only appropriate when ρ(J) is small.

    The graph of the sweep is freed when the call returns."""

    def ivag(theta, t, y, yerr2, mu_star, var_star, *, adjoint="gmres",
             maxiter=25, restart=20, tol=None):
        if adjoint not in ("gmres", "neumann"):
            raise ValueError(f"unknown adjoint solver {adjoint!r}")
        mu_star = mu_star.detach().reshape(-1)
        var_star = var_star.detach().reshape(-1)
        d = mu_star.numel()
        if tol is None:
            tol = 1e-10 if mu_star.dtype == torch.float64 else 1e-5
        theta = theta.detach().requires_grad_(True)
        s = torch.cat([mu_star, var_star]).requires_grad_(True)
        with torch.enable_grad():
            elbo, mu1, var1 = engine.sweep_once(theta, t, y, yerr2, s[:d],
                                                s[d:])
            s1 = torch.cat([mu1, var1])
        pullbacks = 0

        def pull(g_elbo, g_state, inputs):
            nonlocal pullbacks
            pullbacks += 1
            return torch.autograd.grad((elbo, s1), inputs,
                                       grad_outputs=(g_elbo, g_state),
                                       retain_graph=True)

        def rel_change(new, old):
            return (new - old).abs().max() / (1.0 + old.abs().max())

        state_res = torch.maximum(rel_change(mu1.detach(), mu_star),
                                  rel_change(var1.detach(), var_star))
        one, zero_e = torch.ones_like(elbo), torch.zeros_like(elbo)
        # v = ∂E/∂s and the explicit ∂E/∂θ, from one pull-back of the
        # ELBO output alone
        e_theta, v = pull(one, torch.zeros_like(s1), (theta, s))

        def JT(w):
            # Jᵀ w: the state cotangent pulled back to the state alone
            return pull(zero_e, w, (s,))[0]

        if adjoint == "gmres":
            w = gmres(lambda u: u - JT(u), v, v, tol, int(restart),
                      int(maxiter))
        else:
            w, term = v, v
            for _ in range(int(maxiter)):
                term = JT(term)
                w = w + term
        # (∂T/∂θ)ᵀ w, and Jᵀ w for the residual of the solve
        g_extra, jtw = pull(zero_e, w, (theta, s))
        tiny = torch.finfo(v.dtype).tiny
        adj_res = torch.linalg.vector_norm(w - jtw - v) / torch.clamp_min(
            torch.linalg.vector_norm(v), tiny)
        return ImplicitGrad(elbo.detach(), e_theta + g_extra, adj_res,
                            state_res, pullbacks)

    return ivag


@functools.lru_cache(maxsize=128)
def implicit_value_and_grad_for(engine):
    """Per-engine cache of :func:`make_implicit_value_and_grad`, as in the
    JAX package (the cache keeps its engines alive: an engine holds its
    spec and parameter maps, no tensors)."""
    return make_implicit_value_and_grad(engine)
