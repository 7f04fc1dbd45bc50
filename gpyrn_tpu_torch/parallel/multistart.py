"""Multi-start hyperparameter optimization.

Port of :mod:`gpyrn_tpu.parallel.multistart`.  The GPRN ELBO surface is
multi-modal (node/weight amplitude degeneracies, period aliases), so a
population of B restarts searches it at once: the restarts are the batch
axis of the engine, and each step of the population is one batched
sweep, one autograd pass through ``Engine.elbo_fixed_batch`` over the B
rows and one adam step in log-parameter space.  ``method='nm'`` runs the
population of Nelder-Mead simplexes of
``inference.neldermead.nelder_mead_multistart``.

With ``mesh=`` (called by every rank of the mesh) the population is split
over the mesh's ``dp`` axis: each rank runs its share of the restarts (the
rows are independent, and adam is elementwise) and the results are
gathered before the winner is chosen, on every rank alike.  A lattice-
sharded engine (the inference's ``lattice_axis``) splits each restart's
weight lattice over ``lat`` as well.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gpyrn_tpu_torch.parallel.mesh import dp_rows

__all__ = ["make_multistart_step", "multistart_optimize", "MultistartState"]


class MultistartState(NamedTuple):
    """Population state: log-parameters, optimizer state, warm-start
    variational caches, best-so-far tracking."""
    z: torch.Tensor           # (B, n_par) log-parameters
    opt_state: object         # the torch.optim.Adam over z
    mu: torch.Tensor          # (B, d) per-restart variational means
    var: torch.Tensor         # (B, d)
    best_elbo: torch.Tensor   # (B,)
    best_z: torch.Tensor      # (B, n_par)


def make_multistart_step(engine, t, y, yerr2, n_sweeps: int = 25,
                         learning_rate: float = 3e-2,
                         free_mask: Optional[np.ndarray] = None,
                         base_theta=None):
    """Build ``(init_fn, step_fn, theta_of)`` for a population of adam
    ascents; ``t``, ``y``, ``yerr2`` are tensors on the device.

    ``step_fn(state) -> state`` is one step of every restart: (1) one
    coordinate-ascent sweep refreshes its variational cache, (2) ∂ELBO/∂θ
    through ``n_sweeps`` sweeps by autograd, (3) an adam update in
    log-parameter space (torch.optim.Adam with optax.adam's defaults:
    b1=0.9, b2=0.999, eps=1e-8).  The state's ``z`` is the optimizer's
    parameter and is updated in place.
    """
    if free_mask is None:
        free = None
    else:
        free = torch.as_tensor(np.asarray(free_mask), device=t.device)
        base = torch.as_tensor(np.asarray(base_theta, dtype=float),
                               dtype=t.dtype, device=t.device)

    def theta_of(z):
        th = torch.exp(z)
        if free is not None:
            th = torch.where(free, th, base)
        return th

    def init_fn(thetas):
        """thetas: (B, n_par) initial (positive) parameter vectors."""
        thetas = torch.as_tensor(np.asarray(thetas, dtype=float),
                                 dtype=t.dtype, device=t.device)
        z = torch.log(thetas).requires_grad_(True)
        mu, var = engine.init_mu_var(thetas, y)
        opt = torch.optim.Adam([z], lr=learning_rate, betas=(0.9, 0.999),
                               eps=1e-8)
        return MultistartState(
            z=z, opt_state=opt, mu=mu, var=var,
            best_elbo=torch.full((thetas.shape[0],), -np.inf,
                                 dtype=t.dtype, device=t.device),
            best_z=z.detach().clone())

    def step_fn(state: MultistartState) -> MultistartState:
        z = state.z
        with torch.no_grad():
            # (1) advance every cache one sweep (keeps the unrolled
            # fixed-sweep gradient short)
            _, mu, var = engine.elbo_refine(theta_of(z), t, y, yerr2,
                                            state.mu, state.var, 1)
        # (2) value and gradient through the sweeps; the rows are
        # independent, so the gradient of the sum is each row's own
        with torch.enable_grad():
            elbo = engine.elbo_fixed_batch(theta_of(z), t, y, yerr2, mu,
                                           var, n_sweeps)
            (grad,) = torch.autograd.grad(-elbo.sum(), z)
        elbo = elbo.detach()
        z_before = z.detach().clone()
        z.grad = grad
        state.opt_state.step()
        improved = elbo > state.best_elbo
        return MultistartState(
            z=z, opt_state=state.opt_state, mu=mu, var=var,
            best_elbo=torch.where(improved, elbo, state.best_elbo),
            best_z=torch.where(improved[:, None], z_before, state.best_z))

    return init_fn, step_fn, theta_of


def multistart_optimize(gprn, n_restarts: int = 8, n_steps: int = 100,
                        learning_rate: float = 3e-2, n_sweeps: int = 25,
                        jitter_scale: float = 0.3, seed: int = 0,
                        mesh=None, method: str = "adam"):
    """Run a population of optimizer restarts from perturbed inits on the
    inference's device and install the best hyperparameters into
    ``gprn``.

    ``method='adam'`` (default): gradient ascents through the sweeps.
    ``method='nm'``: scipy-trajectory Nelder-Mead simplexes
    (inference/neldermead.py) in lockstep, ``n_steps`` as the iteration
    cap.  The inits are numpy's ``default_rng(seed)`` perturbations of
    the current parameters, restart 0 unperturbed, as in the JAX package.

    ``mesh``: the restarts split over its ``dp`` axis when B divides by
    it (else every rank runs them all); every rank returns the same.

    Returns a dict with the best ELBO (the variational cache refreshed at
    the winner), the best parameters, the per-restart best ELBOs and the
    winning restart (with ``method='nm'`` also ``nit`` and
    ``converged``).
    """
    rng = np.random.default_rng(seed)
    theta0 = gprn.get_parameters(include_frozen=True)
    frozen = gprn.frozen_mask
    B = n_restarts
    inits = theta0[None, :] * np.exp(
        jitter_scale * rng.standard_normal((B, theta0.size)))
    inits[:, frozen] = theta0[frozen]
    inits[0] = theta0                       # keep one unperturbed restart
    if method not in ("adam", "nm"):
        raise ValueError(f"unknown method {method!r}")
    if method == "nm":
        return _multistart_nm(gprn, inits, frozen, theta0, n_steps,
                              n_sweeps, mesh)

    t, y, yerr2 = gprn._data()
    init_fn, step_fn, theta_of = make_multistart_step(
        gprn.engine, t, y, yerr2, n_sweeps=n_sweeps,
        learning_rate=learning_rate, free_mask=~frozen, base_theta=theta0)

    def ascend(theta_inits):
        state = init_fn(theta_inits)
        for _ in range(n_steps):
            state = step_fn(state)
        return state.best_elbo, state.best_z

    best_elbo, best_z = dp_rows(ascend, mesh, torch.as_tensor(inits))
    best_elbo = best_elbo.cpu().numpy()
    best = int(np.argmax(best_elbo))
    theta_best = theta_of(best_z[best]).cpu().numpy()
    gprn.set_parameters(theta_best)
    elbo, *_ = gprn.ELBOcalc(mu='init', var='init')
    return {"elbo": float(elbo), "theta": theta_best,
            "restart_elbos": best_elbo, "winner": best}


def _multistart_nm(gprn, inits, frozen, theta0, n_steps, n_sweeps, mesh):
    """Population Nelder-Mead: one simplex per restart in lockstep.  The
    objective is −ELBO after ``n_sweeps`` sweeps from the heuristic
    'init' state of the candidate's own θ (each vertex self-contained),
    all candidates of an iteration in one batched call; the simplexes
    split over ``mesh``'s ``dp`` axis as :func:`multistart_optimize`'s."""
    from gpyrn_tpu_torch.inference.neldermead import nelder_mead_multistart

    eng = gprn.engine
    t, y, yerr2 = gprn._data()
    free_idx = torch.as_tensor(np.flatnonzero(~frozen), device=t.device)
    base = gprn._tensor(theta0)

    def objective_batch(X):
        theta = base.expand(X.shape[0], -1).clone()
        theta[:, free_idx] = X
        mu0, var0 = eng.init_mu_var(theta, y)
        return -eng.elbo_fixed_batch(theta, t, y, yerr2, mu0, var0,
                                     n_sweeps)

    def simplexes(x0):
        res, _ = nelder_mead_multistart(None, x0, max_iter=n_steps,
                                        batched_f=objective_batch)
        return res.fun, res.x, res.nit, res.converged

    fun, x, nit, converged = dp_rows(simplexes, mesh,
                                     gprn._tensor(inits[:, ~frozen]))
    elbos = -fun.cpu().numpy()
    best = int(np.argmax(elbos))
    theta_best = theta0.copy()
    theta_best[~frozen] = x[best].cpu().numpy()
    gprn.set_parameters(theta_best)
    elbo, *_ = gprn.ELBOcalc(mu='init', var='init')
    return {"elbo": float(elbo), "theta": theta_best,
            "restart_elbos": elbos, "winner": best,
            "nit": nit.cpu().numpy(), "converged": converged.cpu().numpy()}
