"""Nelder-Mead on the device: scipy's simplex trajectory, all candidates of
an iteration in one batched call.

Port of :mod:`gpyrn_tpu.inference.neldermead`.  scipy's algorithm
evaluates one or two points per iteration (the reflection, then maybe the
expansion or a contraction) and n more on a shrink.  Here every iteration
evaluates all n + 4 candidates at once,

    [x_reflect, x_expand, x_out_contract, x_in_contract,
     shrink row 1, ..., shrink row n],

which depend only on the current sorted simplex, and selects scipy's
outcome with the same arithmetic masks as the JAX package.  The simplex
trajectory, and so the answer, is scipy's ``method='Nelder-Mead'`` up to
floating-point associativity; ``nfev`` counts the evaluations scipy would
have made on that trajectory, not the larger number evaluated here.

The simplexes stay on the objective's device; one boolean per simplex
comes to the host per iteration.  :func:`nelder_mead_multistart` runs a
population of simplexes as one ``(m, n+1, n)`` tensor: each member has its
own stopping test, and a member that has stopped keeps its simplex, its
``nit`` and its ``nfev`` (the semantics of JAX's ``vmap`` over the
simplex loop) and is no longer evaluated.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["nelder_mead", "nelder_mead_multistart", "NMResult",
           "initial_simplex"]


class NMResult(NamedTuple):
    """The scipy result fields the reference surface uses, as tensors."""
    x: torch.Tensor          # best vertex
    fun: torch.Tensor        # objective there
    nit: torch.Tensor        # iterations taken
    nfev: torch.Tensor       # scipy-equivalent function-eval count
    converged: torch.Tensor  # xatol+fatol test passed (vs hitting max_iter)


def _as_points(x, device):
    """A tensor of the given points: a float tensor as it is, anything
    else as float64 on ``device``."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x
    return torch.as_tensor(np.asarray(x, dtype=float), device=device)


def initial_simplex(x0, nonzdelt=0.05, zdelt=0.00025, device="cuda"):
    """scipy's default initial simplex: vertex k+1 perturbs coordinate k
    by 5% (or sets 0.00025 where x0[k] == 0).  A non-tensor ``x0`` goes
    to ``device``."""
    x0 = torch.atleast_1d(_as_points(x0, device))
    n = x0.shape[0]
    pert = torch.where(x0 == 0, torch.full_like(x0, zdelt),
                       (1.0 + nonzdelt) * x0)
    sim = x0.expand(n + 1, n).clone()
    k = torch.arange(n, device=x0.device)
    sim[k + 1, k] = pert
    return sim


def _coeffs(n: int, adaptive: bool):
    if adaptive:        # Gao & Han 2012, as in scipy
        dim = float(n)
        return 1.0, 1.0 + 2.0 / dim, 0.75 - 1.0 / (2.0 * dim), \
            1.0 - 1.0 / dim
    return 1.0, 2.0, 0.5, 0.5           # rho, chi, psi, sigma


def _sorted(sim, fsim):
    """The simplexes (m, n+1, n) with their vertices in ascending order of
    the objective (a stable sort, as JAX's argsort)."""
    order = torch.argsort(fsim, dim=1, stable=True)
    return (torch.take_along_dim(sim, order[..., None], dim=1),
            torch.take_along_dim(fsim, order, dim=1))


def _done(sim, fsim, xatol, fatol):
    """scipy's stopping test per simplex: every vertex within ``xatol`` of
    the best in every coordinate, every value within ``fatol``."""
    dx = torch.amax(torch.abs(sim[:, 1:] - sim[:, :1]), dim=(1, 2))
    df = torch.amax(torch.abs(fsim[:, :1] - fsim[:, 1:]), dim=1)
    return (dx <= xatol) & (df <= fatol)


def _pick(masks, values, default):
    """``values[i]`` where ``masks[i]`` holds first, else ``default``: the
    nested selects of the JAX package, innermost last."""
    out = default
    for mask, value in zip(reversed(masks), reversed(values)):
        out = torch.where(mask, value, out)
    return out


def _population(fbatch, sim, xatol, fatol, max_iter, adaptive):
    """The simplex loop over a population (m, n+1, n); returns the
    per-member (x, fun, nit, nfev, converged)."""
    m, _, n = sim.shape
    rho, chi, psi, sigma = _coeffs(n, adaptive)
    dev = sim.device
    fsim = fbatch(sim.reshape(-1, n)).reshape(m, n + 1)
    sim, fsim = _sorted(sim, fsim)
    # scipy checks convergence at the loop top and counts iterations from
    # 1, so an already-converged initial simplex reports nit == 1
    done = _done(sim, fsim, xatol, fatol)
    nit = np.ones(m, dtype=np.int64)
    nfev = torch.full((m,), n + 1, dtype=torch.int64, device=dev)
    active = ~done.cpu().numpy() & (nit < max_iter)
    while active.any():
        a = torch.as_tensor(np.flatnonzero(active), device=dev)
        S, F = sim[a], fsim[a]
        k = S.shape[0]
        xbar = torch.mean(S[:, :-1], dim=1)
        worst = S[:, -1]
        cand = torch.stack([
            (1 + rho) * xbar - rho * worst,                  # reflect
            (1 + rho * chi) * xbar - rho * chi * worst,      # expand
            (1 + psi * rho) * xbar - psi * rho * worst,      # contract
            (1 - psi) * xbar + psi * worst,                  # in-contract
        ], dim=1)
        shrink_pts = S[:, :1] + sigma * (S[:, 1:] - S[:, :1])  # rows 1..n
        fall = fbatch(torch.cat([cand, shrink_pts], dim=1)
                      .reshape(-1, n)).reshape(k, n + 4)
        fxr, fxe, fxc, fxcc = fall[:, 0], fall[:, 1], fall[:, 2], fall[:, 3]
        fshrink = fall[:, 4:]
        f0, f_second, f_last = F[:, 0], F[:, -2], F[:, -1]

        # scipy's decision tree as masks (flow: _minimize_neldermead)
        take_e = (fxr < f0) & (fxe < fxr)
        take_r = ((fxr < f0) & ~(fxe < fxr)) | \
                 (~(fxr < f0) & (fxr < f_second))
        try_c = ~(fxr < f0) & ~(fxr < f_second) & (fxr < f_last)
        take_c = try_c & (fxc <= fxr)
        try_cc = ~(fxr < f0) & ~(fxr < f_second) & ~(fxr < f_last)
        take_cc = try_cc & (fxcc < f_last)
        do_shrink = (try_c & ~(fxc <= fxr)) | (try_cc & ~(fxcc < f_last))

        masks = (take_e, take_r, take_c, take_cc)
        new_last = _pick([mk[:, None] for mk in masks],
                         [cand[:, 1], cand[:, 0], cand[:, 2], cand[:, 3]],
                         worst)
        new_flast = _pick(masks, [fxe, fxr, fxc, fxcc], f_last)
        S1 = torch.cat([S[:, :-1], new_last[:, None]], dim=1)
        F1 = torch.cat([F[:, :-1], new_flast[:, None]], dim=1)
        S1 = torch.where(do_shrink[:, None, None],
                         torch.cat([S[:, :1], shrink_pts], dim=1), S1)
        F1 = torch.where(do_shrink[:, None],
                         torch.cat([F[:, :1], fshrink], dim=1), F1)
        S1, F1 = _sorted(S1, F1)
        # scipy-equivalent eval count: reflect always; +1 for the expansion
        # or contraction it would have tried; +n on a shrink
        one = torch.ones_like(nfev[a])
        nfev[a] = nfev[a] + 1 \
            + torch.where((fxr < f0) | try_c | try_cc, one, 0 * one) \
            + torch.where(do_shrink, n * one, 0 * one)
        sim[a], fsim[a] = S1, F1
        done[a] = _done(S1, F1, xatol, fatol)
        nit[active] += 1
        active = ~done.cpu().numpy() & (nit < max_iter)
    return (sim[:, 0], fsim[:, 0], torch.as_tensor(nit, device=dev), nfev,
            done)


def nelder_mead(f: Callable, x0, *, xatol=1e-4, fatol=1e-4,
                max_iter: int | None = None, adaptive: bool = False,
                simplex0=None, batched_f: Callable | None = None,
                device="cuda"):
    """Minimize ``f`` with Nelder-Mead, the simplex on the device.

    Parameters
    ----------
    f : callable
        ``f(x) -> scalar`` on a (n,) tensor (unused, and may be None, when
        ``batched_f`` is given).
    batched_f : callable, optional
        ``batched_f(X) -> values`` for a (k, n) batch of points.  By
        default ``torch.func.vmap(f)``; pass an engine's batched objective
        (a θ-batched ELBO) to skip the vmap.
    simplex0 : (n+1, n) array, optional
        Initial simplex (defaults to scipy's 5%/0.00025 perturbations).

    A tensor ``x0`` gives the device and dtype; other input becomes
    float64 on ``device`` (``"cpu"`` only when asked for).  Returns :class:`NMResult`; ``nfev`` counts the
    evaluations scipy would have performed on the same trajectory."""
    x0 = torch.atleast_1d(_as_points(x0, device))
    n = int(x0.shape[0])
    if n < 1:
        raise ValueError("x0 must have at least one element")
    if max_iter is None:
        max_iter = 200 * n              # scipy default
    fbatch = batched_f if batched_f is not None else torch.func.vmap(f)
    sim = _as_points(simplex0, x0.device).to(x0) if simplex0 is not None \
        else initial_simplex(x0)
    x, fun, nit, nfev, done = _population(fbatch, sim[None].clone(), xatol,
                                          fatol, max_iter, adaptive)
    return NMResult(x[0], fun[0], nit[0], nfev[0], done[0])


def nelder_mead_multistart(f: Callable, x0s, *, xatol=1e-4, fatol=1e-4,
                           max_iter: int | None = None,
                           adaptive: bool = False,
                           batched_f: Callable | None = None,
                           device="cuda"):
    """Run one simplex per row of ``x0s`` (m, n) in lockstep on the device
    and return the population :class:`NMResult` (each field with a
    leading m axis) and the index of the best restart.  ``batched_f`` and
    ``device`` as in :func:`nelder_mead`: the candidates of every running
    member go to ``batched_f`` in one call."""
    x0s = torch.atleast_2d(_as_points(x0s, device))
    if max_iter is None:
        max_iter = 200 * int(x0s.shape[1])
    fbatch = batched_f if batched_f is not None else torch.func.vmap(f)
    sims = torch.stack([initial_simplex(x0) for x0 in x0s])
    res = NMResult(*_population(fbatch, sims, xatol, fatol, max_iter,
                                adaptive))
    return res, torch.argmin(res.fun)
