"""Anderson-accelerated fixed-point solver (host orchestration).

The port's own copy of ``gpyrn_tpu/ops/fixedpoint.py``: numpy float64 on
the host with the same arithmetic, so both packages' solvers give the same
iterates on the same map.  ``F`` is the only place that touches the device.

The mean-field coordinate-ascent sweep x ← F(x) converges linearly with a
spectral radius that approaches 1 as N grows; Anderson mixing (Anderson
1965; Walker & Ni 2011, type II) extrapolates over the last ``memory``
residuals and cuts hundreds of plain sweeps to a few dozen F-evaluations.
The state is O(N) (variational means and variances), so the numpy
least-squares mixing is free next to one O(N³) device sweep.

The merit safeguard keeps the ascent honest: every candidate is scored by
the merit of its own plain sweep (for the GPRN polish, the ELBO), and an
extrapolation that loses merit is rejected and replaced by the plain
iteration, whose monotone ascent is guaranteed for coordinate ascent.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

__all__ = ["anderson_fixed_point"]


def anderson_fixed_point(F: Callable[[np.ndarray],
                                     Tuple[np.ndarray, float]],
                         x0: np.ndarray,
                         memory: int = 8,
                         max_evals: int = 60,
                         rel_tol: float = 1e-8,
                         clamp: Optional[Callable[[np.ndarray],
                                                  np.ndarray]] = None,
                         verbose: bool = False,
                         stall_patience: Optional[int] = None,
                         stall_tol: float = 0.0):
    """Accelerate the fixed-point iteration ``x ← F(x)``.

    Args:
        F: one application of the map; returns ``(F(x), merit)`` where
            ``merit`` is a scalar the iteration ASCENDS (the ELBO for
            the GPRN sweep map).  Candidates whose merit regresses are
            rejected (history reset, plain step taken instead).  The
            merit must be a genuine Lyapunov function of the plain
            iteration — monotone under F with its maximizer AT the
            fixed point.  A residual norm is NOT one far from the
            fixed point (it can reward spurious low-residual regions
            and trap the safeguard); coordinate-ascent objectives like
            the ELBO are.
        x0: initial state (1-D float64).
        memory: Anderson depth m (number of residual differences kept).
        max_evals: hard cap on F-evaluations.
        rel_tol: stop when the relative merit change between consecutive
            accepted evaluations stays below this twice in a row.
        clamp: optional projection applied to every extrapolated
            candidate (e.g. flooring variances at a positive value —
            extrapolation is not constrained to the feasible set).
        stall_patience: when set, ALSO stop once ``stall_patience``
            consecutive evaluations fail to improve the best merit
            seen by more than ``stall_tol·max(1, |best|)``, and return
            the best-merit state instead of the last one.  This is the
            stop for maps whose arithmetic has a merit noise floor
            (the float32 GPRN sweep: state and ELBO wobble at the
            rounding floor forever, so neither a state tolerance nor
            ``rel_tol`` can ever fire) — the iteration ends where
            systematic ascent ends.
        stall_tol: relative merit-improvement threshold for the stall
            rule (see ``stall_patience``).

    Returns:
        ``(x, merit, info)`` — ``x`` is the final post-sweep state
        F(candidate) (always the output of a genuine map application,
        never a raw extrapolation; the best-merit one when the stall
        rule fired), ``merit`` its merit, and ``info`` a dict with
        ``evals``, ``rejects``, ``rel`` (last relative merit change),
        ``res`` (last residual ∞-norm, scaled), and ``stalled``.
    """
    x = np.asarray(x0, dtype=np.float64)
    Fx, e = F(x)
    evals, rejects = 1, 0
    g = Fx - x
    dx_hist, dg_hist = [], []
    rel = np.inf
    calm = 0
    stall = 0
    stalled = False
    best_x, best_e = Fx, e

    def _note(Fc_, ec_):
        """Track the best-merit post-sweep state for the stall rule."""
        nonlocal best_x, best_e, stall
        if ec_ > best_e + stall_tol * max(1.0, abs(best_e)):
            best_x, best_e = Fc_, ec_
            stall = 0
        else:
            stall += 1

    while evals < max_evals:
        extrapolated = bool(dx_hist)
        if extrapolated:
            G = np.stack(dg_hist, axis=1)
            X = np.stack(dx_hist, axis=1)
            gamma, *_ = np.linalg.lstsq(G, g, rcond=None)
            cand = Fx - (X + G) @ gamma
            if clamp is not None:
                cand = clamp(cand)
            # stagnation guard: a clamped extrapolation that lands back
            # on the current iterate would re-evaluate the same point
            # with the same merit forever (and fool the rel-stop at a
            # NON-fixed point) — fall back to the plain iteration
            if np.max(np.abs(cand - x)) <= 1e-14 * (
                    1.0 + np.max(np.abs(x))):
                dx_hist.clear()
                dg_hist.clear()
                extrapolated = False
        if not extrapolated:
            cand = Fx if clamp is None else clamp(Fx)
        Fc, ec = F(cand)
        evals += 1
        _note(Fc, ec)
        if extrapolated and ec < e - 1e-12 * abs(e):
            # extrapolation regressed the merit: drop the history and
            # fall back to the plain iteration (monotone by
            # construction for coordinate ascent)
            rejects += 1
            calm = 0
            dx_hist.clear()
            dg_hist.clear()
            if evals >= max_evals:
                break
            cand = Fx if clamp is None else clamp(Fx)
            Fc, ec = F(cand)
            evals += 1
            _note(Fc, ec)
        g_new = Fc - cand
        dx_hist.append(cand - x)
        dg_hist.append(g_new - g)
        if len(dx_hist) > memory:
            dx_hist.pop(0)
            dg_hist.pop(0)
        rel = abs(ec - e) / max(abs(ec), 1.0)
        x, Fx, g, e = cand, Fc, g_new, ec
        if verbose:
            res = float(np.max(np.abs(g)) / (1.0 + np.max(np.abs(Fx))))
            print(f"  anderson eval={evals} merit={e:.10g} "
                  f"rel={rel:.3e} res={res:.3e}", flush=True)
        calm = calm + 1 if rel < rel_tol else 0
        if calm >= 2:
            break
        if stall_patience is not None and stall >= stall_patience:
            stalled = True
            break
    res = float(np.max(np.abs(g)) / (1.0 + np.max(np.abs(Fx))))
    if stall_patience is not None:
        # merit is the quantity the caller wants maximized — return the
        # best post-sweep state seen, not wherever the noise walk ended
        Fx, e = best_x, best_e
    return Fx, e, {"evals": evals, "rejects": rejects,
                   "rel": float(rel), "res": res, "stalled": stalled}
