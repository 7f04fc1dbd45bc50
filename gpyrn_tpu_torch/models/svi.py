"""Stochastic (minibatch-over-outputs) variational fit: the large-p path.

Port of :mod:`gpyrn_tpu.models.svi`.  The node update's data-dependent
quantities are sums over outputs of the likelihood's natural-parameter
statistics,

    dv   = Σ_i (μw_i² + varw_i)/σ_i²,      pred = Σ_i resid_i · μw_i / σ_i²,

so a minibatch S of outputs gives the unbiased estimates (p/|S|)·Σ_{i∈S},
blended into Robbins–Monro averages with step ρ_t = (t₀+t)^(−κ); the node
posterior is the closed form at the averages (κ = 0 and |S| = p is exactly
the dense coordinate-ascent sweep).  The weights of the sampled outputs
take their exact update; the others keep theirs until drawn.  Per step: q
node factorizations and q·|S| weight factorizations, each GP's K rebuilt
in its update (``Engine._gp_update_lean``, B1 on the card).

All q·p weight kernels must share one structure (the JAX package gathers
the sampled outputs through a traced index).

The subsets: the JAX package draws ``jax.random.choice(fold_in(
PRNGKey(seed), i), p, (B,), replace=False)`` per step i, which torch
cannot reproduce.  Here they come from a ``torch.Generator`` on the
state's device seeded with ``seed`` (the first B entries of a random
permutation per step), or are given as ``draws`` (n_steps, B): fed the JAX
package's subsets, the fit is the JAX package's.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from gpyrn_tpu_torch.models.gprn import GPRNSpec, Engine

__all__ = ["SVIEngine", "make_svi_fit", "run_svi", "device_subsets"]


class SVIEngine(NamedTuple):
    """The stochastic fit of one model structure."""
    spec: GPRNSpec
    batch_p: int
    fit_state_svi: Callable  # (theta, t, y, yerr2, mu0, var0, n_steps,
    #                           seed, t0, kappa, draws=None) -> (mu, var)


def device_subsets(p, batch_p, n_steps, seed, device):
    """``n_steps`` subsets of ``batch_p`` distinct outputs out of ``p``,
    (n_steps, batch_p), from a ``torch.Generator`` on ``device`` seeded
    with ``seed``: the default draws of ``fit_state_svi``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    if n_steps == 0:
        return torch.zeros((0, batch_p), dtype=torch.long, device=device)
    return torch.stack([torch.randperm(p, generator=gen,
                                       device=device)[:batch_p]
                        for _ in range(n_steps)])


def make_svi_fit(spec: GPRNSpec, batch_p: int,
                 core_maps: Optional[Tuple] = None) -> SVIEngine:
    """Build the minibatch-over-outputs fit for ``spec``; ``batch_p`` is
    the outputs sampled per step (1 ≤ batch_p ≤ p)."""
    q, p, N = spec.q, spec.p, spec.N
    B = int(batch_p)
    if not 1 <= B <= p:
        raise ValueError(f"batch_p must be in [1, {p}], got {B}")
    if len(set(spec.weight_structs)) != 1:
        raise ValueError(
            "the SVI fit samples outputs through a gather, so all weight "
            "kernels must share one structure; got "
            f"{len(set(spec.weight_structs))} distinct structures (their "
            "parameters may still differ per weight)")
    w_struct = spec.weight_structs[0]
    scale = p / B
    eng = Engine(spec, core_maps)

    def fit_state_svi(theta, t, y, yerr2, mu0, var0, n_steps, seed, t0,
                      kappa, draws=None):
        """``n_steps`` stochastic steps from (mu0, var0): ``(mu, var)``.
        ``draws`` (n_steps, B) gives each step's sampled outputs; by
        default :func:`device_subsets` draws them on the state's
        device."""
        n_steps = int(n_steps)
        node_c, weight_c = eng._lean_cores(theta)
        # mapped weight params stacked node-major: (q, p, n_wpar)
        Wp = torch.stack([torch.stack([weight_c[j * p + i]
                                       for i in range(p)])
                          for j in range(q)])
        y_c, _, variance = eng._prepare_lean(theta, t, y, yerr2)
        muF, muW = eng._u_split(mu0.reshape(-1))
        varF, varW = eng._u_split(var0.reshape(-1))
        if draws is None:
            draws = device_subsets(p, B, n_steps, seed, muF.device)
        draws = torch.as_tensor(draws, dtype=torch.long, device=muF.device)
        if tuple(draws.shape) != (n_steps, B):
            raise ValueError(f"draws must be ({n_steps}, {B}), got "
                             f"{tuple(draws.shape)}")

        # full-batch natural statistics at the entry state
        var_w = variance[:, None, :]
        dv_avg = torch.sum((muW * muW + varW) / var_w, dim=0)
        total = torch.einsum("pqn,qn->pn", muW, muF)
        resid = (y_c[None, :, :] - total[None, :, :]
                 + muW.transpose(0, 1) * muF[:, None, :])
        pred_avg = torch.einsum("qpn,pqn->qn", resid, muW / var_w)
        kappa = torch.as_tensor(kappa, dtype=muF.dtype, device=muF.device)
        t0 = torch.as_tensor(t0, dtype=muF.dtype, device=muF.device)
        Wp_out = Wp.transpose(0, 1)                 # (p, q, n_wpar)

        for i in range(n_steps):
            S = draws[i]
            y_S, var_S = y_c[S], variance[S]         # (B, N)
            muW_S, varW_S = muW[S], varW[S]          # (B, q, N)

            # -- node stage: SVI natural-parameter averaging --
            dv_S = scale * torch.sum(
                (muW_S * muW_S + varW_S) / var_S[:, None, :], dim=0)
            total_S = torch.einsum("bqn,qn->bn", muW_S, muF)
            resid_S = (y_S[:, None, :] - total_S[:, None, :]
                       + muW_S * muF[None, :, :])
            pred_S = scale * torch.einsum("bqn,bqn->qn", resid_S,
                                          muW_S / var_S[:, None, :])
            rho = (t0 + i) ** (-kappa)
            dv_avg = (1.0 - rho) * dv_avg + rho * dv_S
            pred_avg = (1.0 - rho) * pred_avg + rho * pred_S
            rows = [eng._gp_update_lean(s, node_c[j], t, 1.0 / dv_avg[j],
                                        pred_avg[j])
                    for j, s in enumerate(spec.node_structs)]
            muF = torch.stack([r[0] for r in rows])
            varF = torch.stack([r[1] for r in rows])

            # -- weight stage: exact updates of the sampled outputs --
            dv2 = muF * muF + varF                   # (q, N)
            ratio = var_S[:, None, :] / dv2[None, :, :]     # (B, q, N)
            total2_S = torch.einsum("bqn,qn->bn", muW_S, muF)
            resid2_S = (y_S[:, None, :] - total2_S[:, None, :]
                        + muW_S * muF[None, :, :])
            pred2_S = resid2_S * muF[None, :, :] / var_S[:, None, :]
            Wp_S = Wp_out[S]                         # (B, q, n_wpar)
            rows = [eng._gp_update_lean(w_struct, Wp_S[b, j], t,
                                        ratio[b, j], pred2_S[b, j])
                    for b in range(B) for j in range(q)]
            muW, varW = muW.clone(), varW.clone()
            muW[S] = torch.stack([r[0] for r in rows]).reshape(B, q, N)
            varW[S] = torch.stack([r[1] for r in rows]).reshape(B, q, N)
        return eng._u_join(muF, muW), eng._u_join(varF, varW)

    return SVIEngine(spec=spec, batch_p=B, fit_state_svi=fit_state_svi)


def run_svi(gprn, n_steps: int = 600, batch_p: Optional[int] = None,
            seed: int = 0, t0: float = 5.0, kappa: float = 0.6,
            install: bool = True, draws=None):
    """Run the stochastic fit on a port ``inference`` from its heuristic
    start.  ``batch_p`` defaults to p // 4 (at least 1).  Returns ``(mu,
    var)``, float64 tensors on the inference's device; with ``install``
    they become its cached variational state."""
    gprn._require_components()
    if batch_p is None:
        batch_p = max(1, gprn.p // 4)
    eng = gprn._svi_engine(batch_p)
    theta = gprn._theta()
    mu0, var0 = gprn.engine.init_mu_var(theta, gprn._tensor(gprn.y))
    mu, var = eng.fit_state_svi(theta, *gprn._data(), mu0, var0,
                                int(n_steps), int(seed), float(t0),
                                float(kappa), draws=draws)
    if install:
        gprn._mu, gprn._var = mu, var
    return mu, var
