"""Prediction and component plotting.

Port of :mod:`gpyrn_tpu.utils.plots`: a mosaic figure per output with the
data and the posterior predictive band, residual panels with their std,
the posterior weight function(s) with the mean function on a twin axis,
and the posterior node function(s); a sketch of the network; an ELBO
trajectory.  Layouts adapt to p ∈ {1, 2, 3} (larger p falls back to a
uniform per-output stack).  The port's predictions are tensors on the
inference's device: they are brought to the host before they are drawn.
matplotlib is imported inside the functions, so the package imports
without it."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["plot_prediction", "plot_elbo_history", "plot_structure",
           "equal_y_axis"]


def _host(x):
    """A tensor or array as a float numpy array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=float)


def equal_y_axis(ax):
    """Symmetrize the y limits about zero."""
    ylim = ax.get_ylim()
    m = np.max(np.abs(ylim))
    ax.set_ylim(-m, m)


def _layout(p):
    if p == 1:
        return [['pred1', 'd1'],
                ['resid1', 'node']]
    if p == 2:
        return [['pred1', 'd1'],
                ['pred1', 'd1'],
                ['resid1', 'node'],
                ['pred2', 'node'],
                ['pred2', 'd2'],
                ['resid2', 'd2']]
    if p == 3:
        return [['node', 'node'],
                ['node', 'node'],
                ['pred1', 'd1'], ['pred1', 'd1'],
                ['resid1', 'd1'],
                ['pred2', 'd2'], ['pred2', 'd2'],
                ['resid2', 'd2'],
                ['pred3', 'd3'], ['pred3', 'd3'],
                ['resid3', 'd3']]
    # general fallback: one pred/resid/weight row block per output
    rows = [['node', 'node']]
    for i in range(1, p + 1):
        rows += [[f'pred{i}', f'd{i}'], [f'pred{i}', f'd{i}'],
                 [f'resid{i}', f'd{i}']]
    return rows


def plot_prediction(gprn, nn: int = 1000, tstar=None, over: float = 0.2,
                    title=None):
    """Plot the GPRN posterior predictive, residuals, weights and nodes.

    Returns ``(fig, axs)``; ``axs`` is the mosaic dict."""
    import matplotlib.pyplot as plt

    time = np.asarray(gprn.time)
    if tstar is None:
        tptp = np.ptp(time)
        tstar = np.linspace(time.min() - over * tptp,
                            time.max() + over * tptp, nn)

    a = _host(gprn._Prediction()[0])                # at the data times
    aa, vv, bb = gprn._Prediction(tstar=tstar, separate=True)
    aa, ss = _host(aa), np.sqrt(_host(vv))
    node_pred = _host(bb[0])                        # (q, n*)
    weight_pred = _host(bb[1])                      # (q*p, n*)

    fig = plt.figure(constrained_layout=False, figsize=(10, 4 * gprn.p))
    if title is not None:
        fig.suptitle(title)
    axs = fig.subplot_mosaic(_layout(gprn.p))

    means = []
    for i in range(gprn.p):
        ax = axs[f'pred{i + 1}']
        ax.set(xlabel='', ylabel=f'y{i + 1}')
        ax.errorbar(time, gprn.y[i], gprn.yerr[i], fmt='ok', ms=2)
        pred, std = aa[:, i].T, ss[:, i].T
        ax.fill_between(tstar, pred - std, pred + std, alpha=0.1)
        ax.plot(tstar, pred)
        ax.grid(which='major', alpha=0.5)
        ax.grid(which='minor', alpha=0.2)

        resid = gprn.y[i] - a[:, i]
        axr = axs[f'resid{i + 1}']
        axr.errorbar(time, resid, gprn.yerr[i], fmt='ok', ms=2)
        axr.axhline(y=0.0, ls='--', color='k', alpha=0.2)
        axr.set_title(f'std: {resid.std():.2f}', loc='right', fontsize=10)
        equal_y_axis(axr)
        axr.set_ylabel('residuals')

        mean_i = gprn.means[i]
        if mean_i is None or isinstance(mean_i, (int, float)):
            means.append(np.zeros_like(tstar))
        else:
            means.append(_host(mean_i(tstar)))

    for i in range(gprn.p):
        ax = axs[f'd{i + 1}']
        ax.set(xlabel='')
        ax.set_ylabel('weight', color='C0')
        ax.set_title('weight(s) and mean', loc='left', fontsize=10)
        for w in weight_pred[i::gprn.p]:
            ax.plot(tstar, w, alpha=0.6)
        ax.tick_params(axis='y', labelcolor='C0')
        ax2 = ax.twinx()
        ax2.plot(tstar, means[i], color='k', ls='--', alpha=0.6)
        ax2.tick_params(axis='y', labelcolor='k')
        ax2.set_ylabel('mean', color='k')

    axs['node'].set(xlabel='')
    axs['node'].set_title('node' + ('' if gprn.q == 1 else 's'),
                          loc='left', fontsize=10)
    axs['node'].plot(tstar, node_pred.T, '-')
    equal_y_axis(axs['node'])

    ax0 = axs['pred1']
    for ax in axs.values():
        ax.sharex(ax0)
    # hide intermediate x tick labels on the stacked panels so only the
    # bottom row keeps them
    for i in range(gprn.p - 1):
        for key in (f'pred{i + 1}', f'resid{i + 1}', f'd{i + 1}'):
            plt.setp(axs[key].get_xticklabels(), visible=False)
    if gprn.p > 1:
        # pred{p}'s labels go too, as in the JAX package (which keeps the
        # reference's leaked loop index; for p=1 nothing is hidden)
        plt.setp(axs[f'pred{gprn.p}'].get_xticklabels(), visible=False)
    for ax in axs.values():
        ax.axvspan(time[0], time[-1], color='k', alpha=0.05, zorder=-1)
    fig.tight_layout()
    return fig, axs


def plot_structure(gprn, ax=None, title=None):
    """Graphical-model sketch of the GPRN: the q latent node GPs on the
    left, the p observed output series on the right, and one weight-GP
    edge per (node, output) pair, annotated with each component's kernel
    type (and the output's mean function and jitter).  Returns
    ``(fig, ax)``."""
    import matplotlib.pyplot as plt
    gprn._require_components()
    q, p = gprn.q, gprn.p

    def _spread(k):
        return np.linspace(0.85, 0.15, k) if k > 1 else np.array([0.5])

    ys_f, ys_y = _spread(q), _spread(p)
    if ax is None:
        fig, ax = plt.subplots(
            figsize=(7.0, 1.1 * max(q, p) + 1.6), constrained_layout=True)
    else:
        fig = ax.figure

    # weight edges under the boxes; label each with its kernel type
    # while the lattice is small enough to stay legible
    for j in range(q):
        for i in range(p):
            ax.annotate("", xy=(0.72, ys_y[i]), xytext=(0.28, ys_f[j]),
                        arrowprops=dict(arrowstyle="-|>", lw=1.1,
                                        color="0.45",
                                        shrinkA=12, shrinkB=12))
            if q * p <= 12:
                # short tag on the edge; kernel types go in the caption
                # (staggered along the edge so crossings don't collide)
                frac = 0.30 + 0.20 * ((j * p + i) % 3)
                lx = 0.28 + frac * (0.72 - 0.28)
                ly = ys_f[j] + frac * (ys_y[i] - ys_f[j]) \
                    + 0.030 * (-1) ** (j * p + i)
                ax.text(lx, ly, f"w$_{{{j + 1}{i + 1}}}$",
                        ha="center", va="center", fontsize=8,
                        color="0.30",
                        bbox=dict(boxstyle="round,pad=0.15", fc="white",
                                  ec="none", alpha=0.85))

    node_box = dict(boxstyle="circle,pad=0.35", fc="#dbe9f6", ec="#3b6ea5")
    out_box = dict(boxstyle="round,pad=0.35", fc="#e8e8e8", ec="0.35")
    for j, node in enumerate(gprn.nodes):
        ax.text(0.18, ys_f[j], f"f$_{{{j + 1}}}$\n"
                               f"{type(node).__name__}",
                ha="center", va="center", fontsize=9, bbox=node_box)
    for i in range(p):
        mean = gprn.means[i]
        mean_name = "0" if mean is None else type(mean).__name__
        jit = float(gprn.jitters[i]) if i < gprn.jitters.size else 0.0
        ax.text(0.82, ys_y[i], f"y$_{{{i + 1}}}$\n"
                               f"mean: {mean_name}\n"
                               f"jitter: {jit:.3g}",
                ha="center", va="center", fontsize=9, bbox=out_box)

    ax.text(0.18, 0.97, f"latent nodes (q={q})", ha="center", va="top",
            fontsize=9, color="0.25")
    ax.text(0.82, 0.97, f"outputs (p={p})", ha="center", va="top",
            fontsize=9, color="0.25")
    wnames = [type(w).__name__ for w in gprn.weights]
    if len(set(wnames)) == 1:
        caption = f"weight GPs: {wnames[0]} (all {q}×{p})"
    else:
        caption = "weight GPs: " + ", ".join(
            f"w$_{{{j + 1}{i + 1}}}$={wnames[j * p + i]}"
            for j in range(q) for i in range(p))
    ax.text(0.5, 0.015, caption, ha="center", va="bottom", fontsize=8,
            color="0.30", wrap=True)
    if title:
        ax.set_title(title)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.set_axis_off()
    return fig, ax


def plot_elbo_history(elbos, ax=None):
    """Plot an ELBO trajectory (``inference.elbo_history``, a tensor or an
    array) for convergence diagnostics."""
    import matplotlib.pyplot as plt
    if ax is None:
        _, ax = plt.subplots(1, 1, constrained_layout=True)
    elbos = _host(elbos)
    ax.plot(np.arange(1, elbos.size + 1), elbos)
    ax.set(xlabel='iteration', ylabel='ELBO')
    ax.grid(alpha=0.4)
    return ax
