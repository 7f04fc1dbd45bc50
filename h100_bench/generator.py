"""The one traffic generator: a configuration and a traffic mix, both
data, give the data set and, from the run's seed, the batches of
hyperparameter rows the window fits.

Two kinds of mix, told apart by the mix's ``stretch``:

* **cold rows** (no ``stretch``): every batch is ``rows`` rows drawn anew
  from ``--seed`` around the configuration's parameters, each fitted from
  the heuristic start;
* **ensemble half-steps** (``stretch`` a): as ``inference/ensemble.py``'s
  ``_half_step``.  ``2 rows`` walkers lie around the configuration's
  parameters; set-up fits them once, as the sampler's first call does, and
  keeps each walker's converged state.  Every batch is then the proposals
  of one half of the walkers against the other: stretch factors
  z = ((a - 1) u + 1)² / a and partners drawn at random, each proposal
  x_P + z (x_S - x_P) fitted from the state of its walker S, as
  ``_logpost`` passes ``mu[S], var[S]``.  The walkers stay where they
  started (no proposal is accepted), so the work never depends on the
  program's answers.  With ``pass`` the half-steps are a fixed pass,
  repeated in new orders and with a fresh jitter on every row (see
  ``Batches``); without it each is drawn fresh from ``--seed``.

The data set, and an ensemble mix's walkers and pass, come from the mix's
``pool_seed`` where it gives one (the star observed and the sampler's
start, the same in every run), else from ``--seed``; the rows fitted in
the window are never fitted twice.

The data and the rows follow chip_smoke.py (``headline_problem``,
chip_smoke.py:370-385; ``flagship_problem``, :388-404; ``batch_thetas``,
:691-699): sorted times uniform on [0, t_span), output i a sine of period
``periods[i]`` plus Gaussian noise, and each row the configuration's
parameters times exp(spread N(0, 1)), entry by entry.  The data may add
to an output a mean at stated parameters (``data.signals``: a planet in the
radial velocities), computed by the reference's component file.  The
stretch move is
``ensemble.py::_host_draws`` and ``_half_step`` (:257-290).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from h100_bench.reference import components


class Pool(NamedTuple):
    t: np.ndarray                   # (N,)
    y: np.ndarray                   # (p, N)
    yerr: np.ndarray                # (p, N)
    walkers: Optional[np.ndarray]   # (2 rows, n_parameters), ensemble mixes


def _kernel_pars(entry):
    """A kernel entry's parameters; a composite's are its parts', left
    first, as the package's ``Sum.pars`` is ``r_[k1.pars, k2.pars]``."""
    if "of" in entry:
        return [x for e in entry["of"] for x in _kernel_pars(e)]
    return list(entry["pars"])


def theta0(config) -> np.ndarray:
    """The configuration's parameters in the order nodes, weights, means,
    jitters."""
    parts = [_kernel_pars(c) for c in config["nodes"] + config["weights"]]
    parts += [m["pars"] for m in config["means"] if m is not None]
    parts.append(config["jitters"])
    return np.concatenate([np.asarray(p, dtype=float) for p in parts])


def signal(entry, t):
    """The mean ``entry`` at its stated parameters at the times t, by the
    reference's component file, in float64 on the CPU."""
    value = components.Mean(entry).value(
        torch.tensor([entry["pars"]], dtype=torch.float64),
        torch.as_tensor(t, dtype=torch.float64))
    return value[0].numpy()


def data(config, N, rng):
    """(t, y, yerr): output i a sine of period ``periods[i]`` with noise,
    plus the mean ``signals[i]`` where the data name one (a planet)."""
    d = config["data"]
    t = np.sort(rng.uniform(0.0, d["t_span"], N))
    y = np.stack([np.sin(2 * np.pi * t / P) + d["noise"]
                  * rng.standard_normal(N) for P in d["periods"]])
    for i, entry in enumerate(d.get("signals", [])):
        if entry is not None:
            y[i] += signal(entry, t)
    return t, y, np.full_like(y, d["yerr"])


def rows_around(config, traffic, n, rng):
    base = theta0(config)
    return base * np.exp(traffic["spread"]
                         * rng.standard_normal((n, base.size)))


def pool(config, traffic, seed) -> Pool:
    """The data and, for an ensemble mix, the walkers: from the mix's
    ``pool_seed``, or from ``seed`` where it gives none."""
    rng = np.random.default_rng(int(traffic.get("pool_seed", seed)))
    t, y, yerr = data(config, int(traffic["N"]), rng)
    walkers = (rows_around(config, traffic, 2 * int(traffic["rows"]), rng)
               if "stretch" in traffic else None)
    return Pool(t, y, yerr, walkers)


class Batches:
    """The window's batches, drawn from ``seed``.

    An ensemble mix with ``pass`` K repeats a pass of K half-steps, whose
    draws come from the mix's ``pool_seed``: ``--seed`` draws the order of
    each pass and, for every row of every pass, a fresh factor
    exp(``jitter`` N(0, 1)) on each parameter.  So every seed does the
    same work (the same half-steps, the jitter far too small to change a
    fit's sweeps) and no row is fitted twice, while a fit answered from
    an earlier row's result would read a state off by about the jitter,
    far past the check's limits.  Without ``pass`` every half-step is
    drawn fresh from ``--seed``."""

    def __init__(self, config, traffic, pool, seed):
        self.config, self.traffic, self.pool = config, traffic, pool
        self.rows = int(traffic["rows"])
        self.rng = np.random.default_rng(int(seed))
        self.step = 0
        self.queue = []
        self.steps = None
        if pool.walkers is not None and "pass" in traffic:
            # the pass's draws, after the data and the walkers
            rng = np.random.default_rng(int(traffic["pool_seed"]))
            data(config, int(traffic["N"]), rng)
            rows_around(config, traffic, 2 * self.rows, rng)
            self.steps = [self._draw(rng, k)
                          for k in range(int(traffic["pass"]))]

    @property
    def boundary(self):
        """Whether the batches so far end a whole pass (every batch does,
        in a mix without passes)."""
        return not self.queue

    def _draw(self, rng, step):
        """(S, proposals) of one half-step: the walkers ``S`` of half
        ``step % 2`` proposed against the other half."""
        a, h = float(self.traffic["stretch"]), self.rows
        S = np.arange(h) + h * (step % 2)
        C = np.arange(h) + h * (1 - step % 2)
        z = ((a - 1.0) * rng.random(h) + 1.0) ** 2 / a
        partners = C[rng.integers(0, h, size=h)]
        xS, xP = self.pool.walkers[S], self.pool.walkers[partners]
        return S, xP + z[:, None] * (xS - xP)

    def next(self):
        """``(theta (rows, n_parameters), walker)``: the rows of the next
        batch, and for each the walker whose state it starts from (None:
        the heuristic start)."""
        if self.pool.walkers is None:
            return rows_around(self.config, self.traffic, self.rows,
                               self.rng), None
        if self.steps is None:
            self.step += 1
            S, theta = self._draw(self.rng, self.step - 1)
            return theta, S
        if not self.queue:
            self.queue = [self.steps[k]
                          for k in self.rng.permutation(len(self.steps))]
        S, theta = self.queue.pop(0)
        return theta * np.exp(float(self.traffic["jitter"])
                              * self.rng.standard_normal(theta.shape)), S

    def sample(self, n_fits, k, must=()):
        """``k`` distinct fit indices out of ``n_fits``, the ones in
        ``must`` first."""
        chosen = list(dict.fromkeys(int(m) for m in must))[:k]
        rest = [int(i) for i in self.rng.permutation(n_fits)
                if int(i) not in chosen]
        return chosen + rest[:max(0, k - len(chosen))]
