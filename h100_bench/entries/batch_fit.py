"""The batched search's fit: ``Engine.elbo_fit_batch`` of a batch of rows
under the reference rule to at most ``max_iter`` sweeps, each row from the
heuristic start or from a state it is given: the call that
``inference/ensemble.py::_batch_fit`` makes for every ensemble half-step
(each proposal from its walker's cached state) and
``inference/evidence.py::batch_elbo`` for every evidence batch (from the
heuristic start)."""
from __future__ import annotations

import torch

from h100_bench import port
from h100_bench.results import Fits


class Entry:
    def __init__(self, config, traffic, pool, device, dtype):
        self.dtype, self.device = dtype, device
        self.eng = port.engine(config, int(traffic["N"]))
        self.data = port.tensors(pool, dtype, device)
        self.max_iter = int(traffic["max_iter"])

    def _theta(self, theta):
        return torch.as_tensor(theta, dtype=self.dtype, device=self.device)

    def fit(self, theta, start=None, max_iter=None):
        """The fits of ``theta``'s rows, from ``start`` = (mu0, var0)
        where given, else from the heuristic start."""
        th = self._theta(theta)
        mu0, var0 = (self.eng.init_mu_var(th, self.data[1]) if start is None
                     else start)
        elbo, mu, var, n_iter, _ = self.eng.elbo_fit_batch(
            th, *self.data, mu0, var0,
            self.max_iter if max_iter is None else max_iter)
        return Fits(elbo, mu, var, n_iter)

    def walker_states(self, walkers):
        """The walkers' first fit, as ``ensemble._run_chain`` makes it: each
        walker's state where its fit converged, else its heuristic start.
        Returns (mu, var) on the device."""
        th = self._theta(walkers)
        mu0, var0 = self.eng.init_mu_var(th, self.data[1])
        _, mu, var, _, conv = self.eng.elbo_fit_batch(
            th, *self.data, mu0, var0, self.max_iter)
        keep = conv[:, None]
        return torch.where(keep, mu, mu0), torch.where(keep, var, var0)

    def warm_up(self, theta, start=None):
        """A whole batch's first sweeps and its stopping test, then one
        sweep at every smaller batch size the fits pass through as rows
        stop: ``theta``'s rows, from ``start`` where given."""
        for r in range(theta.shape[0], 0, -1):
            part = None if start is None else (start[0][:r], start[1][:r])
            self.fit(theta[:r], part, max_iter=4 if r == theta.shape[0]
                     else 1)
