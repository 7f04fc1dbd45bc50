"""The large-N reference fit: ``inference.ELBOcalc`` from the heuristic
start under the reference rule, to at most ``max_iter`` sweeps, one row
at a time; from ``LEAN_N`` on it takes ``Engine.elbo_fit_lean``.

ELBOcalc fits in float64 only; in another dtype (the correctness
control's) the same engine call is fed tensors of that dtype."""
from __future__ import annotations

import torch

from h100_bench import port
from h100_bench.results import Fits


class Entry:
    def __init__(self, config, traffic, pool, device, dtype):
        from gpyrn_tpu_torch import inference
        data = [a for i in range(pool.y.shape[0])
                for a in (pool.y[i], pool.yerr[i])]
        self.g = inference(int(config["q"]), pool.t, *data, device=device)
        self.g.set_components(*port.components(config))
        self.max_iter = int(traffic["max_iter"])
        self.dtype, self.device = dtype, device
        if dtype != torch.float64:
            self.data = port.tensors(pool, dtype, device)

    def _fit(self, row, max_iter):
        if self.dtype == torch.float64:
            self.g.set_parameters(row)
            return self.g.ELBOcalc(max_iter=max_iter)
        eng = self.g.engine
        th = torch.as_tensor(row, dtype=self.dtype, device=self.device)
        mu0, var0 = eng.init_mu_var(th, self.data[1])
        fit = eng.elbo_fit_lean if self.g._lean() else eng.elbo_fit
        elbo, mu, var, n_iter, _, _ = fit(th, *self.data, mu0, var0,
                                          max_iter)
        return float(elbo), mu, var, n_iter

    def fit(self, theta, start=None, max_iter=None):
        if start is not None:
            raise ValueError("ELBOcalc's fits here start from the heuristic")
        out = [self._fit(row, self.max_iter if max_iter is None
                         else max_iter) for row in theta]
        return Fits(torch.tensor([o[0] for o in out], dtype=torch.float64),
                    torch.stack([o[1] for o in out]),
                    torch.stack([o[2] for o in out]),
                    torch.tensor([int(o[3]) for o in out]))

    def warm_up(self, theta, start=None):
        self.fit(theta[:1], start, max_iter=1)
