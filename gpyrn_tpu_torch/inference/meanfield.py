"""Mean-field variational inference for GPRNs — user-facing API.

Port of the fit-and-predict subset of :mod:`gpyrn_tpu.inference.meanfield`:
``inference(q, time, y1, y1err, ..., device=...)``, ``set_components``,
``get_parameters`` / ``set_parameters``, ``ELBO`` / ``ELBOcalc`` and
``predict`` / ``_Prediction``, over the engine of
:mod:`gpyrn_tpu_torch.models.gprn`.

The device is chosen by the caller (``device="cpu"`` by default, never
detected); the data and every result live there as float64 tensors.
"""
from __future__ import annotations

from itertools import chain

import numpy as np
import torch

from gpyrn_tpu_torch.config import DEFAULT_DTYPE
from gpyrn_tpu_torch.models import gprn as _core
from gpyrn_tpu_torch.ops import kernels as covfunc
from gpyrn_tpu_torch.ops import means as meanfunc

__all__ = ["inference"]


class inference:
    """Mean-field variational inference for GPRNs
    (Nguyen & Bonilla 2013).

    Args:
        q: number of latent node functions f(x)
        time: time coordinates
        *args: observed data as y1, y1error, y2, y2error, ...
        device: torch device the fit and prediction run on

    The ``'random'`` starting state draws from ``self.generator``, a CPU
    ``torch.Generator`` (seed it with ``self.generator.manual_seed``).
    """

    def __init__(self, q: int, time, *args, device="cpu"):
        self.q = q
        self.time = np.asarray(time, dtype=float)
        self.N = self.time.size
        self.device = torch.device(device)
        self.dtype = DEFAULT_DTYPE

        if len(args) == 0 or len(args) % 2:
            raise ValueError('Number of observed data arrays should be '
                             'even: y1, y1error, ...')
        if any(len(a) != self.N for a in args):
            raise ValueError('Output arrays should all have the same '
                             'dimensions as time')

        self.p = len(args) // 2
        self.qp = self.q * self.p
        self.d = self.N * self.q * (self.p + 1)

        self.y = np.stack([np.asarray(a, dtype=float) for a in args[::2]])
        self.yerr = np.stack([np.asarray(a, dtype=float) for a in args[1::2]])
        self.yerr2 = self.yerr ** 2

        self.generator = torch.Generator()
        self._components_set = False
        self._mu, self._var = None, None
        self._engine = None

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, dtype=float), dtype=self.dtype,
                               device=self.device)

    # ------------------------------------------------------------------
    # components & parameters
    # ------------------------------------------------------------------

    def set_components(self, nodes, weights, means, jitters):
        """Set the GPRN components: nodes, weights, means, and jitters."""
        if isinstance(nodes, covfunc.covFunction):
            nodes = [nodes]
        if len(nodes) != self.q:
            raise ValueError('Wrong number of nodes provided, '
                             f'expected {self.q} got {len(nodes)}')

        if isinstance(weights, covfunc.covFunction):
            weights = [weights]
        if len(weights) != self.qp:
            raise ValueError('Wrong number of weights provided, '
                             f'expected {self.qp} got {len(weights)}')

        if isinstance(means, (int, float, meanfunc.meanFunction)) \
                or means is None:
            means = [means]
        means = [None if isinstance(m, (int, float)) or m is None else m
                 for m in means]
        if len(means) != self.p:
            # a single mean broadcasts to the p outputs
            if len(means) == 1:
                means = means * self.p
            else:
                raise ValueError('Wrong number of means provided, '
                                 f'expected {self.p} got {len(means)}')

        if isinstance(jitters, (int, float)):
            jitters = [jitters]

        self.nodes = list(nodes)
        self.weights = list(weights)
        self.means = means
        self.jitters = np.array(jitters, dtype=float)
        self._components_set = True
        self._engine = None     # structure changed: rebuild lazily

    def _require_components(self):
        if not self._components_set:
            raise ValueError('GPRN components not set, use set_components')

    def _get_components(self, nodes=None, weights=None, means=None,
                        jitters=None):
        all_none = all(i is None for i in (nodes, weights, means, jitters))
        if all_none and not self._components_set:
            raise ValueError('GPRN components not set, use set_components')
        nodes = self.nodes if nodes is None else nodes
        weights = self.weights if weights is None else weights
        means = self.means if means is None else means
        jitters = self.jitters if jitters is None else jitters
        return nodes, weights, means, jitters

    def get_parameters(self, nodes=None, weights=None, means=None,
                       jitters=None):
        """Values of all GPRN parameters as a flat vector, in the order
        nodes → weights → means → jitters."""
        nodes, weights, means, jitters = self._get_components(
            nodes, weights, means, jitters)
        return _core.pack_parameters(nodes, weights, means, jitters)

    def set_parameters(self, parameters):
        """Set values for all GPRN parameters (the full vector)."""
        self._require_components()
        parameters = np.atleast_1d(np.asarray(parameters, dtype=float))
        if parameters.size != self.n_parameters:
            raise ValueError(f'Wrong number of parameters provided: got '
                             f'{parameters.size}, expected '
                             f'{self.n_parameters}')
        it = [self.nodes, self.weights,
              [m for m in self.means if m is not None]]
        for component in chain.from_iterable(it):
            parameters = component.set_parameters(parameters)
        self.jitters = np.atleast_1d(np.asarray(parameters, dtype=float))

    @property
    def n_parameters(self):
        """Total number of parameters."""
        self._require_components()
        it = [self.nodes, self.weights,
              [m for m in self.means if m is not None]]
        return sum(c.pars.size for c in chain.from_iterable(it)) + \
            self.jitters.size

    # ------------------------------------------------------------------
    # engine plumbing
    # ------------------------------------------------------------------

    @property
    def engine(self) -> _core.Engine:
        """The fit-and-predict engine of the current model structure."""
        self._require_components()
        if self._engine is None:
            spec = _core.spec_from_components(self.nodes, self.weights,
                                              self.means, self.N)
            core_maps = None
            kernels = self.nodes + self.weights
            if any(k.has_core_map() for k in kernels):
                core_maps = (
                    tuple(k.core_params_from if k.has_core_map() else None
                          for k in self.nodes),
                    tuple(k.core_params_from if k.has_core_map() else None
                          for k in self.weights))
            self._engine = _core.Engine(spec, core_maps)
        return self._engine

    def _theta(self, nodes=None, weights=None, means=None, jitters=None):
        return self._tensor(self.get_parameters(nodes, weights, means,
                                                jitters))

    def _resolve_mu_var(self, mu, var, theta):
        """Starting state: arrays, or 'init' | 'random' | 'previous'."""
        if mu is None or var is None:
            mu = var = 'init'
        if isinstance(mu, str) and (mu == 'previous' or var == 'previous'):
            if self._mu is not None:
                return self._mu.reshape(-1), self._var.reshape(-1)
            return self.engine.init_mu_var(theta, self._tensor(self.y))
        if isinstance(mu, str) and mu == 'random' and var == 'random':
            return self._randomMuVar()
        if isinstance(mu, str) and mu == 'init' and var == 'init':
            return self.engine.init_mu_var(theta, self._tensor(self.y))
        if isinstance(mu, str) or isinstance(var, str):
            raise ValueError(f"mu/var must be arrays or 'init' | 'random' | "
                             f"'previous', got {mu!r}, {var!r}")
        return (torch.as_tensor(mu, dtype=self.dtype,
                                device=self.device).reshape(-1),
                torch.as_tensor(var, dtype=self.dtype,
                                device=self.device).reshape(-1))

    def _randomMuVar(self):
        mu = torch.randn(self.d, generator=self.generator, dtype=self.dtype)
        var = torch.rand(self.d, generator=self.generator, dtype=self.dtype)
        return mu.to(self.device), var.to(self.device)

    # ------------------------------------------------------------------
    # ELBO
    # ------------------------------------------------------------------

    @property
    def ELBO(self):
        """The evidence lower bound for the GPRN."""
        return self.ELBOcalc()[0]

    def ELBOcalc(self, nodes=None, weights=None, means=None, jitters=None,
                 max_iter=None, mu=None, var=None, precision=None):
        """Run the coordinate-ascent fit of the variational parameters and
        return ``(ELBO, mu, var, iterNumber)``; mu and var are tensors on
        the inference's device.

        mu/var may be arrays or 'init' | 'random' | 'previous'.
        ``precision=None`` fits in float64."""
        if precision == 'mixed':
            raise NotImplementedError(
                "precision='mixed' (float32 bulk fit + float64 polish) is "
                "not ported yet: it comes with fit_state / "
                "fit_state_stall, after the gradient path")
        if precision is not None:
            raise ValueError(f"precision must be None or 'mixed', "
                             f"got {precision!r}")
        theta = self._theta(nodes, weights, means, jitters)
        mu0, var0 = self._resolve_mu_var(mu, var, theta)
        if max_iter is None:
            max_iter = 10000
        elbo, mu_out, var_out, n_iter, converged, trace = \
            self.engine.elbo_fit(theta, self._tensor(self.time),
                                 self._tensor(self.y),
                                 self._tensor(self.yerr2), mu0, var0,
                                 int(max_iter))
        # per-iteration ELBO trajectory (diagnostics)
        self.elbo_history = trace
        if converged:
            # the reference caches the variational state only on
            # convergence
            self._mu = mu_out
            self._var = var_out
        else:
            print('\nMax iterations reached')
        return float(elbo), mu_out, var_out, int(n_iter)

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------

    def _Prediction(self, nodes=None, weights=None, means=None, jitters=None,
                    tstar=None, mu=None, var=None, separate=False):
        """Posterior predictive of the GPRN per output."""
        nodes, weights, means, jitters = self._get_components(
            nodes, weights, means, jitters)
        if tstar is None:
            tstar = self.time
        theta = self._theta(nodes, weights, means, jitters)
        if mu is None and var is None:
            if self._mu is None and self._var is None:
                mu, var = self.engine.init_mu_var(theta,
                                                  self._tensor(self.y))
            else:
                mu, var = self._mu, self._var
        mu = torch.as_tensor(mu, dtype=self.dtype, device=self.device)
        var = torch.as_tensor(var, dtype=self.dtype, device=self.device)

        mean_out, var_out, n_pred, w_pred = self.engine.predict(
            theta, self._tensor(self.time), self._tensor(self.y),
            self._tensor(self.yerr2), mu.reshape(-1), var.reshape(-1),
            self._tensor(tstar))
        if separate:
            return mean_out, var_out, (n_pred, w_pred)
        return mean_out, var_out

    def predict(self, tstar=None, nn=1000):
        """GPRN prediction; returns (tstar, mean, std, (nodes, weights)),
        the last three as tensors on the inference's device."""
        if tstar is None:
            mi, ma = np.min(self.time), np.max(self.time)
            tptp = np.ptp(self.time)
            tstar = np.linspace(mi - 0.2 * tptp, ma + 0.2 * tptp, nn)
        aa, vv, bb = self._Prediction(tstar=tstar, separate=True)
        return tstar, aa, torch.sqrt(vv), bb
