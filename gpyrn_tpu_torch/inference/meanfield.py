"""Mean-field variational inference for GPRNs — user-facing API.

Port of a subset of :mod:`gpyrn_tpu.inference.meanfield`:
``inference(q, time, y1, y1err, ..., device=...)``, ``set_components``,
``get_parameters`` / ``set_parameters`` / ``parameters_dict``, freeze and
thaw, ``ELBO`` / ``ELBOcalc`` / ``nELBO``, ``elbo_grad`` (unrolled),
``optimize`` (scipy) and ``optimize_adam`` (unrolled gradient), and
``predict`` / ``_Prediction``, over the engine of
:mod:`gpyrn_tpu_torch.models.gprn`.

The device is the card (``device="cuda"``) unless the caller asks for
another (``device="cpu"``); it is never detected, and nothing touches
CUDA before the first tensor is made.  The data and every result live
there as float64 tensors.
"""
from __future__ import annotations

import time as time_module
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
        device: torch device the fit, gradient and prediction run on
            (the card by default)

    The ``'random'`` starting state draws from ``self.generator``, a CPU
    ``torch.Generator`` (seed it with ``self.generator.manual_seed``).
    """

    def __init__(self, q: int, time, *args, device="cuda"):
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
        self._frozen_mask = np.array([])
        self._mu, self._var = None, None
        self._engine = None
        self.verbose = False

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
                       jitters=None, include_frozen=False):
        """Values of the GPRN parameters as a flat vector, in the order
        nodes → weights → means → jitters; the frozen ones are left out
        unless ``include_frozen`` (or no components are set yet)."""
        nodes, weights, means, jitters = self._get_components(
            nodes, weights, means, jitters)
        out = _core.pack_parameters(nodes, weights, means, jitters)
        if include_frozen or not self._components_set:
            return out
        return out[~self.frozen_mask]

    def set_parameters(self, parameters):
        """Set values for the GPRN parameters: the full vector (frozen
        entries keep their values) or only the non-frozen subset."""
        self._require_components()
        parameters = np.atleast_1d(np.asarray(parameters, dtype=float))
        all_parameters = self.get_parameters(include_frozen=True)
        frozen = self.frozen_mask
        n_free = self.n_parameters - int(frozen.sum())
        if parameters.size == self.n_parameters:
            parameters = np.where(frozen, all_parameters, parameters)
        elif parameters.size == n_free:
            full = all_parameters.copy()
            full[~frozen] = parameters
            parameters = full
        else:
            expected = f'{self.n_parameters}' if n_free == \
                self.n_parameters else \
                f'{self.n_parameters} (all) or {n_free} (not frozen)'
            raise ValueError(f'Wrong number of parameters provided: got '
                             f'{parameters.size}, expected {expected}')
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

    @property
    def parameters_dict(self):
        """Parameter names and values, keyed like 'node1.theta',
        'weight2.ell', 'mean1.c', 'jitter1'."""
        self._require_components()
        p = {}
        for i, node in enumerate(self.nodes, start=1):
            for par, val in zip(node._param_names, node.pars):
                p[f'node{i}.{par}'] = val
        for i, weight in enumerate(self.weights, start=1):
            for par, val in zip(weight._param_names, weight.pars):
                p[f'weight{i}.{par}'] = val
        for i, mean in enumerate(self.means, start=1):
            if mean is None:
                continue
            for par, val in zip(mean._param_names, mean.pars):
                p[f'mean{i}.{par}'] = val
        for i, jit in enumerate(self.jitters, start=1):
            p[f'jitter{i}'] = jit
        return p

    # ------------------------------------------------------------------
    # freeze / thaw
    # ------------------------------------------------------------------

    def freeze_parameter(self, index=None, name=None):
        """Freeze (do not fit) a parameter by index or name; a '*' in
        ``name`` freezes every parameter whose name contains the rest."""
        self._set_frozen(index, name, True)

    def thaw_parameter(self, index=None, name=None):
        """Thaw (free) a parameter by index or name ('*' globs)."""
        self._set_frozen(index, name, False)

    def _set_frozen(self, index, name, value):
        mask = self.frozen_mask
        if index is None and name is None:
            raise ValueError('Provide either index or name')
        if name is None:
            mask[index] = value
            return
        names = list(self.parameters_dict)
        if '*' in name:
            frag = name.replace('*', '')
            for i, known in enumerate(names):
                if frag in known:
                    mask[i] = value
        elif name in names:
            mask[names.index(name)] = value
        else:
            raise ValueError(f'Name "{name}" not found in parameters_dict')

    def freeze_all_parameters(self):
        """Freeze all parameters."""
        self._frozen_mask = np.ones(self.frozen_mask.size, dtype=bool)

    def thaw_all_parameters(self):
        """Thaw all parameters."""
        self._frozen_mask = np.zeros(self.frozen_mask.size, dtype=bool)

    fix_parameter = freeze_parameter
    fix_all_parameters = freeze_all_parameters
    free_parameter = thaw_parameter
    free_all_parameters = thaw_all_parameters

    @property
    def frozen_mask(self):
        """Boolean mask of frozen parameters (over the full vector)."""
        self._require_components()
        if self._frozen_mask.size == 0:
            self._frozen_mask = np.full(self.n_parameters, False, dtype=bool)
        return self._frozen_mask

    @frozen_mask.setter
    def frozen_mask(self, mask):
        raise NotImplementedError(
            'Do not set frozen_mask, use thaw_parameter/freeze_parameter')

    def _apply_vars_selection(self, vars):
        """The ``vars=`` freeze/thaw shorthand of the optimizers: a name
        (or '*' glob) to fit alone, '-name' to fit all but it, or a list
        of names to fit."""
        if vars is None:
            return
        if isinstance(vars, str):
            if '-' in vars:
                self.thaw_parameter(name='*')
                self.freeze_parameter(name=vars.replace('-', ''))
            else:
                self.freeze_parameter(name='*')
                self.thaw_parameter(name=vars)
        elif isinstance(vars, list):
            self.freeze_parameter(name='*')
            for var in vars:
                self.thaw_parameter(name=var)
        else:
            raise ValueError(f'`vars` should be str or list, got {type(vars)}')

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
        """The full parameter vector (frozen entries included) as a
        tensor on the device."""
        return self._tensor(_core.pack_parameters(*self._get_components(
            nodes, weights, means, jitters)))

    def _data(self):
        """``(t, y, yerr2)`` as tensors on the device."""
        return (self._tensor(self.time), self._tensor(self.y),
                self._tensor(self.yerr2))

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
            self.engine.elbo_fit(theta, *self._data(), mu0, var0,
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

    def nELBO(self, parameters, max_iter=None):
        """Negative ELBO at the given hyperparameters (warm-started from
        the cached variational state)."""
        self._require_components()
        self.set_parameters(parameters)
        start = time_module.time()
        elbo, _, _, _ = self.ELBOcalc(max_iter=max_iter,
                                      mu='previous', var='previous')
        end = time_module.time()
        if self.verbose:
            spaces = 20 * ' '
            print(f'ELBO={elbo:7.2f} (took {1e3 * (end - start):5.2f} ms)'
                  f'{spaces}', end='\r', flush=True)
        return -elbo

    def elbo_grad(self, parameters=None, n_sweeps=30, mu=None, var=None,
                  method='unroll'):
        """ELBO and its gradient with respect to all hyperparameters
        (frozen ones included), as ``(float, numpy array)``.

        ``method='unroll'`` differentiates through ``n_sweeps``
        coordinate-ascent sweeps from ``mu``/``var`` (default: the cached
        state, else the heuristic start): the exact gradient of the
        truncated objective, cost and memory linear in ``n_sweeps``."""
        self._require_components()
        if method == 'implicit':
            raise NotImplementedError(
                "method='implicit' (the converged-state gradient of "
                "models/implicit.py) is not ported yet: ROADMAP A9")
        if method != 'unroll':
            raise ValueError("method must be 'unroll' or 'implicit', "
                             f"got {method!r}")
        if parameters is not None:
            self.set_parameters(parameters)
        theta = self._theta()
        if mu is None:
            mu, var = 'previous', 'previous'
        mu0, var0 = self._resolve_mu_var(mu, var, theta)
        value, grad = self.engine.elbo_value_and_grad(
            theta, *self._data(), mu0, var0, n_sweeps)
        return float(value), grad.cpu().numpy()

    # ------------------------------------------------------------------
    # optimization
    # ------------------------------------------------------------------

    def optimize(self, vars=None, **kwargs):
        """Maximize the ELBO over the (non-frozen) hyperparameters with
        scipy (default Nelder-Mead, as the reference does)."""
        from scipy.optimize import minimize
        self._apply_vars_selection(vars)
        kwargs.setdefault('method', 'Nelder-Mead')
        res = minimize(self.nELBO, self.get_parameters(), **kwargs)
        self.set_parameters(res.x)
        return res

    def optimize_adam(self, vars=None, n_steps=200, learning_rate=5e-2,
                      n_sweeps=30, transform='log', callback=None,
                      grad='unroll'):
        """Adam on the negative ELBO over the non-frozen hyperparameters.

        ``grad='unroll'`` differentiates through ``n_sweeps``
        coordinate-ascent sweeps from the state cached at entry: a fixed,
        deterministic objective.  ``transform='log'`` optimizes
        log-parameters (every GPRN amplitude, length scale and jitter is
        positive).  Returns ``{'fun', 'x', 'elbo', 'n_steps'}``: the best
        loss seen, the free parameters where it was recorded, and the
        converged ELBO there (the variational cache is refreshed)."""
        if grad == 'implicit':
            raise NotImplementedError(
                "grad='implicit' (the bilevel optimizer on the "
                "converged-state gradient of models/implicit.py) is not "
                "ported yet: ROADMAP A9")
        if grad != 'unroll':
            raise ValueError(f"grad must be 'unroll' or 'implicit', "
                             f"got {grad!r}")
        self._apply_vars_selection(vars)
        free_np = ~self.frozen_mask
        eng = self.engine
        t, y, yerr2 = self._data()
        base = self._theta()
        mu0, var0 = self._resolve_mu_var('previous', 'previous', base)
        free = torch.as_tensor(free_np, device=self.device)
        use_log = transform == 'log'

        def from_opt(z):
            return torch.exp(z) if use_log else z

        z0 = torch.where(free, base, torch.ones_like(base))
        z = (torch.log(z0) if use_log else z0).requires_grad_(True)
        # torch.optim.Adam with optax.adam's defaults (b1=0.9, b2=0.999,
        # eps=1e-8, eps_root=0): the same update formula,
        # z -= lr·m̂ / (√v̂ + eps) with bias-corrected moments
        opt = torch.optim.Adam([z], lr=learning_rate, betas=(0.9, 0.999),
                               eps=1e-8)

        best_v, best_z = np.inf, z.detach().clone()
        for step in range(n_steps):
            opt.zero_grad()
            with torch.enable_grad():
                theta = torch.where(free, from_opt(z), base)
                loss = -eng.elbo_fixed(theta, t, y, yerr2, mu0, var0,
                                       n_sweeps)
                loss.backward()
            opt.step()
            v = float(loss.detach())
            # the loss is that of the parameters before the step, and the
            # parameters kept are those after it, as the JAX package's
            # loop keeps them
            if v < best_v:
                best_v, best_z = v, z.detach().clone()
            if callback is not None:
                callback(step, v)

        theta = torch.where(free, from_opt(best_z), base).cpu().numpy()
        self.set_parameters(theta)
        # refresh the variational cache at the optimum
        elbo, *_ = self.ELBOcalc(mu='previous', var='previous')
        return {'fun': best_v, 'x': theta[free_np], 'elbo': elbo,
                'n_steps': n_steps}

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
