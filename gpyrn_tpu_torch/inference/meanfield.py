"""Mean-field variational inference for GPRNs — user-facing API.

Port of a subset of :mod:`gpyrn_tpu.inference.meanfield`:
``inference(q, time, y1, y1err, ..., device=...)``, ``set_components``,
``get_parameters`` / ``set_parameters`` / ``parameters_dict``, freeze and
thaw, ``ELBO`` / ``ELBOcalc`` (float64, and ``precision='mixed'``: a
float32 bulk fit, dense, CG or SVI, and a float64 polish; the lean engines
from N = ``LEAN_N`` on) / ``nELBO``, ``elbo_grad`` and
``optimize_adam`` (unrolled, and the implicit gradient of the converged
ELBO), ``optimize`` (scipy), ``optimize_device`` (Nelder-Mead on the
device over the θ-batched ELBO), ``mcmc`` (the native ensemble sampler,
HMC and NUTS; emcee when installed), ``predict`` / ``_Prediction``,
``export_predict`` (the served posterior predictive of
:mod:`gpyrn_tpu_torch.serving`), ``plot_prediction`` / ``plot_structure``
(:mod:`gpyrn_tpu_torch.utils.plots`), ``sample``, and ``save`` / ``load``,
over the engine of :mod:`gpyrn_tpu_torch.models.gprn`.

The device is the card (``device="cuda"``) unless the caller asks for
another (``device="cpu"``); it is never detected, and nothing touches
CUDA before the first tensor is made.  The data and every result live
there as float64 tensors; the mixed fit's float32 bulk and its float64
polish both run there.
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

__all__ = ["inference", "STALL_MIN_TOL", "LEAN_N"]

# the merit-stall stop (``mixed_stall``) arms only for mixed_tol at or
# above this: tightening mixed_tol below it is an explicit request for
# the deepest float32 state the plain state rule can deliver
STALL_MIN_TOL = 1e-5

# from this N on, ELBOcalc takes the lean engines (each GP's kernel matrix
# rebuilt inside its update, one GP's few N² buffers alive at a time)
# instead of the dense engine (the whole q·(1+p) lattice and its factors).
# Set from one float64 sweep of each on an H100 (chip_smoke.py phase 25(b),
# PERF.md): at N=10,000 the lean ELBO sweep took 0.65 (headline) and 0.86
# (flagship) of the dense one's time and the updates-only sweep 0.98 and
# 1.03, at 0.14-0.28 of its peak memory; at N=5000 the flagship's lean
# sweeps took 1.10 and 1.11 of the dense ones
LEAN_N = 10000


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

        self.tt = np.tile(self.time, self.p)
        self.y = np.stack([np.asarray(a, dtype=float) for a in args[::2]])
        self.yerr = np.stack([np.asarray(a, dtype=float) for a in args[1::2]])
        self.yerr2 = self.yerr ** 2

        self.generator = torch.Generator()
        self._components_set = False
        self._frozen_mask = np.array([])
        self._mu, self._var = None, None
        self._mu_var_iters = 0
        self.update_muvar_after = 50
        self.elbo_max_iter = 5000
        # -- the mixed-precision fit (``ELBOcalc(precision='mixed')``);
        # defaults as in the JAX package --
        self.refine_sweeps = 3      # float64 polish sweeps: an int, or
        # 'converge' for the Anderson-accelerated fixed-point polish
        # (ops/fixedpoint.py): sweeps until the relative ELBO change per
        # sweep < refine_tol, at most refine_max_sweeps
        self.refine_tol = 1e-8
        self.refine_max_sweeps = 80
        self.mixed_tol = 1e-4       # float32 state-convergence tolerance
        self.mixed_stall = True     # the merit-stall stop of the default
        # bulk fit (engine.fit_state_stall): the float32 sweep map has a
        # rounding floor at which the state wobbles forever, so the plain
        # state tolerance often never fires.  The stall fit scores each
        # block of ``stall_block`` sweeps by its float32 ELBO and stops
        # after ``stall_patience`` blocks in a row fail to improve the
        # best by > ``stall_tol``·|best|, returning the best-ELBO state
        # for the polish.  Armed only when mixed_tol >= STALL_MIN_TOL;
        # ignored by mixed_stop='elbo' and fit_accelerate=True.
        self.stall_block = 8
        self.stall_tol = 1e-4
        self.stall_patience = 3
        self.mixed_stop = 'state'   # 'state' | 'elbo': 'elbo' runs the
        # float32 fit under the reference rule (rel-std of the last 3
        # ELBO values < 1e-3), then polishes as usual
        self.fit_accelerate = False  # Anderson-accelerate the float32
        # bulk fit (takes precedence over mixed_stall): host-driven
        # mixing over blocks of ``accel_sweeps`` float32 sweeps with the
        # float32 ELBO of each block's last sweep as the safeguard merit;
        # stops when ``accel_patience`` blocks in a row fail to improve
        # the best ELBO by > ``accel_tol`` relative
        self.accel_sweeps = 5
        self.accel_tol = 2e-4
        self.accel_patience = 5
        self.refine_method = 'auto'  # 'auto' | 'f64': the polish runs in
        # native float64 on the inference's device; the JAX package's
        # 'df64' (double-single emulation for float32 hardware) is not
        # ported
        self.fit_method = 'dense'   # 'dense' | 'cg' | 'svi': how the
        # mixed fit's float32 bulk runs.  'dense': the dense or (from
        # N = LEAN_N on) the lean engines.  'cg': the matrix-free
        # coordinate ascent of models/cg_fit.py (chunked kernel matvecs,
        # pivoted-Cholesky-preconditioned CG, the closed-form low-rank
        # posterior diagonal; O(N·(cg_rank + chunk)) memory).  'svi': the
        # stochastic minibatch-over-outputs fit of models/svi.py, where
        # max_iter counts SVI steps (default 600)
        self.cg_rank = 128          # pivoted-Cholesky compression rank
        self.cg_tol = 1e-6          # inner CG relative-residual tolerance
        self.cg_achieved_relres = None  # true relres of the last CG fit
        self.svi_batch_p = None     # outputs per SVI step (None: p // 4)
        self.svi_kappa = 0.6        # Robbins-Monro decay exponent
        self.svi_t0 = 5.0           # Robbins-Monro delay
        self.svi_seed = 0           # seeds the generator of the subsets
        self.mixed_info = {}        # diagnostics of the last mixed fit
        self.implicit_info = {}     # ... and of the last implicit gradient
        self._engine = None
        self._cg_engine = None      # keyed by (cg_rank, cg_tol)
        self._svi_engines = {}
        self._lattice_axis = None
        self.verbose = False

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x, dtype=float),
                               dtype=self.dtype if dtype is None else dtype,
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
        self._cg_engine = None

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

    def _spec_and_core_maps(self):
        spec = _core.spec_from_components(self.nodes, self.weights,
                                          self.means, self.N)
        core_maps = None
        if any(k.has_core_map() for k in self.nodes + self.weights):
            core_maps = (
                tuple(k.core_params_from if k.has_core_map() else None
                      for k in self.nodes),
                tuple(k.core_params_from if k.has_core_map() else None
                      for k in self.weights))
        return spec, core_maps

    @property
    def engine(self) -> _core.Engine:
        """The fit-and-predict engine of the current model structure."""
        self._require_components()
        if self._engine is None:
            self._engine = _core.Engine(*self._spec_and_core_maps(),
                                        lattice_axis=self._lattice_axis)
        return self._engine

    @property
    def cg_engine(self):
        """The matrix-free fit (models/cg_fit.py) of ``fit_method='cg'``,
        rebuilt when the structure or (cg_rank, cg_tol) change."""
        self._require_components()
        key = (self.cg_rank, self.cg_tol)
        if self._cg_engine is None or self._cg_engine[0] != key:
            from gpyrn_tpu_torch.models.cg_fit import make_cg_fit
            spec, core_maps = self._spec_and_core_maps()
            self._cg_engine = (key, make_cg_fit(
                spec, rank=self.cg_rank, cg_tol=self.cg_tol,
                core_maps=core_maps))
        return self._cg_engine[1]

    @property
    def lattice_axis(self):
        """The mesh axis over which the engine splits the (q × p) weight
        lattice (None: unsharded).  When set, every rank of the mesh runs
        the inference inside ``gpyrn_tpu_torch.parallel.use_mesh(mesh)``."""
        return self._lattice_axis

    @lattice_axis.setter
    def lattice_axis(self, axis):
        self._lattice_axis = axis
        self._engine = None
        self._cg_engine = None

    def _svi_engine(self, batch_p):
        """The stochastic fit (models/svi.py) sampling ``batch_p`` outputs
        per step, kept per (structure, batch_p)."""
        from gpyrn_tpu_torch.models.svi import make_svi_fit
        spec, core_maps = self._spec_and_core_maps()
        key = (spec, int(batch_p))
        if key not in self._svi_engines:
            self._svi_engines[key] = make_svi_fit(spec, batch_p,
                                                  core_maps=core_maps)
        return self._svi_engines[key]

    def _lean(self) -> bool:
        """Whether ELBOcalc takes the lean engines (N >= LEAN_N)."""
        return self.N >= LEAN_N

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

    def _u_to_fhatW(self, u):
        """Split a flat d-vector into node means (1, q, N) and weight
        means (p, q, N)."""
        u = torch.as_tensor(u).reshape(-1)
        f = u[:self.q * self.N].reshape(1, self.q, self.N)
        w = u[self.q * self.N:].reshape(self.p, self.q, self.N)
        return f, w

    def _initMuVar(self, nodes, weights, jitters):
        """The heuristic starting state for the given components."""
        theta = self._theta(nodes=nodes, weights=weights, jitters=jitters)
        return self.engine.init_mu_var(theta, self._tensor(self.y))

    # ------------------------------------------------------------------
    # the mixed-precision fit's host-driven pieces
    # ------------------------------------------------------------------

    @staticmethod
    def _floor_variances(d, var0):
        """Projection for the Anderson iteration: extrapolation is not
        constrained to positive variances, so they are floored."""
        var_floor = 1e-12 * float(np.max(var0))

        def clamp(x):
            out = x.copy()
            out[d:] = np.maximum(out[d:], var_floor)
            return out
        return clamp

    def _converged_refine(self, one_sweep, mu0, var0):
        """Anderson-accelerated fixed-point polish over a single-sweep
        map ``one_sweep(mu, var) -> (elbo, mu, var)`` on numpy float64
        vectors (see ops/fixedpoint.py).  Ends with one plain sweep so
        the returned state is a genuine map application.  Returns
        ``(elbo, mu, var, n_sweeps)``."""
        from gpyrn_tpu_torch.ops.fixedpoint import anderson_fixed_point
        d = mu0.size

        def F(x):
            e, m2, v2 = one_sweep(x[:d], x[d:])
            return np.concatenate([np.asarray(m2, dtype=np.float64),
                                   np.asarray(v2, dtype=np.float64)]), e

        x, e, info = anderson_fixed_point(
            F, np.concatenate([mu0, var0]), rel_tol=self.refine_tol,
            max_evals=self.refine_max_sweeps,
            clamp=self._floor_variances(d, var0))
        e1, mu1, var1 = one_sweep(x[:d], x[d:])
        return float(e1), np.asarray(mu1), np.asarray(var1), \
            info["evals"] + 1

    def _accelerated_fit32(self, f32_args, lean, max_iter):
        """Anderson-accelerated float32 bulk fit (``fit_accelerate``): F
        is one block of ``accel_sweeps`` float32 sweeps through
        ``engine.elbo_refine`` (``elbo_refine_lean`` when ``lean``), whose
        last sweep also evaluates the float32 ELBO, the safeguard merit;
        the solver mixes block outputs on the host.  The update map is
        ``fit_state``'s; the stop is the merit-stall rule.  Returns
        ``(mu32, var32, n_sweeps, converged)`` where ``converged`` means
        the floor was reached before ``max_iter`` sweeps."""
        from gpyrn_tpu_torch.ops.fixedpoint import anderson_fixed_point
        refine = self.engine.elbo_refine_lean if lean \
            else self.engine.elbo_refine
        theta32, t32, y32, ye32, mu0, var0 = f32_args
        d = mu0.numel()
        k = max(1, int(self.accel_sweeps))

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32,
                                   device=self.device)

        def f64_numpy(x):
            return x.to(torch.float64).cpu().numpy()

        def F(x):
            e, m2, v2 = refine(theta32, t32, y32, ye32, f32(x[:d]),
                               f32(x[d:]), k)
            return np.concatenate([f64_numpy(m2), f64_numpy(v2)]), float(e)

        var0_np = f64_numpy(var0)
        x0 = np.concatenate([f64_numpy(mu0), var0_np])
        max_evals = max(4, int(max_iter) // k)
        # rel_tol=0 disables the calm rule: in float32 the merit change
        # per block never settles below a tolerance, so the stall rule is
        # the one stop that fires
        x, _, info = anderson_fixed_point(
            F, x0, rel_tol=0.0, max_evals=max_evals,
            clamp=self._floor_variances(d, var0_np),
            stall_patience=int(self.accel_patience),
            stall_tol=float(self.accel_tol))
        return (f32(x[:d]), f32(x[d:]), info["evals"] * k,
                bool(info["stalled"]))

    def _bulk_fit32(self, theta, mu0, var0, max_iter, user_max_iter=None):
        """The float32 bulk of the mixed fit, in the JAX package's order
        of precedence, on the lean engines from N = LEAN_N on.  Returns
        ``(mu32, var32, n_iter, converged)``."""
        f32_args = tuple(a.to(torch.float32)
                         for a in (theta, *self._data(), mu0, var0))
        eng, lean = self.engine, self._lean()
        if self.mixed_stop == 'elbo':
            # reference iteration semantics: the float32 fit under the
            # rel-std(3) < 1e-3 ELBO rule
            fit = eng.elbo_fit_lean if lean else eng.elbo_fit
            _, mu32, var32, n_iter, converged, trace = fit(*f32_args,
                                                           max_iter)
            info = {'bulk': 'elbo', 'nonfinite_merits': int(
                (~torch.isfinite(trace)).sum())}
        elif self.fit_method == 'cg':
            mu32, var32, n_iter, converged, rres = \
                self.cg_engine.fit_state_cg(*f32_args, max_iter,
                                            self.mixed_tol)
            # the achieved TRUE relative residual of the last sweep's
            # inner solves: the requested cg_tol may lie under the
            # float32 floor, so the number reached is recorded
            self.cg_achieved_relres = float(rres)
            info = {'bulk': 'cg', 'cg_achieved_relres':
                    self.cg_achieved_relres}
        elif self.fit_method == 'svi':
            # a fixed count of stochastic steps; the reference's
            # 10000-sweep default is the wrong scale for them
            n_iter = user_max_iter if user_max_iter is not None else 600
            bp = self.svi_batch_p or max(1, self.p // 4)
            mu32, var32 = self._svi_engine(bp).fit_state_svi(
                *f32_args, int(n_iter), int(self.svi_seed),
                float(self.svi_t0), float(self.svi_kappa))
            converged = True
            info = {'bulk': 'svi'}
        elif self.fit_method != 'dense':
            raise ValueError(f"fit_method must be 'dense', 'cg' or 'svi', "
                             f"got {self.fit_method!r}")
        elif self.fit_accelerate:
            mu32, var32, n_iter, converged = self._accelerated_fit32(
                f32_args, lean, max_iter)
            info = {'bulk': 'accelerate'}
        elif self.mixed_stall and self.mixed_tol >= STALL_MIN_TOL:
            info = {'bulk': 'stall'}
            fit = eng.fit_state_stall_lean if lean else eng.fit_state_stall
            mu32, var32, n_iter, converged = fit(
                *f32_args, max_iter, self.mixed_tol, int(self.stall_block),
                float(np.float32(self.stall_tol)), int(self.stall_patience),
                info)
        else:
            fit = eng.fit_state_lean if lean else eng.fit_state
            mu32, var32, n_iter, converged = fit(*f32_args, max_iter,
                                                 self.mixed_tol)
            info = {'bulk': 'state'}
        info['lean'] = lean
        self.mixed_info = info
        return mu32, var32, int(n_iter), bool(converged)

    def _polish64(self, theta, mu64, var64):
        """The float64 polish of the mixed fit, on the inference's device
        (the lean engines from N = LEAN_N on): ``refine_sweeps`` sweeps,
        or the Anderson polish for ``'converge'``.  Returns ``(elbo, mu,
        var, n_sweeps)``."""
        eng, data = self.engine, self._data()
        refine = eng.elbo_refine_lean if self._lean() else eng.elbo_refine
        if self.refine_sweeps != 'converge':
            elbo, mu_out, var_out = refine(theta, *data, mu64, var64,
                                           self.refine_sweeps)
            return float(elbo), mu_out, var_out, int(self.refine_sweeps)

        def sweep1(m, v):
            e, m2, v2 = refine(theta, *data, self._tensor(m),
                               self._tensor(v), 1)
            return float(e), m2.cpu().numpy(), v2.cpu().numpy()

        elbo, mu_out, var_out, count = self._converged_refine(
            sweep1, mu64.cpu().numpy(), var64.cpu().numpy())
        return elbo, self._tensor(mu_out), self._tensor(var_out), count

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
        return ``(ELBO, mu, var, iterNumber)``; mu and var are float64
        tensors on the inference's device.

        mu/var may be arrays or 'init' | 'random' | 'previous'.
        ``precision=None`` fits in float64 under the reference rule.

        ``precision='mixed'`` runs the bulk of the coordinate ascent in
        float32 on the exact-nugget kernel matrices (updates only, so the
        float32 fit converges to the true model's fixed point), then
        polishes with ``self.refine_sweeps`` float64 sweeps on the same
        device and evaluates the final ELBO there.  The bulk fit is, in
        this order: ``mixed_stop='elbo'`` (the float32 fit under the
        reference rule), ``fit_accelerate`` (Anderson mixing on the
        host), the merit-stall fit (``mixed_stall`` with ``mixed_tol >=
        STALL_MIN_TOL``; the default), else the plain state rule.
        ``iterNumber`` is bulk sweeps plus polish sweeps, and
        ``elbo_history`` holds the one final value.  ``mixed_info`` keeps
        the bulk mode, its sweeps, the polish sweeps and, for the stall
        fit, the count of non-finite float32 merits.
        ``fit_method='cg'`` takes the matrix-free bulk fit
        (``cg_engine``; ``cg_achieved_relres`` records the true relative
        residual its last sweep's solves reached) and ``'svi'`` the
        stochastic one (``max_iter`` steps, default 600).

        From N = ``LEAN_N`` on, every fit and polish here takes the lean
        engines (each GP's kernel matrix rebuilt inside its update), with
        the same update map and ELBO terms as the dense engine.
        ``refine_method='df64'`` is not ported and raises."""
        if precision not in (None, 'mixed'):
            raise ValueError(f"precision must be None or 'mixed', "
                             f"got {precision!r}")
        if precision == 'mixed':
            if self.refine_method == 'df64':
                raise NotImplementedError(
                    "refine_method='df64' (double-single emulation for "
                    "float32 hardware) is not ported and will not be: the "
                    "polish runs in native float64 ('auto' or 'f64'); "
                    "ROADMAP A13")
            if self.refine_method not in ('auto', 'f64'):
                raise ValueError(f"refine_method must be 'auto' or 'f64', "
                                 f"got {self.refine_method!r}")
        theta = self._theta(nodes, weights, means, jitters)
        mu0, var0 = self._resolve_mu_var(mu, var, theta)
        user_max_iter = max_iter
        if max_iter is None:
            max_iter = 10000
        max_iter = int(max_iter)
        if precision == 'mixed':
            mu32, var32, n_bulk, converged = self._bulk_fit32(
                theta, mu0, var0, max_iter, user_max_iter)
            elbo, mu_out, var_out, n_polish = self._polish64(
                theta, mu32.to(self.dtype), var32.to(self.dtype))
            self.mixed_info.update(bulk_sweeps=n_bulk,
                                   polish_sweeps=n_polish)
            n_iter = n_bulk + n_polish
            trace = torch.full((1,), elbo, dtype=self.dtype,
                               device=self.device)
        else:
            fit = self.engine.elbo_fit_lean if self._lean() \
                else self.engine.elbo_fit
            elbo, mu_out, var_out, n_iter, converged, trace = fit(
                theta, *self._data(), mu0, var0, max_iter)
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
                  method='unroll', fit_tol=None, fit_max_iter=2000,
                  adjoint='gmres', adjoint_maxiter=25, adjoint_restart=20,
                  adjoint_tol=None):
        """ELBO and its gradient with respect to all hyperparameters
        (frozen ones included), as ``(float, numpy array)``.

        ``method='unroll'`` differentiates through ``n_sweeps``
        coordinate-ascent sweeps from ``mu``/``var`` (default: the cached
        state, else the heuristic start): the exact gradient of the
        truncated objective, cost and memory linear in ``n_sweeps``.

        ``method='implicit'`` first converges the variational state
        (``engine.fit_state`` warm-started from ``mu``/``var``, to
        ``fit_tol`` relative state change, default 1e-12, within
        ``fit_max_iter`` sweeps), then takes the gradient of the
        converged ELBO by the implicit function theorem at the fixed
        point (models/implicit.py): the memory of one sweep's graph, and
        exactly the objective ``optimize()`` descends.  ``n_sweeps`` is
        ignored; ``adjoint`` ('gmres' | 'neumann'), ``adjoint_maxiter``,
        ``adjoint_restart`` and ``adjoint_tol`` control the adjoint solve.
        The converged state is cached like a converged ``ELBOcalc``, and
        ``implicit_info`` keeps the residuals and counts of the call."""
        self._require_components()
        if method not in ('unroll', 'implicit'):
            raise ValueError("method must be 'unroll' or 'implicit', "
                             f"got {method!r}")
        if parameters is not None:
            self.set_parameters(parameters)
        theta = self._theta()
        if mu is None:
            mu, var = 'previous', 'previous'
        mu0, var0 = self._resolve_mu_var(mu, var, theta)
        data = self._data()
        if method == 'unroll':
            value, grad = self.engine.elbo_value_and_grad(
                theta, *data, mu0, var0, n_sweeps)
            return float(value), grad.cpu().numpy()
        from gpyrn_tpu_torch.models.implicit import \
            implicit_value_and_grad_for
        if fit_tol is None:
            fit_tol = 1e-12 if mu0.dtype == torch.float64 else 1e-6
        mu_s, var_s, n_fit, converged = self.engine.fit_state(
            theta, *data, mu0, var0, int(fit_max_iter), fit_tol)
        if not converged:
            print('\nMax iterations reached')
        res = implicit_value_and_grad_for(self.engine)(
            theta, *data, mu_s, var_s, adjoint=adjoint,
            maxiter=int(adjoint_maxiter), restart=int(adjoint_restart),
            tol=adjoint_tol)
        self._mu, self._var = mu_s, var_s
        self.implicit_info = {
            'fit_sweeps': n_fit, 'fit_converged': converged,
            'adjoint_residual': float(res.adjoint_residual),
            'state_residual': float(res.state_residual),
            'pullbacks': res.pullbacks}
        return float(res.elbo), res.grad.cpu().numpy()

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

    def optimize_device(self, vars=None, n_sweeps=30, xatol=1e-4,
                        fatol=1e-4, max_iter=None, n_restarts=1,
                        spread=0.1, seed=0, adaptive=False):
        """``optimize()`` without the host in the loop: scipy-trajectory
        Nelder-Mead (inference/neldermead.py) over the non-frozen
        hyperparameters, the simplex on the device and every iteration's
        n + 4 candidates fitted in one batched call.

        The objective is the negative ELBO after ``n_sweeps``
        coordinate-ascent sweeps from the current variational state
        (``engine.elbo_fixed_batch``): a deterministic, batched objective
        (unlike ``nELBO``, whose cache warm-start makes each call depend
        on the previous one).  With ``n_restarts > 1``, that many
        simplexes start from log-normal-perturbed copies of the current
        parameters (``spread`` in log units, numpy ``default_rng(seed)``,
        the first copy unperturbed) and run as one population; the best
        restart wins.

        Returns a dict with scipy-style fields ``x``/``fun``/``nit``/
        ``nfev``/``success`` plus ``elbo`` at the optimum (the variational
        cache is refreshed there)."""
        from gpyrn_tpu_torch.inference.neldermead import (
            NMResult, nelder_mead, nelder_mead_multistart)
        self._require_components()
        self._apply_vars_selection(vars)
        free_idx = np.flatnonzero(~self.frozen_mask)
        if free_idx.size == 0:
            raise ValueError("all parameters are frozen")
        base = self._theta()
        mu0, var0 = self._resolve_mu_var('previous', 'previous', base)
        eng, data = self.engine, self._data()
        idx = torch.as_tensor(free_idx, device=self.device)

        def objective_batch(X):
            theta = base.expand(X.shape[0], -1).clone()
            theta[:, idx] = X
            return -eng.elbo_fixed_batch(theta, *data, mu0, var0,
                                         int(n_sweeps))

        x0 = base[idx]
        if n_restarts > 1:
            rng = np.random.default_rng(seed)
            x0_np = x0.cpu().numpy()
            x0s = x0_np[None, :] * np.exp(
                spread * rng.standard_normal((n_restarts, free_idx.size)))
            x0s[0] = x0_np              # keep the unperturbed start
            res, best = nelder_mead_multistart(
                None, self._tensor(x0s), xatol=xatol, fatol=fatol,
                max_iter=max_iter, adaptive=adaptive,
                batched_f=objective_batch)
            res = NMResult(*(a[int(best)] for a in res))
        else:
            res = nelder_mead(None, x0, xatol=xatol, fatol=fatol,
                              max_iter=max_iter, adaptive=adaptive,
                              batched_f=objective_batch)
        x_best = res.x.cpu().numpy()
        self.set_parameters(x_best)
        elbo, *_ = self.ELBOcalc(mu='previous', var='previous')
        return {'x': x_best, 'fun': float(res.fun), 'nit': int(res.nit),
                'nfev': int(res.nfev), 'success': bool(res.converged),
                'elbo': elbo}

    def optimize_adam(self, vars=None, n_steps=200, learning_rate=5e-2,
                      n_sweeps=30, transform='log', callback=None,
                      grad='unroll', fit_tol=None, fit_max_iter=200,
                      adjoint='gmres', adjoint_maxiter=25,
                      adjoint_restart=20):
        """Adam on the negative ELBO over the non-frozen hyperparameters.

        ``grad='unroll'`` differentiates through ``n_sweeps``
        coordinate-ascent sweeps from the state cached at entry: a fixed,
        deterministic objective.

        ``grad='implicit'`` is the bilevel optimizer: every step converges
        the variational state again (``engine.fit_state`` warm-started
        from the previous step's state, to ``fit_tol``, default 1e-11,
        within ``fit_max_iter`` sweeps) and takes the exact gradient of
        the converged ELBO by the implicit function theorem
        (models/implicit.py), so the outer objective is the converged
        ELBO that ``optimize()`` descends, with the memory of one sweep's
        graph.  ``n_sweeps`` is ignored in this mode.

        ``transform='log'`` optimizes log-parameters (every GPRN
        amplitude, length scale and jitter is positive).  Returns
        ``{'fun', 'x', 'elbo', 'n_steps'}``: the best loss seen, the free
        parameters where it was recorded, and the converged ELBO there
        (the variational cache is refreshed)."""
        if grad not in ('unroll', 'implicit'):
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

        if grad == 'implicit':
            from gpyrn_tpu_torch.models.implicit import \
                implicit_value_and_grad_for
            ivag = implicit_value_and_grad_for(eng)
            if fit_tol is None:
                fit_tol = 1e-11 if mu0.dtype == torch.float64 else 1e-6
            state = [mu0, var0]

            def loss_and_grad():
                """-ELBO at the state converged from the last step's; its
                gradient by the chain rule through the transform."""
                with torch.no_grad():
                    theta = torch.where(free, from_opt(z), base)
                    state[:] = eng.fit_state(
                        theta, t, y, yerr2, *state, int(fit_max_iter),
                        fit_tol)[:2]
                    res = ivag(theta, t, y, yerr2, *state, adjoint=adjoint,
                               maxiter=int(adjoint_maxiter),
                               restart=int(adjoint_restart))
                    dtheta_dz = from_opt(z) if use_log else \
                        torch.ones_like(z)
                    z.grad = torch.where(free, -res.grad * dtheta_dz,
                                         torch.zeros_like(z))
                return -res.elbo
        else:
            def loss_and_grad():
                with torch.enable_grad():
                    theta = torch.where(free, from_opt(z), base)
                    loss = -eng.elbo_fixed(theta, t, y, yerr2, mu0, var0,
                                           n_sweeps)
                    loss.backward()
                return loss.detach()

        best_v, best_z = np.inf, z.detach().clone()
        for step in range(n_steps):
            opt.zero_grad()
            loss = loss_and_grad()
            opt.step()
            v = float(loss)
            # the loss is that of the parameters before the step, and the
            # parameters kept are those after it, as the JAX package's
            # loop keeps them
            if v < best_v:
                best_v, best_z = v, z.detach().clone()
            if callback is not None:
                callback(step, v)

        theta = torch.where(free, from_opt(best_z), base).cpu().numpy()
        self.set_parameters(theta)
        if grad == 'implicit':
            # the trajectory's final state warm-starts the cache refresh
            self._mu, self._var = state
        # refresh the variational cache at the optimum
        elbo, *_ = self.ELBOcalc(mu='previous', var='previous')
        return {'fun': best_v, 'x': theta[free_np], 'elbo': elbo,
                'n_steps': n_steps}

    # ------------------------------------------------------------------
    # MCMC
    # ------------------------------------------------------------------

    def mcmc(self, priors, p0=None, vars=None, niter=500, sampler='native',
             checkpoint=None, **kwargs):
        """Sample the hyperparameter posterior with the ELBO as the
        log-likelihood surrogate.

        ``sampler='native'`` runs the ensemble sampler of
        :mod:`gpyrn_tpu_torch.inference.ensemble` (all walkers' ELBO fits
        batched on the device; the device chain when every prior comes
        from :mod:`gpyrn_tpu_torch.inference.priors`, else the host loop);
        ``sampler='hmc'`` runs HMC or NUTS on the ELBO gradient
        (:mod:`gpyrn_tpu_torch.inference.hmc`, priors from
        :mod:`gpyrn_tpu_torch.inference.priors`; ``nwalkers`` sets
        ``n_chains``); ``sampler='emcee'`` drives emcee if it is
        installed."""
        from gpyrn_tpu_torch.inference.ensemble import run_ensemble
        self._require_components()
        self._apply_vars_selection(vars)

        all_names = np.array(list(self.parameters_dict.keys()))
        free_names = all_names[~self.frozen_mask]
        ndim = len(free_names)
        nwalkers_arg = kwargs.pop('nwalkers', None)
        nwalkers = 2 * ndim if nwalkers_arg is None else nwalkers_arg

        missing = [n for n in free_names if n not in priors]
        if missing:
            raise ValueError(f'missing priors for parameters: {missing}')

        if sampler == 'hmc':
            from gpyrn_tpu_torch.inference.hmc import run_hmc
            if nwalkers_arg is not None:
                kwargs.setdefault('n_chains', nwalkers_arg)
            return run_hmc(self, priors, n_samples=niter, p0=p0,
                           checkpoint=checkpoint, **kwargs)
        if sampler == 'emcee':
            return self._mcmc_emcee(priors, free_names, p0, niter, **kwargs)

        return run_ensemble(self, priors, free_names, p0=p0, niter=niter,
                            nwalkers=nwalkers, checkpoint=checkpoint,
                            **kwargs)

    def _mcmc_emcee(self, priors, free_names, p0, niter, **kwargs):
        try:
            from emcee import EnsembleSampler, backends
            from emcee.utils import sample_ellipsoid
        except ImportError as e:
            raise ImportError(
                "emcee is not installed; use sampler='native'") from e

        def prior_rvs():
            return np.array([priors[name].rvs() for name in free_names])

        def logprior(parameters):
            return float(sum(np.asarray(priors[name].logpdf(par))
                             for par, name in zip(parameters, free_names)))

        def logposterior(parameters):
            lp = logprior(parameters)
            if np.isneginf(lp):
                return -np.inf, -np.inf
            elbo = -self.nELBO(parameters, max_iter=100)
            return lp + elbo, elbo

        ndim = len(free_names)
        nwalkers = 2 * ndim
        if p0 is None:
            p0 = np.array([prior_rvs() for _ in range(nwalkers)])
        else:
            sigma = []
            for name in free_names:
                try:
                    sigma.append(priors[name].std())
                except TypeError:
                    sigma.append(priors[name].std)
            p0 = sample_ellipsoid(p0, np.diag(sigma) / 100, size=nwalkers)
            for i, pw in enumerate(p0):
                if np.isneginf(logprior(pw)):
                    p0[i] = prior_rvs()

        # the reference's pre-run diagnostics
        progress = kwargs.pop('progress', True)
        if progress:
            print('initial values for parameters are set')
            _start = time_module.time()
            _ = [logposterior(pw) for pw in p0]
            _end = time_module.time()
            print()
            print(f'evaluation for initial values took '
                  f'{_end - _start:.0f} sec')
            print('- adjust your expectations accordingly')

        be = backends.HDFBackend(kwargs.pop('filename', 'gprn.h5'))
        be.reset(nwalkers, ndim)
        smplr = EnsembleSampler(nwalkers, ndim, logposterior, backend=be)

        old_tau = np.inf
        # the reference's progress bar and per-10-step log_prob print
        for sample in smplr.sample(p0, iterations=niter, progress=progress):
            if smplr.iteration % 10:
                continue
            if progress:
                print(sample.log_prob.max())
            tau = smplr.get_autocorr_time(tol=0)
            converged = np.all(tau * 100 < smplr.iteration)
            converged &= np.all(np.abs(old_tau - tau) / tau < 0.01)
            if converged:
                break
            old_tau = tau
        return smplr

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

    def export_predict(self, filename=None, **kw):
        """Ahead-of-time export of the fitted posterior predictive for
        serving (see :mod:`gpyrn_tpu_torch.serving`): returns the
        ``torch.export.ExportedProgram``, or — when ``filename`` is given
        — writes the artifact there and returns its byte count.  Keywords
        (``device``, ``n_star``, ``dtype``) pass through to
        ``serving.export_predict``."""
        from gpyrn_tpu_torch import serving
        if filename is not None:
            return serving.save_predict(self, filename, **kw)
        return serving.export_predict(self, **kw)

    def plot_prediction(self, nn=1000, tstar=None, over=0.2, title=None):
        """Data, posterior predictive, residuals, weights and nodes per
        output (:func:`gpyrn_tpu_torch.utils.plots.plot_prediction`)."""
        from gpyrn_tpu_torch.utils.plots import plot_prediction
        return plot_prediction(self, nn=nn, tstar=tstar, over=over,
                               title=title)

    def plot_structure(self, title=None):
        """Graphical-model sketch of the GPRN: the node → weight → output
        network (:func:`gpyrn_tpu_torch.utils.plots.plot_structure`)."""
        from gpyrn_tpu_torch.utils.plots import plot_structure
        return plot_structure(self, title=title)

    # ------------------------------------------------------------------
    # prior samples
    # ------------------------------------------------------------------

    def _sample_from_gp(self, kernel, time=None, rng=None):
        """A random function drawn from a kernel's GP prior (host code on
        numpy, with a numpy ``Generator``)."""
        from gpyrn_tpu_torch.ops.linalg import PREDICT_NUGGET
        rng = np.random.default_rng() if rng is None else rng
        if time is None:
            time = self.time
        time = torch.as_tensor(np.asarray(time, dtype=float))
        params = torch.as_tensor(np.asarray(kernel.core_params(),
                                            dtype=float))
        if covfunc.is_nonstationary(kernel.structure):
            K = covfunc.evaluate(kernel.structure, params,
                                 t1=time[:, None], t2=time[None, :]).numpy()
        else:
            r = time[:, None] - time[None, :]
            K = covfunc.evaluate(kernel.structure, params, r=r).numpy()
            K = K + PREDICT_NUGGET * np.eye(time.numel())
        # eigendecomposition sampling tolerates a semi-definite K
        w, V = np.linalg.eigh(K)
        w = np.clip(w, 0.0, None)
        return V @ (np.sqrt(w) * rng.standard_normal(time.numel()))

    def sample(self, time=None, rng=None):
        """Prior samples of all node and weight functions, as numpy
        arrays ``(q, n)`` and ``(q·p, n)``."""
        nodes, weights, _, _ = self._get_components()
        node_samples = np.array([self._sample_from_gp(n, time, rng)
                                 for n in nodes])
        weight_samples = np.array([self._sample_from_gp(w, time, rng)
                                   for w in weights])
        return node_samples, weight_samples

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------

    def save(self, filename):
        """Checkpoint hyperparameters, frozen mask and the variational
        warm-start state to a compressed npz file, with the JAX package's
        keys: a checkpoint written by either package loads in the
        other."""
        self._require_components()

        def host(x):
            if x is None:
                return np.array([])
            return x.cpu().numpy() if isinstance(x, torch.Tensor) \
                else np.asarray(x)

        np.savez_compressed(
            filename,
            parameters=self.get_parameters(include_frozen=True),
            frozen_mask=self.frozen_mask,
            mu=host(self._mu), var=host(self._var),
            elbo_history=host(getattr(self, 'elbo_history', None)))

    def load(self, filename):
        """Restore a checkpoint written by :meth:`save`.

        Components (the kernels' and means' structure) must already be
        set via :meth:`set_components`; only parameter values and the
        variational state are restored."""
        self._require_components()
        z = np.load(filename)
        # restore values with everything thawed (set_parameters would
        # otherwise keep the current values at frozen positions)
        self._frozen_mask = np.zeros(self.n_parameters, dtype=bool)
        self.set_parameters(z['parameters'])
        self._frozen_mask = np.array(z['frozen_mask'], dtype=bool)
        if z['mu'].size:
            self._mu = self._tensor(z['mu'])
            self._var = self._tensor(z['var'])
        if z['elbo_history'].size:
            self.elbo_history = self._tensor(z['elbo_history'])
        return self
