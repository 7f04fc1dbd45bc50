"""Mean-function library on torch tensors.

Port of :mod:`gpyrn_tpu.ops.means`: each mean is a pure function
``fn(params, t, extras)`` keyed by the same structure tag, with a thin
object shell carrying the reference API (``pars``, prefix-consuming
``set_parameters``, ``m1 + m2`` / ``m1 * m2`` algebra).

``MultiConstant`` carries its per-instrument index data (obsid / time
bins) inside its structure extras, as in the JAX package.  The Keplerian
mean (tag ``"Kep"``) is the radial-velocity curve of
:func:`gpyrn_tpu_torch.utils.astro.keplerian_rv`, differentiable in its
five parameters through every Newton step of Kepler's equation.

Every mean takes parameters of shape (..., n_params) and returns values of
shape (..., n_t): the leading dimensions are rows of a θ batch, evaluated
in one pass (elementwise, so each row's values are those of its own
evaluation).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from gpyrn_tpu_torch.utils.astro import keplerian_rv

__all__ = [
    "meanFunction", "Sum", "Product",
    "Constant", "MultiConstant", "Linear", "Parabola", "Cubic", "Sine",
    "Keplerian", "evaluate", "n_params",
]

# tag -> (n_params or None for variable, fn(params, t, extras))
_REGISTRY: Dict[str, Tuple[object, Callable]] = {}


def _register(tag, npars, fn):
    _REGISTRY[tag] = (npars, fn)
    return fn


def n_params(structure) -> int:
    tag = structure[0]
    if tag in ("+", "*"):
        return n_params(structure[1]) + n_params(structure[2])
    npars = _REGISTRY[tag][0]
    if npars is None:           # variable-size mean (MultiConstant)
        return structure[1]     # first extra = parameter count
    return npars


def evaluate(structure, params, t):
    """Evaluate a mean structure at times ``t`` (a 1-D tensor) for
    parameters of shape (..., n_params): values of shape (..., n_t)."""
    tag = structure[0]
    if tag == "+":
        k = n_params(structure[1])
        return (evaluate(structure[1], params[..., :k], t) +
                evaluate(structure[2], params[..., k:], t))
    if tag == "*":
        k = n_params(structure[1])
        return (evaluate(structure[1], params[..., :k], t) *
                evaluate(structure[2], params[..., k:], t))
    if tag not in _REGISTRY:
        raise NotImplementedError(f"mean {tag!r} is not ported yet")
    _, fn = _REGISTRY[tag]
    return fn(params, t, structure[1:])


def _par(p, i):
    """Parameter ``i`` of every row, shaped to broadcast against t."""
    return p[..., i:i + 1]


def _constant(p, t, extras):
    return torch.zeros_like(t) + _par(p, 0)


def _linear(p, t, extras):
    # slope * (t - mean(t)) + intercept — the mean of the *evaluation*
    # times, as in the reference
    return _par(p, 0) * (t - torch.mean(t)) + _par(p, 1)


def _polyval(p, t, n):
    out = torch.zeros_like(t) + _par(p, 0)
    for i in range(1, n):
        out = out * t + _par(p, i)
    return out


def _parabola(p, t, extras):
    return _polyval(p, t, 3)


def _cubic(p, t, extras):
    return _polyval(p, t, 4)


def _sine(p, t, extras):
    return _par(p, 0) * torch.sin((2 * math.pi * t / _par(p, 1)) +
                                  _par(p, 2))


def _keplerian_mean(p, t, extras):
    return keplerian_rv(t, P=_par(p, 0), K=_par(p, 1), e=_par(p, 2),
                        w=_par(p, 3), T=_par(p, 4))


def _multiconstant(p, t, extras):
    """Per-instrument offsets.

    extras = (parsize, train_size, ii, time_bins) with ``ii`` the
    0-based instrument index per training observation and ``time_bins``
    the bin edges that assign instruments to new times.  As in the JAX
    package, ``ii`` serves times of the training size only where that
    size is a number: a symbolic size (``torch.export``) takes the bins,
    as a JAX export with a symbolic dimension does."""
    parsize, train_size, ii, time_bins = extras
    offsets = torch.cat([p[..., :-1], torch.zeros(
        (*p.shape[:-1], 1), dtype=p.dtype, device=p.device)], dim=-1)
    c = p[..., -1:]
    t = torch.atleast_1d(t)
    n = t.shape[0]
    if not isinstance(n, torch.SymInt) and n == train_size:
        idx = torch.as_tensor(ii, dtype=torch.int64, device=t.device)
    else:
        # numpy's digitize(x, bins) is bucketize(x, bins, right=True)
        bins = torch.as_tensor(time_bins, dtype=t.dtype, device=t.device)
        idx = torch.bucketize(t, bins, right=True) - 1
    return torch.zeros_like(t) + c + offsets[..., idx]


_register("Const", 1, _constant)
_register("Lin", 2, _linear)
_register("Par", 3, _parabola)
_register("Cub", 4, _cubic)
_register("Sin", 3, _sine)
_register("Kep", 5, _keplerian_mean)
_register("MultiConst", None, _multiconstant)


# --------------------------------------------------------------------------
# object shell — reference-compatible API
# --------------------------------------------------------------------------

class meanFunction:
    """Base class for mean functions."""
    _parsize = 0
    _tag = None
    _param_names: Tuple[str, ...] = ()

    def __init__(self, *pars):
        self.pars = np.array(pars, dtype=float)

    @property
    def structure(self):
        return (self._tag,)

    def __repr__(self):
        return "{0}({1})".format(self.__class__.__name__,
                                 ", ".join(map(str, self.pars)))

    def get_parameters(self):
        return self.pars

    def set_parameters(self, p):
        p = np.atleast_1d(np.asarray(p, dtype=float))
        if len(p) < self.pars.size:
            raise ValueError(
                f"too few parameters for mean {self.__class__.__name__}")
        if len(p) > self.pars.size:
            self.pars = np.array(p[:self.pars.size], dtype=float)
            return np.array(p[self.pars.size:])
        self.pars = p

    def __call__(self, t):
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(np.atleast_1d(np.asarray(t, dtype=float)))
        p = torch.as_tensor(self.pars, dtype=t.dtype, device=t.device)
        return evaluate(self.structure, p, torch.atleast_1d(t))

    def __add__(self, b):
        return Sum(self, b)

    def __radd__(self, b):
        return self.__add__(b)

    def __mul__(self, b):
        return Product(self, b)

    def __rmul__(self, b):
        return self.__mul__(b)


class _moperator(meanFunction):
    _op_tag = None

    def __init__(self, m1, m2):
        self.m1, self.m2 = m1, m2
        if m1.__class__ == m2.__class__:
            # same class: number the parameter names
            names = [f"{p}1" for p in m1._param_names]
            names += [f"{p}2" for p in m2._param_names]
            self._param_names = tuple(names)
        else:
            self._param_names = tuple(list(m1._param_names) +
                                      list(m2._param_names))
        self._parsize = m1._parsize + m2._parsize
        self.pars = np.r_[m1.pars, m2.pars]

    @property
    def structure(self):
        return (self._op_tag, self.m1.structure, self.m2.structure)

    def set_parameters(self, p):
        p = np.atleast_1d(np.asarray(p, dtype=float))
        if len(p) < self.pars.size:
            raise ValueError(
                f"too few parameters for mean {self.__class__.__name__}")
        rest = self.m1.set_parameters(p)
        if rest is None:
            rest = np.array([])
        rest = self.m2.set_parameters(rest)
        self.pars = np.r_[self.m1.pars, self.m2.pars]
        if len(p) > self.pars.size:
            return rest
        return None


class Sum(_moperator):
    """Sum of two mean functions."""
    _op_tag = "+"

    def __repr__(self):
        return f"{self.m1} + {self.m2}"


class Product(_moperator):
    """Product of two mean functions."""
    _op_tag = "*"

    def __repr__(self):
        return f"{self.m1} * {self.m2}"


class Constant(meanFunction):
    """Constant mean, m(t) = c."""
    _param_names = ("c",)
    _parsize = 1
    _tag = "Const"

    def __init__(self, c: float):
        super().__init__(c)


class MultiConstant(meanFunction):
    """Constant mean with per-instrument offsets.

    Args:
        offsets: offsets relative to the last instrument plus the average
            of the last instrument: [off_1, ..., off_{n-1}, mean]
        obsid: 1-based instrument index per observation
        time: observed times (same size as obsid)
    """
    _tag = "MultiConst"

    def __init__(self, offsets, obsid, time):
        obsid = np.asarray(obsid)
        time = np.asarray(time, dtype=float)
        self.obsid = obsid
        self.time = time
        self._parsize = int((np.ediff1d(obsid) == 1).sum() + 1)
        self.ii = obsid.astype(int) - 1

        if isinstance(offsets, float):
            offsets = [offsets]
        if len(offsets) != self._parsize:
            raise ValueError("wrong number of parameters, "
                             f"expected {self._parsize} got {len(offsets)}")
        super().__init__(*offsets)
        self._param_names = tuple(
            [f"off{i}" for i in range(1, self._parsize)] + ["mean"])

    def time_bins(self):
        _1 = self.time[np.ediff1d(self.obsid, 0, None) != 0]
        _2 = self.time[np.ediff1d(self.obsid, None, 0) != 0]
        offset_times = np.mean((_1, _2), axis=0)
        return np.sort(np.r_[self.time[0], offset_times])

    @property
    def structure(self):
        return (self._tag, self._parsize, int(self.time.size),
                tuple(int(i) for i in self.ii),
                tuple(float(b) for b in self.time_bins()))


class Linear(meanFunction):
    """Linear mean, m(t) = slope * (t - mean(t)) + intercept."""
    _param_names = ("slope", "intercept")
    _parsize = 2
    _tag = "Lin"

    def __init__(self, slope: float, intercept: float):
        super().__init__(slope, intercept)


class Parabola(meanFunction):
    """2nd-degree polynomial mean."""
    _param_names = ("slope", "intercept", "quadratic")
    _parsize = 3
    _tag = "Par"

    def __init__(self, quad: float, slope: float, intercept: float):
        super().__init__(quad, slope, intercept)


class Cubic(meanFunction):
    """3rd-degree polynomial mean."""
    _param_names = ("cub", "quad", "slope", "intercept")
    _parsize = 4
    _tag = "Cub"

    def __init__(self, cub: float, quad: float, slope: float,
                 intercept: float):
        super().__init__(cub, quad, slope, intercept)


class Sine(meanFunction):
    """Sinusoidal mean, m(t) = A sin(2π t / P + φ)."""
    _param_names = ("amplitude", "period", "phase")
    _parsize = 3
    _tag = "Sin"

    def __init__(self, amplitude: float, period: float, phase: float):
        super().__init__(amplitude, period, phase)


class Keplerian(meanFunction):
    """Keplerian radial-velocity mean function: period P, semi-amplitude
    K, eccentricity e, argument of periastron w and time of periastron
    Tp (:func:`gpyrn_tpu_torch.utils.astro.keplerian_rv`)."""
    _param_names = ("P", "K", "e", "w", "Tp")
    _parsize = 5
    _tag = "Kep"

    def __init__(self, P: float, K: float, e: float, w: float, Tp: float):
        super().__init__(P, K, e, w, Tp)
