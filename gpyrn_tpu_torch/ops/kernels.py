"""Covariance-function (kernel) library on torch tensors.

Port of :mod:`gpyrn_tpu.ops.kernels`, with the same design: a registry of
pure functions ``fn(params, r)`` (stationary, evaluated on a lag tensor
``r = t1[:, None] - t2[None, :]``) or ``fn(params, t1, t2``)
(non-stationary), keyed by the same hashable structure tags
(``("QP",)``, ``("+", ("SE",), ("M52",))``, ``("d", ("SE",))``), and a
thin object shell with the reference's parameter names.  Structures are
plain Python tuples identical to the JAX package's, so they compare equal
across the two packages.

Every formula keeps the JAX package's operation order, so the float64
results agree to rounding; the CUDA kernel-matrix kernel
(``csrc/kernel_matrix.cu``) repeats the stationary ones in the same order.

The deliberate fixes of the JAX package relative to the reference are
kept (``gpyrn_tpu/ops/kernels.py:22-34``): composites propagate
``set_parameters`` into their children; every kernel evaluates from
``self.pars``; ``NewRQP`` uses ``sin``; ``CosPeriodic`` keeps its
amplitude in ``pars``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch

__all__ = [
    "covFunction", "Sum", "Multiplication", "Derivative",
    "Constant", "WhiteNoise", "SquaredExponential", "Periodic",
    "QuasiPeriodic", "RationalQuadratic", "RQP", "Cosine", "Exponential",
    "Matern32", "Matern52", "Linear", "GammaExp", "Polynomial", "Piecewise",
    "Paciorek", "NewPeriodic", "QuasiNewPeriodic", "NewRQP",
    "HarmonicPeriodic", "QuasiHarmonicPeriodic", "CosPeriodic",
    "QuasiCosPeriodic",
    "evaluate", "n_params", "is_nonstationary", "structure_of",
    "from_structure",
]

PI = math.pi
SQRT3 = math.sqrt(3.0)
SQRT5 = math.sqrt(5.0)

# --------------------------------------------------------------------------
# functional core: registry of pure kernel functions
# --------------------------------------------------------------------------

# tag -> (n_params, fn, nonstationary, d2fn-or-None)
_REGISTRY: Dict[str, Tuple[int, Callable, bool, Callable]] = {}


def _register(tag, npars, fn, nonstationary=False, d2fn=None):
    _REGISTRY[tag] = (npars, fn, nonstationary, d2fn)
    return fn


def n_params(structure) -> int:
    """Number of (core) parameters consumed by a kernel structure tree."""
    tag = structure[0]
    if tag in ("+", "*"):
        return n_params(structure[1]) + n_params(structure[2])
    if tag == "d":
        return n_params(structure[1])
    return _REGISTRY[tag][0]


def is_nonstationary(structure) -> bool:
    """Whether the structure needs the (t1, t2) calling convention
    (HarmonicPeriodic, QuasiHarmonicPeriodic, Polynomial, Linear, and any
    composite holding one of them)."""
    tag = structure[0]
    if tag in ("+", "*"):
        return is_nonstationary(structure[1]) or is_nonstationary(structure[2])
    if tag == "d":
        return is_nonstationary(structure[1])
    return _REGISTRY[tag][2]


def evaluate(structure, params, r=None, t1=None, t2=None):
    """Evaluate a kernel structure on tensors.

    For stationary kernels pass the lag tensor ``r``; for non-stationary
    ones pass broadcastable coordinates ``t1``, ``t2``.  ``params`` is a
    1-D tensor of core parameters (indexing gives 0-d tensors, so the
    result stays on the parameters' device and in their dtype)."""
    tag = structure[0]
    if tag == "+":
        k = n_params(structure[1])
        return (evaluate(structure[1], params[:k], r, t1, t2) +
                evaluate(structure[2], params[k:], r, t1, t2))
    if tag == "*":
        k = n_params(structure[1])
        return (evaluate(structure[1], params[:k], r, t1, t2) *
                evaluate(structure[2], params[k:], r, t1, t2))
    if tag == "d":
        sub = structure[1]
        d2fn = _REGISTRY[sub[0]][3]
        if d2fn is None:
            raise ValueError(f"kernel {sub[0]} is not twice differentiable")
        return d2fn(params, r)
    _, fn, nonstat, _ = _REGISTRY[tag]
    if nonstat:
        if t1 is None or t2 is None:
            raise ValueError(f"kernel {tag} requires (t1, t2) inputs")
        return fn(params, t1, t2)
    return fn(params, r)


# ---- stationary kernels (evaluated on the lag tensor r) -------------------

def _constant(p, r):
    # K = c^2
    return torch.zeros_like(r) + p[0] ** 2


def _white_noise(p, r):
    # K = w^2 δij on square inputs
    w2 = p[0] ** 2
    if r.ndim == 2 and r.shape[0] == r.shape[1]:
        return w2 * torch.eye(r.shape[0], dtype=r.dtype, device=r.device)
    return torch.zeros_like(r) + w2


def _se(p, r):
    # θ² exp(-r²/2ℓ²)
    return p[0] ** 2 * torch.exp(-0.5 * r ** 2 / p[1] ** 2)


def _se_d2(p, r):
    theta, ell = p[0], p[1]
    return (theta ** 2 / ell ** 4) * (ell ** 2 - r ** 2) * \
        torch.exp(-0.5 * r ** 2 / ell ** 2)


def _periodic(p, r):
    # θ² exp(-2 sin²(π|r|/P)/ℓ²)
    theta, P, ell = p[0], p[1], p[2]
    return theta ** 2 * torch.exp(
        -2 * torch.sin(PI * torch.abs(r) / P) ** 2 / ell ** 2)


def _periodic_d2(p, r):
    theta, P, ell = p[0], p[1], p[2]
    rP = PI * r / P
    term1 = 4 * PI ** 2 * theta ** 2
    term2 = ell ** 2 * torch.cos(2 * rP) - \
        4 * torch.sin(rP) ** 2 * torch.cos(rP) ** 2
    term3 = torch.exp(-2 * torch.sin(rP) ** 2 / ell ** 2)
    return term1 * term2 * term3


def _quasi_periodic(p, r):
    # SE × Periodic closed form
    theta, elle, P, ellp = p[0], p[1], p[2], p[3]
    term1 = -2 * torch.sin(PI * torch.abs(r) / P) ** 2 / ellp ** 2
    term2 = r ** 2 / (2 * elle ** 2)
    return theta ** 2 * torch.exp(term1 - term2)


def _quasi_periodic_d2(p, r):
    theta, elle, P, ellp = p[0], p[1], p[2], p[3]
    term1 = 2 * theta ** 2 / (P ** 2 * ellp ** 4 * elle ** 4)
    term2 = (P ** 2 * ellp ** 4 * elle ** 2
             - 2 * P ** 2 * ellp ** 4 * r ** 2
             - 4 * PI * P * ellp ** 2 * elle ** 2 * r *
             torch.sin(2 * PI * r / P)
             + 2 * PI ** 2 * ellp ** 2 * elle ** 4 *
             torch.cos(2 * PI * r / P)
             - 8 * PI ** 2 * elle ** 4 *
             torch.sin(PI * r / P) ** 2 * torch.cos(PI * r / P) ** 2)
    term3 = torch.exp(-(ellp ** 2 * r ** 2 +
                        2 * elle ** 2 * torch.sin(PI * r / P) ** 2) /
                      (ellp ** 2 * elle ** 2))
    return term1 * term2 * term3


def _rational_quadratic(p, r):
    # θ² (1 + r²/2αℓ²)^-α
    theta, alpha, ell = p[0], p[1], p[2]
    return theta ** 2 * (1 + 0.5 * r ** 2 / (alpha * ell ** 2)) ** (-alpha)


def _rqp(p, r):
    # Periodic × RQ
    theta, alpha, elle, P, ellp = p[0], p[1], p[2], p[3], p[4]
    return theta ** 2 * \
        torch.exp(-2 * torch.sin(PI * torch.abs(r) / P) ** 2 / ellp ** 2) * \
        (1 + r ** 2 / (2 * alpha * elle ** 2)) ** (-alpha)


def _cosine(p, r):
    # θ² cos(2π|r|/P)
    return p[0] ** 2 * torch.cos(2 * PI * torch.abs(r) / p[1])


def _exponential(p, r):
    # θ² exp(-|r|/ℓ)
    return p[0] ** 2 * torch.exp(-torch.abs(r) / p[1])


def _matern32(p, r):
    # Matérn ν=3/2
    s = SQRT3 * torch.abs(r) / p[1]
    return p[0] ** 2 * (1.0 + s) * torch.exp(-s)


def _matern52(p, r):
    # Matérn ν=5/2, written as the reference writes it
    theta, ell = p[0], p[1]
    ar = torch.abs(r)
    return theta ** 2 * \
        (1.0 + (3 * SQRT5 * ell * ar + 5 * ar ** 2) /
         (3 * ell ** 2)) * torch.exp(-SQRT5 * ar / ell)


def _gamma_exp(p, r):
    # θ² exp(-(|r|/ℓ)^γ)
    return p[0] ** 2 * torch.exp(-(torch.abs(r) / p[2]) ** p[1])


def _piecewise(p, r):
    # cubic compact-support kernel
    rr = r / (0.5 * p[0])
    a = torch.abs(rr)
    piecewise = (3 * a + 1) * (1 - a) ** 3
    return torch.where(a > 1, torch.zeros_like(piecewise), piecewise)


def _paciorek(p, r):
    # modified stationary Paciorek
    amp, l1, l2 = p[0], p[1], p[2]
    a = torch.sqrt(2 * l1 * l2 / (l1 ** 2 + l2 ** 2))
    b = torch.exp(-2 * r * r / (l1 ** 2 + l2 ** 2))
    return amp ** 2 * a * b


def _new_periodic(p, r):
    # RQ mapped to (cos, sin) space
    amp, alpha2, P, ell = p[0], p[1], p[2], p[3]
    a = (1 + 2 * torch.sin(PI * torch.abs(r) / P) ** 2 /
         (alpha2 * ell ** 2)) ** (-alpha2)
    return amp ** 2 * a


def _quasi_new_periodic(p, r):
    # NewPeriodic × SE
    amp, alpha2, elle, P, ellp = p[0], p[1], p[2], p[3], p[4]
    a = (1 + 2 * torch.sin(PI * torch.abs(r) / P) ** 2 /
         (alpha2 * ellp ** 2)) ** (-alpha2)
    b = torch.exp(-0.5 * r ** 2 / elle ** 2)
    return amp ** 2 * a * b


def _new_rqp(p, r):
    # NewPeriodic × RQ (the reference's ``np.sine`` typo fixed to sin)
    amp, alpha1, alpha2, elle, P, ellp = p[0], p[1], p[2], p[3], p[4], p[5]
    a = (1 + 2 * torch.sin(PI * torch.abs(r) / P) ** 2 /
         (alpha2 * ellp ** 2)) ** (-alpha2)
    b = (1 + 0.5 * r ** 2 / (alpha1 * elle ** 2)) ** (-alpha1)
    return amp ** 2 * a * b


def _cos_periodic(p, r):
    # SE mapped with cos (note cos², not sin²)
    amp, P, ell = p[0], p[1], p[2]
    return amp ** 2 * torch.exp(
        -2 * torch.cos(PI * torch.abs(r) / P) ** 2 / ell ** 2)


def _quasi_cos_periodic(p, r):
    # CosPeriodic × SE
    amp, elle, P, ellp = p[0], p[1], p[2], p[3]
    return amp ** 2 * torch.exp(
        -2 * torch.cos(PI * torch.abs(r) / P) ** 2 / ellp ** 2
        - r ** 2 / (2 * elle ** 2))


# ---- non-stationary kernels (evaluated on coordinates t1, t2) -------------

def _linear(p, t1, t2):
    # (t1 - c)(t2 - c)
    return (t1 - p[0]) * (t2 - p[0])


def _polynomial(p, t1, t2):
    # (a t1 t2 + b)^c; pars[0]=theta is unused, matching the reference
    return (p[1] * t1 * t2 + p[2]) ** p[3]


def _harmonic_series(N, P, t):
    """Shared Lagrange-identity terms of the Harmonic kernels."""
    s = (N + 0.5) * 2 * PI * t / P
    base = torch.sin(PI * t / P)
    # operator precedence matches the reference exactly:
    # sin(...)/2*sin(...) means (sin(...)/2) * sin(...)
    sin_term = torch.sin(s) / 2 * base
    cos_term = torch.cos(s) / 2 * base
    tan_term = 0.5 / torch.tan(PI * t / P)
    return sin_term, cos_term, tan_term


def _harmonic_periodic(p, t1, t2):
    # N-harmonic periodic kernel
    N, amp, P, ell = p[0], p[1], p[2], p[3]
    sin1, cos1, tan1 = _harmonic_series(N, P, t1)
    sin2, cos2, tan2 = _harmonic_series(N, P, t2)
    first_part = (sin1 - sin2) ** 2
    second_part = (tan1 - cos1 - tan2 + cos2) ** 2
    return amp ** 2 * torch.exp(-0.5 * (first_part + second_part) / ell ** 2)


def _quasi_harmonic_periodic(p, t1, t2):
    # HarmonicPeriodic × SE; N rides along in pars[0] (the OO shell keeps
    # the reference's 4-parameter public surface)
    N, amp, elle, P, ellp = p[0], p[1], p[2], p[3], p[4]
    sin1, cos1, tan1 = _harmonic_series(N, P, t1)
    sin2, cos2, tan2 = _harmonic_series(N, P, t2)
    first_part = (sin1 - sin2) ** 2
    second_part = (tan1 - cos1 - tan2 + cos2) ** 2
    a = torch.exp(-0.5 * (first_part + second_part) / ellp ** 2)
    b = torch.exp(-0.5 * (t1 - t2) ** 2 / elle ** 2)
    return amp ** 2 * a * b


_register("C", 1, _constant)
_register("WN", 1, _white_noise)
_register("SE", 2, _se, d2fn=_se_d2)
_register("P", 3, _periodic, d2fn=_periodic_d2)
_register("QP", 4, _quasi_periodic, d2fn=_quasi_periodic_d2)
_register("RQ", 3, _rational_quadratic)
_register("RQP", 5, _rqp)
_register("COS", 2, _cosine)
_register("EXP", 2, _exponential)
_register("M32", 2, _matern32)
_register("M52", 2, _matern52)
_register("LIN", 1, _linear, nonstationary=True)
_register("GammaExp", 3, _gamma_exp)
_register("POLY", 4, _polynomial, nonstationary=True)
_register("PW", 1, _piecewise)
_register("PAC", 3, _paciorek)
_register("NP", 4, _new_periodic)
_register("QNP", 5, _quasi_new_periodic)
_register("NRQP", 6, _new_rqp)
_register("HP", 4, _harmonic_periodic, nonstationary=True)
_register("QHP", 5, _quasi_harmonic_periodic, nonstationary=True)
_register("CP", 3, _cos_periodic)
_register("QCP", 4, _quasi_cos_periodic)


# --------------------------------------------------------------------------
# thin object shell — reference-compatible API
# --------------------------------------------------------------------------

def _as_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=float), dtype=torch.float64)


class covFunction:
    """Base class for covariance functions used for GPRN nodes and weights.

    Holds a flat numpy ``pars`` array, supports ``k1 + k2`` / ``k1 * k2``
    algebra and the prefix-consuming ``set_parameters`` chaining protocol
    used by ``inference.set_parameters``.
    """
    _tag: str = None
    _param_names: Tuple[str, ...] = ()
    _twice_differentiable = False

    def __init__(self, *args):
        self.pars = np.array(args, dtype=float)

    # -- functional-core bridge -------------------------------------------
    @property
    def structure(self):
        """Hashable structure tree for the functional core."""
        return (self._tag,)

    def core_params(self):
        """Flat core parameter vector (numpy) for :attr:`structure`
        (identical to ``pars`` except for kernels with static extras,
        see QuasiHarmonicPeriodic)."""
        return self.pars

    def core_params_from(self, pars):
        """Map from a trainable parameter tensor to the core parameter
        tensor (identity for almost all kernels)."""
        return pars

    def has_core_map(self) -> bool:
        """True when trainable pars differ from core params."""
        return False

    # -- reference-compatible surface ---------------------------------------
    def __call__(self, r, t1=None, t2=None):
        p = _as_tensor(self.core_params())
        if is_nonstationary(self.structure):
            # the reference calls these as kernel(t1, t2)
            return evaluate(self.structure, p, t1=_as_tensor(r),
                            t2=_as_tensor(t1))
        return evaluate(self.structure, p, r=_as_tensor(r))

    def _dkdxidj(self, r):
        return evaluate(("d", self.structure), _as_tensor(self.core_params()),
                        r=_as_tensor(r))

    def __repr__(self):
        if self._param_names:
            pars = ", ".join(f"{p}={v}"
                             for p, v in zip(self._param_names, self.pars))
        else:
            pars = ", ".join(map(str, self.pars))
        return f"{self.__class__.__name__}({pars})"

    def get_parameters(self):
        return self.pars

    def set_parameters(self, p):
        """Consume a prefix of ``p``; return the (possibly empty) remainder
        (the reference's chaining protocol)."""
        p = np.atleast_1d(np.asarray(p, dtype=float))
        if len(p) < self.pars.size:
            raise ValueError(
                f"too few parameters for kernel {self.__class__.__name__}")
        if len(p) > self.pars.size:
            self.pars = np.array(p[:self.pars.size], dtype=float)
            return np.array(p[self.pars.size:])
        self.pars = p

    def __add__(self, b):
        return Sum(self, b)

    def __radd__(self, b):
        return self.__add__(b)

    def __mul__(self, b):
        return Multiplication(self, b)

    def __rmul__(self, b):
        return self.__mul__(b)


def _combined_param_names(k1, k2):
    """Combined names for composite kernels, numbering duplicates so
    ``parameters_dict`` keys stay unique."""
    n1 = list(getattr(k1, "_param_names", ()) or ())
    n2 = list(getattr(k2, "_param_names", ()) or ())
    if n1 and n2 and set(n1) & set(n2):
        return tuple(f"{n}1" for n in n1) + tuple(f"{n}2" for n in n2)
    return tuple(n1) + tuple(n2)


class _operator(covFunction):
    """Binary composite of two kernels."""
    _op_tag = None

    def __init__(self, k1, k2):
        self.k1 = k1
        self.k2 = k2
        self.kerneltype = "complex"
        self.pars = np.r_[k1.pars, k2.pars]
        self._param_names = _combined_param_names(k1, k2)

    @property
    def structure(self):
        return (self._op_tag, self.k1.structure, self.k2.structure)

    def core_params(self):
        # read children live so direct child mutation is never stale
        return np.r_[np.asarray(self.k1.core_params()),
                     np.asarray(self.k2.core_params())]

    def core_params_from(self, pars):
        n1 = self.k1.pars.size
        c1 = self.k1.core_params_from(pars[:n1])
        c2 = self.k2.core_params_from(pars[n1:])
        return torch.cat([torch.atleast_1d(c1), torch.atleast_1d(c2)])

    def has_core_map(self):
        return self.k1.has_core_map() or self.k2.has_core_map()

    def set_parameters(self, p):
        """Propagate into children."""
        p = np.atleast_1d(np.asarray(p, dtype=float))
        if len(p) < self.pars.size:
            raise ValueError(
                f"too few parameters for kernel {self.__class__.__name__}")
        rest = self.k1.set_parameters(p)
        if rest is None:
            rest = np.array([])
        rest = self.k2.set_parameters(rest)
        self.pars = np.r_[self.k1.pars, self.k2.pars]
        if len(p) > self.pars.size:
            return rest
        return None


class Sum(_operator):
    """Sum of two covariance functions."""
    _op_tag = "+"

    def __call__(self, r, t1=None, t2=None):
        return evaluate(self.structure, _as_tensor(self.core_params()),
                        r=None if r is None else _as_tensor(r),
                        t1=None if t1 is None else _as_tensor(t1),
                        t2=None if t2 is None else _as_tensor(t2))

    def __repr__(self):
        return f"{self.k1} + {self.k2}"


class Multiplication(_operator):
    """Product of two covariance functions."""
    _op_tag = "*"

    __call__ = Sum.__call__

    def __repr__(self):
        return f"{self.k1} * {self.k2}"


class _unary_operator(covFunction):
    """Unary composite over one (twice-differentiable) kernel."""
    def __init__(self, k):
        if not getattr(k, "_twice_differentiable", False):
            raise ValueError(f"kernel {k} is not twice differentiable")
        self.k = k
        self.kerneltype = "complex_unary"
        self.pars = self.k.pars
        self._param_names = self.k._param_names
        self._tag = "d" + self.k._tag

    @property
    def structure(self):
        return ("d", self.k.structure)

    def core_params(self):
        return self.k.core_params()

    def core_params_from(self, pars):
        return self.k.core_params_from(pars)

    def has_core_map(self):
        return self.k.has_core_map()

    def set_parameters(self, p):
        rest = self.k.set_parameters(p)
        self.pars = self.k.pars
        return rest


class Derivative(_unary_operator):
    """d²k/dxᵢdxⱼ kernel of a twice-differentiable kernel."""
    def __call__(self, r, t1=None, t2=None):
        return evaluate(self.structure, _as_tensor(self.core_params()),
                        r=_as_tensor(r))

    def __repr__(self):
        self.k.pars = self.pars
        return f"d {self.k}"


# ---- concrete kernels ------------------------------------------------------

class Constant(covFunction):
    r"""Constant kernel, $K_{ij} = c^2$."""
    _param_names = ("c",)
    _tag = "C"

    def __init__(self, c: float):
        super().__init__(c)


class WhiteNoise(covFunction):
    r"""White-noise kernel, $K_{ij} = w^2 \delta_{ij}$ on square inputs."""
    _param_names = ("wn",)
    _tag = "WN"

    def __init__(self, w: float):
        super().__init__(w)


class SquaredExponential(covFunction):
    r"""Squared-exponential (RBF), $\theta^2 e^{-r^2/2\ell^2}$."""
    _param_names = ("theta", "ell")
    _tag = "SE"
    _twice_differentiable = True

    def __init__(self, theta: float, ell: float):
        super().__init__(theta, ell)


class Periodic(covFunction):
    r"""Periodic (exp-sine-squared), $\theta^2 e^{-2\sin^2(\pi r/P)/\ell^2}$."""
    _param_names = ("theta", "P", "ell")
    _tag = "P"
    _twice_differentiable = True

    def __init__(self, theta: float, P: float, ell: float):
        super().__init__(theta, P, ell)


class QuasiPeriodic(covFunction):
    r"""SE × Periodic closed form (equivalent to their product)."""
    _param_names = ("theta", "le", "P", "lp")
    _tag = "QP"
    _twice_differentiable = True

    def __init__(self, theta: float, elle: float, P: float, ellp: float):
        super().__init__(theta, elle, P, ellp)


class RationalQuadratic(covFunction):
    r"""Rational quadratic, $\theta^2 (1 + r^2/2\alpha\ell^2)^{-\alpha}$."""
    _param_names = ("theta", "alpha", "ell")
    _tag = "RQ"

    def __init__(self, theta: float, alpha: float, ell: float):
        super().__init__(theta, alpha, ell)


class RQP(covFunction):
    """Periodic × rational-quadratic product."""
    _param_names = ("theta", "alpha", "elle", "ellp", "P")
    _tag = "RQP"

    def __init__(self, theta: float, alpha: float, elle: float, P: float,
                 ellp: float):
        # argument-to-pars order matches the reference
        super().__init__(theta, alpha, elle, P, ellp)


class Cosine(covFunction):
    r"""Cosine kernel, $\theta^2 \cos(2\pi r/P)$."""
    _param_names = ("theta", "P")
    _tag = "COS"

    def __init__(self, theta: float, P: float):
        super().__init__(theta, P)


class Exponential(covFunction):
    r"""Exponential kernel, $\theta^2 e^{-|r|/\ell}$."""
    _param_names = ("theta", "ell")
    _tag = "EXP"

    def __init__(self, theta: float, ell: float):
        super().__init__(theta, ell)


class Matern32(covFunction):
    """Matérn ν=3/2 kernel."""
    _param_names = ("theta", "ell")
    _tag = "M32"

    def __init__(self, theta: float, ell: float):
        super().__init__(theta, ell)


class Matern52(covFunction):
    """Matérn ν=5/2 kernel."""
    _param_names = ("theta", "ell")
    _tag = "M52"

    def __init__(self, theta: float, ell: float):
        super().__init__(theta, ell)


class Linear(covFunction):
    """Linear (non-stationary) kernel, (t1-c)(t2-c)."""
    _param_names = ("c",)
    _tag = "LIN"

    def __init__(self, c: float):
        super().__init__(c)
        self.tag = "LIN"


class GammaExp(covFunction):
    r"""Gamma-exponential, $\theta^2 e^{-(|r|/\ell)^\gamma}$."""
    _param_names = ("theta", "gamma", "l")
    _tag = "GammaExp"

    def __init__(self, theta: float, gamma: float, l: float):  # noqa: E741
        super().__init__(theta, gamma, l)


class Polynomial(covFunction):
    """Polynomial (non-stationary) kernel, (a·t1·t2 + b)^c."""
    _param_names = ("theta", "a", "b", "c")
    _tag = "POLY"

    def __init__(self, theta: float, a: float, b: float, c: float):
        super().__init__(theta, a, b, c)


class Piecewise(covFunction):
    """Third-order piecewise-polynomial compact-support kernel."""
    _param_names = ("eta",)
    _tag = "PW"

    def __init__(self, eta: float):
        super().__init__(eta)


class Paciorek(covFunction):
    """Modified Paciorek kernel (stationary version)."""
    _param_names = ("amplitude", "ell_1", "ell_2")
    _tag = "PAC"

    def __init__(self, amplitude: float, ell_1: float, ell_2: float):
        super().__init__(amplitude, ell_1, ell_2)


class NewPeriodic(covFunction):
    """RQ kernel mapped to the 2D space u(x) = (cos x, sin x)."""
    _param_names = ("amplitude", "alpha2", "P", "l")
    _tag = "NP"

    def __init__(self, amplitude: float, alpha2: float, P: float,
                 l: float):  # noqa: E741
        super().__init__(amplitude, alpha2, P, l)


class QuasiNewPeriodic(covFunction):
    """NewPeriodic × SquaredExponential."""
    _param_names = ("amplitude", "alpha2", "ell_e", "P", "ell_p")
    _tag = "QNP"

    def __init__(self, amplitude: float, alpha2: float, ell_e: float,
                 P: float, ell_p: float):
        super().__init__(amplitude, alpha2, ell_e, P, ell_p)


class NewRQP(covFunction):
    """NewPeriodic × RationalQuadratic."""
    _param_names = ("amplitude", "alpha1", "alpha2", "ell_e", "P", "ell_p")
    _tag = "NRQP"

    def __init__(self, amplitude: float, alpha1: float, alpha2: float,
                 ell_e: float, P: float, ell_p: float):
        super().__init__(amplitude, alpha1, alpha2, ell_e, P, ell_p)


class HarmonicPeriodic(covFunction):
    """N-harmonic periodic kernel via Lagrange identities (non-stationary)."""
    _param_names = ("N", "amplitude", "P", "ell")
    _tag = "HP"

    def __init__(self, N: int, amplitude: float, P: float, ell: float):
        super().__init__(N, amplitude, P, ell)


class QuasiHarmonicPeriodic(covFunction):
    """HarmonicPeriodic × SE (non-stationary).

    Public parameter surface matches the reference: 4 parameters, with
    the harmonic count ``N`` a fixed attribute outside ``pars``.
    Internally N is prepended to the core parameter vector.
    """
    _param_names = ("amplitude", "ell_e", "P", "ell_p")
    _tag = "QHP"

    def __init__(self, N: int, amplitude: float, ell_e: float, P: float,
                 ell_p: float):
        super().__init__(amplitude, ell_e, P, ell_p)
        self.N = N

    def core_params(self):
        return np.r_[float(self.N), self.pars]

    def core_params_from(self, pars):
        N = torch.full((1,), float(self.N), dtype=pars.dtype,
                       device=pars.device)
        return torch.cat([N, pars])

    def has_core_map(self):
        return True

    @property
    def structure(self):
        # N is a static extra of the structure
        return (self._tag, int(self.N))


class CosPeriodic(covFunction):
    r"""SE mapped with cos (note cos², not sin²): carries the amplitude in
    ``pars``.

    .. warning:: Not a valid covariance function in general —
       :math:`e^{-2\cos^2(\pi r/P)/\ell^2}` can exceed its zero-lag value,
       so kernel matrices may be indefinite (reproduced for API parity)."""
    _param_names = ("amplitude", "P", "ell")
    _tag = "CP"

    def __init__(self, amplitude: float, P: float, ell: float):
        super().__init__(amplitude, P, ell)


class QuasiCosPeriodic(covFunction):
    """CosPeriodic × SE."""
    _param_names = ("amplitude", "ell_e", "P", "ell_p")
    _tag = "QCP"

    def __init__(self, amplitude: float, ell_e: float, P: float,
                 ell_p: float):
        super().__init__(amplitude, ell_e, P, ell_p)


def structure_of(kernel: covFunction):
    """Structure tree of a kernel object (convenience)."""
    return kernel.structure


_CLASS_BY_TAG = {cls._tag: cls for cls in (
    Constant, WhiteNoise, SquaredExponential, Periodic, QuasiPeriodic,
    RationalQuadratic, RQP, Cosine, Exponential, Matern32, Matern52, Linear,
    GammaExp, Polynomial, Piecewise, Paciorek, NewPeriodic, QuasiNewPeriodic,
    NewRQP, HarmonicPeriodic, QuasiHarmonicPeriodic, CosPeriodic,
    QuasiCosPeriodic)}


def _n_trainable(structure) -> int:
    """Trainable (``pars``) count of a structure: the core count, less
    QuasiHarmonicPeriodic's static harmonic count."""
    tag = structure[0]
    if tag in ("+", "*"):
        return _n_trainable(structure[1]) + _n_trainable(structure[2])
    if tag == "d":
        return _n_trainable(structure[1])
    return n_params(structure) - (tag == "QHP")


def from_structure(structure, pars) -> covFunction:
    """Kernel object for a structure tree and its trainable ``pars``
    (the inverse of ``(k.structure, k.pars)``)."""
    pars = np.atleast_1d(np.asarray(pars, dtype=float))
    tag = structure[0]
    if tag in ("+", "*"):
        k = _n_trainable(structure[1])
        k1 = from_structure(structure[1], pars[:k])
        k2 = from_structure(structure[2], pars[k:])
        return Sum(k1, k2) if tag == "+" else Multiplication(k1, k2)
    if tag == "d":
        return Derivative(from_structure(structure[1], pars))
    if tag == "QHP":
        return QuasiHarmonicPeriodic(structure[1], *pars)
    return _CLASS_BY_TAG[tag](*pars)
