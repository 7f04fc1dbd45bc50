"""Prior distributions whose log-density runs on the device.

Port of :mod:`gpyrn_tpu.inference.priors`.  The reference takes frozen
``scipy.stats`` objects as priors; these classes keep that protocol
(``logpdf``, ``rvs``, ``std``) so they drop into the ensemble sampler,
and their ``logpdf`` computes in torch on the input's device and dtype,
so the ensemble's device chain never leaves the card.  ``rvs`` and
``std`` run on the host with numpy, as in the JAX package.  ``logpdf``
takes a tensor (its result stays on that device) or anything numpy takes
(computed in float64 on the CPU).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Normal", "LogNormal", "Uniform", "HalfNormal", "Gamma",
           "InvGamma", "Jeffreys"]


def _tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=float))


def _masked(valid, lp):
    """``lp`` where ``valid``, −inf elsewhere."""
    return torch.where(valid, lp, torch.full_like(lp, -math.inf))


class _Prior:
    def rvs(self, size=None, rng=None):
        raise NotImplementedError

    def logpdf(self, x):
        raise NotImplementedError

    def std(self):
        return float(np.std(self.rvs(size=4096,
                                     rng=np.random.default_rng(0))))


class Normal(_Prior):
    def __init__(self, loc, scale):
        self.loc, self.scale = float(loc), float(scale)

    def logpdf(self, x):
        # jax.scipy.stats.norm.logpdf's formula
        x = _tensor(x)
        scale2 = self.scale * self.scale
        return (math.log(2 * math.pi * scale2)
                + (x - self.loc) ** 2 / scale2) / -2.0

    def rvs(self, size=None, rng=None):
        rng = np.random.default_rng() if rng is None else rng
        return rng.normal(self.loc, self.scale, size=size)

    def std(self):
        return self.scale


class LogNormal(_Prior):
    def __init__(self, mu, sigma):
        self.mu, self.sigma = float(mu), float(sigma)

    def logpdf(self, x):
        x = _tensor(x)
        valid = x > 0
        lx = torch.log(torch.where(valid, x, torch.ones_like(x)))
        lp = (-lx - math.log(self.sigma) - 0.5 * math.log(2 * math.pi)
              - 0.5 * ((lx - self.mu) / self.sigma) ** 2)
        return _masked(valid, lp)

    def rvs(self, size=None, rng=None):
        rng = np.random.default_rng() if rng is None else rng
        return rng.lognormal(self.mu, self.sigma, size=size)


class Uniform(_Prior):
    def __init__(self, lo, hi):
        self.lo, self.hi = float(lo), float(hi)

    def logpdf(self, x):
        x = _tensor(x)
        inside = (x >= self.lo) & (x <= self.hi)
        return _masked(inside, torch.full_like(x, -math.log(self.hi -
                                                            self.lo)))

    def rvs(self, size=None, rng=None):
        rng = np.random.default_rng() if rng is None else rng
        return rng.uniform(self.lo, self.hi, size=size)

    def std(self):
        return (self.hi - self.lo) / np.sqrt(12.0)


class HalfNormal(_Prior):
    def __init__(self, scale):
        self.scale = float(scale)

    def logpdf(self, x):
        x = _tensor(x)
        lp = (0.5 * math.log(2.0 / math.pi) - math.log(self.scale)
              - 0.5 * (x / self.scale) ** 2)
        return _masked(x >= 0, lp)

    def rvs(self, size=None, rng=None):
        rng = np.random.default_rng() if rng is None else rng
        return np.abs(rng.normal(0.0, self.scale, size=size))


class Gamma(_Prior):
    def __init__(self, a, scale=1.0):
        self.a, self.scale = float(a), float(scale)

    def logpdf(self, x):
        # jax.scipy.stats.gamma.logpdf's formula
        x = _tensor(x)
        ok = x >= 0
        y = torch.where(ok, x / self.scale, torch.ones_like(x))
        lp = torch.xlogy(torch.full_like(y, self.a - 1.0), y) - y \
            - (math.lgamma(self.a) + math.log(self.scale))
        return _masked(ok, lp)

    def rvs(self, size=None, rng=None):
        rng = np.random.default_rng() if rng is None else rng
        return rng.gamma(self.a, self.scale, size=size)


class InvGamma(_Prior):
    """Inverse-gamma (the reference builds such priors to hold 98% of the
    mass in a range)."""

    def __init__(self, a, scale=1.0):
        self.a, self.scale = float(a), float(scale)

    def logpdf(self, x):
        x = _tensor(x)
        valid = x > 0
        xs = torch.where(valid, x, torch.ones_like(x))
        lp = (self.a * math.log(self.scale) - math.lgamma(self.a)
              - (self.a + 1) * torch.log(xs) - self.scale / xs)
        return _masked(valid, lp)

    def rvs(self, size=None, rng=None):
        rng = np.random.default_rng() if rng is None else rng
        return 1.0 / rng.gamma(self.a, 1.0 / self.scale, size=size)


class Jeffreys(_Prior):
    """log-uniform on [lo, hi]."""

    def __init__(self, lo, hi):
        assert lo > 0
        self.lo, self.hi = float(lo), float(hi)

    def logpdf(self, x):
        x = _tensor(x)
        inside = (x >= self.lo) & (x <= self.hi)
        xs = torch.where(inside, x, torch.ones_like(x))
        norm = math.log(math.log(self.hi / self.lo))
        return _masked(inside, -torch.log(xs) - norm)

    def rvs(self, size=None, rng=None):
        rng = np.random.default_rng() if rng is None else rng
        return np.exp(rng.uniform(np.log(self.lo), np.log(self.hi),
                                  size=size))
