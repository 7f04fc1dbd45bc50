"""Single-GP conditional helper.

Port of :mod:`gpyrn_tpu.models.gp`: a thin ``GP(time, y, yerr)`` holder
whose ``prediction(kernel, time, m, v)`` evaluates the standard GP
conditional, directly usable for plain single-output GP regression.  The
conditional is one Cholesky and two solves on the GP's device.

``new_kernel`` rebuilds ``Multiplication`` composites with each child's
own type, as the JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch

from gpyrn_tpu_torch.config import DEFAULT_DTYPE
from gpyrn_tpu_torch.ops import blocked as _blocked
from gpyrn_tpu_torch.ops import kernels as covfunc
from gpyrn_tpu_torch.ops.linalg import (PREDICT_NUGGET, cross_kernel_matrix,
                                        kernel_diag, kernel_matrix)

__all__ = ["GP"]


class GP:
    """A single Gaussian process over ``time`` with data ``y`` ± ``yerr``.

    Args:
        time: input coordinates
        y: measurements
        yerr: measurement uncertainties (default ~0)
        device: torch device the conditional runs on (the card by default;
            never detected)

    Results are float64 tensors on that device.
    """

    def __init__(self, time, y, yerr=None, device="cuda"):
        self.time = np.asarray(time, dtype=float)
        self.y = np.asarray(y, dtype=float)
        if yerr is None:
            self.yerr = np.full(self.time.size, 1e-12)
        else:
            self.yerr = np.asarray(yerr, dtype=float)
        self.yerr2 = self.yerr ** 2
        self.device = torch.device(device)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, dtype=float),
                               dtype=DEFAULT_DTYPE, device=self.device)

    def _kernel_pars(self, kernel):
        return kernel.pars

    def _kernel_matrix(self, kernel, time):
        return kernel_matrix(kernel.structure,
                             self._tensor(kernel.core_params()),
                             self._tensor(time), PREDICT_NUGGET)

    def _predict_kernel_matrix(self, kernel, time):
        return cross_kernel_matrix(
            kernel.structure, self._tensor(kernel.core_params()),
            self._tensor(time), self._tensor(self.time))

    def new_kernel(self, kernel, new_pars):
        """Rebuild a kernel object with new hyperparameters (composites
        recurse into both children)."""
        new_pars = list(np.atleast_1d(new_pars))
        if isinstance(kernel, (covfunc.Sum, covfunc.Multiplication)):
            n1 = kernel.k1.pars.size
            k1 = self.new_kernel(kernel.k1, new_pars[:n1])
            k2 = self.new_kernel(kernel.k2, new_pars[n1:])
            return k1 + k2 if isinstance(kernel, covfunc.Sum) else k1 * k2
        return type(kernel)(*new_pars)

    def prediction(self, kernel, time, m=None, v=None):
        """Conditional predictive distribution at ``time``.

        Args:
            kernel: covariance function object
            time: prediction coordinates
            m: observation vector to condition on (defaults to ``y``)
            v: per-point observation variances (defaults to ``yerr²``)

        Returns:
            (y_mean, y_var) tensors
        """
        tstar = self._tensor(np.atleast_1d(np.asarray(time, dtype=float)))
        m = self._tensor(self.y if m is None else m)
        v = self._tensor(self.yerr2 if v is None else v)
        structure = kernel.structure
        params = self._tensor(kernel.core_params())
        K = self._kernel_matrix(kernel, self.time) + torch.diag(v)
        L = _blocked.cholesky_nan(K)
        Ks = cross_kernel_matrix(structure, params, tstar,
                                 self._tensor(self.time))
        # O(n*): the diagonal of kernel_matrix without the n* × n* buffer
        Kss_diag = kernel_diag(structure, params, tstar, PREDICT_NUGGET)
        y_mean = Ks @ torch.cholesky_solve(m[:, None], L)[:, 0]
        y_var = Kss_diag - torch.einsum("nk,kn->n", Ks,
                                        torch.cholesky_solve(Ks.T, L))
        return y_mean, y_var
