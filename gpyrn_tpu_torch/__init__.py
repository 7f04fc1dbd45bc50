"""gpyrn_tpu_torch — Gaussian Process Regression Networks on PyTorch and CUDA.

Port of :mod:`gpyrn_tpu` (JAX, TPU) to PyTorch on an NVIDIA H100: the
mean-field fit in float64 and in mixed precision, the posterior
predictive, the ELBO's unrolled and implicit gradients, and the
searches over a batch of hyperparameter vectors
(``inference → set_components → ELBOcalc → predict``, ``elbo_grad``,
``optimize_adam``, ``optimize``, ``optimize_device``, ``mcmc``,
``inference.evidence.batch_elbo``), the Keplerian radial-velocity mean
(``utils.astro``), the bundled solar dataset (``datasets``), and the
exported posterior predictive of :mod:`gpyrn_tpu_torch.serving`.  The
dense kernel matrices and their backward come from hand-written CUDA
kernels (``csrc/kernel_matrix.cu``), built with nvcc at first use.  The
package imports torch and never jax.

The names below are the JAX package's top-level names
(``gpyrn_tpu/__init__.py``), each imported on first use, so that a
serving process (``serving.load_predict``) loads neither the shell nor
the engine.

>>> from gpyrn_tpu_torch import inference, covfunc, meanfunc, GP
>>> from gpyrn_tpu_torch import Constant, QuasiPeriodic, priors, serving
"""
import importlib
import sys
import types

__version__ = "0.1.0"

from gpyrn_tpu_torch import config  # noqa: F401,E402  (numerics policy)

__all__ = [
    "inference", "covfunc", "meanfunc", "meanfield", "evidence",
    "nonparametric", "priors", "datasets", "serving", "GP",
    "Constant", "Linear", "SquaredExponential", "QuasiPeriodic",
]

# name -> (module, attribute of it, or None for the module itself)
_LAZY = {"inference": ("gpyrn_tpu_torch.inference.meanfield", "inference"),
         "covfunc": ("gpyrn_tpu_torch.ops.kernels", None),
         "meanfunc": ("gpyrn_tpu_torch.ops.means", None),
         "meanfield": ("gpyrn_tpu_torch.inference.meanfield", None),
         "evidence": ("gpyrn_tpu_torch.inference.evidence", None),
         "nonparametric": ("gpyrn_tpu_torch.inference.nonparametric", None),
         "priors": ("gpyrn_tpu_torch.inference.priors", None),
         "datasets": ("gpyrn_tpu_torch.datasets", None),
         "serving": ("gpyrn_tpu_torch.serving", None),
         "GP": ("gpyrn_tpu_torch.models.gp", "GP"),
         "Constant": ("gpyrn_tpu_torch.ops.means", "Constant"),
         "Linear": ("gpyrn_tpu_torch.ops.means", "Linear"),
         "SquaredExponential": ("gpyrn_tpu_torch.ops.kernels",
                                "SquaredExponential"),
         "QuasiPeriodic": ("gpyrn_tpu_torch.ops.kernels", "QuasiPeriodic")}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = _LAZY[name]
    value = importlib.import_module(module)
    if attr is not None:
        value = getattr(value, attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


class _Package(types.ModuleType):
    """The import system binds a loaded subpackage to its parent's
    attribute of the same name; ``gpyrn_tpu_torch.inference`` names the
    user's class, so the subpackage of that name is left to
    ``sys.modules``."""

    def __setattr__(self, name, value):
        if name == "inference" and isinstance(value, types.ModuleType):
            return
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Package
