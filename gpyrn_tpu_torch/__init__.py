"""gpyrn_tpu_torch — Gaussian Process Regression Networks on PyTorch and CUDA.

Port of :mod:`gpyrn_tpu` (JAX, TPU) to PyTorch on an NVIDIA H100: the
mean-field fit in float64 and in mixed precision, the posterior
predictive, the ELBO's unrolled and implicit gradients, and the
searches over a batch of hyperparameter vectors
(``inference → set_components → ELBOcalc → predict``, ``elbo_grad``,
``optimize_adam``, ``optimize``, ``optimize_device``, ``mcmc``,
``inference.evidence.batch_elbo``).  The dense kernel matrices and their
backward come from hand-written CUDA kernels (``csrc/kernel_matrix.cu``),
built with nvcc at first use.  The package imports torch and never jax.

>>> from gpyrn_tpu_torch import inference, covfunc, meanfunc, GP
"""

__version__ = "0.1.0"

from gpyrn_tpu_torch import config  # noqa: F401  (numerics policy)

from gpyrn_tpu_torch.ops import kernels as covfunc   # noqa: E402
from gpyrn_tpu_torch.ops import means as meanfunc    # noqa: E402
from gpyrn_tpu_torch.inference.meanfield import inference  # noqa: E402
from gpyrn_tpu_torch.models.gp import GP             # noqa: E402

__all__ = ["inference", "covfunc", "meanfunc", "GP"]
