"""Numerics policy of gpyrn_tpu_torch, applied at import.

Counterpart of :mod:`gpyrn_tpu.config`:

* float64 is the default compute dtype (the JAX package enables x64 at
  import for the same reason, ``gpyrn_tpu/config.py:39-40``): the
  coordinate-ascent ELBO factors ill-conditioned kernel matrices.  The
  port never changes torch's global default dtype; every tensor it
  creates names its dtype, and the user shell converts its inputs to
  :data:`DEFAULT_DTYPE`.
* float32 matrix products run in full float32, never TF32 (mirrors
  ``jax_default_matmul_precision="highest"``, ``gpyrn_tpu/config.py:42-49``):
  the Cholesky factors and the Gram updates K − BᵀB go NaN on
  ill-conditioned kernels at TF32's ~10-bit mantissa.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DTYPE"]

DEFAULT_DTYPE = torch.float64

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
