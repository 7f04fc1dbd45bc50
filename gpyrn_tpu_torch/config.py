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
* :func:`set_compute_dtype` records a preferred compute dtype that
  :func:`compute_dtype` reports back; it is advisory, as in the JAX
  package: the engines compute in the dtype of the tensors they are given.
* :func:`enable_nan_checks` is the counterpart of ``jax_debug_nans``:
  autograd's anomaly mode, which names the forward operation whose
  backward produced a NaN.

``enable_x64`` and ``ensure_compile_cache`` are not ported: torch names
every dtype, and there is no compiled program to cache.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DTYPE", "default_dtype", "set_compute_dtype",
           "compute_dtype", "enable_nan_checks"]

DEFAULT_DTYPE = torch.float64

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

_COMPUTE_DTYPE = DEFAULT_DTYPE


def default_dtype() -> torch.dtype:
    """The port's default floating dtype (:data:`DEFAULT_DTYPE`)."""
    return DEFAULT_DTYPE


def set_compute_dtype(dtype) -> None:
    """Record a preferred compute dtype (advisory): the engines compute in
    the dtype of the tensors they are given, so the actual switch is the
    dtype of the inputs or ``ELBOcalc(precision='mixed')``; this only
    records a preference that :func:`compute_dtype` reports back."""
    global _COMPUTE_DTYPE
    if not (isinstance(dtype, torch.dtype) and dtype.is_floating_point):
        raise ValueError(f"a compute dtype is a floating torch.dtype, got "
                         f"{dtype!r}")
    _COMPUTE_DTYPE = dtype


def compute_dtype() -> torch.dtype:
    return _COMPUTE_DTYPE


def enable_nan_checks(enable: bool = True) -> None:
    """Turn autograd's anomaly detection on or off: a backward pass that
    produces a NaN raises and names the forward operation it came from."""
    torch.autograd.set_detect_anomaly(bool(enable))
