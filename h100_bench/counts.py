"""The yardstick's counts: the work a fit needs by its shapes, and the
H100's published peaks.  Nothing here is read from the program, its
machine code or its launches, so a later implementation that does less
work than these counts reads a higher share, never a count that moved
with it.

The fit's floating-point operations (``PERF.md`` gives the derivation).
Per row of hyperparameters and per GP (q nodes and q p weights):

* once per fit, a Cholesky factor of the prior covariance K (N³/3);
* every sweep, a Cholesky factor of A = K + D (N³/3) and the diagonal
  of A⁻¹, which takes one triangular inverse (N³/3);
* with q > 1, once per fit the inverse of each node's factor (N³/3), and
  every sweep, for each pair of nodes k < j, the cross trace
  tr(K_j⁻¹ Σ_k), a triangular solve with N right-hand sides (N³).

Products with vectors (O(N²)) and the ELBO's sums (O(N)) are left out;
they are under 1 % of the above from N = 1000 on.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense rates, at the 700 W power limit.
# cuSOLVER's and cuBLAS's float64 factorizations and products run on the
# FP64 tensor cores; float32 is held at the CUDA cores' rate (TF32 is off
# in the package).
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}
# the CUDA cores alone, where B1 evaluates the covariance formulas
CUDA_CORE_FLOPS = {"float64": 34e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float64": 8, "float32": 4}

# Floating-point operations per element of a kernel matrix, counted from
# each covariance formula once per lag (a copy of chip_smoke.py:338's
# 17 for QP, each add, multiply, divide, abs, sin and exp counted once;
# the others counted the same way here):
#   QP   r, |r|, pi|r|/P, sin, sin², 2·/lp², r², /(2le²), −, exp, θ²·  = 17
#   SE   r, r², /(2ℓ²), exp, θ²·                                      = 6
#   P    r, |r|, pi|r|/P, sin, sin², 2·/ℓ², exp, θ²·                  = 11
#   M52  r, |r|, √5|r|/ℓ, a², /3, 1+a+, exp, θ²·                      = 11
OPS_PER_ELEMENT = {"QuasiPeriodic": 17, "SquaredExponential": 6,
                   "Periodic": 11, "Matern52": 11}


def sweep_flops(N, q, p):
    """Operations of one sweep of one row."""
    gps = q * (1 + p)
    return gps * 2 * N ** 3 / 3 + q * (q - 1) / 2 * N ** 3


def fit_flops(N, q, p):
    """Operations of a fit's set-up, once per row."""
    gps = q * (1 + p)
    return gps * N ** 3 / 3 + (q * N ** 3 / 3 if q > 1 else 0.0)


def fits_flops(N, q, p, n_iter):
    """Operations of the fits of rows that took ``n_iter`` sweeps each."""
    return sum(fit_flops(N, q, p) + int(n) * sweep_flops(N, q, p)
               for n in n_iter)


def kernel_matrix_seconds(N, dtype, kernel):
    """The least time B1 can build one N x N kernel matrix in: its output
    written once, and the formula evaluated once per lag (N (N + 1) / 2
    lags), the larger of the two."""
    t_bytes = N * N * ITEMSIZE[dtype] / HBM_BYTES_PER_S
    t_ops = (OPS_PER_ELEMENT[kernel] * N * (N + 1) / 2
             / CUDA_CORE_FLOPS[dtype])
    return max(t_bytes, t_ops)
