"""Kernel-matrix construction with the reference's nugget conventions.

Port of :mod:`gpyrn_tpu.ops.linalg`:

* training covariance: ``K + 1e-6 I``; prediction covariance:
  ``K + 1.25e-12 I``;
* in float32 the diagonal jitter scales with the trace,
  ``max(nugget, F32_JITTER_MULT·eps·tr K)``, so the condition number stays
  inside float32's range (in float64 the fixed nugget always wins);
* non-stationary kernels (HarmonicPeriodic, QuasiHarmonicPeriodic,
  Polynomial, Linear) receive ``(t1, t2)`` coordinates, and a TOP-LEVEL
  HP/QHP/POLY kernel gets no nugget at all (the reference quirk,
  ``gpyrn_tpu/ops/linalg.py:83-94``).

Dispatch (the counterpart of ``_use_pallas``): a structure the CUDA
kernel supports goes to :mod:`gpyrn_tpu_torch.ops.cuda_kernels` — the
kernel for a CUDA tensor, at every N and in float32 and float64, and its
plain twin for a CPU tensor.  Any other structure (WhiteNoise, the
derivative kernels, the non-stationary kernels) takes the plain formula
on every device, exactly as in the JAX package.  :func:`kernel_matrix_stack`
is the same dispatch for a list of structures: when the kernel supports
them all, it writes them into one ``(B, N, N)`` tensor without a copy;
:func:`kernel_matrix_rows` does it for W rows of such a list, one
``(W, S, N, N)`` tensor.  While ``torch.export`` traces (the served
posterior predictive), the stack goes through the custom operator
``gpyrn_torch::kernel_matrix_stack`` on either device, so that the
exported program holds B1 as one node.
"""
from __future__ import annotations

import torch

from gpyrn_tpu_torch.ops import cuda_kernels as _ck
from gpyrn_tpu_torch.ops import kernels as _k

__all__ = [
    "TRAIN_NUGGET", "PREDICT_NUGGET", "F32_JITTER_MULT",
    "kernel_matrix", "kernel_matrix_stack", "kernel_matrix_rows",
    "kernel_matrix_plain",
    "kernel_diag",
    "cross_kernel_matrix", "psd_jitter",
    "cholesky_nugget", "chol_solve", "batched_chol", "batched_chol_solve",
]

TRAIN_NUGGET = 1e-6
PREDICT_NUGGET = 1.25e-12

# Margin multiplier of the float32 trace-scaled jitter (the JAX package's
# default): mult=m caps the condition number at 1/(m·eps).  Immaterial in
# float64, where the fixed nuggets dominate the scaled term.
F32_JITTER_MULT = 4.0


def _params(params, t):
    return torch.as_tensor(params, dtype=t.dtype, device=t.device)


def _dense(structure, params, t, nugget, jitter_mult):
    """The CUDA kernel for a CUDA tensor, its twin for a CPU tensor."""
    if t.is_cuda:
        return _ck.kernel_matrix_cuda(structure, params.contiguous(),
                                      t.contiguous(), nugget, jitter_mult)
    return _ck.kernel_matrix_ref(structure, params, t, nugget, jitter_mult)


def _nonstationary(structure, params, t):
    # lag AND coordinate grids: composites can mix non-stationary and
    # stationary children, which evaluate on r
    return _k.evaluate(structure, params, r=t[:, None] - t[None, :],
                       t1=t[:, None], t2=t[None, :])


def _eye(t):
    return torch.eye(t.shape[0], dtype=t.dtype, device=t.device)


def kernel_matrix(structure, params, t, nugget=TRAIN_NUGGET):
    """Dense covariance matrix K(t, t) + max(nugget, 4·eps·tr K)·I for one
    kernel structure (``t`` a 1-D tensor; the result is on its device and
    in its dtype)."""
    params = _params(params, t)
    if _k.is_nonstationary(structure):
        K = _nonstationary(structure, params, t)
        if structure[0] in ("HP", "QHP", "POLY"):
            return K
    elif _ck.cuda_supported(structure):
        return _dense(structure, params, t, nugget, F32_JITTER_MULT)
    else:
        K = _k.evaluate(structure, params, r=t[:, None] - t[None, :])
    eps = torch.finfo(K.dtype).eps
    # maximum, not clamp_min: at a tie the gradient splits as in JAX
    jitter = torch.maximum(F32_JITTER_MULT * eps * torch.trace(K),
                           K.new_full((), nugget))
    return K + jitter * _eye(t)


def kernel_matrix_stack(structures, params, t, nugget=TRAIN_NUGGET,
                        jitter_mult=F32_JITTER_MULT):
    """The ``(B, N, N)`` stack of :func:`kernel_matrix` over a list of
    structures and their parameters, or, with ``jitter_mult=0``, of
    :func:`kernel_matrix_plain` (the exact nugget of the updates-only
    fits).  When the CUDA kernel supports every structure, a CUDA tensor
    goes through the kernel straight into one buffer and a CPU tensor
    through its plain version; a list that holds any other structure is
    built matrix by matrix and stacked."""
    if jitter_mult not in (0.0, F32_JITTER_MULT):
        raise ValueError(f"jitter_mult is F32_JITTER_MULT or 0 (the exact "
                         f"nugget), got {jitter_mult!r}")
    structures = tuple(structures)
    if all(_ck.cuda_supported(s) for s in structures):
        params = [_params(p, t) for p in params]
        if torch.compiler.is_exporting():
            return _ck.kernel_matrix_stack_op(
                structures, [p.contiguous() for p in params], t.contiguous(),
                nugget, jitter_mult)
        if t.is_cuda:
            return _ck.kernel_matrix_stack_cuda(
                structures, [p.contiguous() for p in params], t.contiguous(),
                nugget, jitter_mult)
        return _ck.kernel_matrix_stack_ref(structures, params, t, nugget,
                                           jitter_mult)
    one = kernel_matrix if jitter_mult else kernel_matrix_plain
    return torch.stack([one(s, p, t, nugget)
                        for s, p in zip(structures, params)])


def kernel_matrix_rows(structures, params, t, nugget=TRAIN_NUGGET,
                       jitter_mult=F32_JITTER_MULT):
    """The ``(W, S, N, N)`` lattice of :func:`kernel_matrix_stack` over W
    rows: ``params[s]`` holds the (W, n_params_s) parameters of structure
    s, one row per lattice row.  When the CUDA kernel supports every
    structure, a CUDA tensor goes through it into one buffer, each
    structure checked and its jitters computed once for all rows; anything
    else is built row by row by :func:`kernel_matrix_stack`."""
    if jitter_mult not in (0.0, F32_JITTER_MULT):
        raise ValueError(f"jitter_mult is F32_JITTER_MULT or 0 (the exact "
                         f"nugget), got {jitter_mult!r}")
    structures = tuple(structures)
    params = [_params(p, t) for p in params]
    if t.is_cuda and all(_ck.cuda_supported(s) for s in structures):
        return _ck.kernel_matrix_rows_cuda(
            structures, [p.contiguous() for p in params], t.contiguous(),
            nugget, jitter_mult)
    return torch.stack([
        kernel_matrix_stack(structures, [p[w] for p in params], t, nugget,
                            jitter_mult)
        for w in range(params[0].shape[0])])


def kernel_matrix_plain(structure, params, t, nugget=TRAIN_NUGGET):
    """Dense K(t, t) with the FIXED reference nugget only (no float32
    trace scaling), for the updates-only sweeps."""
    params = _params(params, t)
    if _k.is_nonstationary(structure):
        K = _nonstationary(structure, params, t)
        if structure[0] in ("HP", "QHP", "POLY"):
            return K
        return K + nugget * _eye(t)
    if _ck.cuda_supported(structure):
        return _dense(structure, params, t, nugget, 0.0)
    K = _k.evaluate(structure, params, r=t[:, None] - t[None, :])
    return K + nugget * _eye(t)


def psd_jitter(S):
    """S + 4·eps·tr(S)·I per matrix of a (B, N, N) batch: a no-op at
    float64 scales, the float32 margin for posterior Choleskys."""
    eps = torch.finfo(S.dtype).eps
    tr = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return S + F32_JITTER_MULT * eps * tr * torch.eye(
        S.shape[-1], dtype=S.dtype, device=S.device)


def kernel_diag(structure, params, t, nugget=TRAIN_NUGGET):
    """diag(K(t, t)) + the jitter ``kernel_matrix`` would add, without the
    N×N matrix (O(N) memory: prediction variances)."""
    params = _params(params, t)
    if _k.is_nonstationary(structure):
        d = _k.evaluate(structure, params, r=torch.zeros_like(t), t1=t, t2=t)
        d = torch.broadcast_to(d, t.shape)
        if structure[0] in ("HP", "QHP", "POLY"):
            return d            # reference quirk: no nugget
    else:
        d = torch.broadcast_to(
            _k.evaluate(structure, params, r=torch.zeros_like(t)), t.shape)
    eps = torch.finfo(d.dtype).eps
    # maximum, not clamp_min: at a tie the gradient splits as in JAX
    jitter = torch.maximum(F32_JITTER_MULT * eps * torch.sum(d),
                           d.new_full((), nugget))
    return d + jitter


def cross_kernel_matrix(structure, params, t_star, t):
    """Cross-covariance K(t*, t) (no nugget)."""
    t_star = torch.atleast_1d(t_star)
    params = _params(params, t)
    r = t_star[:, None] - t[None, :]
    if _k.is_nonstationary(structure):
        return _k.evaluate(structure, params, r=r,
                           t1=t_star[:, None], t2=t[None, :])
    return _k.evaluate(structure, params, r=r)


def cholesky_nugget(K):
    """Lower Cholesky factor of K (the reference's ``_cholNugget`` is a
    plain Cholesky with a vestigial name)."""
    return torch.linalg.cholesky(K)


def _solve_columns(L, b):
    """Solve (L Lᵀ) x = b for one lower factor; b (N,) or (N, k)."""
    if b.ndim == 1:
        return torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.cholesky_solve(b, L)


def chol_solve(L, b):
    """Solve K x = b given the lower Cholesky factor L of K; b (N,) or
    (N, k)."""
    return _solve_columns(L, b)


def batched_chol(K):
    """Lower Cholesky factors of a (B, N, N) batch."""
    return torch.linalg.cholesky(K)


def batched_chol_solve(L, B):
    """:func:`chol_solve` over a leading batch axis: L (B, N, N), B (B, N)
    or (B, N, k).  Above ``models/gprn.py::BATCHED_SOLVE_MAX_N`` each
    matrix is solved alone, as the engine's solves are (MAGMA's batched
    solve fails there on the card; on the CPU the loop gives the same
    values)."""
    from gpyrn_tpu_torch.models import gprn   # gprn imports this module
    if L.shape[-1] > gprn.BATCHED_SOLVE_MAX_N and L.shape[0] > 1:
        return torch.stack([_solve_columns(l, b) for l, b in zip(L, B)])
    if B.ndim == L.ndim - 1:
        return torch.cholesky_solve(B[..., None], L)[..., 0]
    return torch.cholesky_solve(B, L)
