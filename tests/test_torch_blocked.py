"""Blocked Cholesky / diag(A⁻¹) of gpyrn_tpu_torch against gpyrn_tpu.

A batch of SPD matrices, made with numpy from a seed, goes through both
packages in float64 with ``block=32`` so that N ∈ {37, 130} spans several
blocks and a padded tail; factors and diagonals agree to 1e-10."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gpyrn_tpu.ops import blocked as jb
from gpyrn_tpu_torch.ops import blocked as tb

TOL = 1e-10


def _spd_batch(N, B=3, seed=0):
    rng = np.random.default_rng(seed + N)
    t = np.sort(rng.uniform(0, 30, N))
    r = t[:, None] - t[None, :]
    out = []
    for b in range(B):
        K = (1.0 + b) * np.exp(-0.5 * r ** 2 / (2.0 + b) ** 2)
        out.append(K + np.diag(rng.uniform(0.05, 0.5, N)))
    return np.stack(out)


@pytest.mark.parametrize("N", [37, 130])
def test_chol_diag_ainv_matches_jax(N):
    A = _spd_batch(N)
    Lj, dj = jb.blocked_chol_diag_ainv(jnp.asarray(A), block=32)
    Lt, dt = tb.blocked_chol_diag_ainv(torch.tensor(A), block=32)
    assert Lt.shape == (3, N, N) and dt.shape == (3, N)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=TOL,
                               atol=TOL)
    # and the quantities themselves: L Lᵀ = A, diag(A⁻¹)
    np.testing.assert_allclose((Lt @ Lt.transpose(1, 2)).numpy(), A,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        dt.numpy(), np.diagonal(np.linalg.inv(A), axis1=1, axis2=2),
        rtol=1e-9)


@pytest.mark.parametrize("N", [37, 130])
def test_blocked_cholesky_parts_match_jax(N):
    A = _spd_batch(N, seed=5)
    Lj, Linv_j = jb.blocked_cholesky(jnp.asarray(A), block=32)
    Lt, Linv_t = tb.blocked_cholesky(torch.tensor(A), block=32)
    assert Lt.shape == tuple(Lj.shape) and Linv_t.shape == tuple(Linv_j.shape)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(Linv_t.numpy(), np.asarray(Linv_j), rtol=TOL,
                               atol=TOL)
    # diag_Ainv without the precomputed block inverses
    np.testing.assert_allclose(
        tb.diag_Ainv(Lt, block=32, n_valid=N).numpy(),
        np.asarray(jb.diag_Ainv(Lj, block=32, n_valid=N)), rtol=TOL,
        atol=TOL)


def test_failed_factorization_gives_nan_without_raising():
    A = _spd_batch(40, B=2)
    A[1, 5, 5] = -1.0                          # batch entry 1 is not SPD
    L, d = tb.blocked_chol_diag_ainv(torch.tensor(A), block=32)
    assert torch.isfinite(L[0]).all() and torch.isfinite(d[0]).all()
    assert torch.isnan(d[1]).any()
    Lj = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    Lt = tb.cholesky_nan(torch.tensor(A)).numpy()
    np.testing.assert_array_equal(np.isnan(Lt), np.isnan(Lj))
    np.testing.assert_allclose(Lt[0], Lj[0], rtol=TOL, atol=TOL)
