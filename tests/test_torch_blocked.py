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


def _max_rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("N", [37, 600, 1000])
def test_inverse_route(N, dtype):
    """``blocked_chol_inverse`` at the engine's block (N = 37 one padded
    strip, 600 and 1000 two, padded): X is L⁻¹, Xᵀ(X b) is
    ``torch.cholesky_solve``'s A⁻¹b (1e-10 of max |A⁻¹b| in float64, 1e-4
    in float32), and the lean engines' ``blocked_chol_diag_ainv`` gives
    what it gave, ``blocked_cholesky``'s factor and the same diag(A⁻¹)."""
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    A = torch.tensor(_spd_batch(N, B=2, seed=9), dtype=dtype)
    logdiag, X, d = tb.blocked_chol_inverse(A)
    L, d_lean = tb.blocked_chol_diag_ainv(A)
    assert X.shape == (2, N, N) and d.shape == logdiag.shape == (2, N)
    assert X.dtype == d.dtype == logdiag.dtype == dtype
    # the lean call: the padded factor sliced, the same diagonal, no X
    assert torch.equal(L, tb.blocked_cholesky(A)[0][:, :N, :N])
    assert torch.equal(d_lean, d)
    assert torch.equal(logdiag,
                       torch.log(torch.diagonal(L, dim1=-2, dim2=-1)))
    # X = L⁻¹, against the inverse of the same factor in float64
    L64 = L.double()
    eye = torch.eye(N, dtype=torch.float64).expand(2, N, N)
    inv = torch.linalg.solve_triangular(L64, eye, upper=False)
    assert _max_rel(X.double(), inv) <= tol
    assert torch.equal(X, torch.tril(X))
    # A⁻¹b through X, and d = diag(A⁻¹) = column norms² of X
    b = torch.tensor(np.random.default_rng(N).standard_normal((2, N, 1)),
                     dtype=dtype)
    got = X.transpose(-2, -1) @ (X @ b)
    assert _max_rel(got, torch.cholesky_solve(b, L)) <= tol
    assert _max_rel(d, torch.sum(X * X, dim=-2)) <= tol


@pytest.mark.parametrize("N", [37, 600])
def test_tri_inverse_of_an_unpadded_factor(N, monkeypatch):
    """``tri_inverse`` of a factor of any N (padded inside, sliced back):
    L⁻¹ to 1e-10, by T×T triangular solves alone (T ≤ the block)."""
    A = torch.tensor(_spd_batch(N, B=2, seed=4))
    L = tb.cholesky_nan(A)
    calls = []
    real = torch.linalg.solve_triangular

    def spy(M, *a, **kw):
        calls.append(M.shape[-1])
        return real(M, *a, **kw)

    monkeypatch.setattr(torch.linalg, "solve_triangular", spy)
    X = tb.tri_inverse(L)
    monkeypatch.undo()
    assert X.shape == (2, N, N)
    eye = torch.eye(N, dtype=torch.float64).expand(2, N, N)
    ref = torch.linalg.solve_triangular(L, eye, upper=False)
    assert _max_rel(X, ref) <= 1e-10
    assert calls and max(calls) <= tb.DEFAULT_BLOCK
    assert (N < tb.DEFAULT_BLOCK) or max(calls) < N
