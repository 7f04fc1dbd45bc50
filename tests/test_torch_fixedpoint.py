"""The port's Anderson fixed-point solver against the JAX package's.

Both are host code on numpy float64 with the same arithmetic, so on one
synthetic contractive map with a merit they visit the same iterates and
return the same state, merit and ``info`` (1e-12; the counts equal), with
and without ``clamp``, and with the stall rule on a merit that carries a
noise floor."""
import numpy as np
import pytest

from gpyrn_tpu.ops.fixedpoint import anderson_fixed_point as anderson_jax
from gpyrn_tpu_torch.ops.fixedpoint import anderson_fixed_point

D = 12


def _map(noise=0.0):
    """x ← A x + b with ρ(A) = 0.95 and a mild nonlinearity; the merit is
    minus the squared distance to the fixed point of the linear part,
    with an optional deterministic wobble (a rounding floor)."""
    rng = np.random.default_rng(4)
    Q, _ = np.linalg.qr(rng.standard_normal((D, D)))
    A = Q @ np.diag(np.linspace(0.2, 0.95, D)) @ Q.T
    b = rng.standard_normal(D)
    x_star = np.linalg.solve(np.eye(D) - A, b)
    calls = []

    def F(x):
        calls.append(np.array(x))
        out = A @ x + b + 1e-3 * np.tanh(x - x_star) ** 3
        merit = -float(np.sum((out - x_star) ** 2))
        if noise:
            merit += noise * np.sin(37.0 * len(calls))
        return out, merit

    return F, calls


def _clamp(x):
    out = x.copy()
    out[D // 2:] = np.maximum(out[D // 2:], -0.25)
    return out


CASES = {
    "plain": (0.0, dict(rel_tol=1e-12, max_evals=60)),
    "clamp": (0.0, dict(rel_tol=1e-12, max_evals=60, clamp=_clamp)),
    "short-memory": (0.0, dict(rel_tol=1e-10, max_evals=40, memory=3)),
    "stall": (1e-6, dict(rel_tol=0.0, max_evals=200, stall_patience=4,
                         stall_tol=1e-3)),
    "stall-clamp": (1e-6, dict(rel_tol=0.0, max_evals=200, clamp=_clamp,
                               stall_patience=3, stall_tol=1e-4)),
}


@pytest.mark.parametrize("case", CASES)
def test_same_iterates_as_the_jax_package(case):
    noise, kw = CASES[case]
    x0 = np.random.default_rng(5).standard_normal(D)
    F_j, calls_j = _map(noise)
    F_t, calls_t = _map(noise)
    x_j, e_j, info_j = anderson_jax(F_j, x0, **kw)
    x_t, e_t, info_t = anderson_fixed_point(F_t, x0, **kw)
    assert len(calls_t) == len(calls_j) == info_t["evals"]
    np.testing.assert_allclose(np.array(calls_t), np.array(calls_j),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-12)
    assert abs(e_t - e_j) <= 1e-12
    assert set(info_t) == set(info_j)
    for key in ("evals", "rejects", "stalled"):
        assert info_t[key] == info_j[key]
    for key in ("rel", "res"):
        assert abs(info_t[key] - info_j[key]) <= 1e-12
    if "stall_patience" in kw:
        assert info_t["stalled"] and info_t["evals"] < kw["max_evals"]
    else:
        assert not info_t["stalled"]
    if case == "plain":
        assert info_t["evals"] < kw["max_evals"]      # the calm rule fired


def test_port_copy_imports_no_jax_package():
    import re
    import gpyrn_tpu_torch.ops.fixedpoint as fp
    with open(fp.__file__) as f:
        src = f.read()
    assert not re.search(r"^\s*(import|from) (jax|gpyrn_tpu)\b", src, re.M)
