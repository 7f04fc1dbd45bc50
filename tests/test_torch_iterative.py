"""The matrix-free kernel linear algebra of gpyrn_tpu_torch
(``ops/iterative.py``) against gpyrn_tpu.ops.iterative, in float64 on
small kernels made from a seed:

* ``kernel_matvec`` with a ragged last row chunk, one and several
  right-hand sides, a stationary and a non-stationary kernel: 1e-13 of
  max |y|; and with ``r0`` / ``n_rows`` (one rank's slab of rows), those
  rows of the JAX package's product, at the same tolerance;
* ``cg_solve`` plain, Jacobi, warm-started, with an SPD apply, with
  residual replacement and the achieved relres, and its breakdown guards
  (a zero right-hand side, an indefinite operator): the same iteration
  counts, x within 1e-7 of max |x| (the solves' own accuracy: CG
  amplifies the two runtimes' rounding as its residual nears the
  tolerance; the tolerances are set where no count sits on its edge);
* ``kernel_diag``, ``_kernel_column``, ``pivoted_cholesky`` (stationary,
  non-stationary, and a rank asked past exhaustion: zero columns),
  ``woodbury_apply``, ``split_precond``: 1e-12;
* ``lanczos``, ``lanczos_vectors`` (with a Krylov space that runs out),
  ``msqrt_apply`` and ``slq_logdet`` fed the JAX package's Rademacher
  probes: 1e-8 (the last steps before the space runs out carry the
  rounding of the earlier ones);
* ``cg_refined`` with a float64 residual matvec: both reach the
  tolerance, x within 1e-8 of max |x|."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gpyrn_tpu.ops import iterative as ji
from gpyrn_tpu_torch.ops import iterative as ti

torch.set_num_threads(1)

N = 37
QP = (("QP",), np.array([1.1, 20.0, 13.0, 0.6]))
LIN = (("LIN",), np.array([3.0]))
MATVEC_TOL = 1e-13
CG_TOL = 1e-7
ALG_TOL = 1e-12
LANCZOS_TOL = 1e-8
REFINED_TOL = 1e-8


def _t64(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    t = np.sort(rng.uniform(0, 30, N))
    v = rng.standard_normal((N, 3))
    return t, v


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.max(np.abs(want)), 1e-300)
    assert np.max(np.abs(got - want)) <= tol * scale


def _matvecs(t, kernel, nugget, chunk=8):
    s, pars = kernel
    return (lambda x: ji.kernel_matvec(s, pars, t, x, nugget=nugget,
                                       chunk=chunk),
            lambda x: ti.kernel_matvec(s, _t64(pars), _t64(t), x,
                                       nugget=nugget, chunk=chunk))


@pytest.mark.parametrize("kernel", [QP, LIN], ids=["QP", "LIN"])
@pytest.mark.parametrize("cols", [None, 3], ids=["vector", "matrix"])
@pytest.mark.parametrize("chunk", [8, 64], ids=["ragged", "one-chunk"])
def test_kernel_matvec(data, kernel, cols, chunk):
    t, v = data
    v = v[:, 0] if cols is None else v
    mj, mt = _matvecs(t, kernel, 0.3, chunk)
    _close(mt(_t64(v)), mj(v), MATVEC_TOL)


@pytest.fixture(scope="module")
def jax_products(data):
    """The JAX package's whole product per kernel, computed once."""
    t, v = data
    return {name: np.asarray(ji.kernel_matvec(s, pars, t, v, nugget=0.3,
                                              chunk=8))
            for name, (s, pars) in (("QP", QP), ("LIN", LIN))}


@pytest.mark.parametrize("kernel", ["QP", "LIN"])
@pytest.mark.parametrize("r0,n_rows", [(0, 10), (12, 25), (30, None)],
                         ids=["first", "inner", "last"])
def test_kernel_matvec_rows(data, jax_products, kernel, r0, n_rows):
    """Rows [r0, r0 + n_rows) of the port's product, a stationary and a
    non-stationary kernel, against those rows of the JAX package's."""
    t, v = data
    s, pars = {"QP": QP, "LIN": LIN}[kernel]
    end = N if n_rows is None else r0 + n_rows
    got = ti.kernel_matvec(s, _t64(pars), _t64(t), _t64(v), nugget=0.3,
                           chunk=8, r0=r0, n_rows=n_rows)
    _close(got, jax_products[kernel][r0:end], MATVEC_TOL)


# cg_solve settings: (keywords, the nugget of K + nugget·I).  A nugget of
# 1 keeps the system well conditioned.
CG_CASES = {
    "plain": ({"tol": 1e-6, "maxiter": 200}, 1.0),
    "jacobi": ({"tol": 1e-6, "maxiter": 200, "jacobi": True}, 1.0),
    "x0": ({"tol": 1e-6, "maxiter": 200, "x0": True}, 1.0),
    "split": ({"tol": 1e-8, "maxiter": 200, "split": True}, 0.5),
    "refresh": ({"tol": 1e-6, "maxiter": 200, "refresh_every": 3,
                 "return_relres": True}, 1.0),
    "maxiter": ({"tol": 1e-14, "maxiter": 4, "return_relres": True}, 1.0),
}


def _cg_keywords(case, t, v, packages):
    kw, nugget = CG_CASES[case]
    kw = dict(kw)
    out = {}
    for pkg in packages:
        k = {key: val for key, val in kw.items()
             if key not in ("jacobi", "x0", "split")}
        if kw.get("jacobi"):
            diag = 1.1 ** 2 + nugget + np.linspace(0.0, 0.5, N)
            k["precond_diag"] = jnp.asarray(diag) if pkg == "jax" \
                else _t64(diag)
        if kw.get("x0"):
            x0 = 0.1 * v
            k["x0"] = x0 if pkg == "jax" else _t64(x0)
        if kw.get("split"):
            U, _ = (ji if pkg == "jax" else ti).pivoted_cholesky(
                QP[0], QP[1] if pkg == "jax" else _t64(QP[1]),
                t if pkg == "jax" else _t64(t), 12)
            h = np.full(N, nugget)
            k["precond_apply"] = (ji if pkg == "jax" else ti).split_precond(
                U, jnp.asarray(h) if pkg == "jax" else _t64(h))
        out[pkg] = k
    return out, nugget


@pytest.mark.parametrize("case", list(CG_CASES))
def test_cg_solve(data, case):
    t, v = data
    kws, nugget = _cg_keywords(case, t, v, ("jax", "port"))
    mj, mt = _matvecs(t, QP, nugget)
    got = ti.cg_solve(mt, _t64(v), **kws["port"])
    want = ji.cg_solve(mj, v, **kws["jax"])
    assert got[1] == int(want[1])
    _close(got[0], want[0], CG_TOL)
    if len(want) == 3:
        assert got[2].ndim == 0
        np.testing.assert_allclose(float(got[2]), float(want[2]),
                                   rtol=1e-3, atol=1e-15)


def test_cg_breakdown_guards(data):
    """A zero right-hand side keeps x = 0 while the other columns solve;
    an indefinite operator freezes every column and runs to maxiter."""
    t, v = data
    b = v.copy()
    b[:, 1] = 0.0
    mj, mt = _matvecs(t, QP, 1.0)
    got = ti.cg_solve(mt, _t64(b), tol=1e-6, maxiter=100)
    want = ji.cg_solve(mj, b, tol=1e-6, maxiter=100)
    assert got[1] == int(want[1]) < 100
    assert torch.all(got[0][:, 1] == 0)
    _close(got[0], want[0], CG_TOL)
    got = ti.cg_solve(lambda x: -x, _t64(v), tol=1e-8, maxiter=7)
    want = ji.cg_solve(lambda x: -x, v, tol=1e-8, maxiter=7)
    assert got[1] == int(want[1]) == 7
    assert torch.all(got[0] == 0)
    _close(got[0], want[0], CG_TOL)


@pytest.mark.parametrize("kernel", [QP, LIN], ids=["QP", "LIN"])
def test_kernel_diag_and_column(data, kernel):
    t, _ = data
    s, pars = kernel
    _close(ti.kernel_diag(s, _t64(pars), _t64(t), 0.2),
           ji.kernel_diag(s, pars, t, 0.2), ALG_TOL)
    j = 11
    got = ti._kernel_column(s, _t64(pars), _t64(t), _t64(t[j]),
                            torch.tensor(j), 0.2)
    want = ji._kernel_column(s, jnp.asarray(pars), jnp.asarray(t),
                             jnp.asarray(t[j]), j, 0.2)
    _close(got, want, ALG_TOL)


@pytest.mark.parametrize("kernel,rank", [
    (QP, 8), ((("SE",), np.array([1.0, 6.0])), 12),
    # rank one (c² = 4: the first pivot leaves an exact 0), asked for 5
    ((("C",), np.array([2.0])), 5), (LIN, 1)],
    ids=["QP", "SE", "exhausted", "LIN"])
def test_pivoted_cholesky(data, kernel, rank):
    t, _ = data
    s, pars = kernel
    U, d = ti.pivoted_cholesky(s, _t64(pars), _t64(t), rank, nugget=0.0)
    Uj, dj = ji.pivoted_cholesky(s, pars, t, rank, nugget=0.0)
    _close(U, Uj, ALG_TOL)
    # the remaining diagonal against the kernel's own scale, k(t, t)
    k_diag = np.max(np.abs(np.asarray(ji.kernel_diag(s, pars, t))))
    assert np.max(np.abs(d.numpy() - np.asarray(dj))) <= ALG_TOL * k_diag
    if s == ("C",):
        assert torch.all(U[:, 1:] == 0) and torch.all(d == 0)


@pytest.mark.parametrize("cols", [None, 3], ids=["vector", "matrix"])
def test_woodbury_and_split_precond(data, cols):
    t, v = data
    r = v[:, 0] if cols is None else v
    Uj, _ = ji.pivoted_cholesky(QP[0], QP[1], t, 10)
    U = _t64(Uj)
    a = np.linspace(0.2, 0.7, N)
    _close(ti.woodbury_apply(U, _t64(a), _t64(r)),
           ji.woodbury_apply(Uj, jnp.asarray(a), r), ALG_TOL)
    _close(ti.split_precond(U, _t64(a))(_t64(r)),
           ji.split_precond(Uj, jnp.asarray(a))(jnp.asarray(r)), ALG_TOL)


@pytest.mark.parametrize("n_steps", [12, 45], ids=["partial", "exhausted"])
def test_lanczos_and_msqrt(data, n_steps):
    t, v = data
    mj, mt = _matvecs(t, QP, 0.5)
    got = ti.lanczos_vectors(mt, _t64(v[:, 0]), n_steps)
    want = ji.lanczos_vectors(mj, jnp.asarray(v[:, 0]), n_steps)
    for a, b in zip(got, want):
        _close(a, b, LANCZOS_TOL)
    if n_steps > N:
        assert torch.all(got[0][N:] == 0) and torch.all(got[1][N:] == 1)
    got = ti.lanczos(mt, _t64(v[:, 1]), min(n_steps, 12))
    want = ji.lanczos(mj, jnp.asarray(v[:, 1]), min(n_steps, 12))
    for a, b in zip(got, want):
        _close(a, b, LANCZOS_TOL)
    _close(ti.msqrt_apply(mt, _t64(v[:, 2]), n_steps),
           ji.msqrt_apply(mj, jnp.asarray(v[:, 2]), n_steps), LANCZOS_TOL)


def test_slq_logdet_on_the_jax_probes(data):
    t, _ = data
    mj, mt = _matvecs(t, QP, 0.5)
    key = jax.random.PRNGKey(3)
    probes = np.array(jax.random.rademacher(key, (5, N),
                                            dtype=jnp.float64))
    want = ji.slq_logdet(mj, N, n_probes=5, n_steps=15, key=key,
                         dtype=jnp.float64)
    got = ti.slq_logdet(mt, N, n_probes=5, n_steps=15,
                        dtype=torch.float64, device="cpu", probes=probes)
    np.testing.assert_allclose(float(got), float(want), rtol=LANCZOS_TOL)
    # the port's own draws: Rademacher probes from a seeded generator
    a = ti.slq_logdet(mt, N, n_probes=5, n_steps=15, seed=1,
                      dtype=torch.float64, device="cpu")
    b = ti.slq_logdet(mt, N, n_probes=5, n_steps=15, seed=1,
                      dtype=torch.float64, device="cpu")
    assert float(a) == float(b) and np.isfinite(float(a))


def test_cg_refined_with_a_float64_residual(data):
    t, v = data
    s, pars = QP
    b = v[:, 0]
    t32, p32 = t.astype(np.float32), pars.astype(np.float32)

    def mv32_j(x):
        return ji.kernel_matvec(s, p32, t32, x, nugget=0.5)

    def res_j(x):
        return np.asarray(ji.kernel_matvec(s, pars, t, jnp.asarray(x),
                                           nugget=0.5))

    def mv32_t(x):
        return ti.kernel_matvec(s, torch.tensor(p32), torch.tensor(t32), x,
                                nugget=0.5)

    def res_t(x):
        return ti.kernel_matvec(s, _t64(pars), _t64(t), x, nugget=0.5)

    xj, rel_j = ji.cg_refined(mv32_j, res_j, b, n_refine=4, tol=1e-10,
                              inner_tol=1e-4, maxiter=100)
    xt, rel_t = ti.cg_refined(mv32_t, res_t, _t64(b), n_refine=4,
                              tol=1e-10, inner_tol=1e-4, maxiter=100)
    assert xt.dtype == torch.float64
    assert rel_t < 1e-10 and rel_j < 1e-10
    _close(xt, xj, REFINED_TOL)
