"""The θ-batched engine of gpyrn_tpu_torch against gpyrn_tpu.

Two small models (q=1 and q=2, p=2, N ≤ 24, constant and linear means)
are built in the JAX package and carried into the port on the CPU.  Five
parameter rows, log-normally perturbed around the model's values (row 0
unperturbed), the last with a NaN length scale, go through:

* ``Engine.elbo_fit_batch`` against the JAX package's
  ``vmap(elbo_fit)`` and against the port's own single-θ ``elbo_fit``
  of each row: ELBO relative 1e-9, state 1e-8 of max |state|, equal
  ``n_iter`` and ``converged``; the rows stop at different sweeps, and
  the NaN row sweeps on to ``max_iter``, unconverged, as under JAX;
* ``Engine.elbo_fixed_batch`` against ``vmap(elbo_fixed.static)`` and the
  port's single-θ ``elbo_fixed``, from one shared state and from one
  state per row;
* ``init_mu_var`` over the rows against ``vmap(init_mu_var)``.

The JAX side compiles three functions per model.  Beside them, a batched
fit at N = 600 (two strips of the blocked factorization) with the
library's solvers spied on: the sweep applies every inverse as a product
with a triangular inverse."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
from gpyrn_tpu_torch.convert import inference_from_jax
from gpyrn_tpu_torch.ops import linalg as tlin

torch.set_num_threads(1)

ELBO_RTOL = 1e-9
STATE_TOL = 1e-8
MAX_ITER = 60
SWEEPS = 4
ROWS = 5


def _jax_model(q):
    rng = np.random.default_rng(30 + q)
    N = 24 if q == 1 else 20
    t = np.sort(rng.uniform(0, 40, N))
    data = []
    for i in range(2):
        data += [np.sin(2 * np.pi * t / (9 + 4 * i)) + 0.3 * i
                 + 0.1 * rng.standard_normal(N), np.full(N, 0.1)]
    g = gj.inference(q, t, *data)
    cf, mf = gj.covfunc, gj.meanfunc
    nodes = [cf.Periodic(1.0, 9.0, 0.6), cf.Matern52(1.0, 5.0)][:q]
    weights = [cf.SquaredExponential(1.0 + 0.05 * k, 8.0 + k)
               for k in range(2 * q)]
    g.set_components(nodes, weights, [mf.Constant(0.1), mf.Linear(0.01, 0.0)],
                     [0.1, 0.12])
    return g


def _thetas(g):
    theta0 = g.get_parameters(include_frozen=True)
    rng = np.random.default_rng(10)
    out = theta0[None, :] * np.exp(
        0.2 * rng.standard_normal((ROWS, theta0.size)))
    out[0] = theta0
    out[-1, 1] = np.nan             # an ELBO that is never finite
    return out


def _state_err(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(b))))


@pytest.fixture(scope="module", params=[1, 2], ids=["q1", "q2"])
def case(request):
    q = request.param
    g = _jax_model(q)
    port = inference_from_jax(g, device="cpu")
    thetas = _thetas(g)
    eng, t = g.engine, np.asarray(g.time, dtype=float)

    def init(th):
        return eng.init_mu_var(th, g.y)

    def fit(th):
        mu0, var0 = init(th)
        return eng.elbo_fit(th, t, g.y, g.yerr2, mu0, var0, MAX_ITER)

    def fixed(th, mu0, var0):
        return eng.elbo_fixed.static(th, t, g.y, g.yerr2, mu0, var0, SWEEPS)

    th = jnp.asarray(thetas)
    mu0, var0 = jax.jit(jax.vmap(init))(th)
    jfit = jax.jit(jax.vmap(fit))(th)
    jfixed = jax.jit(jax.vmap(fixed, in_axes=(0, None, None)))(
        th[:-1], mu0[0], var0[0])
    jax_out = {"init": (np.asarray(mu0), np.asarray(var0)),
               "fit": [np.asarray(a) for a in jfit[:5]],
               "fixed": np.asarray(jfixed)}

    te, data = port.engine, port._data()
    T = port._tensor(thetas)
    M0, V0 = te.init_mu_var(T, data[1])
    port_out = {"init": (M0.numpy(), V0.numpy()),
                "fit": [a.numpy() for a in te.elbo_fit_batch(
                    T, *data, M0, V0, MAX_ITER)],
                "fixed": te.elbo_fixed_batch(T[:-1], *data, M0[0], V0[0],
                                             SWEEPS).numpy()}
    return {"q": q, "port": port, "T": T, "M0": M0, "V0": V0,
            "jax": jax_out, "out": port_out}


def _assert_rows_close(elbo, mu, var, elbo_ref, mu_ref, var_ref):
    """Row by row: the same non-finite rows, the finite ones within the
    tolerances."""
    for w in range(len(elbo_ref)):
        if not np.isfinite(elbo_ref[w]):
            assert not np.isfinite(elbo[w]), w
            continue
        assert abs(elbo[w] - elbo_ref[w]) <= ELBO_RTOL * abs(elbo_ref[w]), w
        assert _state_err(mu[w], mu_ref[w]) <= STATE_TOL, w
        assert _state_err(var[w], var_ref[w]) <= STATE_TOL, w


def test_init_mu_var_over_rows_matches_jax(case):
    (mu, var), (mu_j, var_j) = case["out"]["init"], case["jax"]["init"]
    assert mu.shape == (ROWS, case["port"].d)
    np.testing.assert_allclose(mu, mu_j, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(var, var_j, rtol=1e-12, atol=1e-14)


def test_fit_batch_matches_jax_vmap(case):
    elbo, mu, var, n_iter, conv = case["out"]["fit"]
    elbo_j, mu_j, var_j, n_iter_j, conv_j = case["jax"]["fit"]
    assert elbo.shape == (ROWS,) and mu.shape == (ROWS, case["port"].d)
    np.testing.assert_array_equal(n_iter, n_iter_j)
    np.testing.assert_array_equal(conv, conv_j)
    _assert_rows_close(elbo, mu, var, elbo_j, mu_j, var_j)


def test_rows_stop_at_different_sweeps(case):
    """Rows stop at several counts, each under its own rule (the rest run
    to ``max_iter``); the NaN row runs every sweep and never converges."""
    _, _, _, n_iter, conv = case["out"]["fit"]
    assert len(set(n_iter[conv].tolist())) > 1
    assert n_iter[conv].max() < MAX_ITER
    assert (n_iter[~conv] == MAX_ITER).all()
    assert n_iter[-1] == MAX_ITER and not conv[-1]


def test_fit_batch_matches_single_fits(case):
    port, T, M0, V0 = case["port"], case["T"], case["M0"], case["V0"]
    elbo, mu, var, n_iter, conv = case["out"]["fit"]
    single = [port.engine.elbo_fit(T[w], *port._data(), M0[w], V0[w],
                                   MAX_ITER) for w in range(ROWS)]
    assert [s[3] for s in single] == n_iter.tolist()
    assert [s[4] for s in single] == conv.tolist()
    _assert_rows_close(elbo, mu, var, [float(s[0]) for s in single],
                       [s[1].numpy() for s in single],
                       [s[2].numpy() for s in single])


def test_fixed_batch_matches_jax_and_single(case):
    port, T, M0, V0 = case["port"], case["T"], case["M0"], case["V0"]
    got = case["out"]["fixed"]
    np.testing.assert_allclose(got, case["jax"]["fixed"], rtol=ELBO_RTOL)
    single = [float(port.engine.elbo_fixed(T[w], *port._data(), M0[0], V0[0],
                                           SWEEPS)) for w in range(ROWS - 1)]
    np.testing.assert_allclose(got, single, rtol=ELBO_RTOL)


def test_fixed_batch_takes_a_state_per_row(case):
    port, T, M0, V0 = case["port"], case["T"], case["M0"], case["V0"]
    got = port.engine.elbo_fixed_batch(T[:-1], *port._data(), M0[:-1],
                                       V0[:-1], SWEEPS).numpy()
    single = [float(port.engine.elbo_fixed(T[w], *port._data(), M0[w], V0[w],
                                           SWEEPS)) for w in range(ROWS - 1)]
    np.testing.assert_allclose(got, single, rtol=ELBO_RTOL)


def test_one_stack_call_builds_every_row(case, monkeypatch):
    """The batch's prior lattice is one ``kernel_matrix_rows`` call over
    the q node and q·p weight structures, each with its parameters of all
    W rows (on the card: one buffer)."""
    from gpyrn_tpu_torch.models import gprn as tg
    calls = []
    real = tlin.kernel_matrix_rows

    def counting(structures, params, *a, **kw):
        calls.append((len(structures), {tuple(p.shape[:-1]) for p in params}))
        return real(structures, params, *a, **kw)

    monkeypatch.setattr(tg, "kernel_matrix_rows", counting)
    port, T = case["port"], case["T"]
    prepared = port.engine._prepare(T, *port._data())
    q = case["q"]
    assert calls == [(q * 3, {(ROWS,)})]
    assert prepared[0].shape == (ROWS, q, port.N, port.N)
    assert prepared[1].shape == (ROWS, 2 * q, port.N, port.N)


@pytest.mark.parametrize("q", [1, 2], ids=["q1", "q2"])
def test_sweep_solves_by_products_alone(q, monkeypatch):
    """``elbo_fit_batch`` of two rows at N = 600, q = 1 and q = 2 (p = 2),
    with ``torch.cholesky_solve`` and ``torch.linalg.solve_triangular``
    spied on: ``_prepare`` and ``_sweep`` call no ``cholesky_solve``, and
    ``solve_triangular`` only on the blocked factorization's diagonal
    blocks (at most ``DEFAULT_BLOCK`` wide, narrower than N), never on a
    whole N×N factor (torch sends a batch of more than 8 such to MAGMA
    above 512); ``gprn.sweep.inverse_solves`` rises by 3 a sweep at
    q = 1 (node, weight, prior) and by 4 at q = 2 (and the cross trace)."""
    from gpyrn_tpu_torch import covfunc
    from gpyrn_tpu_torch.models.gprn import (make_engine, pack_parameters,
                                             spec_from_components)
    from gpyrn_tpu_torch.ops.blocked import DEFAULT_BLOCK
    from gpyrn_tpu_torch.utils import profiling
    N = 600
    rng = np.random.default_rng(60 + q)
    t = np.sort(rng.uniform(0, 100, N))
    y = np.stack([np.sin(2 * np.pi * t / P) + 0.1 * rng.standard_normal(N)
                  for P in (20, 30)])
    nodes = [covfunc.QuasiPeriodic(1.0, 30.0, 27.0, 0.7),
             covfunc.Matern52(1.0, 5.0)][:q]
    weights = [covfunc.SquaredExponential(1.0 + 0.1 * k, 30.0)
               for k in range(2 * q)]
    eng = make_engine(spec_from_components(nodes, weights, [None] * 2, N))
    theta0 = pack_parameters(nodes, weights, [None] * 2, [0.1] * 2)
    theta = torch.as_tensor(theta0[None] * np.exp(
        0.05 * rng.standard_normal((2, theta0.size))))
    data = (torch.as_tensor(t), torch.as_tensor(y),
            torch.full((2, N), 0.01, dtype=torch.float64))
    mu0, var0 = eng.init_mu_var(theta, data[1])

    calls = {"cholesky_solve": [], "solve_triangular": []}
    real_cs, real_st = torch.cholesky_solve, torch.linalg.solve_triangular

    def cholesky_solve(B, L, *a, **kw):
        calls["cholesky_solve"].append(tuple(L.shape))
        return real_cs(B, L, *a, **kw)

    def solve_triangular(A, B, *a, **kw):
        calls["solve_triangular"].append(tuple(A.shape))
        return real_st(A, B, *a, **kw)

    monkeypatch.setattr(torch, "cholesky_solve", cholesky_solve)
    monkeypatch.setattr(torch.linalg, "solve_triangular", solve_triangular)
    before = profiling.counts()
    elbo, *_ = eng.elbo_fit_batch(theta, *data, mu0, var0, 5)
    after = profiling.counts()
    monkeypatch.undo()

    assert torch.isfinite(elbo).all()
    assert calls["cholesky_solve"] == []
    widths = {shape[-1] for shape in calls["solve_triangular"]}
    assert widths and max(widths) <= DEFAULT_BLOCK < N
    sweeps = after["gprn.batch.sweeps"] - before["gprn.batch.sweeps"]
    assert sweeps == 5
    assert (after["gprn.sweep.inverse_solves"]
            - before["gprn.sweep.inverse_solves"]) == (3 if q == 1 else 4) \
        * sweeps
