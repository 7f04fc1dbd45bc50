"""The gradient of the θ-batched ELBO of gpyrn_tpu_torch against
gpyrn_tpu.

``Engine.elbo_fixed_batch`` under ``torch.autograd.grad`` with a
(W, n_parameters) θ is what the HMC chains and the multistart population
differentiate.  It is held against the JAX package's
``vmap(value_and_grad(elbo_fixed))`` on two small models (q=1 and q=2,
p=2, N ≤ 20, constant and linear means), from one shared state and from
one state per row: values relative 1e-10, gradients 1e-9 of max |g|.

The rows are independent: the gradient of the row sum is each row's own
gradient (the port's single-θ ``elbo_value_and_grad``), and a row whose
ELBO is NaN leaves the other rows' gradients finite and unchanged.  The
port is handed the shared state as one (d,) vector; JAX's vmap gets it
once per row, so one compiled function serves both cases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
from gpyrn_tpu_torch.convert import inference_from_jax

torch.set_num_threads(1)

VALUE_RTOL = 1e-10
GRAD_TOL = 1e-9         # of max |g| over the rows
SWEEPS = 3
ROWS = 4


def _jax_model(q):
    rng = np.random.default_rng(50 + q)
    N = 20 if q == 1 else 16
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
    rng = np.random.default_rng(20)
    out = theta0[None, :] * np.exp(
        0.15 * rng.standard_normal((ROWS, theta0.size)))
    out[0] = theta0
    return out


def _grad_err(g, ref):
    return float(np.max(np.abs(g - ref)) / np.max(np.abs(ref)))


def _port_value_and_grad(eng, T, data, mu0, var0):
    T = T.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        elbo = eng.elbo_fixed_batch(T, *data, mu0, var0, SWEEPS)
        (grad,) = torch.autograd.grad(elbo.sum(), T)
    return elbo.detach().numpy(), grad.numpy()


@pytest.fixture(scope="module", params=[1, 2], ids=["q1", "q2"])
def case(request):
    q = request.param
    g = _jax_model(q)
    port = inference_from_jax(g, device="cpu")
    te, data = port.engine, port._data()
    thetas = _thetas(g)
    T = port._tensor(thetas)
    # each row's heuristic start (the port's init_mu_var equals the JAX
    # package's, tests/test_torch_batched.py); the shared state is row 0's
    M, V = te.init_mu_var(T, data[1])
    states = {"shared": (M[0], V[0]), "per_row": (M, V)}

    eng, t = g.engine, np.asarray(g.time, dtype=float)
    vg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda x, mu, var: eng.elbo_fixed(x, t, g.y, g.yerr2, mu, var,
                                          SWEEPS))))
    jax_out, port_out = {}, {}
    for name, (mu, var) in states.items():
        # one compiled vmap over (θ, state) rows serves both cases: the
        # shared state is passed once per row
        mu_rows, var_rows = (np.broadcast_to(a.numpy(), M.shape)
                             for a in (mu, var))
        jax_out[name] = tuple(np.asarray(a) for a in vg(
            jnp.asarray(thetas), jnp.asarray(mu_rows), jnp.asarray(var_rows)))
        port_out[name] = _port_value_and_grad(te, T, data, mu, var)
    return {"port": port, "T": T, "M": M, "V": V, "jax": jax_out,
            "out": port_out}


@pytest.mark.parametrize("state", ["shared", "per_row"])
def test_batched_grad_matches_jax_vmap(case, state):
    """Values rel 1e-10, gradients 1e-9 of max |g|."""
    value, grad = case["out"][state]
    value_j, grad_j = case["jax"][state]
    assert grad.shape == (ROWS, case["port"].n_parameters)
    np.testing.assert_allclose(value, value_j, rtol=VALUE_RTOL)
    assert _grad_err(grad, grad_j) <= GRAD_TOL


@pytest.mark.parametrize("state", ["shared", "per_row"])
def test_rows_are_independent(case, state):
    """The gradient of the row sum, row by row, is that row's own
    single-θ gradient (values rel 1e-10, gradients 1e-9 of max |g|)."""
    port, T, M, V = case["port"], case["T"], case["M"], case["V"]
    value, grad = case["out"][state]
    for w in range(ROWS):
        mu0, var0 = (M[0], V[0]) if state == "shared" else (M[w], V[w])
        v1, g1 = port.engine.elbo_value_and_grad(T[w], *port._data(), mu0,
                                                 var0, SWEEPS)
        assert abs(value[w] - float(v1)) <= VALUE_RTOL * abs(float(v1))
        assert _grad_err(grad[w], g1.numpy()) <= GRAD_TOL


def test_a_nan_row_leaves_the_others_alone(case):
    """A row whose ELBO is NaN (a NaN length scale) gets a non-finite
    gradient; every other row keeps its value and gradient bit for bit."""
    port, T, M, V = case["port"], case["T"], case["M"], case["V"]
    bad = T.clone()
    bad[1, 1] = float("nan")
    value, grad = _port_value_and_grad(port.engine, bad, port._data(), M, V)
    ref_value, ref_grad = case["out"]["per_row"]
    assert np.isnan(value[1])
    keep = [0, 2, 3]
    np.testing.assert_array_equal(value[keep], ref_value[keep])
    np.testing.assert_array_equal(grad[keep], ref_grad[keep])
