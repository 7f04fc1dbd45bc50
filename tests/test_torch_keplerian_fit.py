"""The Keplerian RV workflow of gpyrn_tpu_torch against gpyrn_tpu.

The solar model (RV and FWHM of the bundled solar data, one
QuasiPeriodic node, SquaredExponential weights, a Keplerian mean on RV and
a constant on FWHM), subsampled to N=64, float64 on the CPU, with the
same parameters, data and heuristic starting state in both packages:

* 10 fixed sweeps' ELBO (relative 1e-10) and its gradient with respect to
  every parameter, the Keplerian's five through all 100 Newton steps
  (1e-9 of max |g|), against ``jax.value_and_grad``;
* ``fit_state`` converged to 1e-11 (state 1e-8·(1 + max), the same sweep
  count) and the shell's ``ELBOcalc`` (ELBO relative 1e-9, the same sweep
  count);
* a 4-row ``elbo_fit_batch`` of perturbed parameter rows against the JAX
  package's ``vmap(elbo_fit)`` (ELBO relative 1e-9, state 1e-8, counts);
* the port's lean engines with the Keplerian against the JAX package's
  ``elbo_fit_lean`` (ELBO relative 1e-10, state 1e-8, the same sweep
  count) and against its own dense engine (the same map: ELBO relative
  1e-12, state 1e-10);
* ``optimize_device`` over the θ batch, whose every objective call takes
  the batch's mean values in one pass, against the JAX package's (x and
  fun relative 1e-8, ``nit`` / ``nfev`` equal, the bar of the
  Nelder-Mead tests).

The JAX package compiles each of these anew (tens of seconds of worker
time), so its results are kept in ``torch_keplerian_reference.json``
(written by ``JAX_PLATFORMS=cpu python -m tests.test_torch_keplerian_fit``);
the ``slow`` test ``test_reference_is_the_jax_packages`` recomputes them
with the JAX package and holds the file to them."""
import json
import os

import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
import gpyrn_tpu_torch as gt
from gpyrn_tpu_torch.convert import inference_from_jax

torch.set_num_threads(1)

VALUE_RTOL = 1e-10
GRAD_TOL = 1e-9
ELBO_RTOL = 1e-9
STATE_TOL = 1e-8
REFERENCE_RTOL = 1e-12
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "torch_keplerian_reference.json")
KEEP = slice(0, 448, 7)                 # 64 of the 497 observations
N_SWEEPS = 10
FIT_TOL = 1e-11
FIT_MAX_ITER = 400
BATCH = {"rows": 4, "spread": 0.1, "seed": 3, "max_iter": 500}
LEAN_MAX_ITER = 50
LEAN_ELBO_RTOL = 1e-10
SAME_ELBO_RTOL = 1e-12
SAME_STATE_TOL = 1e-10
OPTIMIZE = {"n_sweeps": 3, "max_iter": 4}
OPTIMIZE_TOL = 1e-8


def _model(pkg, **kw):
    import importlib
    datasets = importlib.import_module(pkg.__name__ + ".datasets")
    time, data = datasets.load_solar(("RV", "FWHM"))
    time, data = time[KEEP], [d[KEEP] for d in data]
    g = pkg.inference(1, time, *data, **kw)
    s_rv, s_fwhm = np.std(data[0]), np.std(data[2])
    g.set_components(
        pkg.covfunc.QuasiPeriodic(1.0, 30.0, 27.0, 0.7),
        [pkg.covfunc.SquaredExponential(s_rv, 30.0),
         pkg.covfunc.SquaredExponential(s_fwhm, 30.0)],
        [pkg.meanfunc.Keplerian(100.0, 1.0, 0.1, 0.5, 0.0),
         pkg.meanfunc.Constant(0.0)],
        [s_rv / 2, s_fwhm / 2])
    return g


def _thetas(theta0):
    rng = np.random.default_rng(BATCH["seed"])
    out = theta0[None, :] * np.exp(
        BATCH["spread"] * rng.standard_normal((BATCH["rows"], theta0.size)))
    out[0] = theta0
    return out


def _jax_reference():
    import jax
    import jax.numpy as jnp
    g = _model(gj)
    eng, theta = g.engine, g._theta()
    t = np.asarray(g.time, dtype=float)
    mu0, var0 = eng.init_mu_var(theta, g.y)
    value, grad = eng.elbo_value_and_grad(theta, t, g.y, g.yerr2, mu0, var0,
                                          N_SWEEPS)
    mu, var, n_it, done = eng.fit_state(theta, t, g.y, g.yerr2, mu0, var0,
                                        FIT_MAX_ITER, FIT_TOL)
    out = {"fixed": {"value": float(value), "grad": np.asarray(grad).tolist()},
           "fit_state": {"mu": np.asarray(mu).tolist(),
                         "var": np.asarray(var).tolist(),
                         "n_iter": int(n_it), "converged": bool(done)}}
    elbo, mu, var, n_iter = g.ELBOcalc()
    out["elbocalc"] = {"elbo": float(elbo), "n_iter": int(n_iter),
                       "mu": np.asarray(mu).tolist(),
                       "var": np.asarray(var).tolist()}
    thetas = _thetas(np.asarray(theta))

    def one(th):
        m0, v0 = eng.init_mu_var(th, g.y)
        return eng.elbo_fit(th, t, g.y, g.yerr2, m0, v0, BATCH["max_iter"])

    elbo, mu, var, n_iter, conv, _ = jax.jit(jax.vmap(one))(
        jnp.asarray(thetas))
    out["batch"] = {"elbo": np.asarray(elbo).tolist(),
                    "mu": np.asarray(mu).tolist(),
                    "var": np.asarray(var).tolist(),
                    "n_iter": np.asarray(n_iter).tolist(),
                    "converged": np.asarray(conv).tolist()}
    elbo, mu, var, n_iter, conv, _ = eng.elbo_fit_lean(
        theta, t, g.y, g.yerr2, mu0, var0, LEAN_MAX_ITER)
    out["lean"] = {"elbo": float(elbo), "mu": np.asarray(mu).tolist(),
                   "var": np.asarray(var).tolist(), "n_iter": int(n_iter),
                   "converged": bool(conv)}
    res = _model(gj).optimize_device(**OPTIMIZE)
    out["optimize_device"] = {
        "x": np.asarray(res["x"]).tolist(), "fun": float(res["fun"]),
        "nit": int(res["nit"]), "nfev": int(res["nfev"])}
    return out


def write_reference():
    with open(REFERENCE, "w") as f:
        json.dump(_jax_reference(), f)


@pytest.fixture(scope="module")
def reference():
    with open(REFERENCE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port():
    g = inference_from_jax(_model(gj), device="cpu")
    theta = g._theta()
    mu0, var0 = g.engine.init_mu_var(theta, g._tensor(g.y))
    return g, theta, mu0, var0


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _state_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(b)))


def test_the_models_agree(port):
    g, _, _, _ = port
    ref = _model(gt, device="cpu")
    assert g.engine.spec == ref.engine.spec
    np.testing.assert_array_equal(g.get_parameters(include_frozen=True),
                                  ref.get_parameters(include_frozen=True))
    np.testing.assert_array_equal(g.y, ref.y)
    assert g.N == 64 and g.engine.spec.mean_structs[0] == ("Kep",)


def test_fixed_sweeps_value_and_grad(port, reference):
    g, theta, mu0, var0 = port
    value, grad = g.engine.elbo_value_and_grad(theta, *g._data(), mu0, var0,
                                               N_SWEEPS)
    ref = reference["fixed"]
    assert _rel(value, ref["value"]) <= VALUE_RTOL
    g_ref = np.asarray(ref["grad"])
    assert np.max(np.abs(grad.numpy() - g_ref)) <= \
        GRAD_TOL * np.max(np.abs(g_ref))
    # the Keplerian's five entries (after the 3 + 2 + 2 kernel
    # parameters) carry a gradient; Tp = 0 too
    assert np.all(grad.numpy()[7:12] != 0)


def test_converged_state_and_elbocalc(port, reference):
    g, theta, mu0, var0 = port
    mu, var, n_iter, done = g.engine.fit_state(
        theta, *g._data(), mu0, var0, FIT_MAX_ITER, FIT_TOL)
    ref = reference["fit_state"]
    assert (n_iter, done) == (ref["n_iter"], ref["converged"])
    assert _state_err(mu.numpy(), ref["mu"]) <= STATE_TOL
    assert _state_err(var.numpy(), ref["var"]) <= STATE_TOL
    elbo, mu, var, n_iter = g.ELBOcalc()
    ref = reference["elbocalc"]
    assert n_iter == ref["n_iter"]
    assert _rel(elbo, ref["elbo"]) <= ELBO_RTOL
    assert _state_err(mu.numpy(), ref["mu"]) <= STATE_TOL


def test_batched_fit(port, reference):
    g, theta, _, _ = port
    thetas = g._tensor(_thetas(theta.numpy()))
    mu0, var0 = g.engine.init_mu_var(thetas, g._tensor(g.y))
    elbo, mu, var, n_iter, conv = g.engine.elbo_fit_batch(
        thetas, *g._data(), mu0, var0, BATCH["max_iter"])
    ref = reference["batch"]
    assert n_iter.tolist() == ref["n_iter"]
    assert conv.tolist() == ref["converged"]
    np.testing.assert_allclose(elbo.numpy(), ref["elbo"], rtol=ELBO_RTOL)
    for w in range(BATCH["rows"]):
        assert _state_err(mu[w].numpy(), ref["mu"][w]) <= STATE_TOL
        assert _state_err(var[w].numpy(), ref["var"][w]) <= STATE_TOL


def test_lean_engines_and_optimize_device(port, reference):
    g, theta, mu0, var0 = port
    eng, data = g.engine, g._data()
    lean = eng.elbo_fit_lean(theta, *data, mu0, var0, LEAN_MAX_ITER)
    ref = reference["lean"]
    assert (lean[3], bool(lean[4])) == (ref["n_iter"], ref["converged"])
    assert _rel(lean[0], ref["elbo"]) <= LEAN_ELBO_RTOL
    assert _state_err(lean[1].numpy(), ref["mu"]) <= STATE_TOL
    assert _state_err(lean[2].numpy(), ref["var"]) <= STATE_TOL
    dense = eng.elbo_fit(theta, *data, mu0, var0, LEAN_MAX_ITER)
    assert lean[3] == dense[3] and bool(lean[4]) == bool(dense[4])
    assert _rel(lean[0], dense[0]) <= SAME_ELBO_RTOL
    for a, b in zip(lean[1:3], dense[1:3]):
        assert _state_err(a.numpy(), b.numpy()) <= SAME_STATE_TOL
    res = _model(gt, device="cpu").optimize_device(**OPTIMIZE)
    ref = reference["optimize_device"]
    np.testing.assert_allclose(res["x"], ref["x"], rtol=OPTIMIZE_TOL)
    assert (res["nit"], res["nfev"]) == (ref["nit"], ref["nfev"])
    assert abs(res["fun"] - ref["fun"]) <= OPTIMIZE_TOL * abs(ref["fun"])


@pytest.mark.slow
def test_reference_is_the_jax_packages():
    """The cached JAX results are what the JAX package computes now."""
    with open(REFERENCE) as f:
        ref = json.load(f)
    fresh = _jax_reference()
    for name, values in fresh.items():
        for key, value in values.items():
            np.testing.assert_allclose(value, ref[name][key],
                                       rtol=REFERENCE_RTOL, atol=1e-300)


if __name__ == "__main__":
    write_reference()
