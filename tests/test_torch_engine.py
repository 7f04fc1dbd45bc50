"""The fit-and-predict engine of gpyrn_tpu_torch against gpyrn_tpu.

For (q, p) ∈ {(1,1), (1,3), (2,3)} at N=48 (the cumulative-sumSigmaF and
raw-reshape quirks of the ELBO only show at q > 1), the same parameters,
data and starting state, made with numpy from a seed, go through the JAX
engine (``make_engine``) and the port's ``Engine`` in float64.  Tolerances: ELBO
relative 1e-9, equal sweep counts, and max-abs/(1 + max) ≤ 1e-8 for the
variational state and the predictive mean and variance."""
import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
from gpyrn_tpu.models import gprn as jg
import gpyrn_tpu_torch as gt
from gpyrn_tpu_torch.models import gprn as tg
from gpyrn_tpu_torch.ops import cuda_kernels as ck

ELBO_RTOL = 1e-9
STATE_TOL = 1e-8
N = 48


def _components(pkg, q, p):
    cf, mf = pkg.covfunc, pkg.meanfunc
    if (q, p) == (1, 1):
        return ([cf.Periodic(1.0, 9.0, 0.6)],
                [cf.SquaredExponential(1.0, 8.0)],
                [mf.Constant(0.1)], [0.1])
    if (q, p) == (1, 3):
        # the last weight holds WhiteNoise, which takes the plain formula
        return ([cf.QuasiPeriodic(1.0, 20.0, 13.0, 0.7)],
                [cf.SquaredExponential(1.0, 10.0),
                 cf.Matern32(1.05, 8.0),
                 cf.SquaredExponential(1.1, 10.0) + cf.WhiteNoise(0.1)],
                [None, mf.Linear(0.01, 0.0), mf.Sine(0.2, 15.0, 0.1)],
                [0.1, 0.12, 0.14])
    return ([cf.Periodic(1.0, 9.0, 0.6), cf.Matern52(1.0, 5.0)],
            [cf.SquaredExponential(1.0 + 0.05 * k, 5.0 + 0.5 * k)
             for k in range(6)],
            [mf.Linear(0.01, 0.0) for _ in range(3)], [0.1, 0.12, 0.14])


def _data(p):
    rng = np.random.default_rng(11 + p)
    t = np.sort(rng.uniform(0, 60, N))
    y = np.stack([np.sin(2 * np.pi * t / (9 + 4 * i))
                  + 0.1 * rng.standard_normal(N) for i in range(p)])
    yerr2 = np.full((p, N), 0.1 ** 2)
    return t, y, yerr2


def _state_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(b)))


CONFIGS = [(1, 1), (1, 3), (2, 3)]


@pytest.fixture(scope="module", params=CONFIGS,
                ids=lambda c: f"q{c[0]}p{c[1]}")
def runs(request):
    """Both engines on one configuration; the JAX side compiles once."""
    q, p = request.param
    nj, wj, mj, jj = _components(gj, q, p)
    nt, wt, mt, jt = _components(gt, q, p)
    spec_j = jg.spec_from_components(nj, wj, mj, N)
    spec_t = tg.spec_from_components(nt, wt, mt, N)
    eng_j = jg.make_engine(spec_j)
    eng_t = tg.Engine(spec_t)
    theta = jg.pack_parameters(nj, wj, mj, jj)
    t, y, yerr2 = _data(p)
    tstar = np.linspace(-10, 70, 37)
    f64 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64)  # noqa
    jax_out = {}
    jax_out["init"] = [np.asarray(a) for a in eng_j.init_mu_var(theta, y)]
    mu0, var0 = jax_out["init"]
    jax_out["sweep"] = [np.asarray(a) for a in
                        eng_j.sweep_once(theta, t, y, yerr2, mu0, var0)]
    fit = eng_j.elbo_fit(theta, t, y, yerr2, mu0, var0, 500)
    jax_out["fit"] = [np.asarray(a) for a in fit]
    jax_out["predict"] = [np.asarray(a) for a in eng_j.predict(
        theta, t, y, yerr2, jax_out["fit"][1], jax_out["fit"][2], tstar)]
    args_t = (f64(theta), f64(t), f64(y), f64(yerr2))
    return dict(q=q, p=p, spec_j=spec_j, spec_t=spec_t, eng_t=eng_t,
                args_t=args_t, f64=f64, tstar=tstar, jax=jax_out,
                theta=theta, y=y)


def test_spec_matches_jax(runs):
    assert tuple(runs["spec_t"]) == tuple(runs["spec_j"])
    assert runs["spec_t"].d == runs["spec_j"].d
    theta_t = tg.pack_parameters(*_components(gt, runs["q"], runs["p"]))
    np.testing.assert_array_equal(theta_t, runs["theta"])
    parts_t = tg.unpack_parameters(runs["spec_t"], torch.tensor(theta_t))
    parts_j = jg.unpack_parameters(runs["spec_j"], runs["theta"])
    for a, b in zip(parts_t[:3], parts_j[:3]):
        for x, z in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(z))


def test_init_mu_var_matches_jax(runs):
    mu, var = runs["eng_t"].init_mu_var(runs["args_t"][0],
                                        runs["f64"](runs["y"]))
    np.testing.assert_allclose(mu.numpy(), runs["jax"]["init"][0],
                               rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(var.numpy(), runs["jax"]["init"][1],
                               rtol=1e-14, atol=1e-14)


def test_sweep_once_matches_jax(runs):
    mu0, var0 = (runs["f64"](a) for a in runs["jax"]["init"])
    elbo, mu, var = runs["eng_t"].sweep_once(*runs["args_t"], mu0, var0)
    e_j, mu_j, var_j = runs["jax"]["sweep"]
    assert abs(float(elbo) - float(e_j)) <= ELBO_RTOL * abs(float(e_j))
    assert _state_err(mu.numpy(), mu_j) <= STATE_TOL
    assert _state_err(var.numpy(), var_j) <= STATE_TOL


def test_elbo_fit_matches_jax(runs):
    mu0, var0 = (runs["f64"](a) for a in runs["jax"]["init"])
    elbo, mu, var, n_iter, converged, trace = runs["eng_t"].elbo_fit(
        *runs["args_t"], mu0, var0, 500)
    e_j, mu_j, var_j, it_j, conv_j, trace_j = runs["jax"]["fit"]
    assert n_iter == int(it_j) and converged == bool(conv_j)
    assert abs(float(elbo) - float(e_j)) <= ELBO_RTOL * abs(float(e_j))
    assert _state_err(mu.numpy(), mu_j) <= STATE_TOL
    assert _state_err(var.numpy(), var_j) <= STATE_TOL
    np.testing.assert_allclose(trace.numpy(), trace_j[:n_iter],
                               rtol=ELBO_RTOL)


def test_elbo_fit_stops_at_max_iter(runs):
    mu0, var0 = (runs["f64"](a) for a in runs["jax"]["init"])
    elbo, mu, var, n_iter, converged, trace = runs["eng_t"].elbo_fit(
        *runs["args_t"], mu0, var0, 2)
    assert (n_iter, converged, trace.shape) == (2, False, (2,))
    np.testing.assert_allclose(trace.numpy(),
                               runs["jax"]["fit"][5][:2], rtol=ELBO_RTOL)


def test_predict_matches_jax(runs):
    f64 = runs["f64"]
    e_j, mu_j, var_j = runs["jax"]["fit"][:3]
    out = runs["eng_t"].predict(*runs["args_t"], f64(mu_j), f64(var_j),
                                f64(runs["tstar"]))
    for got, ref in zip(out, runs["jax"]["predict"]):
        assert tuple(got.shape) == ref.shape
        assert _state_err(got.numpy(), ref) <= STATE_TOL


def test_cpu_engine_never_launches_the_kernel(runs):
    before = ck.LAUNCHES["kernel_matrix"]
    mu0, var0 = (runs["f64"](a) for a in runs["jax"]["init"])
    runs["eng_t"].sweep_once(*runs["args_t"], mu0, var0)
    assert ck.LAUNCHES["kernel_matrix"] == before
