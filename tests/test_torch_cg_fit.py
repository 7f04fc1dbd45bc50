"""The matrix-free CG fit of gpyrn_tpu_torch against
gpyrn_tpu.models.cg_fit, and the shell's ``fit_method='cg'``.

``make_cg_fit(...).fit_state_cg`` for (q, p) = (1, 3) and (2, 2), N=40,
float64, rank 10 (a pivoted-Cholesky factor short of the rank where
its pivots fall on rounding noise, which each runtime picks its own way)
and cg_tol 1e-10, from the heuristic
start: 5 sweeps, and a fit to the state rule at 3e-3, against the JAX
package's: state within 1e-7·(1 + max) (the solves' tolerance 1e-10
times the conditioning of A = K + diag(d), in μ's cancellation), the
same sweep counts and flags, the achieved relres below the tolerance on
both sides; the factors (U, g, ν) within 1e-10.

The shell: ``ELBOcalc(precision='mixed')`` with ``fit_method='cg'`` at
rank 10 takes the CG bulk (``mixed_info['bulk'] == 'cg'``), sets
``cg_achieved_relres`` and lands within 1e-4 of the JAX package's ELBO
(a float32 bulk of 20 sweeps, whose rounding differs between the
runtimes, then three float64 polish sweeps); the
``cg_engine`` is rebuilt when ``cg_rank`` or ``cg_tol`` change; ``mesh=``
on a one-rank mesh gives the unsharded fit.

The JAX package compiles each fit anew, so its results are kept in
``torch_cg_fit_reference.json`` (written by ``JAX_PLATFORMS=cpu python -m
tests.test_torch_cg_fit``); the ``slow`` test
``test_reference_is_the_jax_packages`` recomputes them."""
import json
import os

import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
from gpyrn_tpu.models import cg_fit as jcg
from gpyrn_tpu.models import gprn as jg
import gpyrn_tpu_torch as gt
from gpyrn_tpu_torch.convert import inference_from_jax
from gpyrn_tpu_torch.models import cg_fit as tcg
from gpyrn_tpu_torch.models import gprn as tg

from tests.torch_parallel_jobs import one_rank_mesh

torch.set_num_threads(1)

STATE_TOL = 1e-7
FACTOR_TOL = 1e-10
SHELL_ELBO_RTOL = 1e-4
REFERENCE_RTOL = 1e-12
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "torch_cg_fit_reference.json")
N = 40
RANK = 10
CG_TOL = 1e-10
CONFIGS = {"q1p3": (1, 3), "q2p2": (2, 2)}
RUNS = {"sweeps": (5, 0.0), "converge": (200, 3e-3)}
SHELL = {"cg_rank": RANK, "cg_tol": 1e-6, "max_iter": 20}


def _components(pkg, q):
    cf, mf = pkg.covfunc, pkg.meanfunc
    if q == 1:
        return ([cf.QuasiPeriodic(1.0, 20.0, 13.0, 0.7)],
                [cf.SquaredExponential(1.0, 10.0), cf.Matern52(1.05, 8.0),
                 cf.SquaredExponential(1.1, 12.0)],
                [None, mf.Linear(0.01, 0.0), None], [0.1, 0.12, 0.14])
    return ([cf.Periodic(1.0, 9.0, 0.6), cf.Matern52(1.0, 5.0)],
            [cf.SquaredExponential(1.0 + 0.05 * k, 5.0 + 0.5 * k)
             for k in range(4)],
            [mf.Linear(0.01, 0.0) for _ in range(2)], [0.3, 0.32])


def _data(p):
    rng = np.random.default_rng(15)
    t = np.sort(rng.uniform(0, 60, N))
    y = np.stack([np.sin(2 * np.pi * t / (9 + 4 * i))
                  + 0.1 * rng.standard_normal(N) for i in range(p)])
    return t, y, np.full((p, N), 0.1 ** 2)


def _arrays(pkg, q, p):
    nodes, weights, means, jitters = _components(pkg, q)
    spec_mod = jg if pkg is gj else tg
    spec = spec_mod.spec_from_components(nodes, weights, means, N)
    theta = spec_mod.pack_parameters(nodes, weights, means, jitters)
    return spec, theta, _data(p)


def _jax_model(q):
    nodes, weights, means, jitters = _components(gj, q)
    t, y, _ = _data(CONFIGS["q1p3" if q == 1 else "q2p2"][1])
    data = []
    for row in y:
        data += [row, np.full(N, 0.1)]
    g = gj.inference(q, t, *data)
    g.set_components(nodes, weights, means, jitters)
    g.fit_method, g.cg_rank, g.cg_tol = 'cg', SHELL["cg_rank"], \
        SHELL["cg_tol"]
    return g


def _jax_reference(config):
    q, p = CONFIGS[config]
    spec, theta, (t, y, yerr2) = _arrays(gj, q, p)
    eng = jg.make_engine(spec)
    mu0, var0 = eng.init_mu_var(theta, y)
    cg = jcg.make_cg_fit(spec, rank=RANK, cg_tol=CG_TOL)
    out = {}
    for run, (max_iter, tol) in RUNS.items():
        mu, var, it, done, rres = cg.fit_state_cg(theta, t, y, yerr2, mu0,
                                                  var0, max_iter, tol)
        out[run] = {"mu": np.asarray(mu).tolist(),
                    "var": np.asarray(var).tolist(), "n_iter": int(it),
                    "converged": bool(done), "relres": float(rres)}
    U, g_, nu = cg.factors(theta, t)
    out["factors"] = {"U": np.asarray(U).tolist(),
                      "g": np.asarray(g_).tolist(),
                      "nu": np.asarray(nu).tolist()}
    if q == 1:
        g = _jax_model(q)
        elbo, _, _, n_iter = g.ELBOcalc(precision='mixed',
                                        max_iter=SHELL["max_iter"])
        out["shell"] = {"elbo": float(elbo), "n_iter": int(n_iter),
                        "relres": float(g.cg_achieved_relres)}
    return out


def write_reference():
    with open(REFERENCE, "w") as f:
        json.dump({c: _jax_reference(c) for c in CONFIGS}, f)


@pytest.fixture(scope="module")
def reference():
    with open(REFERENCE) as f:
        return json.load(f)


@pytest.fixture(scope="module", params=list(CONFIGS))
def port(request):
    q, p = CONFIGS[request.param]
    spec, theta, data = _arrays(gt, q, p)
    eng = tg.Engine(spec)
    theta, t, y, yerr2 = (torch.tensor(a, dtype=torch.float64)
                          for a in (theta, *data))
    mu0, var0 = eng.init_mu_var(theta, y)
    cg = tcg.make_cg_fit(spec, rank=RANK, cg_tol=CG_TOL)
    return request.param, cg, (theta, t, y, yerr2, mu0, var0)


def _state_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(b)))


@pytest.mark.parametrize("run", list(RUNS))
def test_fit_state_cg_matches_jax(port, reference, run):
    config, cg, args = port
    want = reference[config][run]
    mu, var, it, done, rres = cg.fit_state_cg(*args, *RUNS[run])
    assert (it, done) == (want["n_iter"], want["converged"])
    assert _state_err(mu, want["mu"]) <= STATE_TOL
    assert _state_err(var, want["var"]) <= STATE_TOL
    assert rres.ndim == 0 and float(rres) <= CG_TOL
    assert want["relres"] <= CG_TOL


def test_factors_match_jax(port, reference):
    config, cg, args = port
    want = reference[config]["factors"]
    for got, key in zip(cg.factors(args[0], args[1]), ("U", "g", "nu")):
        ref = np.asarray(want[key])
        assert np.max(np.abs(got.numpy() - ref)) <= \
            FACTOR_TOL * max(np.max(np.abs(ref)), 1.0)


def test_shell_fit_method_cg_matches_jax(reference):
    ref = reference["q1p3"]["shell"]
    g = inference_from_jax(_jax_model(1), device="cpu")
    assert (g.fit_method, g.cg_rank, g.cg_tol) == ('cg', SHELL["cg_rank"],
                                                   SHELL["cg_tol"])
    elbo, _, _, n_iter = g.ELBOcalc(precision='mixed',
                                    max_iter=SHELL["max_iter"])
    assert g.mixed_info["bulk"] == "cg"
    assert g.cg_achieved_relres == g.mixed_info["cg_achieved_relres"]
    assert 0 < g.cg_achieved_relres < 1
    assert n_iter == ref["n_iter"]
    assert abs(elbo - ref["elbo"]) <= SHELL_ELBO_RTOL * abs(ref["elbo"])


def test_cg_engine_is_rebuilt_with_its_settings():
    g = inference_from_jax(_jax_model(1), device="cpu")
    first = g.cg_engine
    assert g.cg_engine is first and first.rank == SHELL["cg_rank"]
    g.cg_rank = 8
    assert g.cg_engine is not first and g.cg_engine.rank == 8
    second = g.cg_engine
    g.cg_tol = 1e-3
    assert g.cg_engine is not second
    g.set_components(*g._get_components())
    assert g._cg_engine is None


def test_mesh_raises_naming_a15():
    """``mesh=`` on a one-rank mesh: every matvec through the rank's slab
    and a gather, the unsharded fit's sweeps and state."""
    spec, theta, data = _arrays(gt, 1, 3)
    theta, t, y, yerr2 = (torch.tensor(a, dtype=torch.float64)
                          for a in (theta, *data))
    mu0, var0 = tg.Engine(spec).init_mu_var(theta, y)
    args = (theta, t, y, yerr2, mu0, var0, *RUNS["sweeps"])
    ref = tcg.make_cg_fit(spec, rank=RANK, cg_tol=CG_TOL).fit_state_cg(*args)
    with one_rank_mesh() as mesh:
        got = tcg.make_cg_fit(spec, rank=RANK, cg_tol=CG_TOL,
                              mesh=mesh).fit_state_cg(*args)
    assert got[2:4] == ref[2:4]
    assert _state_err(got[0], ref[0]) <= 1e-12
    assert _state_err(got[1], ref[1]) <= 1e-12


@pytest.mark.slow
@pytest.mark.parametrize("config", list(CONFIGS))
def test_reference_is_the_jax_packages(config):
    with open(REFERENCE) as f:
        ref = json.load(f)[config]
    fresh = _jax_reference(config)
    for part, values in fresh.items():
        for key, value in values.items():
            np.testing.assert_allclose(value, ref[part][key],
                                       rtol=REFERENCE_RTOL, atol=1e-300)


if __name__ == "__main__":
    write_reference()
