"""Nelder-Mead on the device (gpyrn_tpu_torch.inference.neldermead) against
scipy and the JAX package.

The batched-candidate formulation must reproduce scipy's
``method='Nelder-Mead'`` simplex trajectory on objectives that exercise
every branch of the decision tree (expansion, reflection, both
contractions, shrink): x and fun to 1e-8, ``nit`` and ``nfev`` equal,
``adaptive`` included.  The population runs against the JAX package's
``nelder_mead_multistart``, and ``optimize_device`` of a small GPRN
(q=1, p=1, N=16) against the JAX package's with 1 and 3 restarts
(x relative 1e-8, ``nit`` / ``nfev`` equal)."""
import numpy as np
import pytest
import torch
from scipy.optimize import minimize

import gpyrn_tpu as gj
from gpyrn_tpu.inference import neldermead as jnm
from gpyrn_tpu_torch.convert import inference_from_jax
from gpyrn_tpu_torch.inference.neldermead import (NMResult, initial_simplex,
                                                  nelder_mead,
                                                  nelder_mead_multistart)

torch.set_num_threads(1)

TOL = 1e-8


def rosen(x):
    return ((100.0 * (x[1:] - x[:-1] ** 2) ** 2
             + (1.0 - x[:-1]) ** 2).sum())


def _agree(res: NMResult, ref):
    np.testing.assert_allclose(res.x.numpy(), ref.x, rtol=TOL, atol=TOL)
    assert abs(float(res.fun) - ref.fun) <= TOL * max(1.0, abs(ref.fun))
    assert int(res.nit) == ref.nit, (int(res.nit), ref.nit)
    assert int(res.nfev) == ref.nfev, (int(res.nfev), ref.nfev)
    assert bool(res.converged) == ref.success


FUNCS = [     # numpy/torch-polymorphic objectives
    ("rosenbrock2", rosen, np.array([-1.2, 1.0])),
    ("rosenbrock4", rosen, np.array([0.5, -0.3, 1.7, 0.1])),
    ("quadratic", lambda x: ((x - 0.7) ** 2).sum(),
     np.array([3.0, -2.0, 0.0])),
    ("abs_ridge", lambda x: abs(x[0]) + 10 * abs(x[1]),
     np.array([1.3, 0.4])),
    ("cosh_bowl", lambda x: (np.e ** x + np.e ** (-x)).sum(),
     np.array([2.0, -1.0])),
]


@pytest.mark.parametrize("name,f,x0", FUNCS, ids=[f[0] for f in FUNCS])
@pytest.mark.parametrize("adaptive", [False, True])
def test_matches_scipy_trajectory(name, f, x0, adaptive):
    ref = minimize(f, x0, method="Nelder-Mead",
                   options={"adaptive": adaptive})
    res = nelder_mead(f, x0, adaptive=adaptive, device="cpu")
    assert res.x.dtype == torch.float64
    _agree(res, ref)


def test_matches_scipy_under_tight_tolerances():
    x0 = np.array([-1.2, 1.0])
    ref = minimize(rosen, x0, method="Nelder-Mead",
                   options={"xatol": 1e-10, "fatol": 1e-10,
                            "maxiter": 5000, "maxfev": 10 ** 9})
    res = nelder_mead(rosen, x0, xatol=1e-10, fatol=1e-10, max_iter=5000,
                      device="cpu")
    _agree(res, ref)
    np.testing.assert_allclose(res.x.numpy(), [1.0, 1.0], atol=1e-6)


def test_max_iter_cap_reports_no_convergence():
    x0 = np.array([-1.2, 1.0])
    res = nelder_mead(rosen, x0, max_iter=5, device="cpu")
    ref = minimize(rosen, x0, method="Nelder-Mead", options={"maxiter": 5})
    _agree(res, ref)
    assert not bool(res.converged)


def test_initial_simplex_matches_scipy_and_jax():
    x0 = np.array([1.0, 0.0, -2.5])
    sim = initial_simplex(x0, device="cpu").numpy()
    np.testing.assert_array_equal(sim, np.asarray(jnm.initial_simplex(x0)))
    np.testing.assert_allclose(sim[1], [1.05, 0.0, -2.5])
    np.testing.assert_allclose(sim[2], [1.0, 0.00025, -2.5])
    np.testing.assert_allclose(sim[3], [1.0, 0.0, -2.625])


def test_numpy_points_go_to_the_card_by_default():
    """Without ``device``, points that are not a tensor go to "cuda": on a
    machine without a card that raises rather than run on the CPU."""
    x0 = np.array([1.0, 2.0])
    if torch.cuda.is_available():
        assert initial_simplex(x0).device.type == "cuda"
    else:
        for call in (lambda: initial_simplex(x0),
                     lambda: nelder_mead(rosen, x0),
                     lambda: nelder_mead_multistart(rosen, x0[None])):
            with pytest.raises((AssertionError, RuntimeError)):
                call()


def test_custom_simplex_and_batched_f():
    sim0 = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    calls = []

    def fb(X):
        calls.append(X.shape[0])
        return torch.sum((X - 0.3) ** 2, dim=-1)

    res = nelder_mead(None, np.zeros(2), simplex0=sim0, batched_f=fb,
                      device="cpu")
    ref = minimize(lambda x: np.sum((x - 0.3) ** 2), np.zeros(2),
                   method="Nelder-Mead", options={"initial_simplex": sim0})
    _agree(res, ref)
    # the simplex, then all n + 4 candidates of each iteration at once
    assert calls[0] == 3 and set(calls[1:]) == {6}
    assert len(calls) == int(res.nit)


def test_multistart_matches_jax_and_single_runs():
    """Members stop at their own iterations and keep their simplex, nit
    and nfev; each equals its own single run and the JAX population."""
    x0s = np.array([[-1.2, 1.0], [0.5, 0.5], [2.0, -1.0], [1.1, 0.9]])
    res, best = nelder_mead_multistart(rosen, x0s, max_iter=300,
                                       device="cpu")
    ref, best_j = jnm.nelder_mead_multistart(rosen, x0s, max_iter=300)
    assert res.x.shape == (4, 2) and int(best) == int(best_j)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(res.fun.numpy(), np.asarray(ref.fun),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(res.nit.numpy(), np.asarray(ref.nit))
    np.testing.assert_array_equal(res.nfev.numpy(), np.asarray(ref.nfev))
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(ref.converged))
    assert len(set(res.nit.tolist())) > 1
    for m, x0 in enumerate(x0s):
        one = nelder_mead(rosen, x0, max_iter=300, device="cpu")
        assert (int(one.nit), int(one.nfev)) == (int(res.nit[m]),
                                                 int(res.nfev[m]))
        np.testing.assert_array_equal(one.x.numpy(), res.x[m].numpy())


def _gprn():
    rng = np.random.default_rng(5)
    N = 16
    t = np.sort(rng.uniform(0, 40, N))
    y = np.sin(2 * np.pi * t / 9) + 0.1 * rng.standard_normal(N)
    g = gj.inference(1, t, y, np.full(N, 0.1))
    cf = gj.covfunc
    g.set_components([cf.Periodic(1.0, 9.0, 0.6)],
                     [cf.SquaredExponential(1.0, 8.0)],
                     [gj.meanfunc.Constant(0.1)], [0.1])
    g.freeze_parameter(name="mean1.c")
    return g


@pytest.mark.parametrize("n_restarts", [1, 3])
def test_optimize_device_matches_jax(n_restarts):
    """``optimize_device`` from the heuristic start (4 sweeps per
    objective, 12 iterations, the mean frozen): the same result dict as
    the JAX package's, the frozen entry kept, the cache refreshed."""
    kw = {"n_sweeps": 4, "max_iter": 12, "n_restarts": n_restarts,
          "seed": 2}
    g = _gprn()
    port = inference_from_jax(g, device="cpu")
    ref = g.optimize_device(**kw)
    got = port.optimize_device(**kw)
    assert set(got) == set(ref)
    assert got["x"].shape == (6,)
    np.testing.assert_allclose(got["x"], ref["x"], rtol=TOL)
    assert (got["nit"], got["nfev"], got["success"]) == \
        (ref["nit"], ref["nfev"], ref["success"])
    assert abs(got["fun"] - ref["fun"]) <= TOL * abs(ref["fun"])
    assert abs(got["elbo"] - ref["elbo"]) <= 1e-9 * abs(ref["elbo"])
    np.testing.assert_allclose(port.get_parameters(include_frozen=True),
                               g.get_parameters(include_frozen=True),
                               rtol=TOL)
    assert port.get_parameters(include_frozen=True)[5] == 0.1
    assert port._mu is not None


def test_optimize_device_all_frozen_raises():
    port = inference_from_jax(_gprn(), device="cpu")
    port.freeze_all_parameters()
    with pytest.raises(ValueError, match="all parameters are frozen"):
        port.optimize_device()
