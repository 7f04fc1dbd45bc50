"""The dp and lat axes of gpyrn_tpu_torch.parallel, and the distributed
matrix-free CG, over a 4-rank gloo mesh on the CPU.

One module-scoped job (``torch_parallel_jobs.sharding_job``, four
processes through ``parallel.mesh.spawn``) computes every case; the tests
read its results and hold them against the port's unsharded calls (made
here, in one process) and the JAX package's values:

* the mesh: ``make_mesh``'s default (all ranks on ``dp``) and a (2, 2)
  shape, a shape that does not cover the world raises, ``shard_along`` /
  ``gather_along``;
* the lat axis over a (2, 2) mesh (``lattice_axis``, ``use_mesh``; the
  JAX package's ``tests/test_sharding.py`` / ``test_sharding_fit_state``
  model, q=2 p=2 N=16): ``fit_state`` with equal sweep counts and state
  within 1e-10, the shell's ``ELBOcalc`` within 1e-10, and the unrolled
  gradient (autograd through the gathered lattice) within 1e-10 of the
  unsharded engine; the same against the JAX package's engine;
* the dp axis: a 3-step ``multistart_optimize`` (adam) on the (2, 2) mesh
  with the lattice split too, and the ``nm`` population on (4, 1),
  against the unsharded populations and the JAX package's; ``batch_elbo``
  over (4, 1) against the unsharded call and the JAX package's; the
  ensemble's device chain against the unsharded chain at the JAX
  package's bars (``tests/test_sharding_samplers.py``), and an uneven
  walker count;
* ``cg_solve_sharded`` (padding, a non-decaying kernel, one right-hand
  side, the low-rank preconditioner against Jacobi, the refresh and the
  achieved residual, a zero nugget) against the single-device
  ``cg_solve`` and the JAX package's ``cg_solve_sharded`` on 4 devices
  (``tests/test_iterative_sharded.py``'s bars); ``predict_iterative``
  and ``make_cg_fit`` with ``mesh=`` against their unsharded calls, and
  the CG fit's raise on an N that does not divide.

The JAX values come from compiled loops and ``shard_map``s, so they are
kept in ``torch_parallel_reference.json`` (written by
``JAX_PLATFORMS=cpu python -m tests.test_torch_sharding``); the ``slow``
test ``test_reference_is_the_jax_packages`` recomputes them."""
import json
import os

import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
import gpyrn_tpu_torch as gt
from gpyrn_tpu_torch.inference import priors as tpr
from gpyrn_tpu_torch.inference.evidence import batch_elbo
from gpyrn_tpu_torch.models.iterative import predict_iterative
from gpyrn_tpu_torch.ops.iterative import kernel_matvec
from gpyrn_tpu_torch.parallel import multistart_optimize

from tests import torch_parallel_jobs as J

torch.set_num_threads(1)

REFERENCE_RTOL = 1e-12
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "torch_parallel_reference.json")
# the port's lattice engine against the JAX package's (the dense engines
# agree to rounding; 25 unconverged sweeps carry it)
JAX_STATE_TOL = 1e-8
JAX_ELBO_RTOL = 1e-9


def _state_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(b)))


def _jax_reference():
    import jax
    from gpyrn_tpu.inference.evidence import batch_elbo as jbatch
    from gpyrn_tpu.parallel import cg_solve_sharded, make_mesh
    g = J.lattice_problem(gj)
    eng = g.engine
    theta = g._theta()
    t = np.asarray(g.time, dtype=float)
    mu0, var0 = eng.init_mu_var(theta, g.y)
    mu, var, it, _ = eng.fit_state(theta, t, g.y, g.yerr2, mu0, var0,
                                   *J.LATTICE_FIT)
    value, grad = jax.value_and_grad(
        lambda th: eng.elbo_fixed(th, t, g.y, g.yerr2, mu0, var0, 3))(theta)
    elbo, mu_e, _, it_e = g.ELBOcalc(max_iter=60)
    out = {"fit_state": {"mu": np.asarray(mu).tolist(),
                         "var": np.asarray(var).tolist(), "n_iter": int(it)},
           "grad": {"value": float(value), "grad": np.asarray(grad).tolist()},
           "elbocalc": {"elbo": float(elbo), "mu": np.asarray(mu_e).tolist(),
                        "n_iter": int(it_e)}}
    g = J.lattice_problem(gj)
    out["batch_elbo"] = np.asarray(
        jbatch(g, J.batch_thetas(g), max_iter=30)).tolist()
    out["multistart"] = _jax_multistart()
    mesh = make_mesh(shape=(J.WORLD, 1), devices=jax.devices()[:J.WORLD])
    out["cg"] = {}
    for name in J.CG_CASES:
        structure, cp, t, b, d, kw = J.cg_system(gj, name)
        res = cg_solve_sharded(structure, cp, t, b, mesh, d_add=d, **kw)
        out["cg"][name] = {"x": np.asarray(res[0]).tolist(),
                           "n_iter": int(res[1])}
    return out


def _jax_multistart():
    """The JAX package's ``multistart_optimize`` on the lattice model, for
    each of the job's settings, as lists."""
    from gpyrn_tpu.parallel import multistart_optimize as jms
    return {method: {k: np.asarray(v).tolist() for k, v in jms(
        J.lattice_problem(gj), **kw).items()}
        for method, kw in J.MULTISTART.items()}


def write_reference():
    """Rewrite this file's section of the shared reference file."""
    ref = {}
    if os.path.exists(REFERENCE):
        with open(REFERENCE) as f:
            ref = json.load(f)
    ref["sharding"] = _jax_reference()
    with open(REFERENCE, "w") as f:
        json.dump(ref, f)


@pytest.fixture(scope="module")
def reference():
    with open(REFERENCE) as f:
        return json.load(f)["sharding"]


@pytest.fixture(scope="module")
def ranks():
    return J.run(J.sharding_job)


@pytest.fixture(scope="module")
def got(ranks):
    return ranks[0]


@pytest.fixture(scope="module")
def lattice_unsharded():
    return J.lattice_results(J.lattice_problem(gt))


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def test_every_rank_returns_the_same(ranks):
    for other in ranks[1:]:
        _equal_trees({k: v for k, v in other.items() if k != "mesh"},
                     {k: v for k, v in ranks[0].items() if k != "mesh"})


def test_mesh_shapes_and_shards(ranks):
    for rank, out in enumerate(ranks):
        m = out["mesh"]
        assert list(m["default"]) == [J.WORLD, 1]
        assert [tuple(a) for a in m["mesh22"]] == [(rank // 2, 2),
                                                   (rank % 2, 2)]
        x = np.arange(24.0).reshape(8, 3)
        np.testing.assert_array_equal(m["share"], x[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(m["gathered"], x)
        assert "(3, 1) != 4 ranks" in m["bad_shape"]


def test_lattice_fit_state_matches_unsharded(got, lattice_unsharded,
                                             reference):
    mu, var, it, _ = got["lattice"]["fit_state"]
    mu_u, var_u, it_u, _ = lattice_unsharded["fit_state"]
    assert it == it_u == J.LATTICE_FIT[0]
    np.testing.assert_allclose(mu, mu_u, atol=1e-10)
    np.testing.assert_allclose(var, var_u, atol=1e-10)
    want = reference["fit_state"]
    assert it == want["n_iter"]
    assert _state_err(mu, want["mu"]) <= JAX_STATE_TOL
    assert _state_err(var, want["var"]) <= JAX_STATE_TOL


def test_lattice_elbocalc_matches_unsharded(got, lattice_unsharded,
                                            reference):
    e, mu, _, it = got["lattice"]["elbocalc"]
    e_u, mu_u, _, it_u = lattice_unsharded["elbocalc"]
    assert it == it_u
    np.testing.assert_allclose(e, e_u, rtol=1e-10)
    np.testing.assert_allclose(mu, mu_u, atol=1e-10)
    want = reference["elbocalc"]
    assert it == want["n_iter"]
    assert abs(e - want["elbo"]) <= JAX_ELBO_RTOL * abs(want["elbo"])


def test_lattice_gradient_matches_unsharded(got, lattice_unsharded,
                                            reference):
    """Autograd through the gathered weight lattice: the shares' gradients
    are summed over the lat axis, every rank ends with the whole."""
    value, grad = got["lattice"]["grad"]
    value_u, grad_u = lattice_unsharded["grad"]
    np.testing.assert_allclose(value, value_u, rtol=1e-10)
    np.testing.assert_allclose(grad, grad_u, rtol=1e-10,
                               atol=1e-10 * np.max(np.abs(grad_u)))
    want = reference["grad"]
    assert abs(value - want["value"]) <= JAX_ELBO_RTOL * abs(want["value"])
    np.testing.assert_allclose(grad, want["grad"], rtol=0,
                               atol=1e-8 * np.max(np.abs(want["grad"])))


@pytest.mark.parametrize("method", list(J.MULTISTART))
def test_multistart_matches_unsharded(got, method):
    """adam on (2, 2) with the lattice split too, nm on (4, 1), against
    the same population on one process."""
    out = got[f"multistart_{method}"]
    ref = multistart_optimize(J.lattice_problem(gt), **J.MULTISTART[method])
    np.testing.assert_allclose(out["restart_elbos"], ref["restart_elbos"],
                               rtol=1e-8)
    assert out["winner"] == ref["winner"]
    np.testing.assert_allclose(out["theta"], ref["theta"], rtol=1e-7)
    np.testing.assert_allclose(out["elbo"], ref["elbo"], rtol=1e-8)
    if method == "nm":
        np.testing.assert_array_equal(out["nit"], ref["nit"])
        np.testing.assert_array_equal(out["converged"], ref["converged"])
    assert np.isfinite(out["elbo"])


@pytest.mark.parametrize("method", list(J.MULTISTART))
def test_multistart_matches_jax(got, reference, method):
    """The sharded populations against the JAX package's (the inits come
    from numpy, so both start alike), at test_torch_multistart's bars:
    ELBOs relative 1e-9, θ relative 1e-7, the same winner, and for nm
    equal ``nit`` and ``converged``."""
    out, want = got[f"multistart_{method}"], reference["multistart"][method]
    np.testing.assert_allclose(out["restart_elbos"], want["restart_elbos"],
                               rtol=1e-9)
    assert out["winner"] == want["winner"]
    np.testing.assert_allclose(out["theta"], want["theta"], rtol=1e-7)
    assert abs(out["elbo"] - want["elbo"]) <= 1e-9 * abs(want["elbo"])
    if method == "nm":
        np.testing.assert_array_equal(out["nit"], want["nit"])
        np.testing.assert_array_equal(out["converged"], want["converged"])


def test_batch_elbo_matches_unsharded_and_jax(got, reference):
    g = J.lattice_problem(gt)
    ref = batch_elbo(g, J.batch_thetas(g), max_iter=30)
    np.testing.assert_allclose(got["batch_elbo"], ref, rtol=1e-8)
    np.testing.assert_allclose(got["batch_elbo"], reference["batch_elbo"],
                               rtol=1e-8)


def test_device_chain_matches_unsharded(got):
    res = J.walker_problem(gt).mcmc(J.walker_priors(tpr), **J.CHAIN)
    np.testing.assert_allclose(got["chain"]["chain"], res.chain, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got["chain"]["log_prob"], res.log_prob,
                               rtol=1e-6, atol=1e-6)


def test_uneven_walkers_run_whole(got):
    chain, lp = got["uneven"]["chain"], got["uneven"]["log_prob"]
    assert chain.shape == (J.UNEVEN["niter"], J.UNEVEN["nwalkers"], 2)
    assert np.isfinite(lp).any()


@pytest.fixture(scope="module")
def cg_unsharded():
    return J.cg_results()


def _residual(name, x):
    """‖(K + nugget·I + diag d) x − b‖ / ‖b‖ per column, the largest."""
    structure, cp, t, b, d, kw = J.cg_system(gt, name)
    xt = torch.tensor(x)
    r = kernel_matvec(structure, torch.tensor(cp), torch.tensor(t), xt,
                      nugget=kw["nugget"]).numpy()
    if d is not None:
        r = r + (d[:, None] * x if x.ndim == 2 else d * x)
    r = (r - b).reshape(len(t), -1)
    return float(np.max(np.linalg.norm(r, axis=0)
                        / np.linalg.norm(b.reshape(len(t), -1), axis=0)))


@pytest.mark.parametrize("name", ["pad", "periodic", "refresh"])
def test_sharded_cg_matches_single_device(got, cg_unsharded, name):
    """Padding (62, 63 rows over 4 ranks; Periodic never decays, so the
    identity padding must be exact) and the refresh, against the
    single-device solve of the same system."""
    x, it = got["cg"][name][:2]
    x_ref, _ = cg_unsharded[name]
    np.testing.assert_allclose(x, x_ref, rtol=1e-5, atol=1e-8)
    assert it > 0


def test_sharded_cg_refresh_reports_the_true_residual(got):
    x, _, rel = got["cg"]["refresh"]
    np.testing.assert_allclose(rel, _residual("refresh", x), rtol=1e-6,
                               atol=1e-12)
    assert rel <= 1e-9


def test_sharded_cg_single_rhs(got):
    x, _ = got["cg"]["single_rhs"]
    assert x.shape == (61,)
    assert _residual("single_rhs", x) < 1e-6


def test_sharded_cg_lowrank_precond(got):
    """The rank-20 split preconditioner on a smooth kernel: the Jacobi
    solve's answer in a third of its iterations or fewer, pad rows the
    identity (61 rows over 4 ranks)."""
    x_p, it_p = got["cg"]["lowrank"]
    x_j, it_j = got["cg"]["jacobi_smooth"]
    assert _residual("lowrank", x_p) < 1e-6
    np.testing.assert_allclose(x_p, x_j, rtol=1e-4, atol=1e-6)
    assert it_p * 3 <= it_j, (it_p, it_j)


def test_sharded_cg_lowrank_zero_nugget(got):
    """nugget 0 and no d_add: the preconditioner's h stays positive (the
    TRAIN_NUGGET floor), so the solve is not a silent x = 0."""
    x, _ = got["cg"]["lowrank_no_nugget"]
    assert np.all(np.isfinite(x)) and np.linalg.norm(x) > 0.0
    assert _residual("lowrank_no_nugget", x) < 1e-4


# the zero-nugget system is singular to rounding: its 60-iteration answer
# is one of many, held to its residual above
@pytest.mark.parametrize("name", [c for c in J.CG_CASES
                                  if c != "lowrank_no_nugget"])
def test_sharded_cg_matches_jax(got, reference, name):
    x = got["cg"][name][0]
    want = np.asarray(reference["cg"][name]["x"])
    np.testing.assert_allclose(x, want, rtol=1e-5, atol=1e-8)


def test_predict_iterative_mesh_matches_unsharded(got):
    _, mean, std, _ = predict_iterative(J.predict_problem(gt),
                                        tstar=J.PREDICT_TSTAR, tol=1e-10)
    np.testing.assert_allclose(got["predict"][0], mean.numpy(), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(got["predict"][1], std.numpy(), rtol=1e-5,
                               atol=1e-8)


def test_cg_fit_mesh_matches_unsharded(got):
    mu, var, it, _, _ = got["cg_fit"]
    mu_u, var_u, it_u, _, _ = (J._np(v) for v in J.cg_fit_results(
        J.cg_fit_problem(gt, 32)))
    assert it == it_u
    assert _state_err(mu, mu_u) < 1e-8
    np.testing.assert_allclose(var, var_u, rtol=1e-7, atol=1e-12)


def test_cg_fit_mesh_needs_a_divisible_n(got):
    assert "divisible" in got["indivisible"]


@pytest.mark.slow
def test_reference_is_the_jax_packages(reference):
    fresh = _jax_reference()

    def close(a, b, where):
        if isinstance(a, dict):
            for k in a:
                close(a[k], b[k], f"{where}.{k}")
        else:
            np.testing.assert_allclose(a, b, rtol=REFERENCE_RTOL,
                                       err_msg=where)
    close(fresh, reference, "sharding")


if __name__ == "__main__":
    # the JAX package's meshes need the CPU's virtual devices (as
    # tests/conftest.py sets them up for pytest)
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    write_reference()
