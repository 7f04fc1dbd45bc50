"""The converged-state entry points of the gpyrn_tpu_torch shell, and the
small rest of it, against gpyrn_tpu (float64, CPU).

A small model (q=1, p=2, N=30) is built in the JAX package and carried
into the port.  ``elbo_grad(method='implicit')`` agrees in value (1e-9)
and gradient (1e-6 of max |g|: two different GMRES, each held to its
1e-10 residual; measured ~1e-9); three ``optimize_adam(grad='implicit')``
steps give the same parameters (relative 1e-6), best loss and refit ELBO
(1e-8).  A checkpoint written by either package loads in the other;
``sample`` with one numpy ``Generator`` seed gives the JAX package's
draws (1e-5 absolute: both diagonalise a K equal to rounding with the
same LAPACK, but the eigenvectors of the eigenvalues at the 1.25e-12
nugget are free to rotate, and their share of a draw is ~1e-6);
``GP.prediction`` agrees to 1e-10."""
import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
import gpyrn_tpu_torch as gt
from gpyrn_tpu_torch.convert import inference_from_jax

# matrices of N <= 64 gain nothing from threads, and eight of them spinning
# beside the other test workers cost a factor of tens
torch.set_num_threads(1)

N = 30
VALUE_RTOL = 1e-9
GRAD_TOL = 1e-6


def _jax_model():
    rng = np.random.default_rng(3)
    t = np.sort(rng.uniform(0, 30, N))
    data = []
    for i in range(2):
        data += [np.sin(2 * np.pi * t / 10 + i) + 0.2 * i
                 + 0.1 * rng.standard_normal(N), np.full(N, 0.1)]
    g = gj.inference(1, t, *data)
    cf, mf = gj.covfunc, gj.meanfunc
    g.set_components([cf.Periodic(1.0, 10.0, 0.5)],
                     [cf.SquaredExponential(1.0, 5.0),
                      cf.SquaredExponential(1.2, 6.0)],
                     [mf.Constant(0.1), mf.Linear(0.01, 0.1)], [0.1, 0.12])
    return g


def _drive(g):
    out = {"grad": g.elbo_grad(method='implicit', fit_max_iter=4000)}
    out["cached"] = np.array(np.asarray(g._mu if not isinstance(
        g._mu, torch.Tensor) else g._mu.numpy()))
    out["adam"] = g.optimize_adam(vars="-jitter*", n_steps=3,
                                  grad='implicit', fit_max_iter=100,
                                  adjoint_maxiter=3)
    out["params"] = g.get_parameters(include_frozen=True)
    return out


@pytest.fixture(scope="module")
def runs():
    g = _jax_model()
    port = inference_from_jax(g, device="cpu")
    return g, port, _drive(g), _drive(port)


def test_elbo_grad_implicit_matches_jax(runs):
    _, port, ref, got = runs
    (v_j, g_j), (v, g) = ref["grad"], got["grad"]
    assert isinstance(v, float) and isinstance(g, np.ndarray)
    assert abs(v - v_j) <= VALUE_RTOL * abs(v_j)
    assert np.max(np.abs(g - g_j)) <= GRAD_TOL * np.max(np.abs(g_j))
    # the converged state was cached, as a converged ELBOcalc's is
    assert np.max(np.abs(got["cached"] - ref["cached"])) <= 1e-8


def test_implicit_info_certifies_the_call():
    port = inference_from_jax(_jax_model(), device="cpu")
    port.elbo_grad(method='implicit', fit_max_iter=4000)
    info = port.implicit_info
    assert info["fit_converged"] and info["fit_sweeps"] > 10
    assert info["state_residual"] < 1e-10
    assert info["adjoint_residual"] < 1e-10
    # warm from the cache: the fit stops at once, the gradient stays
    v1, g1 = port.elbo_grad(method='implicit')
    assert port.implicit_info["fit_sweeps"] <= 2
    v2, g2 = port.elbo_grad(method='implicit', adjoint='neumann',
                            adjoint_maxiter=300)
    assert abs(v2 - v1) <= 1e-12 * abs(v1)
    # 300 terms of a series that contracts at the sweep map's rate
    assert np.max(np.abs(g2 - g1)) <= 1e-4 * np.max(np.abs(g1))


def test_unconverged_fit_says_so(capsys):
    port = inference_from_jax(_jax_model(), device="cpu")
    port.elbo_grad(method='implicit', fit_max_iter=3)
    assert "Max iterations reached" in capsys.readouterr().out
    assert not port.implicit_info["fit_converged"]
    assert port.implicit_info["state_residual"] > 1e-8


def test_optimize_adam_implicit_matches_jax(runs):
    _, _, ref, got = runs
    a_j, a = ref["adam"], got["adam"]
    assert a["n_steps"] == a_j["n_steps"] == 3
    np.testing.assert_allclose(a["x"], a_j["x"], rtol=1e-6)
    assert abs(a["fun"] - a_j["fun"]) <= 1e-8 * abs(a_j["fun"])
    assert abs(a["elbo"] - a_j["elbo"]) <= 1e-8 * abs(a_j["elbo"])
    np.testing.assert_allclose(got["params"], ref["params"], rtol=1e-6)


def test_optimize_adam_implicit_without_log_transform():
    port = inference_from_jax(_jax_model(), device="cpu")
    port.ELBOcalc()
    seen = []
    res = port.optimize_adam(vars="node1.*", n_steps=2, grad='implicit',
                             transform=None, learning_rate=1e-2,
                             callback=lambda step, v: seen.append(v))
    assert len(seen) == 2 and res["fun"] == min(seen)
    assert res["x"].shape == (3,) and np.isfinite(res["elbo"])
    with pytest.raises(ValueError, match="grad"):
        port.optimize_adam(grad="bogus")


def test_checkpoints_cross_the_packages(runs, tmp_path):
    g, port, _, _ = runs
    g.freeze_parameter(name="mean*")
    port.freeze_parameter(name="mean*")
    # JAX writes, the port reads
    g.save(tmp_path / "jax.npz")
    fresh = inference_from_jax(_jax_model(), device="cpu")
    assert fresh.load(tmp_path / "jax.npz") is fresh
    np.testing.assert_array_equal(fresh.get_parameters(include_frozen=True),
                                  g.get_parameters(include_frozen=True))
    np.testing.assert_array_equal(fresh.frozen_mask, g.frozen_mask)
    assert isinstance(fresh._mu, torch.Tensor)
    np.testing.assert_array_equal(fresh._mu.numpy(), np.asarray(g._mu))
    np.testing.assert_array_equal(fresh._var.numpy(), np.asarray(g._var))
    np.testing.assert_array_equal(fresh.elbo_history.numpy(),
                                  np.asarray(g.elbo_history))
    # the port writes, JAX reads
    port.save(tmp_path / "port.npz")
    with np.load(tmp_path / "port.npz") as z:
        assert set(z.files) == set(np.load(tmp_path / "jax.npz").files)
    back = _jax_model().load(tmp_path / "port.npz")
    np.testing.assert_array_equal(back.get_parameters(include_frozen=True),
                                  port.get_parameters(include_frozen=True))
    np.testing.assert_array_equal(back.frozen_mask, port.frozen_mask)
    np.testing.assert_array_equal(np.asarray(back._mu), port._mu.numpy())
    # the restored state predicts
    assert bool(torch.isfinite(fresh.predict(nn=7)[1]).all())


def test_save_without_a_state(tmp_path):
    port = inference_from_jax(_jax_model(), device="cpu")
    port.save(tmp_path / "empty.npz")
    with np.load(tmp_path / "empty.npz") as z:
        assert z["mu"].size == z["var"].size == z["elbo_history"].size == 0
    other = inference_from_jax(_jax_model(), device="cpu").load(
        tmp_path / "empty.npz")
    assert other._mu is None


def test_sample_matches_jax():
    g = _jax_model()
    port = inference_from_jax(g, device="cpu")
    tstar = np.linspace(0.0, 12.0, 14)
    for time in (None, tstar):
        n_j, w_j = g.sample(time, np.random.default_rng(8))
        n_t, w_t = port.sample(time, np.random.default_rng(8))
        n = N if time is None else tstar.size
        assert n_t.shape == (1, n) and w_t.shape == (2, n)
        np.testing.assert_allclose(n_t, n_j, rtol=0, atol=1e-5)
        np.testing.assert_allclose(w_t, w_j, rtol=0, atol=1e-5)
    # a non-stationary kernel is sampled from its coordinates, as in the
    # JAX package
    draws = [pkg_g._sample_from_gp(pkg.covfunc.Polynomial(0.5, 0.1, 1.0, 2.0),
                                   tstar, np.random.default_rng(1))
             for pkg, pkg_g in ((gj, g), (gt, port))]
    np.testing.assert_allclose(draws[1], draws[0], rtol=0, atol=1e-5)


def test_shell_helpers():
    port = inference_from_jax(_jax_model(), device="cpu")
    mu, var = port._initMuVar(port.nodes, port.weights, port.jitters)
    ref = port.engine.init_mu_var(port._theta(), port._tensor(port.y))
    assert torch.equal(mu, ref[0]) and torch.equal(var, ref[1])
    f, w = port._u_to_fhatW(mu)
    assert f.shape == (1, 1, N) and w.shape == (2, 1, N)
    assert torch.equal(f.reshape(-1), mu[:N])
    f2, _ = port._u_to_fhatW(mu.numpy())
    assert torch.equal(f2, f)


@pytest.mark.parametrize("kernel", ["SE", "QP*C", "SE+M32"])
def test_gp_prediction_matches_jax(kernel):
    def make(cf):
        return {"SE": lambda: cf.SquaredExponential(1.2, 8.0),
                "QP*C": lambda: cf.QuasiPeriodic(1.1, 20.0, 13.0, 0.6)
                * cf.Constant(0.8),
                "SE+M32": lambda: cf.SquaredExponential(1.0, 8.0)
                + cf.Matern32(0.5, 3.0)}[kernel]()

    rng = np.random.default_rng(6)
    t = np.sort(rng.uniform(0, 50, 35))
    y = np.sin(t / 4) + 0.1 * rng.standard_normal(35)
    yerr = np.full(35, 0.1)
    tstar = np.linspace(-5, 55, 21)
    gp_j = gj.GP(t, y, yerr)
    gp_t = gt.GP(t, y, yerr, device="cpu")
    m_j, v_j = gp_j.prediction(make(gj.covfunc), tstar)
    m_t, v_t = gp_t.prediction(make(gt.covfunc), tstar)
    assert m_t.dtype == torch.float64 and m_t.shape == v_t.shape == (21,)
    np.testing.assert_allclose(m_t.numpy(), m_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(v_t.numpy(), v_j, rtol=1e-10, atol=1e-10)
    # conditioning on another vector and variances
    m2 = rng.standard_normal(35)
    v2 = rng.uniform(0.01, 0.1, 35)
    a_j = gp_j.prediction(make(gj.covfunc), tstar, m2, v2)
    a_t = gp_t.prediction(make(gt.covfunc), tstar, m2, v2)
    for x, r in zip(a_t, a_j):
        np.testing.assert_allclose(x.numpy(), r, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(
        gp_t._kernel_matrix(make(gt.covfunc), t).numpy(),
        gp_j._kernel_matrix(make(gj.covfunc), t), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        gp_t._predict_kernel_matrix(make(gt.covfunc), tstar).numpy(),
        gp_j._predict_kernel_matrix(make(gj.covfunc), tstar),
        rtol=1e-12, atol=1e-14)


def test_gp_defaults_and_new_kernel():
    t = np.linspace(0, 10, 9)
    gp = gt.GP(t, np.sin(t))
    assert gp.device == torch.device("cuda")       # the card, never detected
    np.testing.assert_array_equal(gp.yerr, np.full(9, 1e-12))
    gp_j = gj.GP(t, np.sin(t))
    for pkg, holder in ((gt, gp), (gj, gp_j)):
        cf = pkg.covfunc
        k = cf.SquaredExponential(1.0, 2.0) * cf.Matern32(0.5, 3.0) \
            + cf.Constant(0.2)
        new = holder.new_kernel(k, [2.0, 3.0, 0.7, 4.0, 0.3])
        assert new.structure == k.structure
        np.testing.assert_array_equal(np.asarray(new.pars),
                                      [2.0, 3.0, 0.7, 4.0, 0.3])
