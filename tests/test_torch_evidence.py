"""The evidence estimators and the batched ELBO likelihood of
gpyrn_tpu_torch against gpyrn_tpu.

``batch_elbo`` (every row fitted from the heuristic start in one
``Engine.elbo_fit_batch`` call) against the JAX package's vmapped fit on
a small model (q=1, p=2, N=20): ELBO relative 1e-9; with ``mesh=`` on a
one-rank mesh, the same values.  The estimators, the
port's own copy of the JAX package's numpy code, against the JAX
package's on the same samples and the same random streams: equal."""
import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
from gpyrn_tpu.inference import evidence as jev
from gpyrn_tpu_torch.convert import inference_from_jax
from gpyrn_tpu_torch.inference import evidence as tev

from tests.torch_parallel_jobs import one_rank_mesh

torch.set_num_threads(1)


def _gprn():
    rng = np.random.default_rng(8)
    N = 20
    t = np.sort(rng.uniform(0, 40, N))
    data = []
    for i in range(2):
        data += [np.sin(2 * np.pi * t / (9 + 4 * i))
                 + 0.1 * rng.standard_normal(N), np.full(N, 0.1)]
    g = gj.inference(1, t, *data)
    cf = gj.covfunc
    g.set_components([cf.Periodic(1.0, 9.0, 0.6)],
                     [cf.SquaredExponential(1.0, 8.0),
                      cf.SquaredExponential(1.1, 10.0)],
                     [gj.meanfunc.Constant(0.1), None], [0.1, 0.12])
    return g


def test_batch_elbo_matches_jax():
    g = _gprn()
    port = inference_from_jax(g, device="cpu")
    theta0 = g.get_parameters(include_frozen=True)
    thetas = theta0 * np.exp(0.15 * np.random.default_rng(2).standard_normal(
        (5, theta0.size)))
    want = np.asarray(jev.batch_elbo(g, thetas, max_iter=40))
    got = tev.batch_elbo(port, thetas, max_iter=40)
    assert isinstance(got, np.ndarray) and got.shape == (5,)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    # one row alone: the same value as in the batch
    np.testing.assert_allclose(tev.batch_elbo(port, thetas[2], max_iter=40),
                               got[2:3], rtol=1e-12)
    # mesh=: the rows over a one-rank mesh's dp axis, the same values
    with one_rank_mesh() as mesh:
        np.testing.assert_allclose(
            tev.batch_elbo(port, thetas, max_iter=40, mesh=mesh), got,
            rtol=1e-12)


# a Gaussian likelihood and prior over 2-D parameter batches
MEAN, COV = np.array([0.3, -0.2]), np.array([[0.5, 0.1], [0.1, 0.3]])


def lnlike(x):
    d = np.atleast_2d(x) - MEAN
    return -0.5 * np.einsum("ni,ij,nj->n", d, np.linalg.inv(COV), d)


def lnprior(x):
    return -0.5 * np.sum(np.atleast_2d(x) ** 2, axis=1) / 4.0


def _samples(n=400):
    return np.random.default_rng(5).multivariate_normal(MEAN, COV, size=n)


@pytest.mark.parametrize("method", ["histogram", "kde", "normal"])
def test_perrakis_matches_jax(method):
    out = [module.compute_perrakis_estimate(
        _samples(), lnlike, lnprior, nsamples=300, densityestimation=method,
        errorestimation=True, rng=np.random.default_rng(3))
        for module in (tev, jev)]
    assert out[0] == out[1] and np.isfinite(out[0][0])


def test_harmonic_mean_and_cj_match_jax():
    post = _samples()
    ll = lnlike(post)
    modules = (tev, jev)
    hm = [m.compute_harmonicmean(ll, size=200, rng=np.random.default_rng(1))
          for m in modules]
    mc = [m.run_hme_mc(ll, 5, 100, rng=np.random.default_rng(4))
          for m in modules]
    cj = [m.compute_cj_estimate(post, lnlike, lnprior, post[:, 0], 200,
                                rng=np.random.default_rng(6))
          for m in modules]
    assert hm[0] == hm[1]
    np.testing.assert_array_equal(mc[0], mc[1])
    assert cj[0] == cj[1] and np.isfinite(cj[0])


def test_helpers_match_jax():
    x = _samples(50)
    assert tev.log_sum(x[:, 0]) == jev.log_sum(x[:, 0])
    assert tev.log_sum([]) == -np.inf
    np.testing.assert_array_equal(tev.metropolis_ratio(x[:, 0], x[:, 1]),
                                  jev.metropolis_ratio(x[:, 0], x[:, 1]))
    np.testing.assert_array_equal(
        tev.make_marginal_samples(x, 30, rng=np.random.default_rng(2)),
        jev.make_marginal_samples(x, 30, rng=np.random.default_rng(2)))
    fp_t, v_t = tev.get_fixed_point(x, x[:, 0], lnlike, lnprior)
    fp_j, v_j = jev.get_fixed_point(x, x[:, 0], lnlike, lnprior)
    np.testing.assert_array_equal(fp_t, fp_j)
    assert v_t == v_j
    q_t = tev.MultivariateGaussian(MEAN, COV, rng=np.random.default_rng(7))
    q_j = jev.MultivariateGaussian(MEAN, COV, rng=np.random.default_rng(7))
    np.testing.assert_array_equal(q_t.rvs(4), q_j.rvs(4))
    np.testing.assert_array_equal(q_t.logpdf(x), q_j.logpdf(x))
    with pytest.raises(ValueError, match="unknown density"):
        tev.estimate_density(x[:, 0], method="bogus")
