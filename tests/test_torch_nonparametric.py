"""Nonparametric VI of gpyrn_tpu_torch against
gpyrn_tpu.inference.nonparametric.

Two small models (q=1 and q=2, p=2, N ≤ 12, a constant and a zero mean)
with a mixture of k=3 components, the same numpy draws in both packages:

* ``NPVEngine.terms`` (the expected log-likelihood and log-prior per
  component, the entropy bound) and ``elbo`` at a random state,
  relative 1e-9; ``npv_elbo`` and ``ELBOaux`` give the same value;
* ``ELBOcalc`` with 5 adam iterations: the ELBO, the trajectory, the
  component means and std-devs, relative 1e-9; a resumed fit continues
  the same way;
* ``predict`` (the mixture predictive of a random state, q=1)
  relative 1e-9;
* ``resample_components`` equal to the JAX package's draws."""
import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
from gpyrn_tpu.inference import nonparametric as jnpv
from gpyrn_tpu.models import gprn as jcore
from gpyrn_tpu_torch.convert import components_from_jax
from gpyrn_tpu_torch.inference import nonparametric as tnpv
from gpyrn_tpu_torch.models import gprn as tcore

torch.set_num_threads(1)

RTOL = 1e-9
K = 3
ITERS = 5


def _case(q):
    rng = np.random.default_rng(40 + q)
    N = 12 if q == 1 else 10
    t = np.sort(rng.uniform(0, 30, N))
    data = []
    for i in range(2):
        data += [np.sin(2 * np.pi * t / (8 + 3 * i)) + 0.2 * i
                 + 0.1 * rng.standard_normal(N), np.full(N, 0.1)]
    cf, mf = gj.covfunc, gj.meanfunc
    nodes = [cf.Periodic(1.0, 8.0, 0.6), cf.Matern52(1.0, 5.0)][:q]
    weights = [cf.SquaredExponential(1.0 + 0.05 * j, 6.0 + j)
               for j in range(2 * q)]
    comps = (nodes, weights, [mf.Constant(0.2), None], [0.1, 0.12])
    return (jnpv.inference(q, t, K, *data),
            tnpv.inference(q, t, K, *data, device="cpu"), comps)


@pytest.fixture(scope="module", params=[1, 2], ids=["q1", "q2"])
def case(request):
    jg, tg, comps = _case(request.param)
    port_comps = components_from_jax(*comps)
    rng = np.random.default_rng(7)
    mu = 0.3 * rng.standard_normal((K, jg.d))
    logs = np.log([0.2, 0.3, 0.5])
    spec = jcore.spec_from_components(comps[0], comps[1], comps[2], jg.N)
    theta = jcore.pack_parameters(*comps)
    jeng = jnpv.make_npv_engine(spec, K)
    args = (theta, jg.time, jg.y, jg.yerr2, mu, logs)
    ref = {"terms": [np.asarray(a) for a in jeng.terms(*args)],
           "elbo": float(jeng.elbo(*args)),
           "calc": jg.ELBOcalc(*comps, iterations=ITERS, seed=2),
           "traj": np.asarray(jg._traj)}
    ref["resumed"] = jg.ELBOcalc(*comps, iterations=ITERS,
                                 mu=ref["calc"][1], var=ref["calc"][2])
    return {"jg": jg, "tg": tg, "comps": port_comps, "jax_comps": comps,
            "mu": mu, "logs": logs, "ref": ref}


def test_terms_and_elbo_match_jax(case):
    """Per-component log-likelihood and log-prior, the entropy bound and
    the ELBO, relative 1e-9; ``npv_elbo`` and ``ELBOaux`` agree."""
    tg, comps = case["tg"], case["comps"]
    spec = tcore.spec_from_components(comps[0], comps[1], comps[2], tg.N)
    theta = tg._tensor(tcore.pack_parameters(*comps))
    eng = tnpv.make_npv_engine(spec, K)
    args = (theta, *tg._data(), tg._tensor(case["mu"]),
            tg._tensor(case["logs"]))
    ll, lp, ent = (a.numpy() for a in eng.terms(*args))
    ll_j, lp_j, ent_j = case["ref"]["terms"]
    assert ll.shape == (K,) and lp.shape == (K,)
    np.testing.assert_allclose(ll, ll_j, rtol=RTOL)
    np.testing.assert_allclose(lp, lp_j, rtol=RTOL)
    np.testing.assert_allclose(ent, ent_j, rtol=RTOL)
    elbo = float(eng.elbo(*args))
    assert abs(elbo - case["ref"]["elbo"]) <= RTOL * abs(case["ref"]["elbo"])
    assert float(tnpv.npv_elbo(spec, *args, K)) == elbo
    aux = tg.ELBOaux(*comps, case["mu"], np.exp(case["logs"]))
    assert abs(aux - elbo) <= 1e-12 * abs(elbo)


def test_elbocalc_matches_jax(case):
    """5 adam iterations from numpy's draws: the ELBO, the trajectory,
    the means and std-devs relative 1e-9; a resumed fit as well."""
    tg, comps, ref = case["tg"], case["comps"], case["ref"]
    elbo, mu, std = tg.ELBOcalc(*comps, iterations=ITERS, seed=2)
    elbo_j, mu_j, std_j = ref["calc"]
    assert mu.shape == (K, tg.d) and std.shape == (K,)
    assert abs(elbo - elbo_j) <= RTOL * abs(elbo_j)
    np.testing.assert_allclose(tg._traj, ref["traj"], rtol=RTOL)
    np.testing.assert_allclose(mu, mu_j, rtol=RTOL,
                               atol=RTOL * np.max(np.abs(mu_j)))
    np.testing.assert_allclose(std, std_j, rtol=RTOL)
    elbo2, mu2, std2 = tg.ELBOcalc(*comps, iterations=ITERS, mu=mu, var=std)
    assert abs(elbo2 - ref["resumed"][0]) <= RTOL * abs(ref["resumed"][0])
    np.testing.assert_allclose(std2, ref["resumed"][2], rtol=RTOL)


def test_predict_matches_jax():
    """The mixture predictive of a random state (q=1): relative 1e-9."""
    jg, tg, comps = _case(1)
    rng = np.random.default_rng(8)
    mu = 0.3 * rng.standard_normal((K, jg.d))
    std = np.array([0.2, 0.3, 0.5])
    ts_j, mean_j, std_j = jg.predict(*comps, mu, std, nn=7)
    tstar, mean, sd = tg.predict(*components_from_jax(*comps), mu, std, nn=7)
    np.testing.assert_array_equal(tstar, ts_j)
    assert mean.shape == (7, 2) and isinstance(mean, np.ndarray)
    np.testing.assert_allclose(mean, mean_j, rtol=RTOL,
                               atol=RTOL * np.max(np.abs(mean_j)))
    np.testing.assert_allclose(sd, std_j, rtol=RTOL)


def test_resample_components_matches_jax(case):
    """Components 0 and 2 collapsed onto one mode: component 2 is
    re-seeded with the JAX package's draws."""
    jg, tg = case["jg"], case["tg"]
    mu = case["mu"].copy()
    mu[2] = mu[0] + 1e-6
    var = np.array([0.2, 0.3, 0.5])
    got = tg.resample_components(mu, var, seed=5)
    want = jg.resample_components(mu, var, seed=5)
    assert got[2] == want[2] == 1
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_sample_from_a_kernel_matches_jax(case):
    """A draw from the first node's GP prior with numpy's generator:
    relative 1e-9."""
    a = case["tg"].sampleIt(case["comps"][0][0],
                            rng=np.random.default_rng(3))
    b = case["jg"].sampleIt(case["jax_comps"][0][0],
                            rng=np.random.default_rng(3))
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.max(np.abs(b)))
