"""The ensemble sampler and the priors of gpyrn_tpu_torch against
gpyrn_tpu.

* The priors' ``logpdf`` against the JAX package's and scipy's, inside
  and at the edges of their support, on tensors of either float dtype;
  ``rvs`` and ``std`` draw what the JAX package's draw.
* ``autocorr_time`` and ``init_walkers`` (prior draws, the ellipsoid with
  its infinite-std fallback and out-of-support redraws, a 2-D start)
  against the JAX package's.
* ``mcmc`` with scipy priors runs the host loop, and on a small model
  (q=1, p=1, N=16) gives the JAX host loop's chain: positions and
  log-probabilities to 1e-8, the same acceptance, one prior with a
  bounded support so that some proposals skip their fit.
* One half-step of the device chain fed the host loop's draws gives the
  host loop's result; the device chain runs with the port's priors and
  is reproducible from its seed.
* ``EnsembleResult`` files load in either package; the modes that are
  not ported raise."""
import numpy as np
import pytest
import scipy.stats as st
import torch

import gpyrn_tpu as gj
from gpyrn_tpu.inference import ensemble as jens
from gpyrn_tpu.inference import priors as jpri
from gpyrn_tpu_torch.convert import inference_from_jax
from gpyrn_tpu_torch.inference import ensemble as tens
from gpyrn_tpu_torch.inference import priors as tpri

torch.set_num_threads(1)

TOL = 1e-8

PRIORS = [
    ("Normal", (0.5, 2.0), st.norm(0.5, 2.0), (-np.inf, np.inf)),
    ("LogNormal", (0.3, 0.7), st.lognorm(s=0.7, scale=np.exp(0.3)),
     (0.0, np.inf)),
    ("Uniform", (-1.0, 3.0), st.uniform(-1.0, 4.0), (-1.0, 3.0)),
    ("HalfNormal", (1.5,), st.halfnorm(scale=1.5), (0.0, np.inf)),
    ("Gamma", (2.5, 0.8), st.gamma(2.5, scale=0.8), (0.0, np.inf)),
    ("InvGamma", (3.0, 2.0), st.invgamma(3.0, scale=2.0), (0.0, np.inf)),
    ("Jeffreys", (0.5, 20.0), st.loguniform(0.5, 20.0), (0.5, 20.0)),
]


def _points(lo, hi):
    """Inside the support, on its edges, just outside them."""
    inner = [-3.0, -0.2, 1e-3, 0.4, 1.0, 2.5, 7.0, 19.0, 60.0]
    edges = [e for e in (lo, hi) if np.isfinite(e)]
    # (no subnormal point: XLA's CPU flushes those to 0)
    outside = [lo - 1e-9 * max(1.0, abs(lo))] if np.isfinite(lo) else []
    outside += [hi + 1e-9 * max(1.0, abs(hi))] if np.isfinite(hi) else []
    return np.array(inner + edges + outside)


@pytest.mark.parametrize("name,args,ref,support", PRIORS,
                         ids=[p[0] for p in PRIORS])
def test_prior_logpdf_matches_jax_and_scipy(name, args, ref, support):
    x = _points(*support)
    got = getattr(tpri, name)(*args).logpdf(torch.tensor(x)).numpy()
    want = np.asarray(getattr(jpri, name)(*args).logpdf(x))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    # scipy: the same support, the same density inside it (at the edges
    # scipy and the JAX package may treat a boundary differently)
    lo, hi = support
    inside = (x > lo) & (x < hi)
    sp = ref.logpdf(x)
    np.testing.assert_allclose(got[inside], sp[inside], rtol=1e-10)
    assert np.all(got[(x < lo) | (x > hi)] == -np.inf)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_prior_logpdf_keeps_dtype_and_takes_numpy(dtype):
    x = torch.tensor([0.5, 2.0, -1.0], dtype=dtype)
    for name, args, _, _ in PRIORS:
        prior = getattr(tpri, name)(*args)
        lp = prior.logpdf(x)
        assert lp.dtype == dtype and lp.shape == (3,)
        np.testing.assert_allclose(
            np.asarray(prior.logpdf(x.double().numpy())),
            prior.logpdf(x.double()).numpy())


@pytest.mark.parametrize("name,args,ref,support", PRIORS,
                         ids=[p[0] for p in PRIORS])
def test_prior_rvs_and_std_match_jax(name, args, ref, support):
    port, jax_prior = getattr(tpri, name)(*args), getattr(jpri, name)(*args)
    np.testing.assert_array_equal(
        port.rvs(size=5, rng=np.random.default_rng(1)),
        jax_prior.rvs(size=5, rng=np.random.default_rng(1)))
    assert port.std() == jax_prior.std()


def test_autocorr_time_matches_jax():
    rng = np.random.default_rng(0)
    chain = np.cumsum(rng.standard_normal((300, 6, 3)), axis=0) * 0.1 + \
        rng.standard_normal((300, 6, 3))
    np.testing.assert_array_equal(tens.autocorr_time(chain),
                                  jens.autocorr_time(chain))
    np.testing.assert_array_equal(tens.autocorr_time(chain, c=3.0),
                                  jens.autocorr_time(chain, c=3.0))


class _Counted:
    """A prior whose draws are a fixed sequence (so that both packages'
    redraws can be compared), with the support x > lo."""

    def __init__(self, start, lo=-np.inf, std=np.inf):
        self.next, self.lo, self._std = start, lo, std

    def rvs(self):
        self.next += 0.125
        return self.next

    def logpdf(self, x):
        return np.where(np.asarray(x) > self.lo, 0.0, -np.inf)

    def std(self):
        return self._std


def _walker_priors():
    """A finite std, an infinite one (the fallback ball) with a support
    that the ellipsoid leaves (redraws), a finite one."""
    return {"a": _Counted(1.0, std=0.5), "b": _Counted(3.0, lo=2.9),
            "c": _Counted(0.0, lo=0.0, std=0.3)}


@pytest.mark.parametrize("p0", ["none", "ellipsoid", "rows"])
def test_init_walkers_matches_jax(p0):
    names = ["a", "b", "c"]
    start = {"none": None, "ellipsoid": np.array([1.0, 3.1, 0.05]),
             "rows": np.arange(24.0).reshape(8, 3)}[p0]
    out = []
    for module in (tens, jens):
        priors = _walker_priors()
        out.append(module.init_walkers(start, priors, names, 8,
                                       np.random.default_rng(9)))
    np.testing.assert_array_equal(out[0], out[1])
    if p0 == "ellipsoid":
        # the out-of-support redraws ran, and not for every walker
        redrawn = np.isin(out[0][:, 1], 3.0 + 0.125 * np.arange(1, 9))
        assert 0 < np.sum(redrawn) < 8


def _gprn():
    rng = np.random.default_rng(12)
    N = 16
    t = np.sort(rng.uniform(0, 30, N))
    y = np.sin(2 * np.pi * t / 10) + 0.1 * rng.standard_normal(N)
    g = gj.inference(1, t, y, np.full(N, 0.1))
    g.set_components([gj.covfunc.Periodic(1.0, 10.0, 0.5)],
                     [gj.covfunc.SquaredExponential(1.0, 5.0)], [None],
                     [0.1])
    return g


def _scipy_priors(g):
    priors = {n: st.lognorm(s=0.3, scale=v)
              for n, v in g.parameters_dict.items()}
    # a bounded support: some proposals fall outside and skip their fit
    priors["jitter1"] = st.uniform(0.05, 0.1)
    return priors


MCMC = {"niter": 3, "elbo_max_iter": 20, "seed": 4}


@pytest.fixture(scope="module")
def host_chains():
    g = _gprn()
    port = inference_from_jax(g, device="cpu")
    p0 = g.get_parameters()
    return g.mcmc(_scipy_priors(g), p0=p0, **MCMC), \
        port.mcmc(_scipy_priors(g), p0=p0, **MCMC)


def test_host_loop_matches_jax(host_chains):
    ref, got = host_chains
    assert got.chain.shape == ref.chain.shape == (3, 12, 6)
    np.testing.assert_allclose(got.chain, ref.chain, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.log_prob, ref.log_prob, rtol=TOL)
    np.testing.assert_allclose(got.elbo, ref.elbo, rtol=TOL)
    assert got.acceptance == ref.acceptance
    assert got.parameter_names == ref.parameter_names
    assert got.converged == ref.converged is False


def test_ensemble_result_files_load_in_both(host_chains, tmp_path):
    ref, got = host_chains
    for result, loader in ((got, jens.EnsembleResult),
                           (ref, tens.EnsembleResult)):
        path = str(tmp_path / f"{type(result).__module__}.npz")
        result.save(path)
        back = loader.load(path[:-4])          # savez appended .npz
        np.testing.assert_array_equal(back.chain, result.chain)
        np.testing.assert_array_equal(back.log_prob, result.log_prob)
        np.testing.assert_array_equal(back.elbo, result.elbo)
        assert back.parameter_names == list(result.parameter_names)
        assert back.acceptance == result.acceptance
        assert back.get_chain(flat=True).shape == (36, 6)


def _port_priors(g):
    priors = {n: tpri.LogNormal(np.log(v), 0.3)
              for n, v in g.parameters_dict.items()}
    priors["jitter1"] = tpri.Uniform(0.05, 0.15)
    return priors


def test_device_half_step_matches_host_loop():
    """Both half-steps of the first step, fed the host loop's draws, give
    the host loop's walkers, log-probabilities and ELBOs."""
    g = _gprn()
    port = inference_from_jax(g, device="cpu")
    priors, names = _port_priors(g), list(port.parameters_dict)
    seed, nwalkers, ndim = 6, 12, 6
    host = tens.run_ensemble(port, priors, names, p0=g.get_parameters(),
                             niter=1, elbo_max_iter=20, seed=seed,
                             device_chain=False)

    rng = np.random.default_rng(seed)
    x = tens.init_walkers(g.get_parameters(), priors, names, nwalkers, rng)
    theta = np.tile(port.get_parameters(include_frozen=True), (nwalkers, 1))
    theta[:] = x
    mu, var = port.engine.init_mu_var(port._tensor(theta),
                                      port._tensor(port.y))
    logpost = tens._logpost(port, tens._device_logprior(priors, names), 20)
    x = port._tensor(x)
    lp, elbo, mu_n, var_n, conv = logpost(x, mu, var, skip=False)
    upd = (conv & torch.isfinite(lp))[:, None]
    mu, var = torch.where(upd, mu_n, mu), torch.where(upd, var_n, var)
    half = nwalkers // 2
    sets = (torch.arange(half), torch.arange(half, nwalkers))
    accepted = 0
    for s in (0, 1):
        z = torch.tensor(((2.0 - 1.0) * rng.random(half) + 1.0) ** 2 / 2.0)
        partners = torch.tensor(rng.integers(0, half, size=half))
        u = torch.tensor(rng.random(half))
        x, lp, elbo, mu, var, acc = tens._half_step(
            logpost, x, lp, elbo, mu, var, sets[s], sets[1 - s], z, partners,
            u, ndim)
        accepted += int(acc)
    np.testing.assert_allclose(x.numpy(), host.chain[0], rtol=1e-12)
    np.testing.assert_allclose(lp.numpy(), host.log_prob[0], rtol=1e-12)
    np.testing.assert_allclose(elbo.numpy(), host.elbo[0], rtol=1e-12)
    assert accepted == round(host.acceptance * nwalkers)


def test_device_chain_runs_and_repeats(tmp_path):
    g = _gprn()
    port = inference_from_jax(g, device="cpu")
    ckpt = str(tmp_path / "chain.npz")
    runs = [port.mcmc(_port_priors(g), p0=g.get_parameters(), niter=3,
                      elbo_max_iter=15, seed=5, check_every=2,
                      checkpoint=ckpt) for _ in range(2)]
    res = runs[0]
    assert res.chain.shape == (3, 12, 6)
    assert np.all(np.isfinite(res.log_prob)) and 0 <= res.acceptance <= 1
    np.testing.assert_array_equal(runs[1].chain, res.chain)
    np.testing.assert_array_equal(runs[1].log_prob, res.log_prob)
    np.testing.assert_array_equal(tens.EnsembleResult.load(ckpt).chain,
                                  res.chain)


def test_modes_that_are_not_ported_raise():
    g = _gprn()
    port = inference_from_jax(g, device="cpu")
    priors = _port_priors(g)
    with pytest.raises(NotImplementedError, match="A10"):
        port.mcmc(priors, sampler="hmc")
    with pytest.raises(ImportError, match="emcee"):
        port.mcmc(priors, sampler="emcee")
    with pytest.raises(NotImplementedError, match="A15"):
        port.mcmc(priors, mesh=object())
    with pytest.raises(ValueError, match="missing priors"):
        port.mcmc({"node1.theta": priors["node1.theta"]})
    with pytest.raises(ValueError, match="free_names"):
        tens.run_ensemble(port, priors, ["node1.theta"])
