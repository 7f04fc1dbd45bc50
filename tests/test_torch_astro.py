"""utils/astro.py and the Keplerian mean of gpyrn_tpu_torch against gpyrn_tpu.

Every function of the module against its JAX counterpart on the same
numpy inputs, float64 on the CPU: ``keplerian_rv`` (and ``keplerian``) to
rtol 1e-12 for e ∈ {0, 0.3, 0.9}, also with ``phi=`` and ``gamma=`` (the
same formula step for step; the math libraries' last bits, carried
through 100 Newton steps); the numpy helpers exactly; the torch
log-density and log-sum-exp to rtol 1e-13.  The Keplerian mean's values
(rtol 1e-12) and its gradient with respect to (P, K, e, w, Tp) through
every Newton step against ``jax.grad`` (1e-10 of max |g|); ``convert``
carries a JAX ``Keplerian``, alone and inside a ``Sum``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
from gpyrn_tpu.ops import means as jm
from gpyrn_tpu.utils import astro as ja
import gpyrn_tpu_torch as gt
from gpyrn_tpu_torch.convert import components_from_jax
from gpyrn_tpu_torch.ops import means as tm
from gpyrn_tpu_torch.utils import astro as ta

torch.set_num_threads(1)

RTOL = 1e-12
GRAD_TOL = 1e-10
ECCENTRICITIES = (0.0, 0.3, 0.9)
PARS = (17.0, 1.3, 0.5, 2.0)        # P, K, w, T


def _times(n=48, seed=4):
    return np.sort(np.random.default_rng(seed).uniform(0, 60, n))


@pytest.mark.parametrize("e", ECCENTRICITIES)
@pytest.mark.parametrize("kw", [{}, {"phi": 0.7, "gamma": 0.4}])
def test_keplerian_rv_matches_jax(e, kw):
    t = _times()
    P, K, w, T = PARS
    ref = np.asarray(ja.keplerian_rv(t, P=P, K=K, e=e, w=w, T=T, **kw))
    got = ta.keplerian_rv(torch.tensor(t), P=P, K=K, e=e, w=w, T=T, **kw)
    assert got.dtype == torch.float64 and got.shape == t.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-14)
    # a numpy t and 0-d tensor parameters give the same curve
    as_tensors = {k: torch.tensor(v, dtype=torch.float64)
                  for k, v in dict(P=P, K=K, e=e, w=w, T=T).items()}
    np.testing.assert_array_equal(
        ta.keplerian_rv(t, **as_tensors, **kw).numpy(), got.numpy())
    t_out, rv = ta.keplerian(P=P, K=K, e=e, w=w, T=T, t=t, **kw)
    assert t_out is t and isinstance(rv, np.ndarray)
    np.testing.assert_array_equal(rv, got.numpy())


def test_keplerian_requires_times():
    with pytest.raises(ValueError):
        ta.keplerian()


def test_numpy_helpers_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(40)
    w = rng.uniform(0.5, 2.0, 40)
    assert ta.rms(x) == ja.rms(x)
    assert ta.wrms(x, w) == ja.wrms(x, w)
    assert ta.semi_amplitude(1.5, 0.8, 1.1, 0.2) == \
        ja.semi_amplitude(1.5, 0.8, 1.1, 0.2)
    for got, ref in zip(ta.phase_folding(x, w, None, 0.3),
                        ja.phase_folding(x, w, None, 0.3)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        ta.truncCauchy_rvs(0.1, 0.5, -1, 2, 30, np.random.default_rng(3)),
        ja.truncCauchy_rvs(0.1, 0.5, -1, 2, 30, np.random.default_rng(3)))
    d_t, d_j = ta.invGamma(1.0, 5.0), ja.invGamma(1.0, 5.0)
    assert d_t.args == d_j.args and d_t.kwds == d_j.kwds
    (r_t, label_t), (r_j, label_j) = (ta.anderson_darling_test(x),
                                      ja.anderson_darling_test(x))
    assert label_t == label_j and r_t.statistic == r_j.statistic

    class Shell:
        @ta._array_input
        def __call__(self, t):
            return t

    assert Shell()(3.0).shape == (1,)


def test_torch_helpers_match_jax():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((12, 12))
    c = a @ a.T + 12 * np.eye(12)
    r = rng.standard_normal(12)
    for method in ("cholesky", "solve"):
        np.testing.assert_allclose(ta.multivariate_normal(r, c, method),
                                   ja.multivariate_normal(r, c, method),
                                   rtol=1e-13)
    with pytest.raises(ValueError):
        ta.multivariate_normal(r, c, "lu")
    x = rng.standard_normal(30) * 50
    np.testing.assert_allclose(ta.log_sum(x), ja.log_sum(x), rtol=1e-13)
    np.testing.assert_allclose(
        ta.torch_logsumexp(torch.tensor(x)).numpy(),
        np.asarray(ja.jax_logsumexp(jnp.asarray(x))), rtol=1e-13)
    L = np.linalg.cholesky(c)
    np.testing.assert_allclose(
        ta.torch_cho_solve(torch.tensor(L), torch.tensor(r)).numpy(),
        np.asarray(ja.jax_cho_solve(jnp.asarray(L), jnp.asarray(r))),
        rtol=1e-12)


@jax.jit
@jax.grad
def _jax_mean_grad(p, t, weights):
    """The gradient of Σ weights·Kep(t; p), compiled once for every e."""
    return jnp.sum(weights * jm.evaluate(("Kep",), p, t))


@pytest.mark.parametrize("e", ECCENTRICITIES)
def test_keplerian_mean_value_and_grad_match_jax(e):
    t = _times(40, 9)
    P, K, w, T = PARS
    pars = np.array([P, K, e, w, T])
    mt, mj = gt.meanfunc.Keplerian(*pars), gj.meanfunc.Keplerian(*pars)
    assert mt.structure == mj.structure == ("Kep",)
    assert mt._param_names == mj._param_names
    np.testing.assert_allclose(mt(t).numpy(), np.asarray(mj(t)), rtol=RTOL,
                               atol=1e-14)
    weights = np.cos(t)
    ref = np.asarray(_jax_mean_grad(jnp.asarray(pars), jnp.asarray(t),
                                    jnp.asarray(weights)))
    p = torch.tensor(pars, requires_grad=True)
    loss = torch.sum(torch.tensor(weights)
                     * tm.evaluate(("Kep",), p, torch.tensor(t)))
    (got,) = torch.autograd.grad(loss, p)
    assert np.max(np.abs(got.numpy() - ref)) <= GRAD_TOL * np.max(np.abs(ref))


def test_convert_carries_keplerian():
    kep = gj.meanfunc.Keplerian(30.0, 2.0, 0.2, 1.0, 3.0)
    means = [kep, gj.meanfunc.Constant(0.5) + kep]
    se = gj.covfunc.SquaredExponential(1.0, 5.0)
    _, _, m_t, _ = components_from_jax([se], [se, se], means, [0.1, 0.1])
    assert isinstance(m_t[0], gt.meanfunc.Keplerian)
    assert isinstance(m_t[1], gt.meanfunc.Sum)
    t = _times(30, 2)
    for got, ref in zip(m_t, means):
        assert got.structure == ref.structure
        np.testing.assert_array_equal(got.pars, ref.pars)
        np.testing.assert_allclose(got(t).numpy(), np.asarray(ref(t)),
                                   rtol=RTOL, atol=1e-14)
