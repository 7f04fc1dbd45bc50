"""The whole slice of gpyrn_tpu_torch against gpyrn_tpu, and its shell.

The JAX flagship model (2 nodes × 3 outputs, linear means) at N=48 goes
through ``inference_from_jax`` into the port on the CPU; ``ELBOcalc()``
and ``predict(nn=50)`` agree with the JAX package (ELBO relative 1e-9,
equal sweep counts, max-abs/(1 + max) ≤ 1e-8).  The port imports and
fits with jax blocked."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import gpyrn_tpu_torch as gt
from gpyrn_tpu_torch.convert import components_from_jax, inference_from_jax

ELBO_RTOL = 1e-9
STATE_TOL = 1e-8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(b)))


@pytest.fixture(scope="module")
def flagship():
    g = graft._flagship(N=48)
    port = inference_from_jax(g, device="cpu")
    jax_fit = g.ELBOcalc()
    jax_pred = g.predict(nn=50)
    return g, port, jax_fit, jax_pred


def test_inference_from_jax_copies_the_model(flagship):
    g, port, _, _ = flagship
    assert isinstance(port, gt.inference)
    assert (port.q, port.p, port.N, port.d) == (g.q, g.p, g.N, g.d)
    assert port.device == torch.device("cpu")
    np.testing.assert_array_equal(port.y, g.y)
    np.testing.assert_array_equal(port.yerr2, g.yerr2)
    np.testing.assert_array_equal(port.get_parameters(),
                                  g.get_parameters(include_frozen=True))
    assert port.engine.spec == g.engine.spec


def test_elbocalc_matches_jax(flagship):
    _, port, (e_j, mu_j, var_j, it_j), _ = flagship
    elbo, mu, var, n_iter = port.ELBOcalc()
    assert n_iter == it_j
    assert abs(elbo - e_j) <= ELBO_RTOL * abs(e_j)
    assert mu.dtype == torch.float64 and mu.device.type == "cpu"
    assert _state_err(mu.numpy(), mu_j) <= STATE_TOL
    assert _state_err(var.numpy(), var_j) <= STATE_TOL
    assert port.elbo_history.shape == (n_iter,)
    # a converged fit is cached for 'previous' and for predict
    assert port._mu is mu


def test_predict_matches_jax(flagship):
    _, port, _, (ts_j, mean_j, std_j, (nodes_j, weights_j)) = flagship
    if port._mu is None:
        port.ELBOcalc()
    tstar, mean, std, (nodes, weights) = port.predict(nn=50)
    np.testing.assert_array_equal(tstar, ts_j)
    assert mean.shape == (50, 3) and std.shape == (50, 3)
    for got, ref in ((mean, mean_j), (std, std_j), (nodes, nodes_j),
                     (weights, weights_j)):
        assert _state_err(got.numpy(), ref) <= STATE_TOL


def test_transferred_state_predicts_like_jax(flagship):
    """The cached variational state travels with the model."""
    g, _, _, (_, mean_j, std_j, _) = flagship
    port = inference_from_jax(g, device="cpu")
    np.testing.assert_array_equal(port._mu.numpy(), np.asarray(g._mu))
    _, mean, std, _ = port.predict(nn=50)
    assert _state_err(mean.numpy(), mean_j) <= STATE_TOL
    assert _state_err(std.numpy(), std_j) <= STATE_TOL


def test_components_from_jax_reject_unported_means(flagship):
    import gpyrn_tpu as gj
    with pytest.raises(NotImplementedError):
        components_from_jax([gj.covfunc.SquaredExponential(1.0, 2.0)],
                            [gj.covfunc.SquaredExponential(1.0, 2.0)],
                            [gj.meanfunc.Keplerian(10.0, 1.0, 0.1, 0.2,
                                                   0.0)], [0.1])


def _small(device="cpu"):
    rng = np.random.default_rng(2)
    t = np.sort(rng.uniform(0, 30, 20))
    y = np.sin(t / 3) + 0.1 * rng.standard_normal(20)
    g = gt.inference(1, t, y, np.full(20, 0.1), device=device)
    g.set_components(gt.covfunc.Periodic(1.0, 9.0, 0.6),
                     gt.covfunc.SquaredExponential(1.0, 8.0),
                     gt.meanfunc.Constant(0.0), 0.1)
    return g


def test_shell_invariants():
    t = np.arange(5.0)
    with pytest.raises(ValueError):
        gt.inference(1, t, t, device="cpu")        # odd number of arrays
    with pytest.raises(ValueError):
        gt.inference(1, t, t, t[:3], device="cpu")  # wrong lengths
    g = gt.inference(2, t, t, t, t, t, device="cpu")
    with pytest.raises(ValueError):
        g.ELBOcalc()                               # no components yet
    se = gt.covfunc.SquaredExponential(1.0, 2.0)
    with pytest.raises(ValueError):
        g.set_components([se], [se] * 4, None, [0.1, 0.1])
    with pytest.raises(ValueError):
        g.set_components([se, se], [se] * 3, None, [0.1, 0.1])
    g.set_components([se, se], [se] * 4, gt.meanfunc.Constant(0.0),
                     [0.1, 0.1])
    assert len(g.means) == 2                       # one mean broadcasts


def test_parameters_round_trip():
    g = _small()
    p = g.get_parameters()
    assert p.size == g.n_parameters == 3 + 2 + 1 + 1
    g.set_parameters(p * 2)
    np.testing.assert_array_equal(g.get_parameters(), p * 2)
    np.testing.assert_array_equal(g.jitters, [0.2])
    with pytest.raises(ValueError):
        g.set_parameters(p[:-1])


def test_starting_states_and_precision():
    g = _small()
    g.generator.manual_seed(5)
    # the modes of the mixed fit that are still to be ported say where
    for attr, value in (("fit_method", "cg"), ("fit_method", "svi"),
                        ("refine_method", "df64")):
        setattr(g, attr, value)
        with pytest.raises(NotImplementedError, match="ROADMAP A1[23]"):
            g.ELBOcalc(precision='mixed')
        setattr(g, attr, {"fit_method": "dense",
                          "refine_method": "auto"}[attr])
    with pytest.raises(ValueError, match="precision"):
        g.ELBOcalc(precision='float32')
    e_init, *_ = g.ELBOcalc(max_iter=3)
    assert g._mu is None                           # not converged: no cache
    e1, mu1, _, it1 = g.ELBOcalc(mu='random', var='random', max_iter=3)
    g.generator.manual_seed(5)
    e2, mu2, _, _ = g.ELBOcalc(mu='random', var='random', max_iter=3)
    assert e1 == e2 and torch.equal(mu1, mu2)      # seeded generator
    e, mu, var, it = g.ELBOcalc()
    assert g._mu is mu and np.isfinite(e)
    e_prev, *_ = g.ELBOcalc(mu='previous', var='previous')
    assert np.isfinite(e_prev)
    assert g.ELBO == e
    with pytest.raises(ValueError):
        g.ELBOcalc(mu='bogus', var='bogus')


def test_imports_and_fits_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.path.insert(0, sys.argv[1])
        import numpy as np
        import gpyrn_tpu_torch as gt
        from gpyrn_tpu_torch import convert
        from gpyrn_tpu_torch.ops import cuda_kernels, _build
        from gpyrn_tpu_torch.inference import (ensemble, evidence,
                                               neldermead, priors)
        t = np.linspace(0, 20, 12)
        g = gt.inference(1, t, np.sin(t), np.full(12, 0.1), device="cpu")
        g.set_components(gt.covfunc.SquaredExponential(1.0, 5.0),
                         gt.covfunc.SquaredExponential(1.0, 8.0),
                         None, 0.1)
        elbo, mu, var, n_iter = g.ELBOcalc()
        assert np.isfinite(elbo) and n_iter > 0
        assert not any(m.split(".")[0] in ("jax", "gpyrn_tpu")
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code, REPO],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_components_from_jax_carry_structures_and_values():
    import gpyrn_tpu as gj
    obsid = np.r_[np.ones(5), 2 * np.ones(6)]
    time = np.linspace(0.0, 20.0, obsid.size)
    nodes = [gj.covfunc.QuasiHarmonicPeriodic(3, 1.0, 15.0, 9.0, 0.8)
             * gj.covfunc.Constant(0.9)]
    weights = [gj.covfunc.Derivative(gj.covfunc.SquaredExponential(1.0, 4.0))
               + gj.covfunc.RQP(1.0, 1.2, 15.0, 9.0, 0.8)]
    means = [gj.meanfunc.MultiConstant([0.3, 1.1], obsid, time)
             + gj.meanfunc.Sine(0.2, 15.0, 0.1)]
    n_t, w_t, m_t, j_t = components_from_jax(nodes, weights, means, [0.1])
    for a, b in zip(n_t + w_t + m_t, nodes + weights + means):
        assert a.structure == b.structure
        np.testing.assert_array_equal(a.pars, b.pars)
    np.testing.assert_array_equal(j_t, [0.1])
    np.testing.assert_array_equal(n_t[0].core_params(),
                                  np.asarray(nodes[0].core_params()))
