"""The shell of the gradient path of gpyrn_tpu_torch against gpyrn_tpu.

A small model (q=1, p=2, N=40: Periodic node, SE weights, Constant and
Linear means) is built in the JAX package and carried into the port on
the CPU.  The same calls run in the same order on both
(``elbo_grad`` from the heuristic start, ``nELBO``, ``elbo_grad`` from the
cached state, three ``optimize_adam`` steps with the jitters frozen, six
Nelder-Mead iterations of ``optimize``), in float64, and agree:

* ELBO values, nELBO and the best Adam loss: relative 1e-9;
* gradients: 1e-8 of max |g|;
* the Adam and Nelder-Mead parameters: relative 1e-8 (torch.optim.Adam
  computes optax's update formula with other rounding; the Nelder-Mead
  path depends only on the objective values, equal to ~1e-12).

Parameter names, freeze/thaw (with '*' globs and ``vars=``) and the
frozen-mask rules of ``get_parameters`` / ``set_parameters`` match the
JAX package exactly.  The JAX side compiles three functions (the fit,
the value-and-gradient, the Adam step)."""
import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
import gpyrn_tpu_torch as gt
from gpyrn_tpu_torch.convert import inference_from_jax

VALUE_RTOL = 1e-9
GRAD_TOL = 1e-8
PARAM_RTOL = 1e-8
N = 40


def _jax_model():
    rng = np.random.default_rng(21)
    t = np.sort(rng.uniform(0, 40, N))
    data = []
    for i in range(2):
        data += [np.sin(2 * np.pi * t / (9 + 4 * i)) + 0.3 * i
                 + 0.1 * rng.standard_normal(N), np.full(N, 0.1)]
    g = gj.inference(1, t, *data)
    cf, mf = gj.covfunc, gj.meanfunc
    g.set_components([cf.Periodic(1.0, 9.0, 0.6)],
                     [cf.SquaredExponential(1.0, 8.0),
                      cf.SquaredExponential(1.1, 10.0)],
                     [mf.Constant(0.1), mf.Linear(0.01, 0.0)], [0.1, 0.12])
    return g


def _drive(g):
    """The same calls, in the same order, on either package."""
    out = {"grad_init": g.elbo_grad(n_sweeps=5)}
    out["nelbo"] = g.nELBO(g.get_parameters() * 1.02)
    out["grad_cached"] = g.elbo_grad(n_sweeps=5)
    out["adam"] = g.optimize_adam(vars="-jitter*", n_steps=3, n_sweeps=5)
    out["adam_mask"] = g.frozen_mask.copy()
    g.thaw_all_parameters()
    nm = g.optimize(options={"maxiter": 6})
    out["nm"] = (np.asarray(nm.x), float(nm.fun))
    out["params"] = g.get_parameters(include_frozen=True)
    return out


@pytest.fixture(scope="module")
def runs():
    g_jax = _jax_model()
    port = inference_from_jax(g_jax, device="cpu")
    return _drive(g_jax), _drive(port)


def _close(a, b, rtol):
    return abs(a - b) <= rtol * abs(b)


def _grad_close(g, g_ref):
    return np.max(np.abs(g - g_ref)) <= GRAD_TOL * np.max(np.abs(g_ref))


def test_elbo_grad_matches_jax(runs):
    ref, port = runs
    for key in ("grad_init", "grad_cached"):
        (v_j, g_j), (v, g) = ref[key], port[key]
        assert isinstance(v, float) and isinstance(g, np.ndarray)
        assert g.shape == g_j.shape
        assert _close(v, v_j, VALUE_RTOL), key
        assert _grad_close(g, g_j), key


def test_nelbo_matches_jax(runs):
    ref, port = runs
    assert _close(port["nelbo"], ref["nelbo"], VALUE_RTOL)


def test_optimize_adam_matches_jax(runs):
    ref, port = runs
    a_j, a = ref["adam"], port["adam"]
    np.testing.assert_array_equal(port["adam_mask"], ref["adam_mask"])
    assert port["adam_mask"].sum() == 2            # the two jitters
    assert a["n_steps"] == a_j["n_steps"] == 3
    assert a["x"].shape == a_j["x"].shape == (10,)
    np.testing.assert_allclose(a["x"], a_j["x"], rtol=PARAM_RTOL)
    assert _close(a["fun"], a_j["fun"], VALUE_RTOL)
    assert _close(a["elbo"], a_j["elbo"], VALUE_RTOL)


def test_optimize_matches_jax(runs):
    ref, port = runs
    (x_j, f_j), (x, f) = ref["nm"], port["nm"]
    np.testing.assert_allclose(x, x_j, rtol=PARAM_RTOL)
    assert _close(f, f_j, VALUE_RTOL)
    np.testing.assert_allclose(port["params"], ref["params"],
                               rtol=PARAM_RTOL)


def test_parameters_dict_matches_jax():
    g = _jax_model()
    port = inference_from_jax(g, device="cpu")
    assert list(port.parameters_dict) == list(g.parameters_dict)
    assert list(port.parameters_dict.values()) == \
        list(g.parameters_dict.values())


def test_freeze_and_thaw_match_jax():
    g = _jax_model()
    port = inference_from_jax(g, device="cpu")
    steps = [
        lambda x: x.freeze_parameter(name="weight*"),
        lambda x: x.thaw_parameter(name="weight2.ell"),
        lambda x: x.fix_parameter(index=0),
        lambda x: x.free_parameter(name="*.theta"),
        lambda x: x.fix_all_parameters(),
        lambda x: x.free_all_parameters(),
        lambda x: x._apply_vars_selection("node*"),
        lambda x: x._apply_vars_selection("-mean*"),
        lambda x: x._apply_vars_selection(["jitter1", "node1.P"]),
    ]
    for step in steps:
        step(g)
        step(port)
        np.testing.assert_array_equal(port.frozen_mask, g.frozen_mask)
        np.testing.assert_array_equal(port.get_parameters(),
                                      g.get_parameters())
        np.testing.assert_array_equal(
            port.get_parameters(include_frozen=True),
            g.get_parameters(include_frozen=True))
    # set_parameters takes the free subset or the full vector (frozen
    # entries keep their values)
    free = g.get_parameters()
    for x in (free * 1.5, g.get_parameters(include_frozen=True) * 0.5):
        g.set_parameters(x)
        port.set_parameters(x)
        np.testing.assert_array_equal(
            port.get_parameters(include_frozen=True),
            g.get_parameters(include_frozen=True))
    with pytest.raises(ValueError, match="expected 12 \\(all\\) or 2"):
        port.set_parameters(free[:1])


def test_frozen_mask_guards():
    port = inference_from_jax(_jax_model(), device="cpu")
    with pytest.raises(NotImplementedError):
        port.frozen_mask = np.zeros(12, dtype=bool)
    with pytest.raises(ValueError):
        port.freeze_parameter()
    with pytest.raises(ValueError, match="not found"):
        port.freeze_parameter(name="node1.bogus")
    with pytest.raises(ValueError):
        port._apply_vars_selection(3)


def test_inference_from_jax_carries_the_frozen_mask():
    g = _jax_model()
    g.freeze_parameter(name="mean*")
    port = inference_from_jax(g, device="cpu")
    np.testing.assert_array_equal(port.frozen_mask, g.frozen_mask)
    np.testing.assert_array_equal(port.get_parameters(), g.get_parameters())


def test_unported_gradient_modes_raise():
    """The gradient methods are 'unroll' and 'implicit'; anything else
    raises before any work, and so does an unknown adjoint solver."""
    port = inference_from_jax(_jax_model(), device="cpu")
    with pytest.raises(ValueError, match="method"):
        port.elbo_grad(method="bogus")
    with pytest.raises(ValueError, match="grad"):
        port.optimize_adam(grad="bogus")
    with pytest.raises(ValueError, match="adjoint"):
        port.elbo_grad(method="implicit", fit_max_iter=1, adjoint="bogus")


def test_default_device_is_the_card():
    """Without ``device=`` the inference runs on ``cuda``; building it and
    setting components touch no CUDA (no tensor is made), so a machine
    without a card can still build one."""
    t = np.linspace(0.0, 10.0, 8)
    g = gt.inference(1, t, np.sin(t), np.full(8, 0.1))
    assert g.device == torch.device("cuda")
    g.set_components(gt.covfunc.SquaredExponential(1.0, 5.0),
                     gt.covfunc.SquaredExponential(1.0, 8.0), None, 0.1)
    assert g.get_parameters().size == 5 and len(g.parameters_dict) == 5
