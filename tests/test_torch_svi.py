"""The stochastic (minibatch-over-outputs) fit of gpyrn_tpu_torch against
gpyrn_tpu.models.svi, and the shell's ``fit_method='svi'``.

A model with p=4 outputs and one node (N=24, float64, made from a seed):

* ``fit_state_svi`` fed the JAX package's subsets (``draws=``: the
  ``jax.random.choice`` draws of its step loop) against the JAX package's
  run, batch_p 1 and 2, κ 0.6: state within 1e-9·(1 + max);
* batch_p = p with κ = 0 is coordinate ascent: with the outputs drawn
  in their own order, ``fit_state_lean``'s state (the same update per
  GP) to the bit; with permuted draws, the dense ``fit_state``'s within
  1e-10 (the JAX package's own bar, tests/test_svi.py);
* the default draws: a generator on the state's device seeded with
  ``seed`` (the same seed, the same fit; a subset holds distinct
  outputs);
* ``run_svi`` installs its state; the shell's ``fit_method='svi'`` runs
  ``max_iter`` steps as its bulk; weight kernels of more than one
  structure and a batch_p outside [1, p] raise.

The JAX package compiles each SVI loop anew, so its results are kept in
``torch_svi_reference.json`` (written by ``JAX_PLATFORMS=cpu python -m
tests.test_torch_svi``); the ``slow`` test
``test_reference_is_the_jax_packages`` recomputes them."""
import json
import os

import jax
import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
from gpyrn_tpu.models import svi as jsvi
from gpyrn_tpu_torch.convert import inference_from_jax
from gpyrn_tpu_torch.models import svi as tsvi

torch.set_num_threads(1)

STATE_TOL = 1e-9
PERMUTED_TOL = 1e-10
REFERENCE_RTOL = 1e-12
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "torch_svi_reference.json")
N, P = 24, 4
RUNS = {"batch1": {"batch_p": 1, "n_steps": 8, "seed": 3},
        "batch2": {"batch_p": 2, "n_steps": 6, "seed": 5}}
T0, KAPPA = 5.0, 0.6


def _jax_model():
    rng = np.random.default_rng(4)
    t = np.sort(rng.uniform(0, 40, N))
    data = []
    for i in range(P):
        data += [np.sin(2 * np.pi * t / (8 + 2 * i))
                 + 0.1 * rng.standard_normal(N), np.full(N, 0.1)]
    g = gj.inference(1, t, *data)
    g.set_components([gj.covfunc.Periodic(1.0, 10.0, 0.6)],
                     [gj.covfunc.SquaredExponential(1.0 + 0.05 * k, 6.0)
                      for k in range(P)], [None] * P, [0.1] * P)
    return g


def _jax_args(g):
    theta = g._theta()
    mu0, var0 = g.engine.init_mu_var(theta, g.y)
    return (theta, np.asarray(g.time, dtype=float), g.y, g.yerr2,
            np.asarray(mu0), np.asarray(var0))


def _subsets(seed, n_steps, batch_p):
    """The subsets the JAX package's fit draws (models/svi.py)."""
    base = jax.random.PRNGKey(seed)
    return [np.asarray(jax.random.choice(jax.random.fold_in(base, i), P,
                                         (batch_p,), replace=False)).tolist()
            for i in range(n_steps)]


def _jax_reference():
    g = _jax_model()
    args = _jax_args(g)
    out = {}
    for run, cfg in RUNS.items():
        eng = jsvi.make_svi_fit(g.engine.spec, cfg["batch_p"])
        mu, var = eng.fit_state_svi(*args, cfg["n_steps"], cfg["seed"], T0,
                                    KAPPA)
        out[run] = {"mu": np.asarray(mu).tolist(),
                    "var": np.asarray(var).tolist(),
                    "subsets": _subsets(cfg["seed"], cfg["n_steps"],
                                        cfg["batch_p"])}
    mu, var = jsvi.run_svi(g, n_steps=5, seed=2)
    out["run_svi"] = {"mu": np.asarray(mu).tolist(),
                      "var": np.asarray(var).tolist(),
                      "subsets": _subsets(2, 5, max(1, P // 4))}
    return out


def write_reference():
    with open(REFERENCE, "w") as f:
        json.dump(_jax_reference(), f)


@pytest.fixture(scope="module")
def reference():
    with open(REFERENCE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port():
    g = inference_from_jax(_jax_model(), device="cpu")
    theta = g._theta()
    mu0, var0 = g.engine.init_mu_var(theta, g._tensor(g.y))
    return g, (theta, *g._data(), mu0, var0)


def _state_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(b)))


@pytest.mark.parametrize("run", list(RUNS))
def test_svi_on_the_jax_subsets_matches_jax(port, reference, run):
    g, args = port
    cfg, want = RUNS[run], reference[run]
    eng = tsvi.make_svi_fit(g.engine.spec, cfg["batch_p"])
    mu, var = eng.fit_state_svi(*args, cfg["n_steps"], cfg["seed"], T0,
                                KAPPA, draws=np.array(want["subsets"]))
    assert _state_err(mu, want["mu"]) <= STATE_TOL
    assert _state_err(var, want["var"]) <= STATE_TOL


def test_full_batch_without_decay_is_coordinate_ascent(port):
    g, args = port
    eng = tsvi.make_svi_fit(g.engine.spec, P)
    mu, var = eng.fit_state_svi(*args, 6, 0, T0, 0.0,
                                draws=np.tile(np.arange(P), (6, 1)))
    mu_l, var_l, it, _ = g.engine.fit_state_lean(*args, 6, 0.0)
    assert it == 6 and torch.equal(mu, mu_l) and torch.equal(var, var_l)
    mu, var = eng.fit_state_svi(*args, 6, 0, T0, 0.0)
    mu_f, var_f, _, _ = g.engine.fit_state(*args, 6, 0.0)
    assert _state_err(mu, mu_f) <= PERMUTED_TOL
    assert _state_err(var, var_f) <= PERMUTED_TOL


def test_default_draws_are_seeded_subsets(port):
    g, args = port
    draws = tsvi.device_subsets(P, 2, 7, seed=9, device="cpu")
    assert draws.shape == (7, 2)
    assert all(len(set(row.tolist())) == 2 for row in draws)
    assert torch.equal(draws, tsvi.device_subsets(P, 2, 7, 9, "cpu"))
    eng = tsvi.make_svi_fit(g.engine.spec, 2)
    a = eng.fit_state_svi(*args, 7, 9, T0, KAPPA)
    b = eng.fit_state_svi(*args, 7, 9, T0, KAPPA, draws=draws)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="draws"):
        eng.fit_state_svi(*args, 7, 9, T0, KAPPA, draws=draws[:3])


def test_run_svi_installs_the_state(reference):
    g = inference_from_jax(_jax_model(), device="cpu")
    want = reference["run_svi"]
    mu, var = tsvi.run_svi(g, n_steps=5, seed=2,
                           draws=np.array(want["subsets"]))
    assert g._mu is mu and g._var is var
    assert _state_err(mu, want["mu"]) <= STATE_TOL
    assert _state_err(var, want["var"]) <= STATE_TOL


def test_shell_fit_method_svi():
    g = inference_from_jax(_jax_model(), device="cpu")
    g.fit_method, g.svi_batch_p, g.svi_seed = 'svi', 2, 4
    elbo, mu, _, n_iter = g.ELBOcalc(precision='mixed', max_iter=6)
    assert g.mixed_info["bulk"] == "svi" and n_iter == 6 + 3
    assert np.isfinite(elbo) and g._mu is mu
    # the same settings, the same subsets: the same fit
    again = g.ELBOcalc(precision='mixed', max_iter=6)[0]
    assert again == elbo


def test_structure_and_batch_guards(port):
    g, _ = port
    spec = g.engine.spec
    mixed = spec._replace(weight_structs=(("M52",),)
                          + spec.weight_structs[1:])
    with pytest.raises(ValueError, match="one structure"):
        tsvi.make_svi_fit(mixed, 1)
    for bad in (0, P + 1):
        with pytest.raises(ValueError, match="batch_p"):
            tsvi.make_svi_fit(spec, bad)


@pytest.mark.slow
def test_reference_is_the_jax_packages():
    with open(REFERENCE) as f:
        ref = json.load(f)
    fresh = _jax_reference()
    for part, values in fresh.items():
        for key, value in values.items():
            np.testing.assert_allclose(value, ref[part][key],
                                       rtol=REFERENCE_RTOL, atol=1e-300)


if __name__ == "__main__":
    write_reference()
