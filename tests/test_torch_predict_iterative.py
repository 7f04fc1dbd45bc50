"""Matrix-free prediction and prior samples of gpyrn_tpu_torch against
gpyrn_tpu.models.iterative.

For (q, p) = (1, 3) and (2, 2) at N=30, float64, the JAX package fits the
variational state (its ``ELBOcalc``) and the port predicts from that same
state (``inference_from_jax``):

* ``predict_iterative`` (CG tol 1e-12, variances by batched solves of 7
  test points, a ragged last batch) against the JAX package's: means and
  std within 1e-8 of their max (the CG solves' accuracy), node and weight
  predictions likewise; ``variances=False`` leaves the lattice variances
  out (std is the jitter term alone);
* ``build_love(rank=12)`` / ``LovePredictor.predict``: 1e-8;
* ``sample_iterative`` with one numpy ``default_rng`` seed on both sides:
  the same draws, the samples within 1e-9 of their max;
* both against the port's dense ``predict`` (1e-6 at CG tol 1e-12 and
  rank N for LOVE); ``mesh=`` on a one-rank mesh predicts the same; no
  state raises.

The JAX package's results are kept in
``torch_predict_iterative_reference.json`` (written by
``JAX_PLATFORMS=cpu python -m tests.test_torch_predict_iterative``); the
``slow`` test ``test_reference_is_the_jax_packages`` recomputes them."""
import json
import os

import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
from gpyrn_tpu.models import iterative as jit_
from gpyrn_tpu_torch.convert import inference_from_jax
from gpyrn_tpu_torch.models import iterative as tit

from tests.torch_parallel_jobs import one_rank_mesh

torch.set_num_threads(1)

PREDICT_TOL = 1e-8
SAMPLE_TOL = 1e-9
DENSE_TOL = 1e-6
REFERENCE_RTOL = 1e-12
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "torch_predict_iterative_reference.json")
N, NN = 30, 17
CONFIGS = {"q1p3": (1, 3), "q2p2": (2, 2)}
PREDICT = {"tol": 1e-12, "rhs_chunk": 7}
LOVE = {"rank": 12, "tol": 1e-12}
SAMPLE = {"seed": 8, "n_steps": 20}


def _jax_unfitted(config):
    q, p = CONFIGS[config]
    rng = np.random.default_rng(16)
    t = np.sort(rng.uniform(0, 50, N))
    data = []
    for i in range(p):
        data += [np.sin(2 * np.pi * t / (9 + 4 * i))
                 + 0.1 * rng.standard_normal(N), np.full(N, 0.1)]
    g = gj.inference(q, t, *data)
    cf, mf = gj.covfunc, gj.meanfunc
    if q == 1:
        g.set_components([cf.QuasiPeriodic(1.0, 20.0, 13.0, 0.7)],
                         [cf.SquaredExponential(1.0, 10.0),
                          cf.Matern52(1.05, 8.0),
                          cf.SquaredExponential(1.1, 12.0)],
                         [None, mf.Linear(0.01, 0.0), None],
                         [0.1, 0.12, 0.14])
    else:
        g.set_components([cf.Periodic(1.0, 9.0, 0.6), cf.Matern52(1.0, 5.0)],
                         [cf.SquaredExponential(1.0 + 0.05 * k,
                                                5.0 + 0.5 * k)
                          for k in range(4)],
                         [mf.Linear(0.01, 0.0) for _ in range(2)],
                         [0.3, 0.32])
    return g


def _jax_model(config):
    """The JAX model at the state of a 30-sweep fit (kept even where the
    fit was cut short)."""
    g = _jax_unfitted(config)
    _, g._mu, g._var, _ = g.ELBOcalc(max_iter=30)
    return g


def _pred_dict(out):
    tstar, mean, std, (nodes, weights) = out
    return {"tstar": np.asarray(tstar).tolist(),
            "mean": np.asarray(mean).tolist(),
            "std": np.asarray(std).tolist(),
            "nodes": np.asarray(nodes).tolist(),
            "weights": np.asarray(weights).tolist()}


def _jax_reference(config):
    g = _jax_model(config)
    out = {"mu": np.asarray(g._mu).tolist(),
           "var": np.asarray(g._var).tolist()}
    out["predict"] = _pred_dict(jit_.predict_iterative(g, nn=NN, **PREDICT))
    out["love"] = _pred_dict(jit_.build_love(g, **LOVE).predict(nn=NN))
    nodes, weights = jit_.sample_iterative(
        g, rng=np.random.default_rng(SAMPLE["seed"]),
        n_steps=SAMPLE["n_steps"])
    out["sample"] = {"nodes": nodes.tolist(), "weights": weights.tolist()}
    return out


def write_reference():
    with open(REFERENCE, "w") as f:
        json.dump({c: _jax_reference(c) for c in CONFIGS}, f)


@pytest.fixture(scope="module")
def reference():
    with open(REFERENCE) as f:
        return json.load(f)


def _port_model(config, reference):
    """The port at the JAX package's fitted state."""
    g = inference_from_jax(_jax_unfitted(config), device="cpu")
    g._mu = g._tensor(reference[config]["mu"])
    g._var = g._tensor(reference[config]["var"])
    return g


@pytest.fixture(scope="module", params=list(CONFIGS))
def port(request, reference):
    return request.param, _port_model(request.param, reference)


def _close(got, want, tol):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)),
                                                    1e-300)


def _check_prediction(got, want, tol):
    tstar, mean, std, (nodes, weights) = got
    np.testing.assert_array_equal(tstar, want["tstar"])
    for value, key in ((mean, "mean"), (std, "std"), (nodes, "nodes"),
                       (weights, "weights")):
        _close(value, want[key], tol)


def test_predict_iterative_matches_jax(port, reference):
    config, g = port
    _check_prediction(tit.predict_iterative(g, nn=NN, **PREDICT),
                      reference[config]["predict"], PREDICT_TOL)
    _, mean, std, _ = tit.predict_iterative(g, nn=NN, variances=False,
                                            **PREDICT)
    _close(mean, reference[config]["predict"]["mean"], PREDICT_TOL)
    # without variances the lattice variances are 0: std is the q·jitter²
    # term alone
    jit2 = torch.as_tensor(g.jitters ** 2)
    _close(std, torch.sqrt(g.q * jit2).expand(NN, g.p), 1e-15)


def test_love_matches_jax(port, reference):
    config, g = port
    love = tit.build_love(g, **LOVE)
    _check_prediction(love.predict(nn=NN), reference[config]["love"],
                      PREDICT_TOL)


def test_sample_iterative_matches_jax(port, reference):
    config, g = port
    nodes, weights = tit.sample_iterative(
        g, rng=np.random.default_rng(SAMPLE["seed"]),
        n_steps=SAMPLE["n_steps"])
    assert isinstance(nodes, np.ndarray)
    _close(nodes, reference[config]["sample"]["nodes"], SAMPLE_TOL)
    _close(weights, reference[config]["sample"]["weights"], SAMPLE_TOL)


def test_iterative_and_love_equal_the_dense_predict(port):
    _, g = port
    tstar, mean_d, std_d, _ = g.predict(nn=NN)
    _, mean, std, _ = tit.predict_iterative(g, nn=NN, **PREDICT)
    _close(mean, mean_d, DENSE_TOL)
    _close(std, std_d, DENSE_TOL)
    _, mean, std, _ = tit.build_love(g, rank=N, tol=1e-12).predict(
        tstar=tstar)
    _close(mean, mean_d, DENSE_TOL)
    _close(std, std_d, DENSE_TOL)


def test_mesh_and_missing_state_raise(reference):
    """``mesh=`` on a one-rank mesh (every solve through
    ``cg_solve_sharded``) predicts what the unsharded call does; no state
    raises."""
    g = _port_model("q1p3", reference)
    _, mean, std, _ = tit.predict_iterative(g, nn=NN, **PREDICT)
    with one_rank_mesh() as mesh:
        _, mean_m, std_m, _ = tit.predict_iterative(g, nn=NN, mesh=mesh,
                                                    **PREDICT)
    _close(mean_m, mean, PREDICT_TOL)
    _close(std_m, std, PREDICT_TOL)
    g._mu = g._var = None
    with pytest.raises(ValueError, match="ELBOcalc"):
        tit.predict_iterative(g, nn=NN)
    with pytest.raises(ValueError, match="ELBOcalc"):
        tit.build_love(g)


@pytest.mark.slow
@pytest.mark.parametrize("config", list(CONFIGS))
def test_reference_is_the_jax_packages(config):
    with open(REFERENCE) as f:
        ref = json.load(f)[config]
    fresh = _jax_reference(config)
    np.testing.assert_allclose(fresh["mu"], ref["mu"], rtol=REFERENCE_RTOL)
    for part in ("predict", "love", "sample"):
        for key, value in fresh[part].items():
            np.testing.assert_allclose(value, ref[part][key],
                                       rtol=REFERENCE_RTOL, atol=1e-300)


if __name__ == "__main__":
    write_reference()
