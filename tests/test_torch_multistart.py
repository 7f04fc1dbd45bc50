"""The multi-start population of gpyrn_tpu_torch against
gpyrn_tpu.parallel.multistart.

A small model (q=1, p=2, N=14, one frozen parameter) runs
``multistart_optimize`` with 3 restarts and 3 steps in both packages
(the inits come from numpy, so both populations start alike):

* ``method='adam'`` (2 sweeps per gradient): per-restart best ELBOs and
  the converged ELBO at the winner relative 1e-9, the winner's θ
  relative 1e-7, the same winning restart, the frozen entry untouched;
* ``method='nm'`` (2 sweeps per objective): the same, and equal ``nit``
  and ``converged``.

The JAX package compiles each population anew (over a minute of worker
time under the tier-1 run's six workers), so its results are kept in
``torch_multistart_reference.json`` (written by ``JAX_PLATFORMS=cpu
python -m tests.test_torch_multistart``); the ``slow`` test
``test_reference_is_the_jax_packages`` recomputes them with the JAX
package and holds the file to them.

``mesh=`` on a one-rank mesh runs the unsharded population."""
import json
import os

import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
from gpyrn_tpu.parallel import multistart as jms
from gpyrn_tpu_torch.convert import inference_from_jax
from gpyrn_tpu_torch.parallel import multistart as tms

from tests.torch_parallel_jobs import one_rank_mesh

torch.set_num_threads(1)

ELBO_RTOL = 1e-9
THETA_RTOL = 1e-7
# the cached JAX results against a fresh JAX computation
REFERENCE_RTOL = 1e-12
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "torch_multistart_reference.json")
SETTINGS = {"n_restarts": 3, "n_steps": 3, "n_sweeps": 2, "seed": 4}
METHODS = ("adam", "nm")


def _jax_model():
    rng = np.random.default_rng(12)
    N = 14
    t = np.sort(rng.uniform(0, 40, N))
    data = []
    for i in range(2):
        data += [np.sin(2 * np.pi * t / (9 + 4 * i))
                 + 0.1 * rng.standard_normal(N), np.full(N, 0.1)]
    g = gj.inference(1, t, *data)
    g.set_components([gj.covfunc.Periodic(1.0, 9.0, 0.6)],
                     [gj.covfunc.SquaredExponential(1.0 + 0.05 * k, 8.0 + k)
                      for k in range(2)], [None, None], [0.1, 0.12])
    g.freeze_parameter(name="node1.P")
    return g


def _jax_reference(method):
    """The JAX package's ``multistart_optimize`` result, as lists."""
    res = jms.multistart_optimize(_jax_model(), method=method, **SETTINGS)
    return {k: np.asarray(v).tolist() for k, v in res.items()}


def write_reference():
    with open(REFERENCE, "w") as f:
        json.dump({m: _jax_reference(m) for m in METHODS}, f)
        f.write("\n")


@pytest.fixture(scope="module", params=METHODS)
def case(request):
    method = request.param
    with open(REFERENCE) as f:
        ref = json.load(f)[method]
    port = inference_from_jax(_jax_model(), device="cpu")
    theta0 = port.get_parameters(include_frozen=True)
    got = tms.multistart_optimize(port, method=method, **SETTINGS)
    return {"method": method, "ref": ref, "got": got, "theta0": theta0,
            "port": port, "frozen": port.frozen_mask}


def test_restart_elbos_and_winner_match_jax(case):
    """Restart ELBOs and the final ELBO relative 1e-9, the same
    winner."""
    got, ref = case["got"], case["ref"]
    assert got["restart_elbos"].shape == (SETTINGS["n_restarts"],)
    np.testing.assert_allclose(got["restart_elbos"],
                               np.asarray(ref["restart_elbos"]),
                               rtol=ELBO_RTOL)
    assert got["winner"] == ref["winner"]
    assert abs(got["elbo"] - ref["elbo"]) <= ELBO_RTOL * abs(ref["elbo"])


def test_winner_theta_matches_jax(case):
    """The winner's θ relative 1e-7, installed in the inference; the
    frozen entry keeps its value."""
    got, ref, frozen = case["got"], case["ref"], case["frozen"]
    np.testing.assert_allclose(got["theta"], np.asarray(ref["theta"]),
                               rtol=THETA_RTOL)
    np.testing.assert_array_equal(got["theta"][frozen],
                                  case["theta0"][frozen])
    np.testing.assert_array_equal(
        case["port"].get_parameters(include_frozen=True), got["theta"])


def test_population_counts_match_jax(case):
    """adam: the restarts moved from their inits; nm: equal ``nit`` and
    ``converged``."""
    got, ref = case["got"], case["ref"]
    if case["method"] == "nm":
        np.testing.assert_array_equal(got["nit"], np.asarray(ref["nit"]))
        np.testing.assert_array_equal(got["converged"],
                                      np.asarray(ref["converged"]))
    else:
        assert not np.allclose(got["theta"], case["theta0"])


@pytest.mark.slow
@pytest.mark.parametrize("method", METHODS)
def test_reference_is_the_jax_packages(method):
    """The cached results are what the JAX package computes now: ELBOs and
    θ relative 1e-12, the same winner and counts."""
    with open(REFERENCE) as f:
        ref = json.load(f)[method]
    fresh = _jax_reference(method)
    assert fresh.keys() == ref.keys()
    for key in ("elbo", "theta", "restart_elbos"):
        np.testing.assert_allclose(fresh[key], ref[key], rtol=REFERENCE_RTOL)
    for key in set(ref) - {"elbo", "theta", "restart_elbos"}:
        assert fresh[key] == ref[key], key


def test_mesh_and_unknown_method_raise():
    """``mesh=`` on a one-rank mesh runs the unsharded population; an
    unknown method raises."""
    port = inference_from_jax(_jax_model(), device="cpu")
    ref = tms.multistart_optimize(port, **SETTINGS)
    port = inference_from_jax(_jax_model(), device="cpu")
    with one_rank_mesh() as mesh:
        got = tms.multistart_optimize(port, mesh=mesh, **SETTINGS)
    np.testing.assert_allclose(got["restart_elbos"], ref["restart_elbos"],
                               rtol=1e-12)
    np.testing.assert_allclose(got["theta"], ref["theta"], rtol=1e-12)
    assert got["winner"] == ref["winner"]
    with pytest.raises(ValueError, match="unknown method"):
        tms.multistart_optimize(port, method="lbfgs")


if __name__ == "__main__":
    write_reference()
