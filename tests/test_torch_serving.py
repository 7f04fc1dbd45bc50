"""The served posterior predictive of gpyrn_tpu_torch (``serving.py``)
against the port's ``predict`` and the JAX package's artifact.

A JAX model (N=40, q=1, p=2, a QuasiPeriodic node, SquaredExponential
weights, Linear and Constant means) with its heuristic variational state
goes into the port through ``inference_from_jax``; float64 on the CPU:

* the artifact with a symbolic request size serves n* ∈ {1, 13, 40} and
  equals the port's ``predict`` (rtol 1e-12, the same operations) and the
  JAX package's exported artifact (1e-9 of max |ref|);
* the exported graph holds B1 as the custom operator
  ``gpyrn_torch::kernel_matrix_stack``, also after a save and a load;
* ``n_star=`` pins the size; a float32 artifact warns once on a float64
  request and stays within the JAX package's bar for it (rtol and atol
  5e-4 against float64);
* a model with a ``MultiConstant`` and a ``Keplerian`` mean served at
  n* = N (where ``predict`` indexes the training instruments) and n* ≠ N
  equals the JAX artifact, which takes the time bins at any symbolic size;
* a fresh process serves the artifact with neither the shell nor the
  engine (nor jax) imported; it starts as soon as the artifact is written
  and runs beside the other tests.

The JAX package compiles its artifact anew for every request size, so
its outputs are kept in ``torch_serving_reference.json`` (written by
``JAX_PLATFORMS=cpu python -m tests.test_torch_serving``); the ``slow``
test ``test_reference_is_the_jax_packages`` exports and serves the JAX
artifacts again and holds the file to them."""
import json
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
from gpyrn_tpu_torch import serving
from gpyrn_tpu_torch.convert import inference_from_jax

torch.set_num_threads(1)

RTOL = 1e-12
JAX_RTOL = 1e-9
F32_TOL = 5e-4
REFERENCE_RTOL = 1e-12
N = 40
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "torch_serving_reference.json")
# the request sizes of each model's JAX artifact in the reference
REQUESTS = {"served": (1, 13, N), "rv": (N, N + 3)}
FRESH_N = 17


def _with_state(g):
    """A cheap variational state, as the JAX package's serving tests use:
    the heuristic start."""
    mu, var = g.engine.init_mu_var(g._theta(), g.y)
    g._mu, g._var = np.asarray(mu), np.asarray(var)
    return inference_from_jax(g, device="cpu")


def _data(seed=1):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 40, N))
    data = []
    for i in range(2):
        data += [np.sin(2 * np.pi * t / (9 + 4 * i))
                 + 0.1 * rng.standard_normal(N), np.full(N, 0.1)]
    return t, data


def _jax_model():
    t, data = _data()
    g = gj.inference(1, t, *data)
    g.set_components(gj.covfunc.QuasiPeriodic(1.0, 20.0, 13.0, 0.7),
                     [gj.covfunc.SquaredExponential(1.0, 10.0),
                      gj.covfunc.SquaredExponential(1.1, 12.0)],
                     [gj.meanfunc.Linear(0.01, 0.1),
                      gj.meanfunc.Constant(0.2)], [0.1, 0.12])
    return g


def _jax_rv_model():
    t, data = _data(2)
    obsid = np.r_[np.ones(18), 2 * np.ones(N - 18)]
    g = gj.inference(1, t, *data)
    g.set_components(gj.covfunc.SquaredExponential(1.0, 10.0),
                     [gj.covfunc.SquaredExponential(1.0, 12.0)] * 2,
                     [gj.meanfunc.MultiConstant([0.3, 0.1], obsid, t)
                      + gj.meanfunc.Keplerian(11.0, 0.5, 0.2, 0.4, 1.0),
                      gj.meanfunc.Constant(0.0)], [0.1, 0.1])
    return g


def _requests(g, n):
    return np.linspace(float(np.min(g.time)) - 5, float(np.max(g.time)) + 5,
                       n)


def _max_rel(got, ref):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _jax_reference():
    from gpyrn_tpu import serving as jserving
    out = {}
    for name, model in (("served", _jax_model), ("rv", _jax_rv_model)):
        g = model()
        _with_state(g)
        serve = jserving.ServingPredictor(jserving.export_predict(g))
        out[name] = {str(n): [np.asarray(o).tolist()
                              for o in serve(_requests(g, n))]
                     for n in REQUESTS[name]}
    return out


def write_reference():
    with open(REFERENCE, "w") as f:
        json.dump(_jax_reference(), f)


@pytest.fixture(scope="module")
def reference():
    with open(REFERENCE) as f:
        return json.load(f)


_FRESH = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    from gpyrn_tpu_torch.serving import load_predict
    out = load_predict(sys.argv[2])(np.load(sys.argv[3]))
    np.savez(sys.argv[4], *[o.numpy() for o in out])
    loaded = [m for m in sys.modules if m.startswith(
        ("gpyrn_tpu_torch.inference", "gpyrn_tpu_torch.models",
         "gpyrn_tpu."))]
    assert not loaded, loaded
    print("ok")
""")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The exported model, its artifact, the loaded predictor, and a fresh
    serving process started on the artifact (checked by
    ``test_fresh_process_serves_without_shell_or_engine``)."""
    g = _with_state(_jax_model())
    tmp = tmp_path_factory.mktemp("serving")
    path = str(tmp / "predict.pt2")
    nbytes = g.export_predict(path)
    fresh = {"tstar": _requests(g, FRESH_N), "out": str(tmp / "out.npz")}
    np.save(tmp / "tstar.npy", fresh["tstar"])
    fresh["proc"] = subprocess.Popen(
        [sys.executable, "-c", _FRESH, REPO, path, str(tmp / "tstar.npy"),
         fresh["out"]], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield g, path, nbytes, serving.load_predict(path), fresh
    if fresh["proc"].poll() is None:
        fresh["proc"].kill()
        fresh["proc"].communicate()


def _local(g, tstar):
    mean, var, (npred, wpred) = g._Prediction(tstar=tstar, separate=True)
    return mean, var, npred, wpred


def test_export_requires_state():
    g = inference_from_jax(_jax_model(), device="cpu")
    with pytest.raises(ValueError, match="fitted variational state"):
        serving.export_predict(g)


@pytest.mark.parametrize("n", [1, 13, N])
def test_symbolic_round_trip_matches_predict(served, n):
    g, _, _, serve, _ = served
    tstar = _requests(g, n)
    out = serve(tstar)
    assert [tuple(o.shape) for o in out] == [(n, 2), (n, 2), (1, n), (2, n)]
    assert all(o.dtype == torch.float64 and o.device.type == "cpu"
               for o in out)
    for got, ref in zip(out, _local(g, tstar)):
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("n", REQUESTS["served"])
def test_matches_the_jax_artifact(served, reference, n):
    g, _, _, serve, _ = served
    tstar = _requests(g, n)
    for got, ref in zip(serve(tstar), reference["served"][str(n)]):
        assert _max_rel(got.numpy(), ref) <= JAX_RTOL


def test_b1_is_one_operator_of_the_graph(served):
    g, path, nbytes, serve, _ = served
    assert nbytes == os.path.getsize(path) > 0
    op = torch.ops.gpyrn_torch.kernel_matrix_stack.default
    loaded = [n for n in serve.program.graph.nodes if n.target is op]
    assert len(loaded) == 1
    assert serve.dtype == torch.float64
    assert serve.device == torch.device("cpu")


def test_load_from_bytes_and_onto_a_device(served):
    # the artifact serves on the device it was exported on, whatever the
    # request's: a file and its bytes load the same program
    g, path, _, serve, _ = served
    tstar = _requests(g, 7)
    with open(path, "rb") as fh:
        other = serving.load_predict(fh.read())
    assert other.device == torch.device("cpu")
    for got, ref in zip(other(torch.as_tensor(tstar)), serve(tstar)):
        assert got.device == torch.device("cpu")
        assert torch.equal(got, ref)


def test_fixed_shape_export(served):
    g = served[0]
    # the shell without a file name hands back the program itself
    program = g.export_predict(n_star=11)
    assert isinstance(program, torch.export.ExportedProgram)
    serve = serving.ServingPredictor(program)
    tstar = _requests(g, 11)
    for got, ref in zip(serve(tstar), _local(g, tstar)):
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=RTOL)
    with pytest.raises(Exception):
        serve(_requests(g, 12))


def test_f32_export_dtype(served):
    g = served[0]
    serve = serving.ServingPredictor(serving.export_predict(
        g, dtype=torch.float32))
    assert serve.dtype == torch.float32
    tstar = _requests(g, 9)
    with pytest.warns(UserWarning, match="narrowed to the artifact's"):
        mean, var = serve(tstar)[:2]
    assert mean.dtype == torch.float32
    mean_r, var_r = g._Prediction(tstar=tstar)
    np.testing.assert_allclose(mean.numpy(), mean_r.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(var.numpy(), var_r.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        serve(tstar.astype(np.float32))


def test_multiconstant_and_keplerian_served_like_jax(reference):
    g = _with_state(_jax_rv_model())
    serve = serving.ServingPredictor(serving.export_predict(g))
    for n in REQUESTS["rv"]:
        tstar = _requests(g, n)
        for got, ref in zip(serve(tstar), reference["rv"][str(n)]):
            assert _max_rel(got.numpy(), ref) <= JAX_RTOL
    # away from the training size the artifact is the engine's predict
    tstar = _requests(g, N + 3)
    for got, ref in zip(serve(tstar), _local(g, tstar)):
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=RTOL)


def test_fresh_process_serves_without_shell_or_engine(served):
    g, _, _, _, fresh = served
    stdout, stderr = fresh["proc"].communicate(timeout=300)
    assert fresh["proc"].returncode == 0, stderr[-3000:]
    assert stdout.strip().endswith("ok")
    got = np.load(fresh["out"])
    for i, ref in enumerate(_local(g, fresh["tstar"])):
        np.testing.assert_allclose(got[f"arr_{i}"], ref.numpy(), rtol=RTOL,
                                   atol=RTOL)


@pytest.mark.slow
def test_reference_is_the_jax_packages():
    """The cached outputs are what the JAX package's artifacts serve now."""
    with open(REFERENCE) as f:
        ref = json.load(f)
    fresh = _jax_reference()
    assert fresh.keys() == ref.keys()
    for name, requests in fresh.items():
        assert requests.keys() == ref[name].keys()
        for n, outputs in requests.items():
            for got, want in zip(outputs, ref[name][n]):
                np.testing.assert_allclose(got, want, rtol=REFERENCE_RTOL,
                                           atol=1e-300)


if __name__ == "__main__":
    write_reference()
