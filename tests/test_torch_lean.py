"""The lean engines of gpyrn_tpu_torch against gpyrn_tpu, and the shell's
route to them.

``Engine.elbo_refine_lean``, ``elbo_fit_lean``, ``fit_state_lean`` and
``fit_state_stall_lean`` (each GP's kernel matrix rebuilt inside its own
update) for (q, p) = (1, 3) (a QuasiPeriodic node, a weight with
WhiteNoise on the plain formula, Linear and Sine means) and (2, 2) (the
cumulative cross traces and the raw-flatten pairing of the weight means,
with its second rebuild pass), N=40, float64, on parameters, data and a
starting state made with numpy from a seed:

* against the JAX package: ELBO relative 1e-10, state 1e-8·(1 + max),
  equal sweep counts and flags;
* against the port's dense engine, the same map: ELBO relative 1e-12,
  state 1e-10·(1 + max);
* ``inference.ELBOcalc`` takes the lean engines from N = ``LEAN_N`` on,
  in float64 and in each mode of the mixed fit (``LEAN_N`` monkeypatched
  to the test's N), with the dense route's results: in float64 within
  the limits above, in the mixed modes within 3e-5 (ELBO) and 1e-3
  (state), as far as float32 trajectories of the two routes agree.

The JAX package compiles each lean loop anew (tens of seconds of worker
time), so its results are kept in ``torch_lean_reference.json`` (written
by ``JAX_PLATFORMS=cpu python -m tests.test_torch_lean``); the ``slow``
test ``test_reference_is_the_jax_packages`` recomputes them with the JAX
package and holds the file to them."""
import json
import os

import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
from gpyrn_tpu.models import gprn as jg
import gpyrn_tpu_torch as gt
from gpyrn_tpu_torch.convert import inference_from_jax
from gpyrn_tpu_torch.inference import meanfield as tmf
from gpyrn_tpu_torch.models import gprn as tg
from gpyrn_tpu_torch.ops import linalg as tlin

torch.set_num_threads(1)

ELBO_RTOL = 1e-10
STATE_TOL = 1e-8
# lean against the port's own dense engine: the same operations, one GP
# at a time instead of batched
SAME_ELBO_RTOL = 1e-12
SAME_STATE_TOL = 1e-10
# the shell's mixed fit on the two routes: float32 trajectories
MIXED_ELBO_RTOL = 3e-5
MIXED_STATE_TOL = 1e-3
# the cached JAX results against a fresh JAX computation
REFERENCE_RTOL = 1e-12
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "torch_lean_reference.json")
N = 40
CONFIGS = {"q1p3": (1, 3), "q2p2": (2, 2)}
# (entry point, its extra arguments); the JAX and the port names agree
CALLS = {
    "elbo_refine_lean": (3,),
    "elbo_fit_lean": (50,),
    "fit_state_lean": (30, 1e-10),
    "fit_state_stall_lean": (60, 1e-10, 8, 1e-4, 3),
}
# the dense counterpart of each lean entry point
DENSE = {"elbo_refine_lean": "elbo_refine", "elbo_fit_lean": "elbo_fit",
         "fit_state_lean": "fit_state",
         "fit_state_stall_lean": "fit_state_stall"}


def _components(pkg, q):
    cf, mf = pkg.covfunc, pkg.meanfunc
    if q == 1:
        return ([cf.QuasiPeriodic(1.0, 20.0, 13.0, 0.7)],
                [cf.SquaredExponential(1.0, 10.0), cf.Matern32(1.05, 8.0),
                 cf.SquaredExponential(1.1, 10.0) + cf.WhiteNoise(0.1)],
                [None, mf.Linear(0.01, 0.0), mf.Sine(0.2, 15.0, 0.1)],
                [0.1, 0.12, 0.14])
    return ([cf.Periodic(1.0, 9.0, 0.6), cf.Matern52(1.0, 5.0)],
            [cf.SquaredExponential(1.0 + 0.05 * k, 5.0 + 0.5 * k)
             for k in range(4)],
            [mf.Linear(0.01, 0.0) for _ in range(2)], [0.3, 0.32])


def _data(p):
    rng = np.random.default_rng(14)
    t = np.sort(rng.uniform(0, 60, N))
    y = np.stack([np.sin(2 * np.pi * t / (9 + 4 * i))
                  + 0.1 * rng.standard_normal(N) for i in range(p)])
    return t, y, np.full((p, N), 0.1 ** 2)


def _jax_args(config):
    q, p = CONFIGS[config]
    nj, wj, mj, jj = _components(gj, q)
    eng = jg.make_engine(jg.spec_from_components(nj, wj, mj, N))
    theta = jg.pack_parameters(nj, wj, mj, jj)
    t, y, yerr2 = _data(p)
    mu0, var0 = (np.asarray(a) for a in eng.init_mu_var(theta, y))
    return eng, (theta, t, y, yerr2, mu0, var0)


def _as_dict(name, out):
    if name == "elbo_refine_lean":
        elbo, mu, var = out
        return {"elbo": float(elbo), "mu": np.asarray(mu).tolist(),
                "var": np.asarray(var).tolist()}
    if name == "elbo_fit_lean":
        elbo, mu, var, it, done, trace = out
        return {"elbo": float(elbo), "mu": np.asarray(mu).tolist(),
                "var": np.asarray(var).tolist(), "n_iter": int(it),
                "converged": bool(done),
                "trace": np.asarray(trace)[:int(it)].tolist()}
    mu, var, it, done = out
    return {"mu": np.asarray(mu).tolist(), "var": np.asarray(var).tolist(),
            "n_iter": int(it), "converged": bool(done)}


def _jax_reference(config):
    eng, args = _jax_args(config)
    return {name: _as_dict(name, getattr(eng, name)(*args, *extra))
            for name, extra in CALLS.items()}


def write_reference():
    with open(REFERENCE, "w") as f:
        json.dump({c: _jax_reference(c) for c in CONFIGS}, f)


@pytest.fixture(scope="module")
def reference():
    with open(REFERENCE) as f:
        return json.load(f)


def _port(config):
    q, p = CONFIGS[config]
    nt, wt, mt, jt = _components(gt, q)
    eng = tg.Engine(tg.spec_from_components(nt, wt, mt, N))
    theta = tg.pack_parameters(nt, wt, mt, jt)
    t, y, yerr2 = _data(p)
    theta_t, y_t = (torch.tensor(a, dtype=torch.float64) for a in (theta, y))
    mu0, var0 = eng.init_mu_var(theta_t, y_t)
    return eng, (theta_t, torch.tensor(t, dtype=torch.float64), y_t,
                 torch.tensor(yerr2, dtype=torch.float64), mu0, var0)


@pytest.fixture(scope="module", params=list(CONFIGS))
def port(request):
    return (request.param, *_port(request.param))


def _state_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(b)))


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _check(name, got, want, elbo_rtol, state_tol):
    if "elbo" in want:
        assert _rel(got["elbo"], want["elbo"]) <= elbo_rtol
    for key in ("mu", "var"):
        assert _state_err(got[key], want[key]) <= state_tol, key
    for key in ("n_iter", "converged"):
        if key in want:
            assert got[key] == want[key], key
    if "trace" in want:
        np.testing.assert_allclose(got["trace"], want["trace"],
                                   rtol=elbo_rtol)


@pytest.mark.parametrize("name", list(CALLS))
def test_lean_entry_point_matches_jax(port, reference, name):
    config, eng, args = port
    got = _as_dict(name, getattr(eng, name)(*args, *CALLS[name]))
    _check(name, got, reference[config][name], ELBO_RTOL, STATE_TOL)


@pytest.mark.parametrize("name", list(CALLS))
def test_lean_equals_the_dense_engine(port, name):
    _, eng, args = port
    got = _as_dict(name, getattr(eng, name)(*args, *CALLS[name]))
    want = _as_dict(name, getattr(eng, DENSE[name])(*args, *CALLS[name]))
    _check(name, got, want, SAME_ELBO_RTOL, SAME_STATE_TOL)


def test_gp_update_leaves_the_kernel_matrix_as_built():
    """The update's A = K + diag(d) is a new tensor: K goes on into
    K @ pred and the clamp's diag K with the builder's bits."""
    eng, args = _port("q1p3")
    built = []

    def builder(structure, cp, t, nugget):
        K = tlin.kernel_matrix_plain(structure, cp, t, nugget)
        built.append((K, K.clone()))
        return K

    theta, t = args[0], args[1]
    node_c, _ = eng._lean_cores(theta)
    eng._gp_update_lean(eng.spec.node_structs[0], node_c[0], t,
                        torch.full((N,), 0.3, dtype=torch.float64),
                        torch.ones(N, dtype=torch.float64), builder)
    K, copy = built[0]
    assert torch.equal(K, copy)


def test_refine_lean_needs_a_sweep():
    eng, args = _port("q1p3")
    with pytest.raises(ValueError, match="n_sweeps"):
        eng.elbo_refine_lean(*args, 0)


def _jax_model(q, **settings):
    nj, wj, mj, jj = _components(gj, q)
    t, y, yerr2 = _data(CONFIGS["q1p3" if q == 1 else "q2p2"][1])
    data = []
    for row in y:
        data += [row, np.full(N, 0.1)]
    g = gj.inference(q, t, *data)
    g.set_components(nj, wj, mj, jj)
    for key, value in settings.items():
        setattr(g, key, value)
    return g


# the shell's modes: ELBOcalc keywords and inference settings
SHELL_MODES = {
    "float64": ({}, {}),
    "mixed-stall": ({"precision": "mixed", "max_iter": 40}, {}),
    "mixed-state": ({"precision": "mixed", "max_iter": 40},
                    {"mixed_stall": False}),
    "mixed-elbo": ({"precision": "mixed", "max_iter": 40},
                   {"mixed_stop": "elbo"}),
    "mixed-accelerate": ({"precision": "mixed", "max_iter": 40},
                         {"fit_accelerate": True}),
    "mixed-converge": ({"precision": "mixed", "max_iter": 40},
                       {"refine_sweeps": "converge",
                        "refine_max_sweeps": 12}),
}


@pytest.mark.parametrize("mode", list(SHELL_MODES))
def test_shell_takes_the_lean_route_from_lean_n(monkeypatch, mode):
    """At N >= LEAN_N every fit and polish of ELBOcalc goes through a lean
    entry point, none through a dense one, and the result is the dense
    route's."""
    kwargs, settings = SHELL_MODES[mode]
    assert isinstance(tmf.LEAN_N, int) and tmf.LEAN_N > N
    dense_run = inference_from_jax(_jax_model(1, **settings), device="cpu")
    e_dense, mu_dense, _, it_dense = dense_run.ELBOcalc(**kwargs)

    calls = []
    for name in list(DENSE) + list(DENSE.values()):
        orig = getattr(tg.Engine, name)

        def spy(self, *a, _name=name, _orig=orig, **k):
            calls.append(_name)
            return _orig(self, *a, **k)
        monkeypatch.setattr(tg.Engine, name, spy)
    monkeypatch.setattr(tmf, "LEAN_N", N)
    lean_run = inference_from_jax(_jax_model(1, **settings), device="cpu")
    e_lean, mu_lean, _, it_lean = lean_run.ELBOcalc(**kwargs)
    assert calls and all(c.endswith("_lean") for c in calls), calls
    assert it_lean == it_dense
    # the float32 bulk of the mixed fit rounds its own way on each route
    # (one GP at a time against a batch), and 40 float32 sweeps carry
    # that apart to ~3e-6 in the ELBO and ~1e-4 in the state
    mixed = kwargs.get("precision") == "mixed"
    assert _rel(e_lean, e_dense) <= (MIXED_ELBO_RTOL if mixed
                                     else SAME_ELBO_RTOL)
    assert _state_err(mu_lean, mu_dense) <= (MIXED_STATE_TOL if mixed
                                             else SAME_STATE_TOL)
    if mixed:
        assert lean_run.mixed_info["lean"] and \
            not dense_run.mixed_info["lean"]


@pytest.mark.slow
@pytest.mark.parametrize("config", list(CONFIGS))
def test_reference_is_the_jax_packages(config):
    """The cached JAX results are what the JAX package computes now."""
    with open(REFERENCE) as f:
        ref = json.load(f)[config]
    fresh = _jax_reference(config)
    for name, values in fresh.items():
        for key, value in values.items():
            np.testing.assert_allclose(value, ref[name][key],
                                       rtol=REFERENCE_RTOL, atol=1e-300)


if __name__ == "__main__":
    write_reference()
