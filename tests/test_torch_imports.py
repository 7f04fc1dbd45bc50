"""The port's package surface against the JAX package's
(``gpyrn_tpu/__init__.py``, ``tests/test_imports.py``).

* Every top-level name of ``gpyrn_tpu.__all__`` imports from
  ``gpyrn_tpu_torch``, here and in a fresh process where jax and the JAX
  package cannot be imported, and is the same kind of object (a module, a
  class) from the port's counterpart module.
* ``models/gprn.py::make_engine`` returns a shared :class:`Engine` per key.
* The ``ops/linalg.py`` helpers (``cholesky_nugget``, ``chol_solve``,
  ``batched_chol``, ``batched_chol_solve``) agree with the JAX package's
  on the CPU in float64 to 1e-12 of the largest value, one batch solved
  matrix by matrix past ``BATCHED_SOLVE_MAX_N`` (the limit monkeypatched
  down to the test's N).
* The ``config.py`` functions: the default and advisory compute dtypes,
  and NaN checks on autograd's anomaly mode.
"""
import importlib
import json
import os
import subprocess
import sys
import textwrap
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpyrn_tpu
from gpyrn_tpu.ops import linalg as jlin
import gpyrn_tpu_torch
from gpyrn_tpu_torch import config as tconfig
from gpyrn_tpu_torch.models import gprn as tg
from gpyrn_tpu_torch.ops import linalg as tlin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = list(gpyrn_tpu.__all__)
N, BATCH, COLS = 12, 3, 2
RTOL = 1e-12

# every name of the port's surface imported in a process where jax and the
# JAX package raise ImportError: what each name is, and whether any of
# them was loaded after all
_BLOCKED = textwrap.dedent("""
    import json, sys, types
    sys.modules["jax"] = None
    sys.modules["gpyrn_tpu"] = None
    sys.path.insert(0, sys.argv[1])
    import gpyrn_tpu_torch
    got = {}
    for name in gpyrn_tpu_torch.__all__:
        scope = {}
        exec(f"from gpyrn_tpu_torch import {name} as value", scope)
        value = scope["value"]
        got[name] = (value.__name__ if isinstance(value, types.ModuleType)
                     else value.__module__ + "." + value.__qualname__)
    loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                    and m.split(".")[0] in ("jax", "gpyrn_tpu"))
    print(json.dumps({"names": got, "loaded": loaded}))
""")


@pytest.fixture(scope="module")
def blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, REPO],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _counterpart(value):
    """The port's module or class path that the JAX package's ``value``
    maps to: ``gpyrn_tpu.x.y`` → ``gpyrn_tpu_torch.x.y``."""
    if isinstance(value, types.ModuleType):
        path = value.__name__
    else:
        path = value.__module__ + "." + value.__qualname__
    return "gpyrn_tpu_torch" + path[len("gpyrn_tpu"):]


def test_import_package():
    import gpyrn_tpu_torch  # noqa: F401


def test_import_covfunc():
    from gpyrn_tpu_torch import covfunc  # noqa: F401


def test_import_meanfunc():
    from gpyrn_tpu_torch import meanfunc  # noqa: F401


def test_import_meanfield():
    from gpyrn_tpu_torch import meanfield  # noqa: F401


def test_import_api_names():
    from gpyrn_tpu_torch import (inference, Constant, Linear,  # noqa: F401
                                 SquaredExponential, QuasiPeriodic)


def test_version():
    assert hasattr(gpyrn_tpu_torch, "__version__")


def test_all_is_the_jax_packages(blocked):
    assert sorted(gpyrn_tpu_torch.__all__) == sorted(NAMES)
    assert sorted(blocked["names"]) == sorted(NAMES)
    assert blocked["loaded"] == []


@pytest.mark.parametrize("name", NAMES)
def test_top_level_name(name, blocked):
    """The name imports here and with jax blocked, and is the port's
    counterpart of the JAX package's object of that name."""
    scope = {}
    exec(f"from gpyrn_tpu_torch import {name} as value", scope)
    value, ref = scope["value"], getattr(gpyrn_tpu, name)
    assert isinstance(value, types.ModuleType) == isinstance(
        ref, types.ModuleType)
    want = _counterpart(ref)
    assert blocked["names"][name] == want
    if isinstance(value, types.ModuleType):
        assert value is importlib.import_module(want)
    else:
        assert f"{value.__module__}.{value.__qualname__}" == want


def test_inference_stays_the_class():
    """Loading the inference subpackage's modules through the surface
    leaves ``gpyrn_tpu_torch.inference`` the user's class."""
    from gpyrn_tpu_torch import evidence, meanfield, nonparametric, priors
    assert all(isinstance(m, types.ModuleType)
               for m in (evidence, meanfield, nonparametric, priors))
    assert gpyrn_tpu_torch.inference is meanfield.inference
    assert isinstance(gpyrn_tpu_torch.inference, type)


def test_make_engine_shares_one_engine_per_key():
    from gpyrn_tpu_torch import covfunc, meanfunc
    spec = tg.spec_from_components(
        [covfunc.QuasiPeriodic(1.0, 20.0, 13.0, 0.6)],
        [covfunc.SquaredExponential(1.0, 8.0)] * 2,
        [meanfunc.Constant(0.0), None], N)
    eng = tg.make_engine(spec)
    assert isinstance(eng, tg.Engine) and eng.spec == spec
    assert eng.lattice_axis is None and eng.node_maps is None
    assert tg.make_engine(spec) is eng
    other = tg.make_engine(spec, None, "lat")
    assert other is not eng and other.lattice_axis == "lat"


def _spd(rng, n, batch=None):
    shape = (n, n) if batch is None else (batch, n, n)
    A = rng.standard_normal(shape)
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= RTOL * np.max(np.abs(ref))


def _t(a):
    return torch.tensor(a, dtype=torch.float64)


def test_cholesky_nugget_and_chol_solve():
    rng = np.random.default_rng(0)
    K = _spd(rng, N)
    L = tlin.cholesky_nugget(_t(K))
    _close(L.numpy(), jlin.cholesky_nugget(jnp.asarray(K)))
    for b in (rng.standard_normal(N), rng.standard_normal((N, COLS))):
        _close(tlin.chol_solve(L, _t(b)).numpy(),
               jlin.chol_solve(jnp.asarray(L.numpy()), jnp.asarray(b)))


@pytest.mark.parametrize("limit", [None, N - 1],
                         ids=["batched", "one_at_a_time"])
def test_batched_chol_and_solve(limit, monkeypatch):
    if limit is not None:
        monkeypatch.setattr(tg, "BATCHED_SOLVE_MAX_N", limit)
    assert (N > tg.BATCHED_SOLVE_MAX_N) == (limit is not None)
    rng = np.random.default_rng(1)
    K = _spd(rng, N, BATCH)
    L = tlin.batched_chol(_t(K))
    _close(L.numpy(), jlin.batched_chol(jnp.asarray(K)))
    for B in (rng.standard_normal((BATCH, N)),
              rng.standard_normal((BATCH, N, COLS))):
        _close(tlin.batched_chol_solve(L, _t(B)).numpy(),
               jlin.batched_chol_solve(jnp.asarray(L.numpy()),
                                       jnp.asarray(B)))


def test_compute_dtype_is_advisory():
    assert tconfig.default_dtype() is torch.float64
    assert tconfig.compute_dtype() is torch.float64
    try:
        tconfig.set_compute_dtype(torch.float32)
        assert tconfig.compute_dtype() is torch.float32
        with pytest.raises(ValueError):
            tconfig.set_compute_dtype(torch.int64)
    finally:
        tconfig.set_compute_dtype(torch.float64)


@pytest.mark.filterwarnings("ignore:Error detected")
def test_nan_checks_name_the_operation():
    before = torch.is_anomaly_enabled()
    try:
        tconfig.enable_nan_checks()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], dtype=torch.float64, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
        tconfig.enable_nan_checks(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)
