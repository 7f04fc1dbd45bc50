"""The port's worked examples (``examples/torch_example_N.py``) against the
JAX package's (``examples/example_N.py``) on the CPU.

Each port example is imported by module name (``examples/`` on
``sys.path``, as the ``spawn`` children of example 3 need) and its
``main("cpu")`` runs in a temporary working directory; what it returns is
held against the values of the JAX example, which ran with ``runpy`` in
a process of its own (``JAX_PLATFORMS=cpu``, one CPU device as a user's
run has, so that example 3's mesh has one device) and whose globals and
printed lines gave the same quantities.  The JAX values are cached in
``torch_examples_reference.json`` (written by ``JAX_PLATFORMS=cpu python
-m tests.test_torch_examples``, ~20 min; each JAX example's process takes
most of the cores, so run it, and the ``slow`` test
``test_reference_is_the_jax_packages`` that recomputes them, without
pytest's workers).  Two draws the JAX example 4 leaves unseeded are
seeded as the port's example seeds them (its initial walkers, from
numpy's global generator; the Perrakis reshuffle).  The checks and
their tolerances are ``chip_smoke.example_checks``, which phase 35 of
``chip_smoke.py`` applies to the same examples on the card (see its
docstring for each bar and its reason).

Examples 1 and 8 take under 5 s on one CPU thread and run in tier-1;
examples 2-7 (30-210 s each) are ``slow``.  Tier-1 also imports all eight
in a process where ``jax`` and ``gpyrn_tpu`` cannot be imported and runs
example 1 there, and holds every example's ``--device`` to ``cuda`` by
default.
"""
import contextlib
import importlib
import io
import json
import os
import runpy
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
EXAMPLES = os.path.join(REPO, "examples")
REFERENCE = os.path.join(HERE, "torch_examples_reference.json")
NUMBERS = tuple(range(1, 9))
TIER1 = (1, 8)
# a fresh JAX value against the cached one
REFERENCE_RTOL = 1e-12


def port_example(n):
    """The module ``torch_example_<n>``, imported by name."""
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    return importlib.import_module(f"torch_example_{n}")


def _printed(out, prefix):
    """The number after the last ``=`` of the printed line that starts
    with ``prefix``."""
    line = next(s for s in out.splitlines() if s.startswith(prefix))
    return float(line.split("=")[-1].split("(")[0])


def _jax_1(g, out):
    return {"elbo_short": _printed(out, "ELBO (ell_w = 1)"),
            "elbo_long": float(g["elbo"]), "tstar": g["tstar"][::50],
            "mean": np.asarray(g["mean"])[::50, 0],
            "std": np.asarray(g["std"])[::50, 0]}


def _jax_2(g, out):
    return {"initial_elbo": _printed(out, "initial ELBO"),
            "elbo": float(g["res"]["elbo"]), "fun": float(g["res"]["fun"]),
            "theta": [float(v) for v in g["gprn"].parameters_dict.values()]}


def _jax_3(g, out):
    o = g["out"]
    return {"initial_elbo": _printed(out, "initial ELBO"),
            "world": int(g["mesh"].devices.size), "elbo": float(o["elbo"]),
            "winner": int(o["winner"]), "restart_elbos": o["restart_elbos"],
            "theta": o["theta"]}


def _jax_4(g, out):
    r, chain = g["result"], g["chain"]
    # the example's own estimate draws from an unseeded generator; the
    # port's example seeds it, so the estimate is taken again here with
    # the port's seed on the JAX example's chain, likelihood and prior
    logz = g["ev"].compute_perrakis_estimate(
        chain[-500:], g["lnlike"], g["lnprior"], nsamples=300,
        rng=np.random.default_rng(port_example(4).PERRAKIS_SEED))
    return {"converged": bool(r.converged),
            "acceptance": float(np.mean(r.acceptance)),
            "iteration": int(r.iteration), "names": list(g["names"]),
            "chain_mean": chain.mean(axis=0), "chain_std": chain.std(axis=0),
            "logz": float(logz)}


def _jax_5(g, out):
    chain = g["chain"]
    return {"elbo_mixed": float(g["elbo_mixed"]), "iterations": int(g["it"]),
            "elbo_plain": float(g["elbo_plain"]),
            "chain_shape": list(chain.shape),
            "chain_mean": chain.mean(axis=0), "chain_std": chain.std(axis=0),
            "acceptance": float(g["res"].acceptance), "gap": float(g["gap"]),
            "mean_cg": np.asarray(g["mean_cg"])[::10, 0],
            "std_cg": np.asarray(g["std_cg"])[::10, 0]}


def _jax_6(g, out):
    o, flat = g["out"], g["flat"]
    mean_l, std_l = np.asarray(g["mean_l"]), np.asarray(g["std_l"])
    return {"elbo0": float(g["elbo0"]), "elbo": float(o["elbo"]),
            "fun": float(o["fun"]), "x": o["x"], "nit": int(o["nit"]),
            "nfev": int(o["nfev"]),
            "love_dmean": float(np.max(np.abs(
                mean_l - np.asarray(g["mean_d"])))),
            "love_dstd": float(np.max(np.abs(
                std_l - np.asarray(g["std_d"])))),
            "mean_love": mean_l[::10, 0], "std_love": std_l[::10, 0],
            "chain_shape": list(flat.shape), "chain_mean": flat.mean(axis=0),
            "chain_std": flat.std(axis=0),
            "acceptance": float(g["res"].acceptance)}


def _jax_7(g, out):
    o = g["out"]
    return {"e_ref": float(g["e_ref"]), "e_3sweep": float(g["e_3sweep"]),
            "e_conv": float(g["e_conv"]), "n_sweeps": int(g["n_sweeps"]),
            "restart_elbos": o["restart_elbos"], "winner": int(o["winner"]),
            "elbo": float(o["elbo"]), "theta": o["theta"], "nit": o["nit"]}


def _jax_8(g, out):
    serve = g["serve"]
    served = {}
    for n_req in (25, 400):
        mean, varr = (np.asarray(x) for x in
                      serve(np.linspace(-5.0, 85.0, n_req))[:2])
        served[n_req] = [mean.min(), mean.max(), np.sqrt(varr).max()]
    return {"elbo": float(g["elbo"]), "iterations": int(g["it"]),
            "nbytes": int(g["nbytes"]), "served_25": served[25],
            "served_400": served[400], "dev": float(g["dev"]),
            "mean_serve": np.asarray(g["mean_serve"])[::3, 0]}


JAX_VALUES = {1: _jax_1, 2: _jax_2, 3: _jax_3, 4: _jax_4, 5: _jax_5,
              6: _jax_6, 7: _jax_7, 8: _jax_8}


def _plain(d):
    """Numpy values as JSON's lists and numbers."""
    out = {}
    for k, v in d.items():
        v = np.asarray(v)
        out[k] = v.tolist() if v.dtype.kind in "biuf" else \
            [str(s) for s in v.ravel()] if v.ndim else str(v)
    return out


def jax_example_values(n):
    """Run ``examples/example_<n>.py`` with ``runpy`` in a temporary
    working directory of this process: the quantities it prints (from its
    globals, or its printed lines where a global was overwritten)."""
    cwd = os.getcwd()
    out = io.StringIO()
    if n == 4:
        # example 4's initial walkers come from numpy's global generator,
        # which the JAX example leaves unseeded: seeded as the port's
        # example seeds it, after the imports (importing jax draws from it)
        importlib.import_module("gpyrn_tpu.inference.evidence")
        np.random.seed(port_example(4).WALKER_SEED)
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            with contextlib.redirect_stdout(out):
                g = runpy.run_path(os.path.join(EXAMPLES, f"example_{n}.py"),
                                   run_name="__main__")
                return _plain(JAX_VALUES[n](g, out.getvalue()))
        finally:
            os.chdir(cwd)


def jax_example_values_fresh(n):
    """:func:`jax_example_values` in a fresh process on one CPU device
    (the tests' ``XLA_FLAGS`` of eight host devices dropped), as a user's
    CPU run of the example has it."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", MPLBACKEND="Agg")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "tests.test_torch_examples", "--example",
         str(n)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=1800)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def write_reference():
    ref = {}
    for n in NUMBERS:
        ref[str(n)] = jax_example_values_fresh(n)
        print(f"example {n} done", flush=True)
    with open(REFERENCE, "w") as f:
        json.dump(ref, f)
        f.write("\n")


def _reference(n):
    with open(REFERENCE) as f:
        return json.load(f)[str(n)]


def run_port_example(n, path):
    """``main("cpu")`` of the port's example ``n`` with ``path`` as the
    working directory."""
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return port_example(n).main("cpu")
    finally:
        os.chdir(cwd)


def _assert_checks(n, got):
    checks = chip_smoke.example_checks(n, got, _reference(n))
    failed = [f"{label}: {detail}" for label, ok, detail in checks if not ok]
    assert not failed, failed


@pytest.mark.parametrize("n", TIER1)
def test_example_matches_jax(n, tmp_path):
    """Examples 1 and 8: ``main("cpu")`` against the JAX example's values
    (``chip_smoke.example_checks``), and the files they write."""
    import matplotlib
    matplotlib.use("Agg")
    got = run_port_example(n, tmp_path)
    _assert_checks(n, got)
    written = {1: "dataAndPrediction.png", 8: "gprn_predict.pt2"}[n]
    assert (tmp_path / written).exists()


@pytest.mark.slow
@pytest.mark.parametrize("n", sorted(set(NUMBERS) - set(TIER1)))
def test_slow_example_matches_jax(n, tmp_path):
    """Examples 2-7: ``main("cpu")`` against the JAX example's values
    (``chip_smoke.example_checks``)."""
    import matplotlib
    matplotlib.use("Agg")
    _assert_checks(n, run_port_example(n, tmp_path))


# every example imported where jax and the JAX package raise ImportError,
# example 1 run there; which of them were loaded after all.  matplotlib is
# blocked too: the examples skip their plots without it (and the process
# skips its import, ~2 s)
_BLOCKED = textwrap.dedent("""
    import importlib, json, os, sys
    sys.modules["jax"] = None
    sys.modules["gpyrn_tpu"] = None
    sys.modules["matplotlib"] = None
    sys.path.insert(0, sys.argv[1])
    sys.path.insert(0, os.path.join(sys.argv[1], "examples"))
    import torch
    torch.set_num_threads(1)
    mods = [importlib.import_module(f"torch_example_{n}")
            for n in range(1, 9)]
    os.chdir(sys.argv[2])
    got = mods[0].main("cpu")
    loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                    and m.split(".")[0] in ("jax", "gpyrn_tpu"))
    print(json.dumps({"elbo_long": got["elbo_long"], "loaded": loaded,
                      "mains": [callable(m.main) for m in mods]}))
""")


def test_examples_import_neither_jax_nor_the_jax_package(tmp_path):
    """The eight examples import with jax and ``gpyrn_tpu`` blocked,
    example 1 runs there (without matplotlib: no plot) to the JAX
    example's ELBO, and neither was loaded at the end."""
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, REPO,
                           str(tmp_path)], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert res["mains"] == [True] * 8
    assert not (tmp_path / "dataAndPrediction.png").exists()
    ref = _reference(1)["elbo_long"]
    assert abs(res["elbo_long"] - ref) <= 1e-10 * abs(ref)


@pytest.mark.parametrize("n", NUMBERS)
def test_device_flag_defaults_to_cuda(n):
    """``--device`` defaults to the card; the CPU only when asked."""
    mod = port_example(n)
    assert mod.parse_args([]).device == "cuda"
    assert mod.parse_args(["--device", "cpu"]).device == "cpu"
    assert mod.main.__defaults__ == ("cuda",)


@pytest.mark.slow
@pytest.mark.parametrize("n", NUMBERS)
def test_reference_is_the_jax_packages(n):
    """The cached values are what the JAX example computes now: floats
    relative 1e-12, everything else equal."""
    fresh, ref = jax_example_values_fresh(n), _reference(n)
    assert fresh.keys() == ref.keys()
    for key, want in ref.items():
        if isinstance(want, str) or (isinstance(want, list) and want
                                     and isinstance(want[0], str)):
            assert fresh[key] == want, key
        else:
            np.testing.assert_allclose(fresh[key], want, rtol=REFERENCE_RTOL,
                                       err_msg=key)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--example"]:
        print(json.dumps(jax_example_values(int(sys.argv[2]))))
    else:
        write_reference()
