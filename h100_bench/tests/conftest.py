"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
with its mixes cut to a size a test can hold, and a fake device trace.

Run with ``python -m pytest h100_bench/tests`` from the root of the
repository; the tests marked ``cuda`` need a card and skip without one."""
import json
import shutil
from pathlib import Path

import pytest

from h100_bench import harness, trace

SMALL = {"N": 40, "rows": 3, "pass": 2}


def small_bench(tmp_path, edit=None):
    """A copy of ``h100_bench/`` and ``BENCHMARK.json`` under ``tmp_path``
    with every mix at N = 40, batches of at most 3 rows and passes of at
    most 2 batches; ``edit(root, spec)`` may add files and entries before
    the spec is written."""
    root = tmp_path / "h100_bench"
    shutil.copytree(harness.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (root / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["N"] = SMALL["N"]
        mix["rows"] = min(mix["rows"], SMALL["rows"])
        if "pass" in mix:
            mix["pass"] = min(mix["pass"], SMALL["pass"])
        path.write_text(json.dumps(mix))
    spec = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    if edit is not None:
        edit(root, spec)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.Bench(root, tmp_path / "BENCHMARK.json")


# a GPRN of gpyrn's own purpose: a Keplerian mean on the radial velocities
# (output 0), whose data hold that planet, and a node kernel that is a sum
KEPLERIAN = {
    "name": "rv3-kep",
    "source": "Camacho, Faria & Viana, MNRAS 519:5439: a GPRN with a "
              "Keplerian mean on the RV",
    "reduced": [], "q": 1, "p": 3, "dtype": "float64",
    "nodes": [{"kernel": "Sum", "of": [
        {"kernel": "QuasiPeriodic", "pars": [1.0, 30.0, 20.0, 0.7]},
        {"kernel": "SquaredExponential", "pars": [0.3, 5.0]}]}],
    "weights": [{"kernel": "SquaredExponential", "pars": [1.0, 30.0]},
                {"kernel": "SquaredExponential", "pars": [1.05, 30.0]},
                {"kernel": "SquaredExponential", "pars": [1.1, 30.0]}],
    "means": [{"mean": "Keplerian", "pars": [11.3, 0.8, 0.15, 1.0, 3.0]},
              None, None],
    "jitters": [0.1, 0.1, 0.1],
    "data": {"t_span": 100.0, "periods": [20.0, 25.0, 30.0], "noise": 0.1,
             "yerr": 0.1,
             "signals": [{"mean": "Keplerian",
                          "pars": [11.3, 0.8, 0.15, 1.0, 3.0]}, None, None]},
}


def add_keplerian(root, spec):
    """The Keplerian configuration, a cold mix and an ensemble mix, and
    their two cells, as new files and entries only."""
    (root / "configs" / "rv3-kep.json").write_text(json.dumps(KEPLERIAN))
    (root / "traffic" / "cold3.json").write_text(json.dumps(
        {"entry": "batch_fit", "N": 40, "rows": 3, "spread": 0.05,
         "max_iter": 40, "pool_seed": 9}))
    (root / "traffic" / "warm3.json").write_text(json.dumps(
        {"entry": "batch_fit", "N": 40, "rows": 3, "stretch": 2.0,
         "spread": 0.05, "max_iter": 100, "pool_seed": 10}))
    spec["configs"].append({"name": "rv3-kep", "source": KEPLERIAN["source"],
                            "file": "h100_bench/configs/rv3-kep.json",
                            "reduced": [], "why": "a test's configuration"})
    for mix in ("cold3", "warm3"):
        name = f"rv3-kep.{mix}"
        (root / "workloads" / f"{name}.json").write_text(json.dumps(
            {"config": "rv3-kep", "traffic": mix,
             "check": {"sample": 3, "limits": {"elbo_rel": 1e-9,
                                               "state_rel": 1e-9,
                                               "n_iter_diff": 0}}}))
        spec["workloads"].append({"name": name, "config": "rv3-kep",
                                  "traffic": mix, "chips": 1,
                                  "why": "a test's cell"})
        spec["end_to_end"][0]["workloads"].append(name)


def fake_profile(fn, host=True):
    """What ``trace.profile`` gives on a card, made up: the call, and a
    slice of 10 ms with a B1 launch, a Cholesky and an idle gap."""
    out = fn()
    ms = 1_000_000
    device = [("void kernel_matrix_kernel<double, 3>", 0, 2 * ms),
              ("potrf_kernel", 2 * ms, 6 * ms)]
    host = [(trace.SLICE, 0, 10 * ms),
            ("h100_bench: batch_fit", 0, 10 * ms),
            ("aten::_local_scalar_dense", 6 * ms, 10 * ms)]
    return out, trace.Trace(0.01, device, host, 0, 10 * ms)


@pytest.fixture
def bench(tmp_path):
    return small_bench(tmp_path)


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
