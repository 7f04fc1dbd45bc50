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
