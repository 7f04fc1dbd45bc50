"""The harness on the CPU: the files it finds by name, the result line, and
the check on what the process loaded."""
import json
import re
import subprocess
import sys
import types

import numpy as np
import pytest

from h100_bench import generator, harness, trace
from h100_bench.tests.conftest import fake_profile, small_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((harness.REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_names_files_of_its_own():
    root = harness.ROOT
    assert SPEC["command"][1] == "h100_bench/run.py"
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for c in SPEC["configs"]:
        assert NAME.match(c["name"])
        assert json.loads((harness.REPO / c["file"]).read_text())[
            "source"] == c["source"]
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        cell = json.loads((root / "workloads" / f"{w['name']}.json")
                          .read_text())
        assert (cell["config"], cell["traffic"]) == (w["config"],
                                                     w["traffic"])
        assert (root / "traffic" / f"{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert (root / "metrics" / f"{m['name']}.py").is_file()
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_has_its_keys(bench, monkeypatch, traced):
    monkeypatch.setattr(trace, "profile", fake_profile)
    line = harness.run_cell(bench, "rv3-qp.search13", 2 ** 31 + 11, 0.0,
                            traced, "cpu")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if traced else []) + \
        ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    kind = "per_layer" if traced else "end_to_end"
    assert set(line["metrics"]) == {
        m["name"] for m in SPEC[kind]
        if "rv3-qp.search13" in m.get("workloads", ["rv3-qp.search13"])}
    if traced:
        assert line["device"]["busy_s"] == pytest.approx(0.006)
        assert line["breakdown"]["idle_gaps"][0][0] == \
            "h100_bench: batch_fit / aten::_local_scalar_dense"
    json.dumps(line)


def test_window_closes_at_a_batch_boundary(bench):
    """A window of 0 s is one batch, run to its end."""
    line = harness.run_cell(bench, "rv3-2node.search26", 5, 0.0, False,
                            "cpu")
    assert line["attempted"] == 3


def test_ensemble_batches_are_stretch_moves_from_the_seed():
    """Each batch is one half of the walkers proposed against the other
    (the halves alternate), x_P + z (x_S - x_P) with z in [1/a, a]; the
    same seed gives the same batches, and no row comes twice."""
    config = json.loads((harness.ROOT / "configs" / "rv3-qp.json")
                        .read_text())
    mix = json.loads((harness.ROOT / "traffic" / "search13.json")
                     .read_text())
    mix["N"] = 40
    del mix["pass"]
    pool = generator.pool(config, mix, 7)
    assert pool.walkers.shape == (26, 13)
    assert np.array_equal(pool.walkers,
                          generator.pool(config, mix, 8).walkers)
    a, h = mix["stretch"], mix["rows"]
    one, two = (generator.Batches(config, mix, pool, 2 ** 31 + 5)
                for _ in range(2))
    seen = []
    for step in range(6):
        theta, walkers = one.next()
        again, _ = two.next()
        assert np.array_equal(theta, again)
        assert np.array_equal(walkers, np.arange(h) + h * (step % 2))
        xS = pool.walkers[walkers]
        # the partner of each proposal lies in the other half
        others = pool.walkers[np.arange(h) + h * (1 - step % 2)]
        for x, s in zip(theta, xS):
            z = [(x - p)[0] / (s - p)[0] for p in others]
            hits = [(p, zz) for p, zz in zip(others, z)
                    if np.allclose(x, p + zz * (s - p), rtol=1e-12)]
            assert hits and 1 / a <= hits[0][1] <= a
        seen.extend(map(tuple, theta))
    assert len(set(seen)) == len(seen)
    other = generator.Batches(config, mix, pool, 2 ** 31 + 6).next()[0]
    assert not np.array_equal(other, generator.Batches(
        config, mix, pool, 2 ** 31 + 5).next()[0])


def test_passes_repeat_their_half_steps_with_fresh_rows():
    """With ``pass`` K, each K batches are the same half-steps in a new
    order, every row jittered afresh: the same walkers and rows to the
    jitter, no row twice, and a pass boundary after each K."""
    config = json.loads((harness.ROOT / "configs" / "rv3-qp.json")
                        .read_text())
    mix = json.loads((harness.ROOT / "traffic" / "search13.json")
                     .read_text())
    mix.update(N=40, rows=3, **{"pass": 4})
    pool = generator.pool(config, mix, 1)
    batches = generator.Batches(config, mix, pool, 2 ** 31 + 9)
    passes, seen = [], []
    for _ in range(3):
        got = []
        for k in range(4):
            assert batches.boundary == (k == 0)
            theta, walkers = batches.next()
            got.append((tuple(walkers), theta))
            seen.extend(map(tuple, theta))
        assert batches.boundary
        passes.append(got)
    for got in passes:
        # each pass holds every half-step of the pass once, jittered
        matched = []
        for S, theta in got:
            k = [k for k, (S0, th0) in enumerate(batches.steps)
                 if tuple(S0) == S
                 and np.abs(np.log(theta / th0)).max() < 10 * mix["jitter"]]
            assert len(k) == 1
            assert not np.array_equal(theta, batches.steps[k[0]][1])
            matched.append(k[0])
        assert sorted(matched) == list(range(4))
    assert [S for S, _ in passes[0]] != [S for S, _ in passes[1]] or \
        [S for S, _ in passes[1]] != [S for S, _ in passes[2]]
    assert len(set(seen)) == len(seen)


def test_cold_batches_are_fresh_rows_from_the_seed():
    config = json.loads((harness.ROOT / "configs" / "rv3-qp.json")
                        .read_text())
    mix = json.loads((harness.ROOT / "traffic" / "lean20k.json")
                     .read_text())
    mix["N"] = 40
    pool = generator.pool(config, mix, 11)
    assert pool.walkers is None
    batches = generator.Batches(config, mix, pool, 11)
    rows = [batches.next() for _ in range(3)]
    assert all(w is None and t.shape == (1, 13) for t, w in rows)
    assert len({tuple(t[0]) for t, _ in rows}) == 3
    again = generator.Batches(config, mix, pool, 11).next()[0]
    assert np.array_equal(again, rows[0][0])


def test_new_cell_and_metric_are_files(tmp_path, monkeypatch):
    """A cell, a mix, a configuration and a per-layer metric dropped in as
    files and entries, with no file of the benchmark edited."""
    def edit(root, spec):
        config = json.loads((root / "configs" / "rv3-qp.json").read_text())
        config["name"] = "rv1-se"
        config["p"] = 1
        config["nodes"] = [{"kernel": "SquaredExponential",
                            "pars": [1.0, 10.0]}]
        config["weights"] = config["weights"][:1]
        config["means"], config["jitters"] = [None], [0.2]
        config["data"]["periods"] = [17.0]
        (root / "configs" / "rv1-se.json").write_text(json.dumps(config))
        (root / "traffic" / "tiny4.json").write_text(json.dumps(
            {"entry": "batch_fit", "N": 24, "rows": 4, "spread": 0.05,
             "max_iter": 30, "pool_seed": 9}))
        (root / "workloads" / "rv1-se.tiny4.json").write_text(json.dumps(
            {"config": "rv1-se", "traffic": "tiny4",
             "check": {"sample": 2, "limits": {"elbo_rel": 1e-9,
                                               "state_rel": 1e-9,
                                               "n_iter_diff": 0}}}))
        (root / "metrics" / "rows_per_batch.py").write_text(
            "def read(run):\n    return run.units[0].rows\n")
        spec["workloads"].append({"name": "rv1-se.tiny4", "config": "rv1-se",
                                  "traffic": "tiny4", "chips": 1,
                                  "why": "a test's cell"})
        spec["end_to_end"][0]["workloads"].append("rv1-se.tiny4")
        spec["per_layer"].append({
            "name": "rows_per_batch", "unit": "rows", "better": "higher",
            "source": "program_counter", "layer": "batch loop",
            "moves": "fits_per_s", "workloads": ["rv1-se.tiny4"]})

    bench = small_bench(tmp_path, edit)
    monkeypatch.setattr(trace, "profile", fake_profile)
    line = harness.run_cell(bench, "rv1-se.tiny4", 3, 0.0, True, "cpu")
    assert line["correct"] is True
    assert line["metrics"]["rows_per_batch"] == {"value": 4.0,
                                                 "unit": "rows"}
    line = harness.run_cell(bench, "rv1-se.tiny4", 3, 0.0, False, "cpu")
    assert set(line["metrics"]) == {"fits_per_s", "setup_s"}


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import gpyrn_tpu_torch  # noqa: F401
    for name in harness.FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gpyrn_tpu_torch_x",
                        types.ModuleType("gpyrn_tpu_torch_x"))
    monkeypatch.setitem(sys.modules, "jaxlib_like",
                        types.ModuleType("jaxlib_like"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gpyrn_tpu.models",
                        types.ModuleType("gpyrn_tpu.models"))
    assert harness.forbidden_modules() == ["gpyrn_tpu"]


def test_yardstick_imports_nothing_of_the_package():
    """The yardstick's modules, and every component file of the
    reference, loaded in a fresh process."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import h100_bench.reference.gprn, h100_bench.counts, "
            "h100_bench.generator, h100_bench.trace, h100_bench.readings; "
            "from h100_bench.reference import components as c; "
            "[c.load(p.parent.name, p.stem) "
            "for p in sorted(c.HERE.glob('*/*.py'))]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gpyrn_tpu', 'gpyrn_tpu_torch', 'jax', 'jaxlib'}))")
    out = subprocess.run([sys.executable, "-c", code, str(harness.REPO)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    from h100_bench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "rv3-qp.search13", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_run_on_the_card(card, capsys):
    from h100_bench import run
    assert run.main(["--workload", "rv3-qp.search13", "--seed",
                     str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
