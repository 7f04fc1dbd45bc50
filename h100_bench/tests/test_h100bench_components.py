"""The reference's components as files, composite kernels, the data's added
signals and the reference's bounded memory, on the CPU."""
import hashlib
import json

import numpy as np
import pytest
import torch

from h100_bench import generator, harness, port
from h100_bench.reference import components, gprn as ref
from h100_bench.tests.conftest import KEPLERIAN, add_keplerian, small_bench

SEED = 2 ** 31 + 77


@pytest.mark.parametrize("cell", ["rv3-kep.cold3", "rv3-kep.warm3"])
def test_keplerian_configuration_is_files(tmp_path, cell):
    """A configuration with a Keplerian mean, a planet in its data and a
    sum of kernels, added with its mixes and cells as new files and
    entries only, runs correct, cold and warm-started."""
    bench = small_bench(tmp_path, add_keplerian)
    line = harness.run_cell(bench, cell, SEED, 0.0, False, "cpu")
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["n_iter_diff"]["value"] == 0


def test_a_component_with_two_parameters_swapped_is_not_correct(
        monkeypatch, tmp_path):
    bench = small_bench(tmp_path)
    monkeypatch.setattr(components, "HERE", bench.root / "reference")
    path = bench.root / "reference" / "kernels" / "SquaredExponential.py"
    text = path.read_text()
    swapped = text.replace("p[:, 0, None, None]", "p[:, X, None, None]") \
        .replace("p[:, 1, None, None]", "p[:, 0, None, None]") \
        .replace("p[:, X, None, None]", "p[:, 1, None, None]")
    assert swapped != text
    path.write_text(swapped)
    line = harness.run_cell(bench, "rv3-qp.search13", SEED, 0.0, False,
                            "cpu")
    assert line["correct"] is False, line["checks"]


def test_a_missing_component_names_its_file(monkeypatch, tmp_path):
    def edit(root, spec):
        config = json.loads((root / "configs" / "rv3-qp.json").read_text())
        config["nodes"] = [{"kernel": "Matern32", "pars": [1.0, 5.0]}]
        (root / "configs" / "rv3-qp.json").write_text(json.dumps(config))

    bench = small_bench(tmp_path, edit)
    monkeypatch.setattr(components, "HERE", bench.root / "reference")
    path = bench.root / "reference" / "kernels" / "Matern32.py"
    with pytest.raises(FileNotFoundError, match=str(path)):
        harness.run_cell(bench, "rv3-qp.search13", SEED, 0.0, False, "cpu")


@pytest.mark.parametrize("entry", [
    {"kernel": "QuasiPeriodic", "pars": [1.0, 30.0, 20.0, 0.7]},
    {"kernel": "Periodic", "pars": [1.0, 9.0, 0.6]},
    {"kernel": "Matern52", "pars": [1.0, 5.0]},
    {"kernel": "Linear", "pars": [40.0]},
    {"kernel": "Polynomial", "pars": [1.0, 0.01, 1.0, 2.0]},
    {"kernel": "Sum", "of": [
        {"kernel": "QuasiPeriodic", "pars": [1.0, 30.0, 20.0, 0.7]},
        {"kernel": "SquaredExponential", "pars": [0.3, 5.0]}]},
    {"kernel": "Multiplication", "of": [
        {"kernel": "Linear", "pars": [40.0]},
        {"kernel": "Sum", "of": [
            {"kernel": "Polynomial", "pars": [1.0, 0.01, 1.0, 2.0]},
            {"kernel": "Periodic", "pars": [1.0, 9.0, 0.6]}]}]}],
    ids=lambda e: e["kernel"])
def test_component_covariance_is_the_packages(entry):
    """Each kernel file, composites of them and the nugget (none on a
    Polynomial alone) against the package's training covariance."""
    from gpyrn_tpu_torch.models.gprn import pack_parameters
    from gpyrn_tpu_torch.ops.linalg import kernel_matrix
    t = torch.as_tensor(np.sort(np.random.default_rng(4).uniform(0, 60, 40)))
    config = {"q": 1, "p": 1, "nodes": [entry], "weights": [entry],
              "means": [None], "jitters": [0.1]}
    model = ref.Model(config)
    kpars, _, _ = model.split(torch.as_tensor(generator.theta0(config))[None])
    nodes, weights, means, jitters = port.components(config)
    assert np.array_equal(generator.theta0(config),
                          pack_parameters(nodes, weights, means, jitters))
    K = kernel_matrix(nodes[0].structure,
                      torch.as_tensor(nodes[0].core_params()), t)
    assert torch.allclose(model.covariance(0, kpars[0], t)[0], K,
                          rtol=1e-13, atol=0)


@pytest.mark.parametrize("name", ["rv3-qp", "rv3-2node", KEPLERIAN["name"]])
def test_theta0_takes_the_packages_order(name):
    from gpyrn_tpu_torch.models.gprn import pack_parameters
    config = KEPLERIAN if name == KEPLERIAN["name"] else json.loads(
        (harness.ROOT / "configs" / f"{name}.json").read_text())
    assert np.array_equal(generator.theta0(config),
                          pack_parameters(*port.components(config)))


def test_the_planet_is_in_the_data():
    mix = {"N": 64, "rows": 1, "spread": 0.1, "max_iter": 4}
    plain = dict(KEPLERIAN, data={k: v for k, v in KEPLERIAN["data"].items()
                                  if k != "signals"})
    pool = generator.pool(KEPLERIAN, mix, 5)
    bare = generator.pool(plain, mix, 5)
    assert np.array_equal(pool.t, bare.t)
    assert np.array_equal(pool.y[1:], bare.y[1:])
    planet = components.Mean(KEPLERIAN["means"][0]).value(
        torch.tensor([KEPLERIAN["means"][0]["pars"]], dtype=torch.float64),
        torch.as_tensor(pool.t))
    assert np.array_equal(pool.y[0], bare.y[0] + planet[0].numpy())
    assert float(planet.abs().max()) > 0.5


@pytest.mark.parametrize("name", ["rv3-qp", "rv3-2node"])
def test_bounded_reference_equals_the_batched_one(monkeypatch, name):
    """Chunks of one row, kernel matrices built a row at a time and
    solves a column at a time, against the batched path."""
    config = json.loads((harness.ROOT / "configs" / f"{name}.json")
                        .read_text())
    mix = {"N": 40, "rows": 3, "spread": 0.1, "stretch": 2.0,
           "max_iter": 100, "pool_seed": 3}
    pool = generator.pool(config, mix, None)
    t, y, yerr2 = port.tensors(pool, torch.float64, "cpu")
    theta = torch.as_tensor(generator.Batches(config, mix, pool, 5).next()[0])
    model = ref.Model(config)
    assert ref.chunking(model, 3, 40, torch.float64, None) == 3
    batched = ref.elbo_fit(model, theta, t, y, yerr2, 100)
    monkeypatch.setattr(ref, "free_bytes", lambda device: 0)
    monkeypatch.setattr(ref, "BLOCK_BYTES", 1)
    assert ref.chunking(model, 3, 40, torch.float64, 0) == 1
    assert len(ref._blocks(1, 40, torch.float64)) == 40
    bounded = ref.elbo_fit(model, theta, t, y, yerr2, 100)
    assert torch.equal(batched[3], bounded[3])
    assert torch.equal(batched[4], bounded[4])
    for a, b in zip(batched[:3], bounded[:3]):
        assert float((a - b).abs().max() / b.abs().max()) < 1e-12


# sha256 of each cell's pool, first three batches, a sample and theta0 at
# seed 0, as the generator before composite kernels and added signals gave
# them (numpy 2.0.2 on x86-64)
POOLS = {
    "rv3-qp.search13":
        "8b65df7c2b38da396cac6c8c9ab51181d1ddb505aa2f95f321e07f3d0672d20c",
    "rv3-qp.lean20k":
        "0dd2c3fc66abe687d195355492272a375850c304238de3dea370b7c78e6118dc",
    "rv3-2node.search26":
        "68e56cb28c9b45161e87d7d21c5046f43e9c549927bd76d6aea8558421349634",
}


@pytest.mark.parametrize("cell", sorted(POOLS))
def test_pools_and_batches_are_unchanged(cell):
    bench = harness.Bench()
    spec = bench.cell(cell)
    config, mix = bench.config(spec["config"]), bench.traffic(spec["traffic"])
    h = hashlib.sha256()
    pool = generator.pool(config, mix, 0)
    for a in pool:
        if a is not None:
            h.update(np.ascontiguousarray(a).tobytes())
    batches = generator.Batches(config, mix, pool, 0)
    for _ in range(3):
        theta, walkers = batches.next()
        h.update(theta.tobytes())
        if walkers is not None:
            h.update(np.asarray(walkers).tobytes())
    h.update(np.asarray(batches.sample(100, 4, must=[7])).tobytes())
    h.update(generator.theta0(config).tobytes())
    assert h.hexdigest() == POOLS[cell]


@pytest.mark.cuda
@pytest.mark.parametrize("name,N", [("rv3-qp", 50_000), ("rv3-2node", 20_000)])
def test_reference_row_fits_in_70_gb(card, name, N):
    """One float64 reference row of the structure at N, two sweeps, from
    the heuristic start: the peak by ``max_memory_allocated``."""
    import time
    config = json.loads((harness.ROOT / "configs" / f"{name}.json")
                        .read_text())
    pool = generator.pool(config, {"N": N, "rows": 1, "spread": 0.1}, 1)
    t, y, yerr2 = (torch.as_tensor(a, dtype=torch.float64, device="cuda")
                   for a in (pool.t, pool.y, pool.yerr ** 2))
    theta = torch.as_tensor(generator.theta0(config), device="cuda")[None]
    model = ref.Model(config)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    elbo, _, _, n_iter, _ = ref.elbo_fit(model, theta, t, y, yerr2, 2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"\n{name} N={N}: peak {peak} bytes ({peak / 1e9:.3f} GB), "
          f"{seconds / 2:.3f} s a sweep, elbo {float(elbo[0])!r}, "
          f"{torch.cuda.get_device_name(0)}")
    assert int(n_iter[0]) == 2 and torch.isfinite(elbo).all()
    assert peak <= 70e9
