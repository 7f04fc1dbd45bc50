"""The yardstick on the CPU: the plain reference against the package at
N <= 64, the counts against cases worked by hand, and the trace's
arithmetic."""
import json

import numpy as np
import pytest
import torch

from h100_bench import counts, generator, harness, port, readings, trace
from h100_bench.entries import batch_fit
from h100_bench.reference import gprn as ref
from h100_bench.tests.conftest import KEPLERIAN


@pytest.mark.parametrize("start", ["heuristic", "walker"])
@pytest.mark.parametrize("name", ["rv3-qp", "rv3-2node", KEPLERIAN["name"]])
def test_reference_agrees_with_the_package(name, start):
    """The fits of four rows, from the heuristic start, or from the states
    of the walkers they were proposed from (the sampler's warm start); the
    two configurations of the benchmark, and the test's Keplerian one
    (a Keplerian mean, a planet in its data, a sum of kernels)."""
    config = KEPLERIAN if name == KEPLERIAN["name"] else json.loads(
        (harness.ROOT / "configs" / f"{name}.json").read_text())
    mix = {"N": 48, "rows": 4, "spread": 0.1, "stretch": 2.0,
           "max_iter": 100, "pool_seed": 3}
    pool = generator.pool(config, mix, None)
    t, y, yerr2 = port.tensors(pool, torch.float64, "cpu")
    eng = port.engine(config, 48)
    model = ref.Model(config)
    mu0, var0 = eng.init_mu_var(torch.as_tensor(pool.walkers), y)
    r_mu0, r_var0 = ref.initial_state(model, torch.as_tensor(pool.walkers),
                                      y)
    assert torch.equal(mu0, r_mu0) and torch.equal(var0, r_var0)
    theta, walkers = generator.Batches(config, mix, pool, 5).next()
    theta = torch.as_tensor(theta)
    r_start = None
    if start == "walker":
        program = batch_fit.Entry(config, mix, pool, "cpu", torch.float64)
        mu0, var0 = (s[walkers] for s in program.walker_states(
            pool.walkers))
        r_start = tuple(s[walkers] for s in ref.walker_states(
            model, torch.as_tensor(pool.walkers), t, y, yerr2, 100))
        assert float((mu0 - r_start[0]).abs().max()) < 1e-10 * float(
            r_start[0].abs().max())
    else:
        mu0, var0 = eng.init_mu_var(theta, y)
    elbo, mu, var, n_iter, conv = eng.elbo_fit_batch(theta, t, y, yerr2,
                                                     mu0, var0, 100)
    r_elbo, r_mu, r_var, r_n, r_conv = ref.elbo_fit(model, theta, t, y,
                                                    yerr2, 100, r_start)
    assert torch.equal(n_iter, r_n) and torch.equal(conv, r_conv)
    assert float(((elbo - r_elbo) / r_elbo).abs().max()) < 1e-10
    assert float((mu - r_mu).abs().max() / r_mu.abs().max()) < 1e-10
    assert float((var - r_var).abs().max() / r_var.abs().max()) < 1e-10


def test_counts_against_hand_worked_cases():
    # q = 1, p = 3, N = 3: 4 GPs x (9 + 9) a sweep, 4 x 9 a fit
    assert counts.sweep_flops(3, 1, 3) == 72
    assert counts.fit_flops(3, 1, 3) == 36
    # q = 2, p = 3: 8 GPs x 18 + one node pair's 27 a sweep; 8 x 9 + the
    # two node inverses' 2 x 9 a fit
    assert counts.sweep_flops(3, 2, 3) == 171
    assert counts.fit_flops(3, 2, 3) == 90
    assert counts.fits_flops(3, 1, 3, [1, 2]) == 2 * 36 + 3 * 72
    # B1 at N = 1000 in float64: 8 MB written at 3.35 TB/s outweighs
    # 6 x 500,500 operations at 34 TFLOP/s
    assert counts.kernel_matrix_seconds(1000, "float64",
                                        "SquaredExponential") == \
        pytest.approx(8e6 / 3.35e12)
    # a float32 QP matrix of N = 4: 64 bytes (19 ps) outweigh 17 x 10
    # operations (2.5 ps): B1 is held to its bytes at every N
    assert counts.kernel_matrix_seconds(4, "float32", "QuasiPeriodic") == \
        pytest.approx(64 / 3.35e12)


def test_busy_time_is_the_union_of_device_intervals():
    device = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 22, 25)]
    tr = trace.Trace(40e-9, device, [(trace.SLICE, 0, 40)], 0, 40)
    assert tr.busy_s == pytest.approx(25e-9)
    assert tr.device_s() == pytest.approx(33e-9)
    assert trace.gaps(tr) == [(15, 20), (30, 40)]
    assert trace.union_ns([]) == 0


def test_readings_of_a_run():
    config = json.loads((harness.ROOT / "configs" / "rv3-qp.json")
                        .read_text())
    ms = 1_000_000
    tr = trace.Trace(0.01, [("void kernel_matrix_kernel<double, 3>", 0,
                             2 * ms), ("potrf_kernel", 2 * ms, 6 * ms),
                            ("elementwise_kernel", 6 * ms, 8 * ms)],
                     [(trace.SLICE, 0, 10 * ms)], 0, 10 * ms)
    units = [harness.Unit(2.0, 2, 30, np.array([30, 20]), False),
             harness.Unit(1.0, 2, 10, np.array([10, 10]), True)]
    run = harness.Run({}, config, {"N": 1000}, "float64", 5.0, 4.0, units,
                      tr)
    assert readings.fits_per_s(run) == 1.0
    assert readings.seconds_per_sweep(run) == 0.1
    assert readings.sweep_ms(run) == pytest.approx(2000 / 30)
    assert readings.linalg_share(run) == pytest.approx(50.0)
    assert readings.idle(run) == pytest.approx(20.0)
    flops = counts.fits_flops(1000, 1, 3, [30, 20])
    assert readings.mfu(run) == pytest.approx(100 * flops / (2.0 * 67e12))
    assert readings.b1_roofline(run) == pytest.approx(
        100 * (8e6 / 3.35e12) / 2e-3)
    empty = run._replace(trace=None, units=units[1:])
    assert readings.b1_roofline(empty) is None
    assert readings.idle(empty) is None and readings.mfu(empty) is None
