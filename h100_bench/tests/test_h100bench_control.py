"""The correctness check fails what it has to fail: the package's float32
path in its place (the control), and the timed path broken underneath a
whole run, once for each fault these cells can have.  (The cells run on
one card, so no exchange between cards can be left out.)"""
import pytest
import torch

from h100_bench import harness
from gpyrn_tpu_torch.inference import meanfield
from gpyrn_tpu_torch.models import gprn

CELLS = ["rv3-qp.search13", "rv3-qp.lean20k", "rv3-2node.search26"]
SEED = 2 ** 31 + 101
# the sweeps a fit runs: the dense engine's, and the lean engine's that
# ELBOcalc takes from LEAN_N on
SWEEPS = ("_sweep", "_sweep_free_lean")


@pytest.fixture(autouse=True)
def lean_at_small_n(monkeypatch):
    """The small lean cell through the lean engine, as at N = 20,000."""
    monkeypatch.setattr(meanfield, "LEAN_N", 1)


@pytest.mark.parametrize("cell", CELLS)
def test_float32_control_fails_where_float64_passes(bench, cell):
    line = harness.run_cell(bench, cell, SEED, 0.0, False, "cpu")
    assert line["correct"] is True, line["checks"]
    line = harness.run_cell(bench, cell, SEED, 0.0, False, "cpu",
                            dtype="float32")
    assert line["correct"] is False, line["checks"]


def _state_unchanged(monkeypatch):
    for name in SWEEPS:
        def unchanged(self, *args, sweep=getattr(gprn.Engine, name)):
            elbo, *_ = sweep(self, *args)
            return (elbo, *args[-4:])
        monkeypatch.setattr(gprn.Engine, name, unchanged)


def _half_the_batch(monkeypatch):
    fit = gprn.Engine.elbo_fit_batch

    def half(self, theta, t, y, yerr2, mu0, var0, max_iter=10000):
        h = max(1, theta.shape[0] // 2)
        out = fit(self, theta[:h], t, y, yerr2, mu0[:h], var0[:h], max_iter)
        rest = theta.shape[0] - h
        return tuple(torch.cat([o, o.double().mean(0, keepdim=True).to(
            o.dtype).expand(rest, *o.shape[1:])]) for o in out)
    monkeypatch.setattr(gprn.Engine, "elbo_fit_batch", half)


def _answer_altered(monkeypatch):
    for name in SWEEPS:
        def altered(self, *args, sweep=getattr(gprn.Engine, name)):
            elbo, *state = sweep(self, *args)
            return (elbo * (1 + 1e-3), *state)
        monkeypatch.setattr(gprn.Engine, name, altered)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_the_batch": _half_the_batch,
          "answer_altered": _answer_altered}


# the lean cell fits one row at a time: it has no batch to halve
CASES = [(c, f) for c in CELLS for f in FAULTS
         if not (f == "half_the_batch" and c == "rv3-qp.lean20k")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(bench, monkeypatch, cell,
                                            fault):
    FAULTS[fault](monkeypatch)
    line = harness.run_cell(bench, cell, SEED, 0.0, False, "cpu")
    assert line["correct"] is False, line["checks"]
