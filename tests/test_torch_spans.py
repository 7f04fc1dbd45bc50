"""The span recorder and the counters of ``gpyrn_tpu_torch.utils.profiling``
on the CPU, and what ``Engine.elbo_fit_batch`` records with them.

* spans nest: each holds its parent's id and the id of the top-level span
  (the call) it belongs to, and a span opened with ``counts=True`` keeps
  what each counter rose by while it was open; the ring keeps the last
  65,536;
* under ``torch.profiler`` each span is also a ``record_function`` event
  whose start and end agree with the recorder's within 1 ms: the two
  share a clock;
* ``StageTimer`` stages and ``LAUNCHES`` live in the same record;
* a batched fit at N = 40 records one ``gprn.fit_batch`` with its stages
  under it, and counts exactly the host reads its sweep counts imply; its
  span keeps its counts inside a ``StageTimer`` stage too."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpyrn_tpu_torch import covfunc, meanfunc
from gpyrn_tpu_torch.models.gprn import (make_engine, pack_parameters,
                                         spec_from_components)
from gpyrn_tpu_torch.ops import cuda_kernels as ck
from gpyrn_tpu_torch.utils import profiling
from gpyrn_tpu_torch.utils.profiling import StageTimer, span

torch.set_num_threads(1)

N, ROWS = 40, 3


def _new(first):
    """The spans recorded since the one with id ``first``."""
    return [s for s in profiling.spans() if s.id > first]


def _last_id():
    with span("marker") as s:
        pass
    return s.id


def test_spans_nest_under_their_parent_and_call():
    first = _last_id()
    group = profiling.counters("test.spans", ("ticks",))
    with span("outer", counts=True) as outer:
        with span("inner", counts=True) as inner:
            with span("leaf") as leaf:
                group["ticks"] += 2
        with span("second") as second:
            pass
    with span("alone", counts=True) as alone:
        group["ticks"] += 1
    with span("uncounted") as uncounted:
        group["ticks"] += 1
    got = {s.name: s for s in _new(first)}
    # closed innermost first
    assert [s.name for s in _new(first)] == ["leaf", "inner", "second",
                                            "outer", "alone", "uncounted"]
    assert got["outer"].parent == 0 and got["outer"].call == outer.id
    assert got["inner"].parent == outer.id and got["inner"].call == outer.id
    assert got["leaf"].parent == inner.id and got["leaf"].call == outer.id
    assert got["second"].parent == outer.id
    assert got["alone"].parent == 0 and got["alone"].call == alone.id
    assert got["uncounted"].call == uncounted.id
    assert got["leaf"].id == leaf.id and got["second"].id == second.id
    for s in got.values():
        assert s.start_ns <= s.end_ns
    assert got["outer"].start_ns <= got["inner"].start_ns \
        <= got["leaf"].start_ns <= got["leaf"].end_ns <= got["inner"].end_ns \
        <= got["second"].start_ns <= got["outer"].end_ns
    # counted spans keep the counters' rise, at any depth; the others
    # nothing
    assert got["outer"].counts == {"test.spans.ticks": 2}
    assert got["inner"].counts == {"test.spans.ticks": 2}
    assert got["alone"].counts == {"test.spans.ticks": 1}
    assert got["leaf"].counts is None and got["second"].counts is None
    assert got["uncounted"].counts is None


def test_a_span_closes_on_an_exception():
    first = _last_id()
    with pytest.raises(ValueError):
        with span("outer"):
            with span("inner"):
                raise ValueError
    assert [s.name for s in _new(first)] == ["inner", "outer"]
    with span("after") as after:
        pass
    assert _new(first)[-1].parent == 0 and after.call == after.id


def test_the_ring_is_bounded():
    capacity = profiling._SPAN_CAPACITY
    for _ in range(capacity + 5):
        with span("fill"):
            pass
    with span("newest") as newest:
        pass
    kept = profiling.spans()
    assert len(kept) == capacity
    assert kept[-1].id == newest.id
    assert kept[0].id == newest.id - capacity + 1


def test_spans_are_record_functions_on_the_profilers_clock():
    first = _last_id()
    a = torch.ones(64, 64, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("gprn.test_outer"):
            for _ in range(3):
                with span("gprn.test_inner"):
                    torch.mm(a, a)
    ours = {}
    for s in _new(first):
        ours.setdefault(s.name, []).append((s.start_ns, s.end_ns))
    theirs = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in ours:
            theirs.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    assert {k: len(v) for k, v in theirs.items()} == \
        {"gprn.test_outer": 1, "gprn.test_inner": 3}
    for name, mine in ours.items():
        for (s, e), (ps, pe) in zip(sorted(mine), sorted(theirs[name])):
            assert abs(s - ps) < 1_000_000 and abs(e - pe) < 1_000_000
            # the profiler's event lies inside the recorder's span
            assert s <= ps <= pe <= e


def test_stage_timer_stages_are_spans():
    first = _last_id()
    timer = StageTimer()
    with timer.stage("fit", block_on=torch.ones(2)):
        with span("gprn.test_inside"):
            pass
    stages = [s for s in _new(first) if s.name == "fit"]
    inner = [s for s in _new(first) if s.name == "gprn.test_inside"]
    assert len(stages) == 1 and inner[0].parent == stages[0].id
    # the stage is timed on the monotonic clock, its span on the profiler's
    assert len(timer.times["fit"]) == 1
    assert abs(timer.times["fit"][0]
               - (stages[0].end_ns - stages[0].start_ns) / 1e9) < 1e-3
    with pytest.raises(RuntimeError):
        with timer.stage("fails"):
            raise RuntimeError
    assert len(timer.times["fails"]) == 1


def test_launches_are_counters_of_the_registry():
    assert profiling.counters("launches", ()) is ck.LAUNCHES
    ck.LAUNCHES["kernel_matrix"] += 3
    assert profiling.counts()["launches.kernel_matrix"] >= 3
    ck.reset_launch_counts()
    assert ck.LAUNCHES == {"kernel_matrix": 0, "kernel_matrix_grad": 0,
                           "kernel_matvec": 0}
    ck.LAUNCHES["kernel_matvec"] += 1
    profiling.reset_counts()
    assert set(profiling.counts().values()) == {0}


def _batch(q):
    rng = np.random.default_rng(40 + q)
    t = np.sort(rng.uniform(0, 100, N))
    y = np.stack([np.sin(2 * np.pi * t / P) + 0.1 * rng.standard_normal(N)
                  for P in (20, 25, 30)])
    cf = covfunc
    nodes = [cf.QuasiPeriodic(1.0, 30.0, 27.0, 0.7),
             cf.Matern52(1.0, 5.0)][:q]
    weights = [cf.SquaredExponential(1.0 + 0.1 * k, 30.0)
               for k in range(3 * q)]
    means = [None, meanfunc.Linear(0.01, 0.0), None]
    eng = make_engine(spec_from_components(nodes, weights, means, N))
    theta0 = pack_parameters(nodes, weights, means, [0.1] * 3)
    theta = torch.as_tensor(theta0[None] * np.exp(
        0.1 * rng.standard_normal((ROWS, theta0.size))))
    data = (torch.as_tensor(t), torch.as_tensor(y),
            torch.full((3, N), 0.01, dtype=torch.float64))
    return eng, theta, data


@pytest.mark.parametrize("q, max_iter", [(1, 100), (2, 100), (1, 6)])
def test_batch_fit_counts_its_host_reads(q, max_iter):
    eng, theta, data = _batch(q)
    mu0, var0 = eng.init_mu_var(theta, data[1])
    profiling.reset_counts()
    first = _last_id()
    _, _, _, n_iter, converged = eng.elbo_fit_batch(theta, *data, mu0, var0,
                                                    max_iter)
    n_iter, converged = n_iter.numpy(), converged.numpy()
    sweeps = int(n_iter.max())
    # the stop test's read each sweep from sweep 4; each sweep at which
    # rows stop gathers: two copies to the device and five mask indexings
    # in finish(), the keep mask's copy, and the mask indexings of the
    # prepared constants that have rows (5: Kf, Kw_flat, Linv_all, y_c,
    # variance), the four states, hist and elbo; rows left running at
    # max_iter are written out by a last finish(); the returned n_iter and
    # converged are two copies to the device
    events = len(set(n_iter[converged].tolist()))
    gather = 2 + 5 + 1 + 5 + 4 + 2
    last = 7 if not converged.all() else 0
    reads = max(sweeps - 3, 0) + gather * events + last + 2
    assert profiling.counts()["gprn.batch.sweeps"] == sweeps
    assert profiling.counts()["gprn.batch.host_reads"] == reads
    if max_iter == 6:
        assert sweeps == 6 and not converged.all()
    else:
        assert converged.all() and events >= 2

    got = _new(first)
    call = [s for s in got if s.name == "gprn.fit_batch"]
    assert len(call) == 1 and call[0].parent == 0
    # every sweep applies an inverse for the node and the weight updates,
    # the prior term and each node pair's cross trace
    assert call[0].counts == {"gprn.batch.sweeps": sweeps,
                              "gprn.batch.host_reads": reads,
                              "gprn.sweep.inverse_solves":
                              sweeps * (3 + q * (q - 1) // 2)}
    inner = [s for s in got if s.name != "gprn.fit_batch"]
    assert all(s.parent == call[0].id and s.call == call[0].id
               for s in inner)
    names = [s.name for s in inner]
    assert names.count("gprn.prepare") == 1
    assert names.count("gprn.sweep") == names.count("gprn.stop") == sweeps
    assert names.count("gprn.gather") == events + 1
    assert names[0] == "gprn.prepare" and names[-1] == "gprn.gather"


def test_batch_fit_inside_a_stage_keeps_its_counts():
    """A batched fit timed as a ``StageTimer`` stage: its span lies under
    the stage's and still keeps the counts of the fit alone."""
    eng, theta, data = _batch(1)
    mu0, var0 = eng.init_mu_var(theta, data[1])
    first = _last_id()
    timer = StageTimer()
    with timer.stage("sampler"):
        for _ in range(2):
            before = profiling.counts()
            eng.elbo_fit_batch(theta, *data, mu0, var0, 6)
            after = profiling.counts()
    got = _new(first)
    stage = [s for s in got if s.name == "sampler"]
    calls = [s for s in got if s.name == "gprn.fit_batch"]
    assert len(stage) == 1 and stage[0].counts is None
    assert len(calls) == 2
    assert all(c.parent == stage[0].id and c.call == stage[0].id
               for c in calls)
    assert calls[-1].counts == {k: after[k] - before[k] for k in after
                                if after[k] != before[k]}
    assert calls[-1].counts["gprn.batch.sweeps"] == 6
