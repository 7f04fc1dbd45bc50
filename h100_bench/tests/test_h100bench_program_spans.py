"""The readers of the program's own record (``program_spans.py``,
``metrics/syncs.search.py``, ``metrics/idle.read.search.py``,
``metrics/idle.sweep.search.py``) on a made-up trace and made-up spans
that share its clock; on the card, the counted host reads against the
syncs that torch's sync debug mode sees, and the spans' clock against the
device trace's."""
import collections
import re
import time
import warnings

import numpy as np
import pytest

from h100_bench import generator, harness, program_spans, trace
from h100_bench.tests.conftest import fake_profile, small_bench

MS = 1_000_000
T0 = 1_800_000_000 * 10 ** 9          # a slice on the Unix-epoch clock


FakeSpan = collections.namedtuple(
    "FakeSpan", "id name start_ns end_ns parent call counts")


def _spans():
    """A batch loop over a 100 ms slice: each 20 ms sweep is enqueued in
    [0, 6) ms (the device idle in [0, 2)), its stop test read in [6, 14)
    (busy to 12, idle in [12, 14)) and, in the second and fourth, a gather
    in [14, 20) (idle throughout); the device is idle in [14, 20) of the
    other sweeps too, with the host outside the read and sweep spans."""
    out, k = [], 100
    for i in range(5):
        base = T0 + 20 * i * MS
        out.append(FakeSpan(k, "gprn.sweep", base, base + 6 * MS, 1, 1,
                            None))
        out.append(FakeSpan(k + 1, "gprn.stop", base + 6 * MS,
                            base + 14 * MS, 1, 1, None))
        if i in (1, 3):
            out.append(FakeSpan(k + 2, "gprn.gather", base + 14 * MS,
                                base + 20 * MS, 1, 1, None))
        k += 3
    return out


def _trace():
    device = [("kernel", T0 + (20 * i + 2) * MS, T0 + (20 * i + 12) * MS)
              for i in range(5)]
    return trace.Trace(0.1, device, [], T0, T0 + 100 * MS)


def _run(units, tr):
    return harness.Run({}, {}, {}, "float64", 1.0, 1.0, units, tr)


def _units(n):
    return [harness.Unit(0.1, 3, 5, np.array([5, 4, 3]), False)
            for _ in range(n)]


def _calls():
    """Two set-up calls, then two window calls."""
    def call(i, sweeps, reads):
        return FakeSpan(i, "gprn.fit_batch", T0 + i, T0 + i + 1, 0, i,
                        {"gprn.batch.sweeps": sweeps,
                         "gprn.batch.host_reads": reads,
                         "launches.kernel_matrix": 1})
    return [call(1, 100, 900), call(2, 4, 3), call(3, 10, 40),
            call(4, 30, 80)]


def test_readers_split_the_idle_slice_into_read_sweep_and_rest(monkeypatch):
    monkeypatch.setattr(program_spans, "record", _spans)
    bench = harness.Bench()
    run = _run(_units(2), _trace())
    idle = bench.reader("idle.search")(run)
    read = bench.reader("idle.read.search")(run)
    sweep = bench.reader("idle.sweep.search")(run)
    # idle 10 ms of each 20: [0, 2) in the sweep, [12, 14) in the stop
    # test, [14, 20) in a gather (2 sweeps) or outside (3 sweeps)
    assert idle == pytest.approx(50.0)
    assert sweep == pytest.approx(5 * 2 / 100 * 100)
    assert read == pytest.approx((5 * 2 + 2 * 6) / 100 * 100)
    assert idle - read - sweep == pytest.approx(3 * 6 / 100 * 100)


def test_syncs_read_the_window_calls_alone(monkeypatch):
    monkeypatch.setattr(program_spans, "record",
                        lambda: _calls() + _spans())
    run = _run(_units(2), _trace())
    assert harness.Bench().reader("syncs.search")(run) == \
        pytest.approx((40 + 80) / (10 + 30))


def test_readers_without_a_record_or_outside_the_slice(monkeypatch):
    bench = harness.Bench()
    run = _run(_units(2), _trace())
    names = ("syncs.search", "idle.read.search", "idle.sweep.search")
    # a package that keeps no record, or has recorded nothing
    for record in (lambda: None, lambda: []):
        monkeypatch.setattr(program_spans, "record", record)
        assert [bench.reader(n)(run) for n in names] == [None] * 3
    # spans, none in the slice: the shares read 0
    late = [s._replace(start_ns=s.start_ns + 10 ** 12,
                       end_ns=s.end_ns + 10 ** 12) for s in _spans()]
    monkeypatch.setattr(program_spans, "record", lambda: late)
    assert bench.reader("idle.read.search")(run) == 0.0
    assert bench.reader("idle.sweep.search")(run) == 0.0
    # no trace
    assert program_spans.idle_share(_run(_units(2), None),
                                    program_spans.READ) is None


def test_the_window_reads_the_programs_record(tmp_path, monkeypatch,
                                             capsys):
    """A traced run of search13 at N = 40 (the fake trace): the counts of
    the window's calls, not the set-up's, make ``syncs.search``; their
    sweeps are the window's batched sweeps."""
    monkeypatch.setattr(trace, "profile", fake_profile)
    line = harness.run_cell(small_bench(tmp_path), "rv3-qp.search13",
                            2 ** 31 + 21, 0.0, True, "cpu")
    window = re.search(r"window: \S+ s, (\d+) batches, \d+ fits, (\d+) "
                       r"batched sweeps", capsys.readouterr().err)
    batches, sweeps = int(window[1]), int(window[2])
    from gpyrn_tpu_torch.utils import profiling
    calls = [s for s in profiling.spans()
             if s.name == "gprn.fit_batch"][-batches:]
    assert sum(c.counts["gprn.batch.sweeps"] for c in calls) == sweeps
    reads = sum(c.counts["gprn.batch.host_reads"] for c in calls)
    assert line["metrics"]["syncs.search"]["value"] == reads / sweeps
    assert 1 < reads / sweeps < 20
    # the fake trace's clock starts at 0, far from the spans'
    assert line["metrics"]["idle.read.search"]["value"] == 0.0
    assert line["metrics"]["idle.sweep.search"]["value"] == 0.0


def _search_batch(name, seed):
    """The program of cell ``name`` on the card after its set-up, and the
    rows and start of its first batch."""
    import torch
    bench = harness.Bench()
    cell = bench.cell(name)
    config, traffic = bench.config(cell["config"]), bench.traffic(
        cell["traffic"])
    pool = generator.pool(config, traffic, seed)
    batches = generator.Batches(config, traffic, pool, seed)
    program = bench.entry(traffic["entry"])(config, traffic, pool, "cuda",
                                            torch.float64)
    states = program.walker_states(pool.walkers)
    h = int(traffic["rows"])
    program.warm_up(pool.walkers[:h], (states[0][:h], states[1][:h]))
    theta, walkers = batches.next()
    torch.cuda.synchronize()
    return program, program._theta(theta), (states[0][walkers],
                                            states[1][walkers])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rv3-qp.search13", "rv3-2node.search26"])
def test_host_reads_are_the_syncs_torch_sees(card, name):
    """One batch of the cell under ``set_sync_debug_mode("warn")``: each
    synchronizing call warns once, and the counter rose by as many.  A
    batch first runs under the mode uncounted, so that one-off syncs of
    the mode's first use are not the batch's."""
    import torch
    from gpyrn_tpu_torch.utils import profiling
    program, theta, (mu0, var0) = _search_batch(name, 2 ** 31 + 101)
    eng = program.eng

    def fit():
        return eng.elbo_fit_batch(theta, *program.data, mu0, var0,
                                  program.max_iter)
    got = []
    try:
        torch.cuda.set_sync_debug_mode("warn")
        for _ in range(2):
            before = profiling.counts()["gprn.batch.host_reads"]
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = fit()
            got.append((profiling.counts()["gprn.batch.host_reads"]
                        - before, caught))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    reads, caught = got[1]
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    sites = collections.Counter(f"{w.filename}:{w.lineno}" for w in syncs)
    print(f"{name}: sweeps {int(out[3].max())}, host reads {reads}, "
          f"sync warnings {len(syncs)}, first batch {got[0][0]} / "
          f"{len(got[0][1])}; sites {dict(sites)}")
    assert reads == len(syncs) > 0


@pytest.mark.cuda
def test_spans_hold_their_device_work_on_the_trace_clock(card):
    """B1 launched and synchronized inside a span, traced with the device
    alone (as the benchmark's per-layer slice is): the kernel's device
    interval lies inside the span's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpyrn_tpu_torch.ops import linalg
    from gpyrn_tpu_torch.utils import profiling
    t = torch.linspace(0, 100, 4096, dtype=torch.float64, device="cuda")

    def b1():
        linalg.kernel_matrix(("QP",), (1.1, 20.0, 13.0, 0.6), t)
        torch.cuda.synchronize()
    b1()
    spans = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            with profiling.span("gprn.test_b1") as s:
                b1()
            spans.append((s.start_ns, s.end_ns))
            time.sleep(0.002)
    kernels = sorted(
        (ev.start_ns(), ev.start_ns() + ev.duration_ns())
        for ev in prof.profiler.kineto_results.events()
        if trace.is_b1(ev.name())
        and ev.device_type() == torch.autograd.DeviceType.CUDA)
    assert len(kernels) == len(spans)
    lead = [ks - ss for (ss, _), (ks, _) in zip(spans, kernels)]
    tail = [se - ke for (_, se), (_, ke) in zip(spans, kernels)]
    print(f"B1 start after the span's start (ns): {lead}; "
          f"span's end after B1's end (ns): {tail}")
    assert min(lead) > 0 and min(tail) > 0
