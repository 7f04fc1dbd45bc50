"""The program's own record of its batch loop, as the per-layer metrics of
the ``Batch loop`` layer read it: the spans and counters that
``gpyrn_tpu_torch.utils.profiling`` keeps (``Engine.elbo_fit_batch``'s
``gprn.*``).  The spans are stamped on the clock of the profiler's events,
so they lie on the device trace's timeline.

A package that keeps no such record gives None (its metrics are left out
of the line); where it keeps spans but none falls in the traced slice,
the shares read 0.  Importing this module imports nothing of the
package."""
from __future__ import annotations

from h100_bench import trace

CALL = "gprn.fit_batch"
SWEEPS, READS = "gprn.batch.sweeps", "gprn.batch.host_reads"
READ = ("gprn.stop", "gprn.gather")
SWEEP = ("gprn.sweep",)


def record():
    """The program's spans, oldest first, or None where it keeps none."""
    try:
        from gpyrn_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    return spans() if spans is not None else None


def syncs_per_sweep(run):
    """Host reads over batched sweeps, over the window's batches: the
    counts of the last ``len(run.units)`` calls, set-up left out."""
    spans = record()
    if not spans:
        return None
    calls = [s for s in spans if s.name == CALL and s.counts is not None]
    calls = calls[-len(run.units):]
    sweeps = sum(c.counts.get(SWEEPS, 0) for c in calls)
    if sweeps == 0:
        return None
    return sum(c.counts.get(READS, 0) for c in calls) / sweeps


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap_ns(a, b):
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share(run, names):
    """The share (%) of the traced slice's wall in which the device was
    idle while the host was inside one of the spans ``names``."""
    t = run.trace
    if t is None or not t.device:
        return None
    spans = record()
    if not spans:
        return None
    inside = _union([(s.start_ns, s.end_ns) for s in spans
                     if s.name in names and s.end_ns > t.t0_ns
                     and s.start_ns < t.t1_ns])
    return 100 * _overlap_ns(trace.gaps(t), inside) / (t.window_s * 1e9)
