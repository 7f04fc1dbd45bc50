"""The quantities the metric readers in ``metrics/`` take from a run
(``harness.Run``).  Each returns None when the run holds nothing to read;
every share is a percentage."""
from __future__ import annotations

from h100_bench import counts, trace


def fits_per_s(run):
    return sum(u.rows for u in run.units) / run.window_s


def seconds_per_sweep(run):
    return run.window_s / sum(u.sweeps for u in run.units)


def sweep_ms(run):
    """Host time per batched sweep over the window's untraced batches."""
    units = run.untraced
    if not units:
        return None
    return 1e3 * sum(u.seconds for u in units) / sum(u.sweeps for u in units)


def linalg_share(run):
    t = run.trace
    if t is None or t.device_s() == 0:
        return None
    return 100 * t.device_s(trace.is_linalg) / t.device_s()


def idle(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return 100 * (1 - t.busy_s / t.window_s)


def mfu(run):
    """The fits' counted operations over the untraced batches' time at the
    card's peak."""
    units = run.untraced
    if not units:
        return None
    c = run.config
    N = int(run.traffic["N"])
    flops = sum(counts.fits_flops(N, int(c["q"]), int(c["p"]), u.n_iter)
                for u in units)
    seconds = sum(u.seconds for u in units)
    return 100 * flops / (seconds * counts.PEAK_FLOPS[run.dtype])


def b1_roofline(run):
    """B1's least time, from its launches in the trace and the shapes,
    over its device time there."""
    t = run.trace
    if t is None:
        return None
    launches = t.count(trace.is_b1)
    if launches == 0:
        return None
    c = run.config
    kernels = [k["kernel"] for k in c["nodes"] + c["weights"]]
    least = sum(counts.kernel_matrix_seconds(int(run.traffic["N"]),
                                             run.dtype, k)
                for k in kernels) / len(kernels)
    return 100 * launches * least / t.device_s(trace.is_b1)


def setup_s(run):
    return run.setup_s
