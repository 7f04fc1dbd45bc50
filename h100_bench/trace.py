"""The device trace of a slice of the window, and the readings taken
from it.

``torch.profiler`` records the host (the benchmark's spans, the operators
and the CUDA runtime calls) and the device (kernels, copies, fills) on
one clock.  From that:

* busy time is the union of the device intervals, not their sum, so
  overlapping work is counted once (chip_smoke.py's ``_trace_kernels``
  summed them);
* an idle gap is a stretch of the slice with no device interval; it is
  put down to the innermost host event that covers its middle (in a
  second slice, traced with the host's operators, which slow the host);
* kernels fall into the classes below by their names, frozen here.

A trace that holds no device interval is taken again on the next unit of
work, up to ``TRIES`` times; after that the run fails rather than report
an idle share from an empty trace.
"""
from __future__ import annotations

import bisect
import time
from typing import NamedTuple

TRIES = 3
TOP = 10

# kernels of the vendor libraries behind torch.linalg and matmul (cuSOLVER,
# cuBLAS, MAGMA), by the substrings of their names
LINALG = ("potrf", "potrs", "potri", "trtri", "lauum", "trsm", "trsv",
          "trmm", "gemm", "gemv", "syrk", "herk", "getrf", "getrs", "geqrf",
          "magma", "cusolver", "cublas", "xmma", "nvjet", "cutlass",
          "sm90_", "dot_kernel", "ger_kernel", "axpy", "scal_kernel")
# B1, the package's kernel-matrix kernel (not its backward or its
# product entry)
B1 = ("kernel_matrix_kernel",)


def is_linalg(name):
    low = name.lower()
    return any(k in low for k in LINALG)


def is_b1(name):
    return any(k in name for k in B1)


class Trace(NamedTuple):
    window_s: float                 # host wall of the slice
    device: list                    # [(name, start_ns, end_ns)]
    host: list                      # [(name, start_ns, end_ns)], by start
    t0_ns: int                      # the slice's start on the trace clock
    t1_ns: int

    @property
    def busy_s(self):
        return union_ns([(s, e) for _, s, e in self.device]) / 1e9

    def device_s(self, keep=lambda name: True):
        return sum(e - s for n, s, e in self.device if keep(n)) / 1e9

    def count(self, keep):
        return sum(1 for n, _, _ in self.device if keep(n))


def union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(trace):
    """[(start_ns, end_ns)] of the slice's stretches with nothing on the
    device."""
    out, cursor = [], trace.t0_ns
    for s, e in sorted((s, e) for _, s, e in trace.device):
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    if trace.t1_ns > cursor:
        out.append((cursor, trace.t1_ns))
    return out


def _ns(event, what):
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{what}_us")() * 1000)


def profile(fn, host=True):
    """``(result, Trace)`` of one call of ``fn`` under the profiler, the
    card synchronized before and after; ``fn`` marks the slice with the
    span ``SLICE``.  With ``host=False`` only the device is recorded,
    which costs the host next to nothing, and the slice is the host's wall
    around the call; recording the host's operators slows a launch-bound
    host by a third (a 13-row batch at N = 1000: 1.11 s against 0.86 s).
    The trace may hold no device interval: the caller retries on its next
    unit of work."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    with _profile(activities=activities) as prof:
        w0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - w0
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = _ns(ev, "start")
        e = s + int(ev.duration_ns()) if hasattr(ev, "duration_ns") \
            else s + int(ev.duration_us() * 1000)
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            # the host's spans are mirrored on the device's timeline as
            # annotations; they are not device work
            if not getattr(ev, "is_user_annotation", bool)() and \
                    not ev.name().startswith(("h100_bench", SLICE)):
                device.append((ev.name(), s, e))
        else:
            host.append((ev.name(), s, e))
    host.sort(key=lambda h: h[1])
    if not host:
        t0 = min((s for _, s, _ in device), default=0)
        return out, Trace(window_s, device, host, t0,
                          t0 + int(window_s * 1e9))
    spans = [h for h in host if h[0] == SLICE]
    t0 = spans[0][1] if spans else min((h[1] for h in host), default=0)
    t1 = spans[0][2] if spans else max((h[2] for h in host), default=0)
    if spans:
        # the span holds the call and the synchronization after it: the
        # slice on the trace's own clock, and the device work inside it
        window_s = (t1 - t0) / 1e9
        device = [(n, max(s, t0), min(e, t1)) for n, s, e in device
                  if e > t0 and s < t1]
    return out, Trace(window_s, device, host, t0, t1)


SLICE = "h100_bench slice"


def breakdown(trace):
    """The slice's ten device operations that took most time, and its idle
    time put down to what the host was doing (the innermost host event
    over each gap's middle, under the benchmark's span), ten largest."""
    ops = {}
    for n, s, e in trace.device:
        ops[n] = ops.get(n, 0) + (e - s)
    spans = [h for h in trace.host if h[0].startswith("h100_bench:")]
    events = [h for h in trace.host
              if h[0] != SLICE and not h[0].startswith("h100_bench:")]
    starts = [h[1] for h in events]
    idle = {}
    for s, e in gaps(trace):
        mid = (s + e) // 2
        span = next((n for n, hs, he in reversed(spans) if hs <= mid <= he),
                    "no span")
        inner = "no host event"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 256, -1), -1):
            if events[j][2] >= mid:
                inner = events[j][0]
                break
        key = f"{span} / {inner}"
        idle[key] = idle.get(key, 0) + (e - s)

    def top(d):
        return [[n, v / 1e9] for n, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}
