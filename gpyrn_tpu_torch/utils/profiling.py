"""Tracing and profiling helpers.

Port of :mod:`gpyrn_tpu.utils.profiling`: a ``torch.profiler`` trace
context that writes a TensorBoard-compatible trace (the counterpart of
``jax.profiler``'s), and a stage timer that waits for the device at each
stage's end.  Beside them, the program's own record, always on:

* **spans** (:class:`span`, read by :func:`spans`): a name, a start and an
  end on the clock ``torch.profiler`` stamps its events with (Unix-epoch
  nanoseconds, ``time.time_ns``), the span it opened inside and the
  top-level span (the call) it belongs to, kept in a ring of the last
  65,536.  While a ``torch.profiler`` session is active a
  span also opens a ``record_function`` of its name, so a :func:`trace`
  shows the program's stages on its timeline;
* **counters** (:func:`counters`, read by :func:`counts`): dicts of plain
  ints, incremented where the work happens, reset together by
  :func:`reset_counts`.  A span opened with ``counts=True`` keeps what
  each counter rose by while it was open, so the counts of each of the
  last calls can be read apart from the others.

``Engine.elbo_fit_batch`` records the spans ``gprn.fit_batch`` (the call)
(with its counts) and, inside it, ``gprn.prepare``, ``gprn.sweep``, ``gprn.stop`` and
``gprn.gather``, and counts ``gprn.batch.sweeps`` and
``gprn.batch.host_reads``; the dense sweep counts
``gprn.sweep.inverse_solves``, each application of a factor's inverse
(3 a sweep at q = 1, one more for each pair of nodes; 2 an updates-only
sweep);
``ops/cuda_kernels.py`` counts the CUDA kernels' launches as
``launches.<kernel>`` (``LAUNCHES``).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch

__all__ = ["trace", "StageTimer", "span", "spans", "counters", "counts",
           "reset_counts"]

# -- counters ---------------------------------------------------------------

_COUNTERS: Dict[str, Dict[str, int]] = {}


def counters(group: str, names: Iterable[str]) -> Dict[str, int]:
    """The registry's counters ``<group>.<name>``: a dict of plain ints,
    from 0, that its owner increments where the work happens.  Asking
    again for a group returns the same dict."""
    d = _COUNTERS.setdefault(group, {})
    for n in names:
        d.setdefault(n, 0)
    return d


def counts() -> Dict[str, int]:
    """Every counter's value, by ``<group>.<name>``."""
    return {f"{g}.{n}": v for g, d in _COUNTERS.items()
            for n, v in d.items()}


def reset_counts() -> None:
    """Every counter of every group to 0."""
    for d in _COUNTERS.values():
        for n in d:
            d[n] = 0


# -- spans ------------------------------------------------------------------

# The ring holds the last _SPAN_CAPACITY spans: a minute of batched search
# at N = 1000 (~3,500 batched sweeps) records ~8,000: two a sweep, a few a fit.
_SPAN_CAPACITY = 65536


class Span(NamedTuple):
    """One recorded span.  ``start_ns`` / ``end_ns`` are Unix-epoch
    nanoseconds, the clock of ``torch.profiler``'s events; ``parent`` is
    the id of the span it was opened inside (0 at the top of its thread),
    ``call`` the id of the top-level span it belongs to (its own at the
    top).  ``counts`` are what each counter that moved rose by while it
    was open, for a span opened with ``counts=True``; else None."""
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int
    call: int
    counts: Optional[Dict[str, int]]


_SPANS: collections.deque = collections.deque(maxlen=_SPAN_CAPACITY)
_ids = itertools.count(1)
_open = threading.local()
_profiler_on = torch._C._autograd._profiler_enabled


class span:
    """``with span(name):`` records the block as a :class:`Span` (two
    clock reads and one append to the ring), nested under the span open
    around it on the same thread.  With ``counts=True`` it also keeps what
    each counter rose by in the block.  Inside an active ``torch.profiler``
    session it also opens ``record_function(name)`` around the block."""
    __slots__ = ("name", "id", "parent", "call", "start_ns", "end_ns",
                 "_before", "_rf")

    def __init__(self, name: str, counts: bool = False):
        self.name = name
        self._before = {} if counts else None

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = 0, self.id
        if self._before is not None:
            self._before = counts()
        stack.append(self)
        self._rf = None
        self.start_ns = time.time_ns()
        if _profiler_on():
            self._rf = torch.autograd.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self.end_ns = time.time_ns()
        _open.stack.pop()
        rose = None
        if self._before is not None:
            before = self._before
            rose = {k: v - before.get(k, 0) for k, v in counts().items()
                    if v != before.get(k, 0)}
        _SPANS.append(Span(self.id, self.name, self.start_ns, self.end_ns,
                           self.parent, self.call, rose))
        return False


def spans() -> List[Span]:
    """The recorded spans, oldest first: the last 65,536 of this
    process, in the order they closed."""
    return list(_SPANS)


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the enclosed block with ``torch.profiler`` and write the
    trace into ``logdir`` (``<host>_<pid>.<n>.pt.trace.json``; view it with
    TensorBoard's profiler plugin, or ``chrome://tracing``).  Default
    directory: ``gpyrn_tpu_torch_trace`` under ``tempfile.gettempdir()``,
    which honours ``TMPDIR``.  Where a CUDA
    device is available, the device's kernels are recorded beside the
    host's operators.  Yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "gpyrn_tpu_torch_trace")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()


class StageTimer:
    """Wall-clock stage timer that waits for device work at boundaries.

    >>> timer = StageTimer()
    >>> with timer.stage("fit", block_on=mu):
    ...     out = engine.elbo_fit(...)
    >>> timer.summary()

    ``block_on`` is a tensor, or a sequence of them: where one lies on a
    CUDA device, the stage ends with ``torch.cuda.synchronize`` of that
    device (``jax.block_until_ready`` in the JAX package)."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @staticmethod
    def _block(block_on):
        tensors = block_on if isinstance(block_on, (list, tuple)) \
            else [block_on]
        for dev in {x.device for x in tensors
                    if isinstance(x, torch.Tensor) and x.is_cuda}:
            torch.cuda.synchronize(dev)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Time the block (``time.perf_counter``), the device's wait
        included, and record it as the span ``name`` (:func:`spans` holds
        it beside the program's own)."""
        t0 = time.perf_counter()
        try:
            with span(name):
                try:
                    yield
                finally:
                    if block_on is not None:
                        self._block(block_on)
        finally:
            self.times.setdefault(name, []).append(
                time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self.times.items():
            n = len(ts)
            out[name] = {"n": n, "total_s": sum(ts),
                         "mean_ms": sum(ts) / n * 1e3,
                         "last_ms": ts[-1] * 1e3}
        return out

    def report(self) -> str:
        lines = []
        for name, s in self.summary().items():
            lines.append(f"{name:24s} n={s['n']:<4d} "
                         f"mean={s['mean_ms']:9.2f} ms  "
                         f"total={s['total_s']:.3f} s")
        return "\n".join(lines)
