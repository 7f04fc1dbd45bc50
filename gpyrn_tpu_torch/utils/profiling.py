"""Tracing and profiling helpers.

Port of :mod:`gpyrn_tpu.utils.profiling`: a ``torch.profiler`` trace
context that writes a TensorBoard-compatible trace (the counterpart of
``jax.profiler``'s), and a stage timer that waits for the device at each
stage's end.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, List

import torch

__all__ = ["trace", "StageTimer"]


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
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                self._block(block_on)
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
