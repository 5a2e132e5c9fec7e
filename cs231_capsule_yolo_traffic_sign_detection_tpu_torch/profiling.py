"""Profiling and step timing (counterpart of the JAX profiling.py).

`trace` captures a `torch.profiler` trace (host and CUDA activity) of a
region of code and writes it into ``logdir`` as a Chrome trace, which
Perfetto and ``chrome://tracing`` open.  `StepTimer` times steps on the
host's clock, discarding the first ``warmup`` of them: a step that
launches work on the card must end in a synchronisation (a fetch, or
``torch.cuda.synchronize()``) inside the timed block, or the timer
measures the launches alone.
"""

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir="runs/profile"):
    """Profile the block (CPU, and CUDA when a card is present) and write
    its Chrome trace to ``logdir/trace.json``; yields ``logdir``.  The
    finished profile is kept as ``trace.last`` (its ``key_averages()``
    sum the time by kernel)."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    trace.last = prof


trace.last = None


class StepTimer:
    """Wall-clock step timer with warmup discard: ``with timer: step()``
    times one step; ``mean`` is the mean of the steps after the first
    ``warmup`` (nan before any), ``throughput(items_per_step)`` items a
    second at that mean."""

    def __init__(self, warmup=2):
        self.warmup = warmup
        self.times = []
        self._t0 = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    @property
    def mean(self):
        return sum(self.times) / len(self.times) if self.times else float("nan")

    def throughput(self, items_per_step):
        return items_per_step / self.mean
