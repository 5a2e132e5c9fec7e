"""Profiling, step timing and the program's spans (counterpart of the JAX
profiling.py).

`trace` captures a `torch.profiler` trace (host and CUDA activity) of a
region of code and writes it into ``logdir`` as a Chrome trace, which
Perfetto and ``chrome://tracing`` open.  `StepTimer` times steps on the
host's clock, discarding the first ``warmup`` of them: a step that
launches work on the card must end in a synchronisation (a fetch, or
``torch.cuda.synchronize()``) inside the timed block, or the timer
measures the launches alone.

`span` is the program's one recorder of spans: a name, a start and an
end in nanoseconds on the profiler's clock (``time.time_ns()``, the Unix
epoch, as kineto's events), the innermost span open on the same thread
as its parent, a sequence number and counts (``bytes``, ``images``).
Serving spans are recorded only while a `torch.profiler` runs; without
one a span costs a flag check.  Set-up spans (``cyt.setup.*``: a few a
process) are recorded always.  Under a profiler every span also opens a
``record_function`` range of its name, so it lies on the kernels'
timeline in the Chrome trace.  Records stay in memory, the newest
`STORE_SIZE` of them, until `spans` reads them or `clear` drops them.

An operator gets the serving path's host boundaries and the set-up on
one timeline: ``with profiling.trace(dir): ...`` over a train or predict
run writes the ``cyt.*`` spans beside the kernels into
``dir/trace.json``, and ``profiling.spans()`` returns them as records.
The spans, where they sit:

  cyt.serve.batch       a batch of `predict._serve_batches` (``index``),
                        the CLI's serving loop; parents its stage spans
  cyt.stage             `ops/preprocess.py:stage`, host rows (frames,
                        crops, streamed batches) to the device
                        (``images``; ``pinned``, those staged through
                        pinned memory; ``workers``, the threads that
                        wrote the rows, 1 for the calling thread
                        alone); `preprocess_images`' frames of mixed
                        shapes
  cyt.stage.gather      each chunk's write into the host buffer, pinned
                        on a card: its ``np.stack``, or the calling
                        thread's wait for the gather threads' rows
  cyt.stage.copy        each chunk's non-blocking copy, its enqueue
                        alone (``bytes``, 0 when the device is the
                        host); each ``.to(device)`` of a mixed frame
  cyt.fetch             `ops/decode.py:to_flat_host_with_extras`
                        (``images``; ``boxes``, the boxes it unpacked)
  cyt.fetch.wait        its ``.cpu()`` of the decode arrays and extras
  cyt.fetch.unpack      its per-image loop and concatenation
  cyt.tail              the fused two-stage tail after the detector
                        (`export._two_stage_tail`; ``crops``, batch x
                        max_crops, the classifier's batch)
  cyt.tail.crop         its top-k decode, crop and centring
  cyt.tail.classify     its classifier call (CapsuleNet: conv1, the
                        primary capsules, K3)
  cyt.setup.build       `ops/_build.library`: digest, nvcc if needed, load
  cyt.setup.init        the seeded initialisers (`models/init.py`)
  cyt.setup.prepare     building a serving fn (`export.make_detector_fn`,
                        `make_classifier_fn`, `make_two_stage_fn`)
  cyt.setup.first_call  the first call of each such fn, and of each
                        `train.steps.Epoch` (its eager batch and capture)
  cyt.setup.capture     `train.steps.GraphCapture.capture`
"""

import collections
import contextlib
import functools
import itertools
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

SETUP = "cyt.setup"
SERVE_BATCH = "cyt.serve.batch"
STAGE, STAGE_GATHER, STAGE_COPY = ("cyt.stage", "cyt.stage.gather",
                                   "cyt.stage.copy")
FETCH, FETCH_WAIT, FETCH_UNPACK = ("cyt.fetch", "cyt.fetch.wait",
                                   "cyt.fetch.unpack")
TAIL, TAIL_CROP, TAIL_CLASSIFY = ("cyt.tail", "cyt.tail.crop",
                                  "cyt.tail.classify")
SETUP_BUILD, SETUP_INIT, SETUP_PREPARE = ("cyt.setup.build", "cyt.setup.init",
                                          "cyt.setup.prepare")
SETUP_FIRST_CALL, SETUP_CAPTURE = "cyt.setup.first_call", "cyt.setup.capture"
STORE_SIZE = 65536

_store = collections.deque(maxlen=STORE_SIZE)
_seq = itertools.count()
_local = threading.local()
_OFF = contextlib.nullcontext()


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


class Span:
    """One span: ``name``, ``start_ns`` and ``end_ns`` (Unix epoch
    nanoseconds), ``parent`` (the enclosing `Span` of its thread, or
    None), ``seq`` (the order spans were opened in) and ``args``.  As a
    context it pushes itself on its thread's stack of open spans, opens
    its profiler range when a profiler runs, and is stored when it
    closes (also when its block raised)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "seq", "args",
                 "_range")

    def __init__(self, name, args):
        self.name, self.args = name, args
        self.seq = next(_seq)
        self.start_ns = self.end_ns = 0
        self.parent = self._range = None

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) / 1e9

    def __repr__(self):
        return (f"Span({self.name!r}, seq={self.seq}, {self.seconds:.6f} s, "
                f"parent={self.parent.seq if self.parent else None}, "
                f"args={self.args})")

    def __enter__(self):
        stack = _open_spans()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _open_spans().pop()
        _store.append(self)
        return False


def _open_spans():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name, **args):
    """A context that records the block as span ``name`` with ``args``
    and yields its `Span`; a serving span (any name outside
    ``cyt.setup``) without a running profiler records nothing and
    yields None.  Adds no synchronisation and no copy."""
    if not _autograd_profiler._is_profiler_enabled and \
            not name.startswith(SETUP):
        return _OFF
    return Span(name, args)


def first_call(fn):
    """``fn`` whose first call is recorded as a ``cyt.setup.first_call``
    span; later calls pass straight through."""
    called = False

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        nonlocal called
        if called:
            return fn(*args, **kwargs)
        called = True
        with span(SETUP_FIRST_CALL):
            return fn(*args, **kwargs)

    return wrapped


def spans(prefix=""):
    """The stored spans whose names start with ``prefix``, oldest first
    by closing."""
    return [s for s in list(_store) if s.name.startswith(prefix)]


def clear():
    """Drop every stored span."""
    _store.clear()


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
