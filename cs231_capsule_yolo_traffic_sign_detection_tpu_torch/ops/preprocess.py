"""On-device image preprocessing (counterpart of the JAX ops/preprocess.py).

Frames go to the device as uint8 and are resized there with plain
bilinear sampling (``align_corners=False, antialias=False``, the
sampling of cv2.INTER_LINEAR up to rounding details).  The port needs
no cv2.  A frame already at the network's input size passes through
unchanged.  Detector inputs are not centered: the reference's predict
path feeds raw 0-255 values, and the port keeps that quirk.

`stage` is the port's one way from host arrays to a device tensor:
frames here, the classifier's crops in `predict.class_pred` and the
streamed training batches in `train.driver.Trainer`.  Bound for a card,
the rows are written into pinned host memory a chunk at a time, each
chunk copied to the card without blocking as soon as it is written, so
the copy engine moves one chunk while the host writes the next.  The
pinned memory comes from torch's caching host allocator: allocated
once, reused by later calls, and not handed out again until the copies
that read it have run on the card.

A call of `PARALLEL_BYTES` or more, on a host with cores to spare, has
its rows written by a process-wide pool of gather threads (at most
`GATHER_WORKERS`, one core left to the caller), a whole row a task,
claimed in order; the calling thread waits for each chunk's rows, then
enqueues that chunk's copy.  The pool starts with the first such call,
and its threads block on a queue when idle.  Smaller calls, and hosts
with fewer cores, write on the calling thread alone.  Both write the
same bytes into the same rows.
"""

import os
import queue
import threading

import numpy as np
import torch
import torch.nn.functional as F

from .. import profiling

# rows (frames) written between two copies to the card by the calling
# thread alone: on an H100's host 4 stages 32 frames of 1360x800 sooner
# than 1, 2, 8 or 32 (PERF.md)
CHUNK_FRAMES = 4
# the same for the gather threads, whose caller wakes once a chunk: on
# an H100's host (8 cores) 8 serves 32 frames of 1360x800 faster than 4
# at 2, 3, 4 and 6 threads, and 6 threads faster than 2, 3 or 4 (gather
# 7.6 ms against 26.2 on one thread; PERF.md)
GATHER_CHUNK = 8
GATHER_WORKERS = 6
# the fewest bytes a call stages on gather threads: there 4 threads
# write 32 rows of 16 MiB in all in 2.2 ms against one thread's 3.9, of
# 8 MiB in 2.3 against 2.1, and a call of 1 MiB in 1.9 against 0.5
PARALLEL_BYTES = 16 << 20


def preprocess_batch(images_u8, size):
    """(B, H, W, 3) uint8 tensor -> (B, size, size, 3) float32, NHWC."""
    x = images_u8.float()
    if x.shape[1:3] != (size, size):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                          mode="bilinear", align_corners=False,
                          antialias=False).permute(0, 2, 3, 1).contiguous()
    return x


def preprocess_images(images, size, device):
    """List of host uint8 frames (any sizes) -> device batch, NHWC f32.

    Frames of one shape are staged together (`stage`), frames of mixed
    shapes one by one, each with a ``.to(device)`` recorded as a
    ``cyt.stage.copy`` span of its bytes (0 when ``device`` is the host)
    in a ``cyt.stage`` span (``images``, ``pinned`` 0, ``workers`` 1;
    `profiling`)."""
    if len({im.shape for im in images}) == 1:
        return preprocess_batch(stage(images, device), size)
    with profiling.span(profiling.STAGE, images=len(images), pinned=0,
                        workers=1):
        return torch.cat([
            preprocess_batch(_copy(torch.from_numpy(
                np.ascontiguousarray(im))[None], device), size)
            for im in images])


def stage(arrays, device):
    """Host arrays of one shape and dtype (a list, or an array's rows)
    -> their stack, a tensor on ``device``.

    The rows are written `CHUNK_FRAMES` at a time (`GATHER_CHUNK` on
    gather threads) into a host tensor, pinned when ``device`` is a
    card, and after each chunk its rows are copied into the same rows
    of the result without blocking.  Recorded
    as a ``cyt.stage`` span (``images``, the rows; ``pinned``, those
    staged through pinned memory; ``workers``, the threads that wrote
    them, `_workers`), each chunk's write (with gather threads, the
    calling thread's wait for it) as a ``cyt.stage.gather`` span and
    each copy's enqueue as a ``cyt.stage.copy`` span of its bytes (0
    when ``device`` is the host; `profiling`)."""
    card = torch.device(device).type == "cuda"
    shape = (len(arrays),) + np.shape(arrays[0])
    dtype = torch.from_numpy(np.empty(0, np.asarray(arrays[0]).dtype)).dtype
    workers = _workers(int(np.prod(shape)) * dtype.itemsize, len(arrays))
    with profiling.span(profiling.STAGE, images=len(arrays),
                        pinned=len(arrays) if card else 0, workers=workers):
        host = torch.empty(shape, dtype=dtype, pin_memory=card)
        dest = torch.empty(shape, dtype=dtype, device=device)
        rows = host.numpy()

        def copy(i, j):
            with profiling.span(profiling.STAGE_COPY,
                                bytes=host[i:j].nbytes if card else 0):
                dest[i:j].copy_(host[i:j], non_blocking=True)

        if workers > 1:
            _gather(arrays, rows, workers, copy)
            return dest
        for i in range(0, len(arrays), CHUNK_FRAMES):
            j = min(i + CHUNK_FRAMES, len(arrays))
            with profiling.span(profiling.STAGE_GATHER):
                np.stack(arrays[i:j], out=rows[i:j])
            copy(i, j)
        return dest


def _cores():
    """The cores this process may run on."""
    return len(os.sched_getaffinity(0))


def _workers(nbytes, rows):
    """The threads that write a call's ``rows`` rows of ``nbytes`` bytes
    in all: 1, the calling thread, below `PARALLEL_BYTES`; else gather
    threads, as many as `GATHER_WORKERS`, the rows and the cores but the
    caller's allow (1 where that is one or none)."""
    if nbytes < PARALLEL_BYTES:
        return 1
    return max(1, min(GATHER_WORKERS, rows, _cores() - 1))


def _gather(arrays, out, workers, on_chunk=None):
    """Write ``arrays[r]`` into ``out[r]``, every row r, on ``workers``
    threads of the gather pool, a row a task, claimed in order.  The
    calling thread waits for each chunk of `GATHER_CHUNK` rows in turn,
    in a ``cyt.stage.gather`` span, then calls ``on_chunk(i, j)`` with
    its rows.  A row's error (a shape other than the first row's, a
    dtype that does not cast) is raised here at its chunk, the lowest
    row's first, as ``np.stack`` would; no thread writes into ``out``
    once this has returned or raised."""
    chunk = GATHER_CHUNK
    job = _Rows(arrays, out, chunk)
    _pool().start(job.run, workers)
    try:
        for k, i in enumerate(range(0, len(arrays), chunk)):
            with profiling.span(profiling.STAGE_GATHER):
                job.wait(k)
            if on_chunk is not None:
                on_chunk(i, min(i + chunk, len(arrays)))
    finally:
        job.stop()


class _Rows:
    """One `_gather` call's rows under one condition: the next row to
    claim, the rows left in each chunk, the rows being written, and
    each failed row's error."""

    def __init__(self, arrays, out, chunk):
        self.arrays, self.out, self.chunk = arrays, out, chunk
        self.cond = threading.Condition()
        self.claimed = self.running = 0
        self.left = [min(chunk, len(arrays) - i)
                     for i in range(0, len(arrays), chunk)]
        self.errors = {}
        self.stopped = False

    def run(self):
        """Claim and write rows in order until none is left or the call
        stopped (a pool thread's job)."""
        while True:
            with self.cond:
                r = self.claimed
                if self.stopped or r == len(self.arrays):
                    return
                self.claimed += 1
                self.running += 1
            error = None
            try:
                row = np.asarray(self.arrays[r])
                if row.shape != self.out.shape[1:]:
                    raise ValueError(
                        f"all input arrays must have the same shape: row "
                        f"{r} is {row.shape}, row 0 {self.out.shape[1:]}")
                np.copyto(self.out[r], row, casting="same_kind")
            except Exception as e:   # raised in the caller, at its chunk
                error = e
            finally:
                with self.cond:
                    self.running -= 1
                    if error is not None:
                        self.errors[r] = error
                    k = r // self.chunk
                    self.left[k] -= 1
                    if not self.left[k] or (self.stopped
                                            and not self.running):
                        self.cond.notify_all()

    def wait(self, k):
        """Wait until chunk ``k``'s rows are written; raise the error of
        its lowest failed row."""
        with self.cond:
            self.cond.wait_for(lambda: not self.left[k])
        lo = k * self.chunk
        bad = [r for r in range(lo, lo + self.chunk) if r in self.errors]
        if bad:
            raise self.errors[bad[0]]

    def stop(self):
        """Let no thread claim another row, and wait for the rows being
        written."""
        with self.cond:
            self.stopped = True
            self.cond.wait_for(lambda: not self.running)


class _Pool:
    """Daemon threads that block on one queue and run the jobs put on
    it; grown to the most threads a call asked for, never shrunk."""

    def __init__(self):
        self.pid = os.getpid()
        self.size = 0
        self._jobs = queue.SimpleQueue()
        self._lock = threading.Lock()

    def start(self, job, n):
        """Run ``job()`` on ``n`` of the pool's threads."""
        with self._lock:
            for k in range(self.size, n):
                threading.Thread(target=self._serve, daemon=True,
                                 name=f"cyt-gather-{k}").start()
            self.size = max(self.size, n)
        for _ in range(n):
            self._jobs.put(job)

    def _serve(self):
        while True:
            self._jobs.get()()


_POOL = None
_POOL_LOCK = threading.Lock()


def _pool():
    """The process's gather pool, made at its first use, and anew in a
    forked child (which has none of its parent's threads)."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None or _POOL.pid != os.getpid():
            _POOL = _Pool()
        return _POOL


def _copy(host, device):
    """``host.to(device)`` as a ``cyt.stage.copy`` span of the bytes it
    moves (0 when ``device`` is the host)."""
    moved = 0 if torch.device(device).type == "cpu" else host.nbytes
    with profiling.span(profiling.STAGE_COPY, bytes=moved):
        return host.to(device)
