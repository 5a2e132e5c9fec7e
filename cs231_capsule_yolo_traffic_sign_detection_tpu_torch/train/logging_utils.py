"""Scalar logging: TensorBoard-compatible with a JSONL fallback.

A copy of the JAX package's jax-free train/logging_utils.py.  Reference
parity: main.py:176-177, 197-199 — scalar names train_loss / eval_loss /
train_metric / eval_metric via tensorboardX's SummaryWriter logging to
`runs/`.  When tensorboardX is unavailable (the card's machine has
none), the same scalars go to runs/<time>/scalars.jsonl only.
`BatchCounter` is the per-epoch progress the JAX driver shows with a
tqdm bar (train/driver.py:668); the card's machine has no tqdm.
"""

import json
import os
import sys
import time


class BatchCounter:
    """A train epoch's batch counter on stderr: ``<desc> i/n`` rewritten
    in place on a terminal, and one closing line with the count and the
    epoch's wall.  It counts batches handed to the device; it reads
    nothing back from it."""

    def __init__(self, total, desc="train"):
        self.total, self.desc, self.n = int(total), desc, 0
        self.stream = sys.stderr
        self._live = self.stream.isatty()
        self._t0 = time.perf_counter()

    def update(self, k=1):
        self.n += k
        if self._live:
            self.stream.write(f"\r{self.desc} {self.n}/{self.total}")
            self.stream.flush()

    def close(self):
        wall = time.perf_counter() - self._t0
        self.stream.write(("\r" if self._live else "")
                          + f"{self.desc} {self.n}/{self.total} batches, "
                          f"{wall:.2f} s\n")
        self.stream.flush()


class ScalarWriter:
    def __init__(self, logdir=None):
        self._tb = None
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(logdir) if logdir else SummaryWriter()
            self.logdir = self._tb.logdir
        except Exception:
            self.logdir = logdir or os.path.join(
                "runs", time.strftime("%b%d_%H-%M-%S"))
            os.makedirs(self.logdir, exist_ok=True)
        self._jsonl = open(os.path.join(self.logdir, "scalars.jsonl"), "a")

    def add_scalar(self, tag, value, step):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "ts": time.time()}) + "\n")
        self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
