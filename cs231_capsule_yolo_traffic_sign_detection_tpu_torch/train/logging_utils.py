"""Scalar logging: TensorBoard-compatible with a JSONL fallback.

A copy of the JAX package's jax-free train/logging_utils.py.  Reference
parity: main.py:176-177, 197-199 — scalar names train_loss / eval_loss /
train_metric / eval_metric via tensorboardX's SummaryWriter logging to
`runs/`.  When tensorboardX is unavailable (the card's machine has
none), the same scalars go to runs/<time>/scalars.jsonl only.
"""

import json
import os
import time


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
