"""Checkpoints in the reference's torch format.

A checkpoint is ``{'epoch', 'state_dict', 'optim_dict'}`` written with
``torch.save`` to ``<model_dir>/last.ckpt`` (and copied to
``best.ckpt`` when it is the best so far), and read back with
``torch.load(weights_only=True)``.  Training adds ``'plateau'``, the LR
schedule's state, as the JAX driver does, and writes into
``model_dir + str(train_frac)`` (no separator, a reference quirk);
`load_checkpoint` falls back to that directory when the bare one has no
checkpoint (JAX train/checkpoint.py:133-152).  The JAX package's
msgpack checkpoints are not read here.  `AsyncCheckpointer` writes them
on a worker thread (``--async_ckpt``).
"""

import os
import queue
import shutil
import threading

import torch


def save_checkpoint(state, is_best, checkpoint_dir):
    """Write ``state`` to last.ckpt (atomically) and, if best, best.ckpt."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, "last.ckpt")
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    if is_best:
        shutil.copyfile(path, os.path.join(checkpoint_dir, "best.ckpt"))


def snapshot(obj):
    """A copy of ``obj`` (nested dicts, lists and tuples of tensors and
    plain values) whose tensors are clones on their own devices: the
    optimizer updates the live parameters and moments in place, so a
    save that runs later must not read them.  The clones are queued on
    the device's stream, so taking them waits for nothing."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return type(obj)((k, snapshot(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(snapshot(v) for v in obj)
    return obj


class AsyncCheckpointer:
    """Background checkpoint writer (``--async_ckpt``; counterpart of the
    JAX `AsyncCheckpointer`, train/checkpoint.py:59).

    `save` snapshots the state on its device (`snapshot`) and queues it;
    one worker thread makes the same `save_checkpoint` calls in order
    (the copy to the host, ``torch.save`` and the write), so the
    last/best files are those of the synchronous path.  At most
    ``MAX_BACKLOG`` saves wait: past that `save` blocks.  A worker's
    error surfaces at the next `save` or at `flush`, which drains the
    queue, stops the worker and is terminal (one writer per run; the
    driver calls it in a ``finally``)."""

    MAX_BACKLOG = 2

    def __init__(self):
        self._q = queue.Queue(maxsize=self.MAX_BACKLOG)
        self._err = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:  # shutdown sentinel from flush()
                    return
                save_checkpoint(*item)
            except Exception as e:  # surfaced by save() or flush()
                if self._err is None:
                    self._err = e
            finally:
                self._q.task_done()

    def save(self, state, is_best, checkpoint_dir):
        if self._closed:
            raise RuntimeError("AsyncCheckpointer used after flush()")
        self._raise_pending()
        self._q.put((snapshot(state), is_best, checkpoint_dir))

    def flush(self):
        """Write every queued save, stop the worker and re-raise its first
        error."""
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._q.join()
            self._thread.join()
        self._raise_pending()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def checkpoint_path(model_dir, restore_file):
    """Map --restore last|best to the checkpoint file path."""
    return os.path.join(model_dir, restore_file + ".ckpt")


def load_checkpoint(path, fallback_dirs=()):
    """Read a checkpoint dict onto the CPU (tensors and plain data only);
    when ``path`` is absent, the same file name in the first of
    ``fallback_dirs`` that has it."""
    if not os.path.exists(path):
        base = os.path.basename(path)
        for d in fallback_dirs:
            alt = os.path.join(d, base)
            if os.path.exists(alt):
                path = alt
                break
        else:
            raise FileNotFoundError("File doesn't exist {}".format(path))
    return torch.load(path, map_location="cpu", weights_only=True)
