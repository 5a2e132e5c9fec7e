"""Checkpoints in the reference's torch format.

A checkpoint is ``{'epoch', 'state_dict', 'optim_dict'}`` written with
``torch.save`` to ``<model_dir>/last.ckpt`` (and copied to
``best.ckpt`` when it is the best so far), and read back with
``torch.load(weights_only=True)``.  Training adds ``'plateau'``, the LR
schedule's state, as the JAX driver does, and writes into
``model_dir + str(train_frac)`` (no separator, a reference quirk);
`load_checkpoint` falls back to that directory when the bare one has no
checkpoint (JAX train/checkpoint.py:133-152).  The JAX package's
msgpack checkpoints are not read here.
"""

import os
import shutil

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
