"""The one traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and makes its inputs from the run's seed, in a few
large calls on the card.

A mix names its ``task`` ("serve": a closed loop of batches; "train":
epochs over a resident set) and its ``input``:

  frames  road scenes of ``frame_hw`` pixels, uint8, with 1 to a few
          square "signs" each (``signs``, side ``sign_frac`` of the
          shorter side), kept on the host in a pool of ``pool`` frames
          that the batches draw from;
  scenes  the same scenes at the detector's input size, centred to
          [-1, 1] floats, resident on the card with their YOLO grids;
  crops   ``crop``-pixel crops of ``n_classes`` class patterns with
          noise, uint8, with labels: a host pool of ``pool`` crops
          centred to [-1, 1] (serving) or ``n`` resident centred crops
          (training).

Every seed makes the same amount of work of the same shapes; only the
pixels, the signs' places and the order differ.
"""

import json
import os

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))


# each input's parameters: a mix that names another is refused, not
# run as if it had not asked
KEYS = {"frames": {"frame_hw", "pool", "signs", "sign_frac",
                   "boxes_per_frame", "calibration_frames"},
        "scenes": {"n", "signs", "sign_frac"},
        "crops": {"crop", "pool", "n"}}


def load(name):
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        mix = json.load(f)
    unknown = set(mix) - {"task", "input", "why"} - KEYS[mix["input"]]
    if mix["task"] not in ("serve", "train") or unknown:
        raise ValueError(f"traffic {name!r}: task {mix['task']!r}, keys "
                         f"not read {sorted(unknown)}")
    return mix


def stream_seed(seed, tag):
    """A sub-stream's seed: the run's seed and a small tag, in 63 bits."""
    return ((int(seed) << 5) + int(tag)) % (1 << 63)


def generator(seed, tag, device):
    return torch.Generator(device=device).manual_seed(stream_seed(seed, tag))


def _uniform(shape, lo, hi, g, device):
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def scenes(n, hw, signs, sign_frac, n_classes, g, device):
    """``n`` scenes of ``hw`` (h, w) pixels: a smooth background with
    noise and ``signs`` (lo, hi) flat squares each.  Returns uint8
    images (n, h, w, 3) and the signs: corners (n, S, 4) in pixels,
    classes (n, S) and validity (n, S), S = hi."""
    h, w = hw
    lo_s, hi_s = signs
    bg = _uniform((n, 3, h // 32 + 2, w // 32 + 2), 30.0, 220.0, g, device)
    img = F.interpolate(bg, size=(h, w), mode="bilinear",
                        align_corners=False)
    img = img + 12.0 * torch.randn(img.shape, generator=g, device=device)
    count = torch.randint(lo_s, hi_s + 1, (n, 1), generator=g, device=device)
    valid = torch.arange(hi_s, device=device)[None] < count
    side = _uniform((n, hi_s), *sign_frac, g, device) * min(h, w)
    cx = _uniform((n, hi_s), 0.0, 1.0, g, device) * (w - side) + side / 2
    cy = _uniform((n, hi_s), 0.0, 1.0, g, device) * (h - side) + side / 2
    color = _uniform((n, hi_s, 3), 0.0, 255.0, g, device)
    cls = torch.randint(0, max(n_classes, 1), (n, hi_s), generator=g,
                        device=device)
    ys = torch.arange(h, device=device, dtype=torch.float32)
    xs = torch.arange(w, device=device, dtype=torch.float32)
    for s in range(hi_s):
        half = side[:, s, None] / 2
        in_y = ((ys[None] + 0.5 - cy[:, s, None]).abs() < half)[:, :, None]
        in_x = ((xs[None] + 0.5 - cx[:, s, None]).abs() < half)[:, None, :]
        m = (in_y & in_x & valid[:, s, None, None])[:, None]
        img = torch.where(m, color[:, s, :, None, None], img)
    box = torch.stack([cx - side / 2, cy - side / 2, cx + side / 2,
                       cy + side / 2], -1)
    img = img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    return img.contiguous(), box, cls, valid


def yolo_grid(box, cls, valid, size, n_grid, n_classes):
    """The signs' YOLO targets (n, g, g, 5 + C): in the cell that holds
    a sign's centre, 1, the centre in cell units, the width and height
    over the image, and the class one-hot (a later sign in the same cell
    wins)."""
    n, s_max = valid.shape
    y = torch.zeros((n, n_grid, n_grid, 5 + n_classes), device=box.device)
    cell = size / n_grid
    for s in range(s_max):
        x1, y1, x2, y2 = box[:, s].unbind(-1)
        xc, yc = (x1 + x2) / 2, (y1 + y2) / 2
        col = (xc / cell).long().clamp(0, n_grid - 1)
        row = (yc / cell).long().clamp(0, n_grid - 1)
        vals = torch.stack([torch.ones_like(xc), xc / cell - col,
                            yc / cell - row, (x2 - x1) / size,
                            (y2 - y1) / size], -1)
        onehot = F.one_hot(cls[:, s], max(n_classes, 1)).float()[:, :n_classes]
        vals = torch.cat([vals, onehot], -1)
        i = torch.nonzero(valid[:, s]).squeeze(1)
        y[i, row[i], col[i]] = vals[i]
    return y


def crops(n, size, n_classes, g, device):
    """``n`` uint8 crops (n, size, size, 3) and labels (n,): each class
    a smooth random pattern, each crop its class's pattern with noise."""
    pattern = _uniform((n_classes, 3, 4, 4), 0.0, 255.0, g, device)
    pattern = F.interpolate(pattern, size=(size, size), mode="bilinear",
                            align_corners=False)
    labels = torch.randint(0, n_classes, (n,), generator=g, device=device)
    x = pattern[labels] + 25.0 * torch.randn((n, 3, size, size), generator=g,
                                             device=device)
    x = x.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    return x.contiguous(), labels


def center(x):
    """uint8-range pixels -> floats in [-1, 1], as the crops are fed."""
    return (x - 128.0) / 128


def batches(n_items, batch, seed, tag):
    """Endless batches of ``batch`` indices into ``n_items``, cut from
    back-to-back seeded permutations (host numpy)."""
    rng = np.random.default_rng(stream_seed(seed, tag))
    queue = np.zeros(0, np.int64)
    while True:
        while len(queue) < batch:
            queue = np.concatenate([queue, rng.permutation(n_items)])
        yield queue[:batch]
        queue = queue[batch:]


def epoch_table(n_items, batch, g):
    """One epoch's index table (n_items // batch, batch) on g's device:
    a seeded permutation cut into full batches."""
    n_batch = n_items // batch
    perm = torch.randperm(n_items, generator=g, device=g.device)
    return perm[:n_batch * batch].reshape(n_batch, batch)
