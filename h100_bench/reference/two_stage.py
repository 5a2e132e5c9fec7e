"""Plain two-stage pipeline (the reference repo's predict_fns.py:75-82,
``main.py --combine capsule``): DarkNet-19 detects, CapsuleNet classifies
each detected sign's crop.  Over the two state_dicts in the reference's
keys (`reference/darknet.py`, `reference/capsule.py`); plain PyTorch in
float32; nothing of the program.

Departures from the reference repo's host composition, each the fused
pipeline's own (the JAX package's COMPAT #33), so that the comparison
holds the program to the mathematics it means to compute:
  * crops are cut from the detector's input (the frame resized to
    ``darknet_input``, boxes in its pixels), not from the full-resolution
    frame, and are not rounded to uint8 before the classifier;
  * only the ``max_crops`` most confident candidates of a frame are
    classified (`top_candidates`);
  * the crop is cv2.INTER_LINEAR's sampling written out (`crop_resize`),
    as the card's machine has no cv2.
"""

import numpy as np
import torch

from ..traffic import center
from . import capsule as rcap
from . import darknet as rdark


def candidates(sd, x, n_boxes, n_classes):
    """The decode of every candidate of each image of ``x`` (the
    detector's input, `common.resize_bilinear` of the frames, 0-255 as
    the predict path feeds it): confidence (n, c), corners in the input's
    pixels (n, c, 4), class (n, c) and the gap of the two best class
    probabilities (n, c), in grid-scan order."""
    size = x.shape[1]
    y = rdark.forward(sd, x, n_boxes, n_classes)
    return rdark.decode(y, n_boxes, size, (size, size))


def top_candidates(conf, k):
    """(n, c) -> bool (n, c): each image's ``k`` most confident
    candidates, ties to the earlier in grid-scan order."""
    order = torch.sort(conf, dim=1, descending=True, stable=True).indices
    keep = torch.zeros_like(conf, dtype=torch.bool)
    keep.scatter_(1, order[:, :k], True)
    return keep


def _taps(lo, hi, size, out):
    """One axis of the crop of integer windows [lo, hi) (int64 (p,)) of a
    frame ``size`` wide resized to ``out``: for each output pixel the
    two source pixels (absolute indices) and the second's weight, (p,
    out) each.  Pixel j samples (j + 0.5) n / out - 0.5 of a window n
    wide; a sample left of the window's first pixel reads that pixel
    alone, one right of its last the last pixel (border replicate)."""
    n = (hi - lo).clamp_min(1).double()[:, None]
    j = torch.arange(out, dtype=torch.float64, device=lo.device)[None]
    src = (j + 0.5) * n / out - 0.5
    first = torch.floor(src)
    weight = (src - first).where(src >= 0, torch.zeros_like(src))
    a = first.clamp(min=0)
    a = torch.minimum(a, n - 1)
    b = torch.minimum(a + 1, n - 1)
    a = (a.long() + lo[:, None]).clamp(0, size - 1)
    b = (b.long() + lo[:, None]).clamp(0, size - 1)
    return a, b, weight.float()


def crop_resize(x, frame, boxes, out):
    """Crops of ``x`` (n, H, W, C) f32: crop i from image ``frame[i]`` at
    corners ``boxes[i]`` (x1, y1, x2, y2, any float) -> (p, out, out, C).
    The integer window is [int(x1), int(x2)) x [int(y1), int(y2)), each
    corner truncated toward zero and clipped to the image; rows are
    mixed first, then columns; an empty window gives zeros."""
    _, h, w, _ = x.shape
    corner = torch.trunc(boxes.double()).long()
    x1, x2 = corner[:, 0].clamp(0, w), corner[:, 2].clamp(0, w)
    y1, y2 = corner[:, 1].clamp(0, h), corner[:, 3].clamp(0, h)
    r0, r1, wy = _taps(y1, y2, h, out)
    c0, c1, wx = _taps(x1, x2, w, out)
    f = frame[:, None, None]
    r0, r1, wy = r0[:, :, None], r1[:, :, None], wy[:, :, None, None]
    c0, c1, wx = c0[:, None, :], c1[:, None, :], wx[:, None, :, None]
    left = (1 - wy) * x[f, r0, c0] + wy * x[f, r1, c0]
    right = (1 - wy) * x[f, r0, c1] + wy * x[f, r1, c1]
    crops = (1 - wx) * left + wx * right
    empty = (x2 <= x1) | (y2 <= y1)
    return torch.where(empty[:, None, None, None], 0.0, crops)


def crop_scores(sd, x, frame, boxes, out, n_iter, block=256):
    """CapsuleNet's scores (p, K) of the centred crops of ``x`` at
    (``frame``, ``boxes``), in blocks of ``block`` crops."""
    got = []
    for i in range(0, len(frame), block):
        crops = center(crop_resize(x, frame[i:i + block],
                                   boxes[i:i + block], out))
        got.append(rcap.scores(rcap.capsules(sd, crops, n_iter)))
    if not got:
        return torch.zeros((0, sd["traffic_sign_capsules.route_weights"]
                            .shape[2]), device=x.device)
    return torch.cat(got)


def pipeline(sd_det, sd_cls, x, cfg, crop_x=None):
    """The whole pipeline on the detector's inputs ``x``: what it serves
    for each image, as host arrays: frame index, corners in the input's
    pixels, detector class and CapsuleNet's scores of every kept
    candidate above ``conf_th``, in grid-scan order within a frame.
    ``crop_x`` (default ``x``): the images the crops are cut from."""
    conf, xy, cls, _ = candidates(sd_det, x, cfg["n_boxes"],
                                  cfg["n_classes"])
    keep = top_candidates(conf, cfg["max_crops"]) & (conf > cfg["conf_th"])
    frame, j = torch.nonzero(keep, as_tuple=True)
    boxes = xy[frame, j]
    scores = crop_scores(sd_cls, x if crop_x is None else crop_x, frame,
                         boxes, cfg["capsule_input"], cfg["n_iter"])
    return tuple(np.asarray(t.cpu()) for t in (frame, boxes, cls[frame, j],
                                                scores))
