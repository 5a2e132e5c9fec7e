"""Crop and bilinear resize for the two-stage pipeline (counterpart of
the JAX ops/crop.py).

`crop_resize_bilinear` crops every box of a batch from the images on
their device and resizes it with cv2's INTER_LINEAR sampling, in fixed
shapes, so the fused two-stage path (predict._dark_class_pred_fused)
never leaves the card between the detector and the classifier:

  * the integer crop window is [int(x1), int(x2)) x [int(y1), int(y2)),
    truncated toward zero and clipped to the frame (JAX viz.py:45-51);
  * output pixel j reads the source coordinate (j + 0.5) * n / out - 0.5
    of a window n pixels wide, its two neighbours clamped inside the
    window (border replicate; a coordinate left of the first pixel reads
    that pixel alone), mixed by the fractional part, rows first;
  * an empty window (after the clip) and a box masked out by ``valid``
    give an all-zero crop.

`frame_crops` is the host path's crop (JAX predict.dark_pred with
``is_end=False``): each box sliced from its full-resolution uint8 frame
and resized to the classifier's input as ``cv2.resize`` does, with the
same sampler (the card's machine has no cv2), rounded to uint8 as cv2
returns it.  cv2 weighs the neighbours in 11-bit fixed point, so a crop
may differ from cv2's by one level.
"""

import numpy as np
import torch


def _axis_samples(lo, hi, size, out):
    """cv2's sample positions along one axis of integer windows
    [lo, hi) (int64 (...,)) of a frame ``size`` wide: the two
    neighbours' absolute indices and the weight of the second, each
    (..., out)."""
    n = (hi - lo).clamp_min(1)[..., None]
    j = torch.arange(out, dtype=torch.float32, device=lo.device)
    r = (j + 0.5) * (n.float() * (1.0 / out)) - 0.5
    r0 = torch.floor(r).long()
    # border replicate: left of pixel 0 reads pixel 0 alone; right of the
    # last pixel both neighbours are the last pixel
    frac = torch.where(r0 < 0, 0.0, r - r0.float())
    i0 = torch.minimum(r0.clamp_min(0), n - 1)
    i1 = torch.minimum(i0 + 1, n - 1)
    lo = lo[..., None]
    return ((lo + i0).clamp(0, size - 1), (lo + i1).clamp(0, size - 1),
            frac)


def crop_resize_bilinear(images, boxes, out, valid=None):
    """images (B, H, W, C) (any real dtype, sampled in f32), boxes (B, M,
    4) corner boxes x1, y1, x2, y2 in the images' pixels, valid (B, M)
    bool or None -> crops (B, M, out, out, C) f32 on the images'
    device."""
    x = images.float()
    b, h, w, _ = x.shape
    m = boxes.shape[1]
    corners = torch.trunc(boxes).long()  # in the boxes' own precision
    x1, x2 = corners[..., 0].clamp(0, w), corners[..., 2].clamp(0, w)
    y1, y2 = corners[..., 1].clamp(0, h), corners[..., 3].clamp(0, h)
    ok = (x2 > x1) & (y2 > y1)
    if valid is not None:
        ok = ok & valid
    xi0, xi1, fx = _axis_samples(x1, x2, w, out)            # (B, M, out)
    yi0, yi1, fy = _axis_samples(y1, y2, h, out)
    bi = torch.arange(b, device=x.device)[:, None, None, None]
    yi0, yi1 = yi0[..., :, None], yi1[..., :, None]         # (B, M, out, 1)
    xi0, xi1 = xi0[..., None, :], xi1[..., None, :]         # (B, M, 1, out)
    fy, fx = fy[..., :, None, None], fx[..., None, :, None]
    # the JAX sampler's order: the two rows mixed first, then the columns
    top = x[bi, yi0, xi0] + fy * (x[bi, yi1, xi0] - x[bi, yi0, xi0])
    right = x[bi, yi0, xi1] + fy * (x[bi, yi1, xi1] - x[bi, yi0, xi1])
    crops = top + fx * (right - top)
    return torch.where(ok.view(b, m, 1, 1, 1), crops, 0.0)


def frame_crops(images, image_indices, boxes_xy, out, device):
    """The host path's crops: box i cut from its uint8 frame
    ``images[image_indices[i]]`` (boxes_xy (n, 4) in that frame's
    pixels) and resized to (out, out), rounded to uint8; zeros for an
    empty window.  Each frame with boxes goes to ``device`` once.
    Returns uint8 (n, out, out, 3) on the host, (0, out, out, 3) for no
    box."""
    crops = np.zeros((len(image_indices), out, out, 3), np.uint8)
    for i in np.unique(image_indices):
        rows = np.flatnonzero(image_indices == i)
        frame = torch.from_numpy(np.ascontiguousarray(images[i])).to(device)
        boxes = torch.from_numpy(np.asarray(boxes_xy[rows],
                                            np.float64)).to(device)
        got = crop_resize_bilinear(frame[None], boxes[None], out)[0]
        crops[rows] = torch.floor(got + 0.5).clamp(0, 255).to(
            torch.uint8).cpu().numpy()
    return crops
