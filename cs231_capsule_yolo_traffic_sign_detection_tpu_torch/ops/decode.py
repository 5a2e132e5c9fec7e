"""On-device YOLO grid decode with static shapes (counterpart of the JAX
ops/decode.py).

Every grid candidate is decoded into a fixed-size box tensor sorted by
confidence, ties in grid-scan order (row, col, box) as ``jax.lax.top_k``
keeps them, plus a validity mask and the candidate's grid index.
`to_flat_host` turns that into the reference's flat lists in grid-scan
order, restored from the index.  `nms_mask` is the JAX package's
optional greedy NMS over that sorted list (off by default: the
reference has none).
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import profiling
from .boxes import iou_xy


def decode_grid(y, *, n_classes, n_boxes, img_size, max_boxes=None,
                conf_th=0.5):
    """Decode (batch, g, g, 5B+C) into fixed-size per-image box lists.

    ``max_boxes`` (n below) defaults to all g*g*B candidates, so no
    above-threshold box is dropped; a smaller static cap keeps the top
    ``max_boxes`` by confidence (the fused two-stage path), and a larger
    one pads with invalid zero slots.  Returns a dict of tensors on y's
    device:
      conf (batch, n) descending; xy (batch, n, 4) corner boxes in the
      img_size frame; classes (batch, n) int32 argmax class (0 if
      C == 0); valid (batch, n) bool, conf > conf_th; idx (batch, n)
      int32 candidate index in row-major (row, col, box) order.
    """
    batch, g, _, D = y.shape
    B, C = n_boxes, n_classes
    if D != 5 * B + C:
        raise ValueError(f"decode_grid: {D} channels != 5*{B} + {C}")
    n_cand = g * g * B
    if max_boxes is None:
        max_boxes = n_cand
    k = min(max_boxes, n_cand)

    yb = y[..., : 5 * B].reshape(batch, g, g, B, 5)
    conf = yb[..., 0]
    grid_size = img_size / g
    ar = torch.arange(g, device=y.device, dtype=y.dtype)
    xc = (yb[..., 1] + ar[None, None, :, None]) * grid_size
    yc = (yb[..., 2] + ar[None, :, None, None]) * grid_size
    w = yb[..., 3] * img_size
    h = yb[..., 4] * img_size
    xy = torch.stack([xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2],
                     dim=-1)

    if C != 0:
        cls = torch.argmax(y[..., 5 * B:], dim=-1).to(torch.int32)
        cls = cls[..., None].expand(conf.shape)
    else:
        cls = torch.zeros(conf.shape, dtype=torch.int32, device=y.device)

    # a stable descending sort: tied confidences keep grid-scan order
    top_conf, top_idx = torch.sort(conf.reshape(batch, n_cand), dim=1,
                                   descending=True, stable=True)
    top_conf, top_idx = top_conf[:, :k], top_idx[:, :k]
    out_xy = torch.gather(xy.reshape(batch, n_cand, 4), 1,
                          top_idx[..., None].expand(batch, k, 4))
    out_cls = torch.gather(cls.reshape(batch, n_cand), 1, top_idx)
    out = {"conf": top_conf, "xy": out_xy, "classes": out_cls,
           "valid": top_conf > conf_th, "idx": top_idx.to(torch.int32)}
    if k < max_boxes:  # pad to the static width with invalid zero slots
        pad = max_boxes - k
        out = {name: F.pad(t, (0, 0, 0, pad) if t.dim() == 3 else (0, pad))
               for name, t in out.items()}
    return out


def nms_mask(xy, conf, valid, iou_th=0.5):
    """Greedy NMS over `decode_grid`'s confidence-sorted fixed-size list
    (JAX ops/decode.py:nms_mask), on xy's device in plain torch.

    Slot by slot in list order, a slot still kept suppresses every LATER
    slot whose IoU with it exceeds ``iou_th`` (strict); degenerate padded
    slots (zero area, 0/0) count as IoU 0 and never suppress anything.
    ``conf`` is unused, as in JAX: the list is already sorted.  Returns
    the updated validity mask (batch, n) bool.
    """
    del conf
    n = xy.shape[-2]
    iou = torch.nan_to_num(iou_xy(xy, xy))             # (batch, n, n)
    later = torch.ones(n, n, dtype=torch.bool, device=xy.device).triu(1)
    over = (iou > iou_th) & later
    keep = valid.clone()
    for i in range(n - 1):
        keep &= ~(over[:, i] & keep[:, i, None])
    return keep


def to_flat_host(decoded, image_hw=None, img_size=None, with_classes=True):
    """Fixed-size decode -> (image_indices, xy, classes_or_None).

    Per-image boxes come in the reference's grid-scan order, restored
    from ``idx``; with ``image_hw`` (batch, 2) boxes are rescaled from
    the img_size frame into each image's frame.
    """
    out, _ = to_flat_host_with_extras(
        decoded, None, image_hw=image_hw, img_size=img_size,
        with_classes=with_classes)
    return out


def to_flat_host_with_extras(decoded, extras, image_hw=None, img_size=None,
                             with_classes=True):
    """`to_flat_host` plus extra per-slot arrays flattened in the same
    order.  Returns ((image_indices, xy, classes_or_None), flat_extras).

    Recorded as a ``cyt.fetch`` span (``images``; ``boxes``, those it
    unpacked), the copies to the host (which wait for the card) as
    ``cyt.fetch.wait`` and the per-image unpacking as
    ``cyt.fetch.unpack`` (`profiling`)."""
    with profiling.span(profiling.FETCH,
                        images=len(decoded["conf"])) as fetch:
        with profiling.span(profiling.FETCH_WAIT):
            conf, xy, cls, valid, idx = (decoded[k].cpu().numpy() for k in (
                "conf", "xy", "classes", "valid", "idx"))
            extras = {k: v.cpu().numpy() for k, v in (extras or {}).items()}
        with profiling.span(profiling.FETCH_UNPACK):
            out = _unpack(conf, xy, cls, valid, idx, extras, image_hw,
                          img_size, with_classes)
        if fetch is not None:
            fetch.args["boxes"] = len(out[0][0])
        return out


def _unpack(conf, xy, cls, valid, idx, extras, image_hw, img_size,
            with_classes):
    """The host arrays of a decode, flattened image by image."""
    img_idx, boxes, classes = [], [], []
    extras_out = {k: [] for k in extras}
    for i in range(conf.shape[0]):
        m = valid[i]
        order = np.argsort(idx[i][m])
        b = xy[i][m][order]
        if image_hw is not None:
            hscale = image_hw[i][0] / img_size
            wscale = image_hw[i][1] / img_size
            b = b * np.array([wscale, hscale, wscale, hscale])
        img_idx.append(np.full(b.shape[0], i, dtype=np.int64))
        boxes.append(b)
        classes.append(cls[i][m][order])
        for k, arr in extras.items():
            extras_out[k].append(arr[i][m][order])
    image_indices = (np.concatenate(img_idx) if img_idx
                     else np.zeros(0, np.int64))
    xy_out = np.concatenate(boxes) if boxes else np.zeros((0, 4))
    cls_out = np.concatenate(classes) if classes else np.zeros(0, np.int64)
    out = (image_indices, xy_out, (cls_out if with_classes else None))
    flat_extras = {
        k: (np.concatenate(v) if v
            else np.zeros((0,) + extras[k].shape[2:], extras[k].dtype))
        for k, v in extras_out.items()
    }
    return out, flat_extras
