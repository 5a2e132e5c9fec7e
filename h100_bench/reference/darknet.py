"""Plain DarkNet-19 YOLO-v1 (the reference repo's models.py:126-236 and
loss_fns.py's YOLO loss) over a state_dict in the reference's keys:
``model.conv_{i}.weight`` (OIHW, no bias), ``model.bn_{i}.{weight,
bias,running_mean,running_var}`` (i = 1..18) and ``model.conv_19.weight``,
the 1x1 head.  Plain PyTorch in float32; nothing of the program.

Departures, each for the comparison's sake and none changing the
mathematics:
  * the forward takes NHWC images and works on channels_last NCHW
    views, so that a dropout mask drawn here from a generator of a given
    seed is the mask the program draws from the same seed (masks are
    drawn in memory order);
  * BN in training normalises by the biased batch variance and leaves
    the running statistics alone (a train step's loss reads neither);
  * the loss's square root of a width is taken only where a box is
    responsible (elsewhere its term is 0 and its gradient too).
"""

import torch
import torch.nn.functional as F

from ..work import DARKNET_LAYERS

BN_EPS = 1e-5
SLOPE = 0.1


def _bn(x, sd, i, train):
    p = f"model.bn_{i}."
    g, b = sd[p + "weight"], sd[p + "bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
    else:
        mean, var = sd[p + "running_mean"], sd[p + "running_var"]
    inv = g / torch.sqrt(var + BN_EPS)
    return (x - mean[None, :, None, None]) * inv[None, :, None, None] \
        + b[None, :, None, None]


def features(sd, x, train=False, dropout=0.0, generator=None, stats=None):
    """NHWC images -> the last block's activations (NCHW view).  In
    training the BN takes batch statistics and, after each "drop" block,
    dropout keeps a value with probability 1 - ``dropout``, its mask
    drawn from ``generator``.  ``stats`` (a list) collects each BN's
    batch mean and biased variance."""
    h = x.permute(0, 3, 1, 2)
    for i, (_, k, after) in enumerate(DARKNET_LAYERS, start=1):
        h = F.conv2d(h, sd[f"model.conv_{i}.weight"], padding=k // 2)
        if stats is not None:
            stats.append((h.mean(dim=(0, 2, 3)),
                          h.var(dim=(0, 2, 3), unbiased=False)))
        h = F.leaky_relu(_bn(h, sd, i, train), SLOPE)
        if train and after == "drop" and dropout > 0:
            keep = 1.0 - dropout
            if not h.is_contiguous(memory_format=torch.channels_last):
                raise ValueError("reference dropout: channels_last "
                                 "activations expected")
            mask = torch.empty_like(h, dtype=torch.bool)
            mask.bernoulli_(keep, generator=generator)
            h = torch.where(mask, h / keep, 0.0)
        if after == "mp":
            h = F.max_pool2d(h, 2, 2)
    return h


def head(sd, h, n_boxes, n_classes):
    """Last activations -> the NHWC grid: sigmoid over the 5 B box
    channels, softmax over the classes."""
    out = F.conv2d(h, sd[f"model.conv_{len(DARKNET_LAYERS) + 1}.weight"])
    out = out.permute(0, 2, 3, 1)
    box = torch.sigmoid(out[..., :5 * n_boxes])
    if n_classes == 0:
        return box
    return torch.cat([box, torch.softmax(out[..., 5 * n_boxes:], -1)], -1)


def forward(sd, x, n_boxes, n_classes, **kw):
    return head(sd, features(sd, x, **kw), n_boxes, n_classes)


def decode(y, n_boxes, img_size, frame_hw):
    """The grid (B, g, g, 5 n_boxes + C) -> every candidate of each
    image, in grid-scan order (row, col, box): confidence (B, n),
    corner boxes in the frame's pixels (B, n, 4), class (B, n) and the
    gap between the two best class probabilities (B, n)."""
    b, g = y.shape[:2]
    yb = y[..., :5 * n_boxes].reshape(b, g, g, n_boxes, 5)
    cell = img_size / g
    col = torch.arange(g, device=y.device, dtype=y.dtype)
    xc = (yb[..., 1] + col[None, None, :, None]) * cell
    yc = (yb[..., 2] + col[None, :, None, None]) * cell
    w, h = yb[..., 3] * img_size, yb[..., 4] * img_size
    sx, sy = frame_hw[1] / img_size, frame_hw[0] / img_size
    xy = torch.stack([(xc - w / 2) * sx, (yc - h / 2) * sy,
                      (xc + w / 2) * sx, (yc + h / 2) * sy], -1)
    cls_p = y[..., 5 * n_boxes:]
    if cls_p.shape[-1]:
        top2 = cls_p.topk(min(2, cls_p.shape[-1]), dim=-1).values
        gap = (top2[..., 0] - top2[..., -1]) if top2.shape[-1] > 1 \
            else torch.ones_like(top2[..., 0])
        cls = cls_p.argmax(-1)
    else:
        gap = torch.ones(y.shape[:3], device=y.device)
        cls = torch.zeros(y.shape[:3], dtype=torch.long, device=y.device)
    expand = (b, g, g, n_boxes)
    return (yb[..., 0].reshape(b, -1), xy.reshape(b, -1, 4),
            cls[..., None].expand(expand).reshape(b, -1),
            gap[..., None].expand(expand).reshape(b, -1))


def _corners(cwh, img_size, g):
    """Grid-frame centre boxes -> corners: centres in cell units times
    the cell's size, widths times the image's (no cell offset: the
    prediction and its target share the frame)."""
    cell = img_size / g
    xc, yc = cwh[..., 0] * cell, cwh[..., 1] * cell
    hw, hh = cwh[..., 2] * img_size / 2, cwh[..., 3] * img_size / 2
    return torch.stack([xc - hw, yc - hh, xc + hw, yc + hh], -1)


def _iou(a, b):
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
            + (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]))
    return torch.nan_to_num(inter / (area - inter))


def yolo_loss(y_pred, y_true, n_boxes, n_classes, img_size, l_coord,
              l_noobj):
    """The YOLO-v1 loss summed over the batch and divided by its size.
    Per object cell the responsible box is the first with the largest
    IoU against the target (both detached); it regresses its confidence
    to that IoU, its centre and the square roots of its size (weight
    ``l_coord``); every other box pushes its confidence to 0 (weight
    ``l_noobj``); the class probabilities regress to the one-hot
    target on object cells."""
    b, g = y_true.shape[:2]
    pred = y_pred[..., :5 * n_boxes].reshape(b, g, g, n_boxes, 5)
    true = y_true[..., :5]
    obj = (true[..., 0] == 1.0).float()
    noobj = (true[..., 0] == 0.0).float()
    iou = torch.stack([
        _iou(_corners(pred[..., j, 1:5].detach(), img_size, g),
             _corners(true[..., 1:5], img_size, g))
        for j in range(n_boxes)], -1)
    best = iou.max(-1).values
    resp = torch.zeros_like(iou)
    resp.scatter_(-1, iou.argmax(-1, keepdim=True), 1.0)
    resp = resp * obj[..., None]
    pc = pred[..., 0]
    loss_noobj = (noobj[..., None] * pc ** 2).sum() \
        + (obj[..., None] * (1 - resp) * pc ** 2).sum()
    loss_pc = (resp * (pc - best[..., None]) ** 2).sum()
    loss_xy = (resp[..., None] * (pred[..., 1:3] - true[..., None, 1:3])
               ** 2).sum()
    on = resp[..., None] > 0
    w = torch.where(on, pred[..., 3:5], 1.0)
    loss_wh = torch.where(
        on, (w.sqrt() - true[..., None, 3:5].sqrt()) ** 2, 0.0).sum()
    loss = l_coord * (loss_xy + loss_wh) + loss_pc + l_noobj * loss_noobj
    if n_classes:
        loss = loss + (obj[..., None] * (y_true[..., 5:]
                                         - y_pred[..., 5 * n_boxes:])
                       ** 2).sum()
    return loss / b
