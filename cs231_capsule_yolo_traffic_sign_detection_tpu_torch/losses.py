"""Losses (PyTorch port of the JAX losses.py): the two classifiers', the
YOLO-v1 detector's (darknet_r and darknet_d) and darkcapsule's.

`LossConfig.from_params` reads the same keys with the same defaults as
the JAX one.  `cnn_loss` is the reference's softmax cross-entropy
(loss_fns.py:6-8), summed and divided by the batch size.
`capsule_loss` is the reference's (loss_fns.py:11-23): the margin loss
T relu(0.9 - s)^2 + 0.5 (1 - T) relu(s - 0.1)^2 summed over every
entry, plus ``recon_coef * sum((x - recon)^2)`` when the reconstruction
is on, all divided by the batch size.  `dark_loss` is the JAX package's
masked, fixed-shape YOLO-v1 loss.  `darkcapsule_loss` is the
reference's polar loss (loss_fns.py:187-204).  All return ``(loss,
aux)`` as the JAX losses do, and none waits for the card: no
``.item()``, no ``F.one_hot`` (it checks its labels on the host), no
boolean indexing.  darkcapsule's variants 2 and 3 are not ported.
"""

import dataclasses

import torch
import torch.nn.functional as F

from .ops.boxes import cwh_to_xy_grid, iou_xy
from .ops.polar import polar_transform


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Static loss hyperparameters extracted from Params."""

    n_classes: int = 43
    n_boxes: int = 2
    n_grid: int = 14
    darknet_input: int = 448
    l_coord: float = 5.0
    l_noobj: float = 0.5
    recon: bool = True
    recon_coef: float = 5e-4

    @classmethod
    def from_params(cls, params):
        return cls(
            n_classes=int(params.get("n_classes", 43)),
            n_boxes=int(params.get("n_boxes", 2)),
            n_grid=int(params.get("n_grid", 14)),
            darknet_input=int(params.get("darknet_input", 448)),
            l_coord=float(params.get("l_coord", 5.0)),
            l_noobj=float(params.get("l_noobj", 0.5)),
            recon=bool(params.get("recon", True)),
            recon_coef=float(params.get("recon_coef", 5e-4)),
        )


def _one_hot(index, n, dtype):
    """One-hot by comparison: F.one_hot checks the labels' range on the
    host, which waits for the card once per step."""
    return (index[..., None] == torch.arange(n, device=index.device)).to(
        dtype)


def cnn_loss(scores, y, cfg, x=None, recon=None):
    """Softmax cross-entropy: -log softmax(scores) at the label, summed
    over the batch and divided by its size.  scores (B, n_classes), y
    (B,) int labels."""
    picked = F.log_softmax(scores, dim=1).gather(1, y.long()[:, None])
    return -picked.sum() / y.shape[0], {}


def capsule_loss(scores, y, cfg, x=None, recon=None):
    """Margin loss + optional reconstruction squared error, / batch.

    scores (B, n_classes) f32, y (B,) int labels, x and recon (B, 32, 32,
    3) f32 crops and their reconstruction."""
    left = F.relu(0.9 - scores) ** 2
    right = F.relu(scores - 0.1) ** 2
    labels = _one_hot(y.long(), cfg.n_classes, scores.dtype)
    loss = (labels * left + 0.5 * (1.0 - labels) * right).sum()
    if cfg.recon and recon is not None:
        loss = loss + cfg.recon_coef * ((x - recon) ** 2).sum()
    return loss / y.shape[0], {}


def dark_loss(y_pred, y_true, cfg):
    """YOLO-v1 loss over every cell, masked (JAX losses.py:84-181).

    y_pred (b, g, g, 5B + C) f32, y_true (b, g, g, 5 + C).  Returns
    (loss, {"avg_iou": mean max-IoU over object cells, 0 when there is
    none}), both 0-d tensors on y_pred's device.  Per object cell the
    responsible box is the first of the B with the largest IoU against
    the target, both in the shared corner frame and detached; it
    regresses its confidence to that (detached) IoU, its xy and sqrt wh
    with weight l_coord; the other boxes of object cells and every box
    of empty cells push their confidence to 0 with weight l_noobj; class
    L2 on object cells; the sum over the batch divided by its size.
    """
    y_true = y_true.to(y_pred.dtype)
    B, C = cfg.n_boxes, cfg.n_classes
    batch_size, g = y_true.shape[0], y_true.shape[1]

    pred_boxes = y_pred[..., :5 * B].reshape(batch_size, g, g, B, 5)
    true_boxes = y_true[..., :5].reshape(batch_size, g, g, 1, 5)
    obj = (true_boxes[:, :, :, 0, 0] == 1.0).to(y_pred.dtype)
    noobj = (true_boxes[:, :, :, 0, 0] == 0.0).to(y_pred.dtype)

    pred_pc = pred_boxes[..., 0]                       # (b, g, g, B)
    pred_cwh = pred_boxes[..., 1:5]
    true_cwh = true_boxes[..., 1:5]                    # (b, g, g, 1, 4)

    noobj_loss_pc = (noobj[..., None] * pred_pc ** 2).sum()

    # both conversions detached, as the reference's (utils.py:370)
    pred_xy = cwh_to_xy_grid(pred_cwh.detach(), cfg.darknet_input, g)
    true_xy = cwh_to_xy_grid(true_cwh.detach(), cfg.darknet_input, g)
    iou = torch.nan_to_num(iou_xy(pred_xy, true_xy)[..., 0])  # 0/0 -> 0
    max_iou = iou.max(dim=-1).values                   # (b, g, g)
    responsible = _one_hot(iou.argmax(dim=-1), B, y_pred.dtype)  # first max

    obj_b = obj[..., None]
    noobj_loss_pc = noobj_loss_pc + (
        obj_b * (1.0 - responsible) * pred_pc ** 2).sum()
    obj_loss_pc = (obj_b * responsible
                   * (pred_pc - max_iou[..., None]) ** 2).sum()

    resp = (obj_b * responsible)[..., None]            # (b, g, g, B, 1)
    obj_loss_xy = (resp * (pred_cwh[..., 0:2] - true_cwh[..., 0:2])
                   ** 2).sum()
    # sqrt of a safe input off the mask: a masked-out w that underflowed
    # to 0 would otherwise send 0 * inf = NaN into the shared weights
    resp_on = resp > 0
    wh_safe = torch.where(resp_on, torch.maximum(
        pred_cwh[..., 2:4], pred_cwh.new_zeros(())), 1.0)
    obj_loss_wh = torch.where(
        resp_on, (wh_safe.sqrt() - true_cwh[..., 2:4].sqrt()) ** 2,
        0.0).sum()

    obj_loss_class = 0.0
    if C != 0:
        obj_loss_class = (obj[..., None] * (y_true[..., 5:]
                                            - y_pred[..., 5 * B:]) ** 2).sum()

    loss = (cfg.l_coord * obj_loss_xy + cfg.l_coord * obj_loss_wh
            + obj_loss_pc + cfg.l_noobj * noobj_loss_pc
            + obj_loss_class) / batch_size
    n_obj = obj.sum()
    avg_iou = torch.where(n_obj > 0,
                          (obj * max_iou).sum() / n_obj.clamp_min(1.0), 0.0)
    return loss, {"avg_iou": avg_iou}


def darkcapsule_loss(caps, y, cfg, x=None, recon=None):
    """Capsule detection loss (JAX losses.py:184-208): the margin on each
    cell capsule's length against the presence y_r, plus the coordinate
    term -caps . y_phi against the polar-transformed target, summed and
    divided by the batch.

    caps (B, g, g, 5), y (B, g, g, 5 + C).  As the reference, the
    reconstruction error is added outside the division and without
    recon_coef, and only when a reconstruction is given (the train loop
    never gives one: COMPAT #5)."""
    y = y.to(caps.dtype)
    y_r, y_phi = polar_transform(y[..., :5])
    cap_r = (caps * caps).sum(dim=-1).sqrt()
    margin = (y_r * F.relu(0.9 - cap_r) ** 2
              + 0.5 * (1.0 - y_r) * F.relu(cap_r - 0.1) ** 2)
    loss = (margin.sum() + (-caps * y_phi).sum()) / y.shape[0]
    if cfg.recon and recon is not None:
        loss = loss + ((x - recon) ** 2).sum()
    return loss, {}
