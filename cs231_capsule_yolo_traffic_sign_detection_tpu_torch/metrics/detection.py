"""Detection metrics (numpy): the JAX metrics/detection.py for the
detectors' predict mode and training and the two-stage pipeline —
the scalar IoU and per-image confusion, COCO-style AP over an (IoU x
confidence) threshold sweep, F1 at conf .5 / IoU .5, their class-wise
forms, and darkcapsule's cell-presence F1.  The sweep runs in C++
(metrics/_native.py, csrc/confusion.cpp) unless ``use_native=False``
asks for numpy; both count the same.  With ``save`` the AP curves are
written as the JAX package's PNG files, drawn by metrics/plots.py
(no text).  `darkcapsule_acc` (the unregistered DarkCapsuleNet3's) is
not ported."""

import os

import numpy as np

from .. import config
from ..ops import boxes as box_ops
from . import plots

IOU_THS = np.linspace(0.5, 0.95, 10)
CONF_THS = np.linspace(0, 1, 100)


def _pairwise_iou(gt_xy, pred_xy):
    """(G,4) x (P,4) -> (G,P) IoU, exactly 0 where boxes don't touch."""
    if gt_xy.shape[0] == 0 or pred_xy.shape[0] == 0:
        return np.zeros((gt_xy.shape[0], pred_xy.shape[0]))
    g = gt_xy[:, None, :]
    p = pred_xy[None, :, :]
    lt = np.maximum(g[..., :2], p[..., :2])
    rb = np.minimum(g[..., 2:], p[..., 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_g = (g[..., 2] - g[..., 0]) * (g[..., 3] - g[..., 1])
    area_p = (p[..., 2] - p[..., 0]) * (p[..., 3] - p[..., 1])
    return np.where(inter > 0, inter / (area_g + area_p - inter), 0.0)


def calc_iou_individual(gt_box, pred_box):
    """IoU of one gt and one pred corner box: exactly 0 where they do not
    overlap; inverted corners raise AssertionError, as the reference's
    assertion does."""
    gt = np.asarray(gt_box, dtype=float)
    pred = np.asarray(pred_box, dtype=float)
    for name, b in (("pred", pred), ("gt", gt)):
        if b[2] < b[0] or b[3] < b[1]:
            raise AssertionError(
                f"inverted corners in {name} box {b.tolist()}")
    return float(_pairwise_iou(gt[None, :], pred[None, :])[0, 0])


def single_img_confusion(y_, y_hat_, iou_th):
    """(tp, fp, fn) of one image at one IoU threshold: a gt is hit if any
    pred overlaps it above ``iou_th``, a pred if it overlaps any gt."""
    iou = _pairwise_iou(np.asarray(y_), np.asarray(y_hat_))
    hits = iou > iou_th
    n_gt_hit = int(hits.any(axis=1).sum())
    n_pred_hit = int(hits.any(axis=0).sum())
    n1, n2 = iou.shape
    return n_gt_hit, n2 - n_pred_hit, n1 - n_gt_hit


def precision_and_recall(tp, fp, fn):
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    return precision, recall


def average_precision(p, r):
    """11-point interpolated AP."""
    p, r = np.asarray(p), np.asarray(r)
    prec_at_rec = []
    for recall_level in np.linspace(0.0, 1.0, 11):
        idx = np.flatnonzero(r >= recall_level)
        prec_at_rec.append(np.max(p[idx]) if idx.size else 0.0)
    return float(np.mean(prec_at_rec))


def decode_with_conf(y, params, image_hw=None):
    """Decode every grid cell/box keeping its confidence (no threshold),
    so one decode serves the whole sweep.  Per-image dicts of conf (N,),
    xy (N, 4) and cls (N,) or None."""
    y = np.asarray(y)
    batch, g, _, D = y.shape
    C = params.n_classes
    B = int((D - C) / 5)

    if B <= 0:
        # the reference's negative-B quirk (C forced to 43 on a
        # 5-channel grid): numpy decodes zero boxes, never a crash
        empty_cls = None if C == 0 else np.zeros(0, np.int64)
        return [{"conf": np.zeros(0, np.float32),
                 "xy": np.zeros((0, 4), np.float64),
                 "cls": empty_cls} for _ in range(batch)]

    yb = y[..., : 5 * B].reshape(batch, g, g, B, 5)
    conf = yb[..., 0].reshape(batch, -1)
    rows, cols = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    grid_idx = np.stack([rows, cols], -1)[None, :, :, None, :]
    grid_idx = np.broadcast_to(grid_idx, (batch, g, g, B, 2)).reshape(-1, 2)
    cwh_flat = yb[..., 1:5].reshape(-1, 4)
    if image_hw is None:
        hw_flat = (params.darknet_input, params.darknet_input)
    else:
        hw_flat = np.repeat(np.asarray(image_hw), g * g * B, axis=0)
    cwh_px = box_ops.denorm_boxes_cwh_vec(hw_flat, g, cwh_flat, grid_idx)
    xy = box_ops.cwh_to_xy_vec(cwh_px).reshape(batch, -1, 4)

    if C != 0:
        cls = np.argmax(y[..., 5 * B:], axis=-1)
        cls = np.broadcast_to(cls[..., None],
                              (batch, g, g, B)).reshape(batch, -1)
    else:
        cls = None
    return [{"conf": conf[i], "xy": xy[i],
             "cls": None if cls is None else cls[i]} for i in range(batch)]


def confusion_sweep(gt, pred, iou_ths, conf_ths, cls_filter=None,
                    use_native=True):
    """TP/FP/FN over the full (iou_th x conf_th) grid, all images.

    gt/pred from `decode_with_conf`; thresholding is strict conf > th.
    A gt counts as hit if any included pred overlaps it above iou_th; a
    pred counts as hit if it overlaps any included gt.  ``use_native``
    runs the sweep in C++ (a failed build raises); else in numpy below.
    """
    if use_native:
        from ._native import confusion_sweep_native

        return confusion_sweep_native(gt, pred, iou_ths, conf_ths,
                                      cls_filter)
    iou_ths = np.asarray(iou_ths)
    conf_ths = np.asarray(conf_ths)
    nI, nC = iou_ths.size, conf_ths.size
    TP = np.zeros((nI, nC), np.int64)
    FP = np.zeros((nI, nC), np.int64)
    FN = np.zeros((nI, nC), np.int64)

    for gt_i, pr_i in zip(gt, pred):
        g_keep = (slice(None) if cls_filter is None
                  else (gt_i["cls"] == cls_filter))
        p_keep = (slice(None) if cls_filter is None
                  else (pr_i["cls"] == cls_filter))
        g_conf, g_xy = gt_i["conf"][g_keep], gt_i["xy"][g_keep]
        p_conf, p_xy = pr_i["conf"][p_keep], pr_i["xy"][p_keep]

        gmask = g_conf[None, :] > conf_ths[:, None]           # (nC,G)
        pmask = p_conf[None, :] > conf_ths[:, None]           # (nC,P)
        hits = _pairwise_iou(g_xy, p_xy)[None] > iou_ths[:, None, None]
        gt_hit = (hits[:, None] & pmask[None, :, None, :]).any(-1)
        tp = (gt_hit & gmask[None]).sum(-1)                   # (nI,nC)
        pred_hit = (hits[:, None] & gmask[None, :, :, None]).any(-2)
        TP += tp
        FP += pmask.sum(-1)[None] - (pred_hit & pmask[None]).sum(-1)
        FN += gmask.sum(-1)[None] - tp
    return TP, FP, FN


def _pr_curves(TP, FP, FN):
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(TP + FP > 0, TP / np.maximum(TP + FP, 1), 0.0)
        r = np.where(TP + FN > 0, TP / np.maximum(TP + FN, 1), 0.0)
    return p, r


def _save_pr_plot(path, p, r):
    """The PR curve of each IoU threshold (recall on x, precision on y,
    axes to 1.1), coloured as the JAX package's (config.colors[2i])."""
    plots.save_plot(path, [(r[i], p[i], config.colors[i * 2])
                           for i in range(len(IOU_THS))],
                    (0.0, 1.1), (0.0, 1.1))


def _plot_dir(params, save_dir):
    return save_dir if save_dir is not None else \
        config.model_dir[params.model]


def detect_AP(y, y_hat, params, save=False, save_dir=None):
    """COCO-style AP: 11-point AP averaged over IoU .5:.05:.95, with a
    100-point confidence sweep.  ``save`` writes the PR curves to
    ``<save_dir>/d_AP.png`` (default: the model's dir)."""
    TP, FP, FN = confusion_sweep(decode_with_conf(y, params),
                                 decode_with_conf(y_hat, params),
                                 IOU_THS, CONF_THS)
    p, r = _pr_curves(TP, FP, FN)
    if save:
        _save_pr_plot(os.path.join(_plot_dir(params, save_dir), "d_AP.png"),
                      p, r)
    return float(np.mean([average_precision(p[i], r[i])
                          for i in range(len(IOU_THS))]))


def detect_acc(y, y_hat, params):
    """F1 at conf .5 / IoU .5."""
    TP, FP, FN = confusion_sweep(decode_with_conf(y, params),
                                 decode_with_conf(y_hat, params),
                                 [0.5], [0.5])
    p, r = precision_and_recall(int(TP[0, 0]), int(FP[0, 0]), int(FN[0, 0]))
    return 2 * p * r / (p + r + 1e-8)


def detect_and_recog_acc(y, y_hat, params):
    """Class-wise F1 at conf .5 / IoU .5: TP/FP/FN summed over the
    classes, each counted between boxes of that class only, then one
    F1.  darknet_r's training metric."""
    gt = decode_with_conf(y, params)
    pred = decode_with_conf(y_hat, params)
    TP = FP = FN = 0
    for c in range(params.n_classes):
        tp, fp, fn = confusion_sweep(gt, pred, [0.5], [0.5], cls_filter=c)
        TP += int(tp[0, 0])
        FP += int(fp[0, 0])
        FN += int(fn[0, 0])
    p, r = precision_and_recall(TP, FP, FN)
    return 2 * p * r / (p + r + 1e-8)


def detect_and_recog_mAP(y, y_hat, params, save=False, save_dir=None):
    """Class-wise COCO-style AP: per class, the 11-point AP at each IoU
    threshold over the confidence sweep, averaged over the classes
    present in ``y``.  As the reference, it sets ``params.n_classes`` to
    43 first (and leaves it so).  The two-stage pipeline's metric.
    ``save`` writes each class's PR curves to
    ``<save_dir>/d&r_mAP_class_<c>.png``."""
    params.n_classes = 43
    gt = decode_with_conf(y, params)
    pred = decode_with_conf(y_hat, params)
    avg_ps = []
    for c in range(params.n_classes):
        TP, FP, FN = confusion_sweep(gt, pred, IOU_THS, CONF_THS,
                                     cls_filter=c)
        p, r = _pr_curves(TP, FP, FN)
        if save:
            _save_pr_plot(os.path.join(_plot_dir(params, save_dir),
                                       f"d&r_mAP_class_{c}.png"), p, r)
        avg_ps.extend(average_precision(p[i], r[i])
                      for i in range(len(IOU_THS)))
    y = np.asarray(y)
    present = np.sign(y[:, :, :, 5:].reshape(-1, 43).sum(axis=0)) > 0
    avg_ps = np.asarray(avg_ps).reshape(params.n_classes, -1)[present]
    return float(np.mean(avg_ps))


def darkcapsule_cell_f1(y, y_hat, params):
    """Cell-presence F1 of DarkCapsuleNet's (B, g, g, 5) capsule grid:
    a cell is predicted present where its capsule's length exceeds 0.5,
    against the target's objectness bit.  darkcapsule's epoch metric,
    the JAX package's binding (COMPAT #4)."""
    y, y_hat = np.asarray(y), np.asarray(y_hat)
    pred = np.sqrt(np.sum(y_hat ** 2, axis=-1)) > 0.5
    true = y[..., 0] == 1
    p, r = precision_and_recall(int(np.sum(pred & true)),
                                int(np.sum(pred & ~true)),
                                int(np.sum(~pred & true)))
    return 2 * p * r / (p + r + 1e-8)
