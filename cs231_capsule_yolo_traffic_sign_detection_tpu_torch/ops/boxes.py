"""Box geometry, the subset of the JAX ops/boxes.py that the detector
and the two-stage pipeline use: host-side (numpy) helpers for the data,
decode, metrics and `combine_y_hat`, and the device-side (torch)
conversion and IoU of the detector's loss."""

import numpy as np
import torch


def xy_to_cwh(box_xy):
    """Corner box [x1,y1,x2,y2] -> center box [xc,yc,w,h]."""
    x1, y1, x2, y2 = box_xy
    return [(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1]


def cwh_to_xy(box_cwh):
    """Center box [xc,yc,w,h] -> corner box [x1,y1,x2,y2]."""
    xc, yc, w, h = box_cwh
    return [xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2]


def resize_box_xy(orig_hw, resized_hw, box_xy):
    """Corner box in an image of ``orig_hw`` -> the same box in the image
    resized to ``resized_hw``."""
    orig_h, orig_w = orig_hw
    resized_h, resized_w = resized_hw
    x1, y1, x2, y2 = box_xy
    wr = 1.0 * resized_w / orig_w
    hr = 1.0 * resized_h / orig_h
    return [x1 * wr, y1 * hr, x2 * wr, y2 * hr]


def normalize_box_cwh(image_hw, n_grid, box_cwh):
    """Center box -> ([xc_cell, yc_cell, w_img, h_img], [row, col]):
    the center relative to its grid cell, w/h relative to the image."""
    image_h, image_w = image_hw
    xc, yc, box_w, box_h = box_cwh
    norm_w = 1.0 * box_w / image_w
    norm_h = 1.0 * box_h / image_h
    grid_w = 1.0 * image_w / n_grid
    grid_h = 1.0 * image_h / n_grid
    col = int(xc / grid_w)
    row = int(yc / grid_h)
    norm_xc = 1.0 * (xc - col * grid_w) / grid_w
    norm_yc = 1.0 * (yc - row * grid_h) / grid_h
    return [norm_xc, norm_yc, norm_w, norm_h], [row, col]


def denorm_boxes_cwh_vec(image_hw, n_grid, norm_cwh, grid_indices):
    """Grid-relative boxes (num_boxes, 4) at [row, col] grid_indices ->
    image pixels.  image_hw: one (h, w) or (num_boxes, 2)."""
    image_hw = np.asarray(image_hw, dtype=np.float64).reshape(-1, 2)
    image_wh = image_hw[:, [1, 0]]
    grids_wh = 1.0 * image_wh / n_grid
    scale = np.concatenate((grids_wh, image_wh), axis=1)
    cwh = np.asarray(norm_cwh, dtype=np.float64) * scale
    cwh[:, 0:2] += np.asarray(grid_indices)[:, [1, 0]] * grids_wh
    return cwh


def cwh_to_xy_vec(cwh):
    """(num_boxes, 4) center boxes -> corner boxes."""
    cwh = np.asarray(cwh)
    xy = np.empty_like(cwh)
    half_w = cwh[:, 2] / 2
    half_h = cwh[:, 3] / 2
    xy[:, 0] = cwh[:, 0] - half_w
    xy[:, 1] = cwh[:, 1] - half_h
    xy[:, 2] = cwh[:, 0] + half_w
    xy[:, 3] = cwh[:, 1] + half_h
    return xy


def y_to_boxes_vec(y, params, image_hw=None, conf_th=0.5):
    """YOLO grid (batch, g, g, 5B+C) -> (image_indices, xy, classes or
    None), boxes with conf > conf_th in grid-scan order.  image_hw: None
    maps every box to darknet_input^2, else (batch, 2) sizes."""
    y = np.asarray(y)
    batch_size, n_grid, _, D = y.shape
    C = params.n_classes
    B = int((D - C) / 5)

    y_boxes = y[:, :, :, 0:5 * B].reshape(batch_size, n_grid, n_grid, B, 5)
    mask = y_boxes[:, :, :, :, 0] > conf_th
    indices = np.argwhere(mask)  # (num_boxes, 4): [img, row, col, b]

    cwh = y_boxes[mask][:, 1:5]
    image_indices = indices[:, 0]
    grid_indices = indices[:, 1:3]
    if image_hw is None:
        image_hw = (params.darknet_input, params.darknet_input)
    else:
        image_hw = np.asarray(image_hw)[image_indices]
    xy = cwh_to_xy_vec(denorm_boxes_cwh_vec(image_hw, n_grid, cwh,
                                            grid_indices))
    if C != 0:
        onehot = y[:, :, :, 5 * B:][indices[:, 0], indices[:, 1],
                                    indices[:, 2]]
        classes = np.argmax(onehot, axis=1)
    else:
        classes = None
    return image_indices, xy, classes


def combine_y_hat(images, dark_y_hat, class_y_hat, image_indices, boxes_xy,
                  params):
    """The two-stage grid: the detector's channels (batch, g, g, D), then
    in each detected box's cell the classifier's n_classes scores.

    Box i (corners in frame ``images[image_indices[i]]``) is moved to
    the darknet_input frame and its centre's cell takes row i of
    ``class_y_hat``; a later box in the same cell overwrites an earlier
    one, and a centre on the right or bottom edge falls in the last
    cell.  Returns float64 (batch, g, g, D + n_classes)."""
    dark_y_hat = np.asarray(dark_y_hat)
    batch_size, n_grid, _, depth = dark_y_hat.shape
    n_classes = class_y_hat.shape[1]

    y_hat = np.zeros((batch_size, n_grid, n_grid, depth + n_classes))
    y_hat[:, :, :, 0:depth] = dark_y_hat

    resized_hw = (params.darknet_input, params.darknet_input)
    for i, index in enumerate(image_indices):
        orig_hw = images[index].shape[0:2]
        resized_box_xy = resize_box_xy(orig_hw, resized_hw, boxes_xy[i])
        box_cwh = xy_to_cwh(resized_box_xy)
        _, (row, col) = normalize_box_cwh(resized_hw, params.n_grid, box_cwh)
        row = min(row, n_grid - 1)
        col = min(col, n_grid - 1)
        y_hat[index, row, col, depth:] = class_y_hat[i, :]
    return y_hat


# ---------------------------------------------------------------------------
# Device tier (torch, fixed shapes): the loss-side box helpers


def cwh_to_xy_grid(cwh, img_size, n_grid):
    """Grid-frame center boxes (..., 4) -> corner boxes (..., 4).

    The loss-side conversion: xc, yc scaled by the grid cell's size and
    w, h by the image's, WITHOUT the cell's row/col offset.  A cell's
    prediction and target share this frame, so their IoU is unchanged.
    """
    grid_size = 1.0 * img_size / n_grid
    xc = cwh[..., 0] * grid_size
    yc = cwh[..., 1] * grid_size
    half_w = cwh[..., 2] * img_size / 2
    half_h = cwh[..., 3] * img_size / 2
    return torch.stack([xc - half_w, yc - half_h, xc + half_w, yc + half_h],
                       dim=-1)


def iou_xy(boxes_a, boxes_b):
    """IoU between corner boxes, broadcast over the leading dims:
    (..., A, 4) x (..., B, 4) -> (..., A, B).  0/0 (two empty boxes)
    gives NaN, as the JAX function does."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter)
