"""PyTorch port: grid decode, host box tier and detection metrics held
against the JAX package on the same grids (CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu.metrics import (
    detection as jax_det)
from cs231_capsule_yolo_traffic_sign_detection_tpu.ops import (
    boxes as jax_boxes, decode as jax_decode)
from cs231_capsule_yolo_traffic_sign_detection_tpu.params import (
    Params as JaxParams)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.metrics import (
    detection as det)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import (
    boxes, decode)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params


def _grid(rng, batch, g, nb, nc):
    y = rng.uniform(0, 1, (batch, g, g, 5 * nb + nc)).astype(np.float32)
    if nc:
        y[..., 5 * nb:] /= y[..., 5 * nb:].sum(-1, keepdims=True)
    return y


def _both(y, nb, nc, size, conf_th=0.5, image_hw=None):
    kw = dict(n_classes=nc, n_boxes=nb, img_size=size, conf_th=conf_th)
    want = jax_decode.to_flat_host(
        jax_decode.decode_grid(jnp.asarray(y), **kw), image_hw=image_hw,
        img_size=size, with_classes=nc != 0)
    got = decode.to_flat_host(
        decode.decode_grid(torch.from_numpy(y), **kw), image_hw=image_hw,
        img_size=size, with_classes=nc != 0)
    return got, want


def _assert_flat_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])      # image indices
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    if want[2] is None:
        assert got[2] is None
    else:
        np.testing.assert_array_equal(got[2], want[2])  # classes, order


@pytest.mark.parametrize("nb,nc", [(1, 43), (2, 0), (2, 5)])
def test_decode_matches_jax(nb, nc):
    rng = np.random.RandomState(0)
    y = _grid(rng, 3, 4, nb, nc)
    y[1, ..., 0:5 * nb:5] = 0.1  # image 1: zero detections
    got, want = _both(y, nb, nc, 64, image_hw=np.array(
        [[100, 80], [64, 64], [48, 96]]))
    _assert_flat_equal(got, want)
    assert not np.any(got[0] == 1)


def test_decode_tied_confidences_order_is_grid_scan():
    """Tied confidences: whatever order topk returns the ties in, the
    flat lists come out in (row, col, box) order."""
    rng = np.random.RandomState(1)
    y = _grid(rng, 2, 4, 2, 3)
    y[..., 0:10:5] = 0.75  # every candidate ties
    y[0, 1, 2, 0] = 0.2   # one below the threshold
    got, want = _both(y, 2, 3, 64)
    _assert_flat_equal(got, want)
    ref = boxes.y_to_boxes_vec(y, Params(n_classes=3, darknet_input=64))
    _assert_flat_equal(got, ref)

    # reverse the slots of the tied candidates: the flat result is the same
    dec = decode.decode_grid(torch.from_numpy(y), n_classes=3, n_boxes=2,
                             img_size=64)
    perm = {k: torch.flip(v, dims=[1]) for k, v in dec.items()}
    _assert_flat_equal(decode.to_flat_host(perm), got)


def test_to_flat_host_with_extras_follows_box_order():
    rng = np.random.RandomState(2)
    y = _grid(rng, 2, 3, 1, 4)
    dec = decode.decode_grid(torch.from_numpy(y), n_classes=4, n_boxes=1,
                             img_size=96, conf_th=0.3)
    (idx, xy, cls), extras = decode.to_flat_host_with_extras(
        dec, {"slot": dec["idx"]})
    jdec = jax_decode.decode_grid(jnp.asarray(y), n_classes=4, n_boxes=1,
                                  img_size=96, conf_th=0.3)
    (jidx, jxy, jcls), jextras = jax_decode.to_flat_host_with_extras(
        jdec, {"slot": jdec["idx"]})
    _assert_flat_equal((idx, xy, cls), (jidx, jxy, jcls))
    np.testing.assert_array_equal(extras["slot"], jextras["slot"])


def test_host_boxes_match_jax():
    rng = np.random.RandomState(3)
    for _ in range(20):
        x1, y1 = rng.uniform(0, 300, 2)
        box = [x1, y1, x1 + rng.uniform(1, 100), y1 + rng.uniform(1, 100)]
        assert boxes.xy_to_cwh(box) == jax_boxes.xy_to_cwh(box)
        cwh = boxes.xy_to_cwh(box)
        assert (boxes.normalize_box_cwh((448, 448), 14, cwh)
                == jax_boxes.normalize_box_cwh((448, 448), 14, cwh))
    y = _grid(rng, 3, 4, 1, 6)
    hw = np.array([[120, 90], [64, 64], [30, 50]])
    for image_hw in (None, hw):
        got = boxes.y_to_boxes_vec(y, Params(n_classes=6, darknet_input=64),
                                   image_hw=image_hw)
        want = jax_boxes.y_to_boxes_vec(
            y, JaxParams(n_classes=6, darknet_input=64), image_hw=image_hw)
        _assert_flat_equal(got, want)


@pytest.mark.parametrize("nc", [43, 0])
def test_detection_metrics_match_jax(nc):
    rng = np.random.RandomState(4)
    y_true = np.zeros((6, 4, 4, 5 + nc), np.float32)
    for i in range(6):
        r, c = rng.randint(0, 4, 2)
        y_true[i, r, c, :5] = [1, *rng.uniform(0.2, 0.8, 4)]
        if nc:
            y_true[i, r, c, 5 + i % nc] = 1
    y_hat = np.clip(y_true + rng.normal(0, 0.1, y_true.shape), 0, 1).astype(
        np.float32)
    p = dict(n_classes=nc, darknet_input=64, model="darknet_r")
    jp, tp = JaxParams(**p), Params(**p)
    # the JAX side's numpy path (its native kernel is a separate build)
    want_sweep = jax_det.confusion_sweep(
        jax_det.decode_with_conf(y_true, jp),
        jax_det.decode_with_conf(y_hat, jp), jax_det.IOU_THS,
        jax_det.CONF_THS, use_native=False)
    got_sweep = det.confusion_sweep(det.decode_with_conf(y_true, tp),
                                    det.decode_with_conf(y_hat, tp),
                                    det.IOU_THS, det.CONF_THS)
    for g, w in zip(got_sweep, want_sweep):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(det.detect_AP(y_true, y_hat, tp),
                               jax_det.detect_AP(y_true, y_hat, jp),
                               rtol=1e-12)
    np.testing.assert_allclose(det.detect_acc(y_true, y_hat, tp),
                               jax_det.detect_acc(y_true, y_hat, jp),
                               rtol=1e-12)
