"""PyTorch port, the rest of darknet_r predict (CPU) at 64 px, n_grid 2:
PPM frames without cv2, the greedy NMS, box drawing, the PNG writer, the
scalar IoU and per-image confusion, the native confusion sweep, the
metric plots and the CLI's artifacts, each against the JAX package (and
cv2, which only this machine has) on the same numpy inputs."""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu import viz as jax_viz
from cs231_capsule_yolo_traffic_sign_detection_tpu.metrics import (
    detection as jax_det)
from cs231_capsule_yolo_traffic_sign_detection_tpu.ops import (
    decode as jax_decode)
from cs231_capsule_yolo_traffic_sign_detection_tpu.params import (
    Params as JaxParams)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import (
    __main__ as cli, imageio, predict, viz)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import loader
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data.ppm import (
    read_ppm)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.interop import (
    jax_variables_to_state_dict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.metrics import (
    classification as cls_metrics, detection as det)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import decode
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    checkpoint as ckpt)

from torch_port_helpers import jax_darknet

cv2 = pytest.importorskip("cv2")

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cs231_capsule_yolo_traffic_sign_detection_tpu_torch"
PARAMS = dict(model="darknet_r", n_classes=43, n_boxes=1, n_grid=2,
              darknet_input=64, capsule_input=32, batch_size=4)


def write_ppm(path, bgr, comment=None):
    """A P6 file of a BGR frame (the file holds RGB)."""
    h, w = bgr.shape[:2]
    head = b"P6\n" + (b"# " + comment + b"\n" if comment else b"")
    with open(path, "wb") as f:
        f.write(head + b"%d %d\n255\n" % (w, h)
                + np.ascontiguousarray(bgr[..., ::-1]).tobytes())


@pytest.mark.parametrize("comment", [None, b"written by the test"])
def test_read_ppm_matches_cv2(tmp_path, comment):
    rng = np.random.RandomState(0)
    frame = (rng.rand(13, 17, 3) * 256).astype(np.uint8)
    path = str(tmp_path / "f.ppm")
    write_ppm(path, frame, comment)
    got = read_ppm(path)
    want = cv2.imread(path)
    assert got.dtype == np.uint8 and got.shape == (13, 17, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, frame)
    # anything but P6 raises, with no fallback
    with open(tmp_path / "a.ppm", "wb") as f:
        f.write(b"P3\n1 1\n255\n0 0 0\n")
    with pytest.raises(ValueError, match="P6"):
        read_ppm(str(tmp_path / "a.ppm"))


def test_nms_mask_matches_jax():
    """Overlapping boxes with tied confidences (quantised to 0.1) and the
    zero slots a decode wider than the grid pads with (max_boxes 60 of 50
    candidates): the port's decode keeps JAX top_k's tie order, and its
    NMS keeps exactly JAX's set."""
    rng = np.random.RandomState(1)
    y = rng.rand(3, 5, 5, 2 * 5 + 3).astype(np.float32)
    y[..., [0, 5]] = np.round(y[..., [0, 5]], 1)
    y[..., [3, 4, 8, 9]] = 0.3 + 0.4 * y[..., [3, 4, 8, 9]]   # wide boxes
    kw = dict(n_classes=3, n_boxes=2, img_size=160, max_boxes=60,
              conf_th=0.3)
    want = jax_decode.decode_grid(jnp.asarray(y), **kw)
    got = decode.decode_grid(torch.from_numpy(y), **kw)
    np.testing.assert_array_equal(got["idx"].numpy(),
                                  np.asarray(want["idx"]))
    keep_want = np.asarray(jax_decode.nms_mask(want["xy"], want["conf"],
                                               want["valid"]))
    keep = decode.nms_mask(got["xy"], got["conf"], got["valid"]).numpy()
    np.testing.assert_array_equal(keep, keep_want)
    # it suppresses some valid boxes and keeps the best of each frame
    valid = got["valid"].numpy()
    assert (keep <= valid).all() and keep.sum() < valid.sum()
    assert keep[:, 0].all()


def test_draw_boxes_vec_matches_jax():
    """Rectangles and crops, classes=None, pixel for pixel: boxes inside,
    fractional, past every edge, inverted and empty."""
    rng = np.random.RandomState(2)
    images = [(rng.rand(40, 50, 3) * 255).astype(np.uint8),
              (rng.rand(64, 30, 3) * 255).astype(np.uint8)]
    xy = np.concatenate([rng.uniform(-20, 70, (12, 4)),
                         [[5.5, 6.2, 5.9, 30.0], [45.0, 30.0, 10.0, 5.0]]])
    idx = np.r_[np.zeros(7, np.int64), np.ones(7, np.int64)]
    for color in ((0, 255, 0), (0, 0, 255)):
        want, want_crops = jax_viz.draw_boxes_vec(images, idx, xy,
                                                  color=color)
        got, got_crops = viz.draw_boxes_vec(images, idx, xy, color=color)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for gs, ws in zip(got_crops, want_crops):
            assert len(gs) == len(ws)
            for g, w in zip(gs, ws):
                np.testing.assert_array_equal(g, w)
    # with classes: the label is drawn in the box's colour at its centre
    box = np.array([[2.0, 2.0, 40.0, 30.0]])
    labelled, _ = viz.draw_boxes_vec(images, idx[:1], box, np.array([7]))
    plain, _ = viz.draw_boxes_vec(images, idx[:1], box)
    diff = np.nonzero((labelled[0] != plain[0]).any(-1))
    assert diff[0].size > 0
    assert (labelled[0][diff] == (0, 255, 0)).all()
    assert 16 - 6 <= diff[0].min() and diff[0].max() <= 16
    assert 21 <= diff[1].min()


def test_png_round_trips(tmp_path):
    rng = np.random.RandomState(3)
    frame = (rng.rand(31, 47, 3) * 256).astype(np.uint8)
    path = str(tmp_path / "f.png")
    imageio.write_png(path, frame)
    np.testing.assert_array_equal(cv2.imread(path), frame)   # BGR, lossless


def test_scalar_iou_and_confusion_match_jax():
    rng = np.random.RandomState(4)
    for _ in range(50):
        a, b = (np.sort(rng.uniform(0, 10, (2, 2)), axis=0).T.ravel()[
            [0, 2, 1, 3]] for _ in range(2))
        assert det.calc_iou_individual(a, b) == \
            jax_det.calc_iou_individual(a, b)
    with pytest.raises(AssertionError):
        det.calc_iou_individual([0, 0, 1, 1], [2, 0, 1, 1])
    gt = rng.uniform(0, 30, (5, 2))
    gt = np.concatenate([gt, gt + rng.uniform(1, 10, (5, 2))], 1)
    pr = gt + rng.uniform(-3, 3, gt.shape)
    for th in (0.1, 0.5, 0.9):
        assert det.single_img_confusion(gt, pr, th) == \
            jax_det.single_img_confusion(gt, pr, th)
    assert det.single_img_confusion(gt[:0], pr, 0.5) == \
        jax_det.single_img_confusion(gt[:0], pr, 0.5)


@pytest.mark.parametrize("cls_filter", [None, 3])
def test_native_sweep_matches_numpy_and_jax(cls_filter):
    rng = np.random.RandomState(5)
    p, jp = Params(**PARAMS), JaxParams(**PARAMS)
    y = rng.rand(6, 2, 2, 48).astype(np.float32)
    y_hat = np.clip(y + rng.normal(0, 0.05, y.shape), 0, 1).astype(
        np.float32)
    y[..., 5:] = rng.randint(0, 5, (6, 2, 2))[..., None] == np.arange(43)
    y_hat[..., 5:] = y[..., 5:]
    gt, pred = det.decode_with_conf(y, p), det.decode_with_conf(y_hat, p)
    args = (det.IOU_THS, det.CONF_THS, cls_filter)
    native = det.confusion_sweep(gt, pred, *args)
    plain = det.confusion_sweep(gt, pred, *args, use_native=False)
    jgt, jpred = jax_det.decode_with_conf(y, jp), jax_det.decode_with_conf(
        y_hat, jp)
    for want in (jax_det.confusion_sweep(jgt, jpred, *args,
                                         use_native=False),
                 jax_det.confusion_sweep(jgt, jpred, *args)):
        for g, q, w in zip(native, plain, want):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(q, w)
    assert native[0].sum() > 0


def _png_size(path):
    img = cv2.imread(path)
    assert img is not None, path
    return img.shape


def test_metric_plots(tmp_path):
    """save=True writes the JAX package's file names at matplotlib's
    default 1000 x 800 px and leaves the numbers as JAX's."""
    rng = np.random.RandomState(6)
    p, jp = Params(**PARAMS), JaxParams(**PARAMS)
    y = rng.rand(4, 2, 2, 48).astype(np.float32)
    y[..., 5:] = rng.randint(0, 3, (4, 2, 2))[..., None] == np.arange(43)
    y_hat = np.clip(y + rng.normal(0, 0.1, y.shape), 0, 1).astype(np.float32)
    ap = det.detect_AP(y, y_hat, p, save=True, save_dir=str(tmp_path))
    assert ap == jax_det.detect_AP(y, y_hat, jp)
    assert _png_size(str(tmp_path / "d_AP.png")) == (800, 1000, 3)
    m_ap = det.detect_and_recog_mAP(y, y_hat, p, save=True,
                                    save_dir=str(tmp_path))
    assert m_ap == jax_det.detect_and_recog_mAP(y, y_hat, jp)
    for c in (0, 42):
        assert _png_size(str(tmp_path / f"d&r_mAP_class_{c}.png")) == (
            800, 1000, 3)
    labels, scores = rng.randint(0, 43, 40), rng.rand(40, 43)
    assert cls_metrics.recog_pr(labels, scores, p, save=True,
                                save_dir=str(tmp_path)) == \
        cls_metrics.recog_pr(labels, scores, p)
    assert cls_metrics.recog_auc(labels, scores, p, save=True,
                                 save_dir=str(tmp_path)) == \
        cls_metrics.recog_auc(labels, scores, p)
    for name in ("r_pr.png", "r_auc.png"):
        img = cv2.imread(str(tmp_path / name))
        assert img.shape == (800, 1000, 3)
        assert ((img != 255).any(-1) & (img != 0).any(-1)).sum() > 500


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A GTSDB-style data dir (test.p, test_names.npy, raw_GTSDB/*.ppm at
    80 x 96, so the frames are resized and the boxes rescaled) and a
    darknet_r checkpoint, under one root."""
    root = tmp_path_factory.mktemp("gtsdb")
    p = Params(**PARAMS)
    _, _, x, y = loader.synthetic_dataset("darknet_r", p, 0, 6)
    frames = [cv2.resize(np.clip(im * 128.0 + 128, 0, 255).astype(np.uint8),
                         (96, 80)) for im in x]
    raw = root / "data" / "GTSDB" / "raw_GTSDB"
    raw.mkdir(parents=True)
    names = [f"{i:05d}.ppm" for i in range(len(frames))]
    for name, f in zip(names, frames):
        write_ppm(str(raw / name), f)
    np.save(root / "data" / "GTSDB" / "test_names.npy", np.array(names))
    with open(root / "data" / "GTSDB" / "test.p", "wb") as f:
        pickle.dump((x, y), f)
    model_dir = root / "experiments" / "darknet_r"
    model_dir.mkdir(parents=True)
    p.save(str(model_dir / "params.json"))
    _, variables = jax_darknet(1, 43)
    ckpt.save_checkpoint(
        {"epoch": 1, "optim_dict": {},
         "state_dict": jax_variables_to_state_dict(variables, "darknet_r")},
        is_best=False, checkpoint_dir=str(model_dir))
    return root, frames, y


def test_dark_pred_nms_and_frames(served):
    """dark_pred(y=, use_nms=True): the kept boxes are JAX's NMS over the
    same decode, and the annotated frames are the frames with those boxes
    (green) and the ground truth (red) drawn."""
    root, frames, y = served
    p = Params(**PARAMS)
    d = str(root / "experiments" / "darknet_r")
    y_hat, boxes = predict.dark_detect(frames, d, p, "last", device="cpu",
                                       conf_th=0.3, use_nms=True)
    want = jax_decode.decode_grid(jnp.asarray(y_hat), n_classes=43,
                                  n_boxes=1, img_size=64, conf_th=0.3)
    want["valid"] = jax_decode.nms_mask(want["xy"], want["conf"],
                                        want["valid"])
    hw = np.array([f.shape[:2] for f in frames])
    w_idx, w_xy, w_cls = jax_decode.to_flat_host(want, image_hw=hw,
                                                 img_size=64)
    np.testing.assert_array_equal(boxes[0], w_idx)
    np.testing.assert_array_equal(boxes[2], w_cls)
    np.testing.assert_allclose(boxes[1], w_xy, rtol=0, atol=1e-4)
    y_hat2, out = predict.dark_pred(frames, d, p, "last", conf_th=0.3, y=y,
                                    use_nms=True, device="cpu")
    np.testing.assert_array_equal(y_hat2, y_hat)
    drawn, _ = viz.draw_boxes_vec(frames, *boxes)
    t_idx, t_xy, t_cls = jax_decode.to_flat_host(
        jax_decode.decode_grid(jnp.asarray(y), n_classes=43, n_boxes=1,
                               img_size=64), image_hw=hw, img_size=64)
    drawn, _ = viz.draw_boxes_vec(drawn, t_idx, t_xy, t_cls,
                                  color=(0, 0, 255))
    assert len(out) == len(frames) and len(t_idx) > 0
    for o, w in zip(out, drawn):
        np.testing.assert_array_equal(o, w)


def test_cli_predict_nms_int8_without_cv2(served):
    """--mode predict --nms --dtype int8 from a GTSDB-style data dir, in a
    process where ``import cv2`` fails: metric_output.txt,
    detect_ap/d_AP.png and one output/<i>.png a frame, the frames as the
    .ppm files hold them."""
    root, frames, _ = served
    code = ("import sys; sys.modules['cv2'] = None\n"
            f"from {PORT.name} import __main__ as cli\n"
            "cli.main(sys.argv[1:])\n")
    res = subprocess.run(
        [sys.executable, "-c", code, "--model", "darknet_r", "--mode",
         "predict", "--restore", "last", "--nms", "--dtype", "int8",
         "--device", "cpu"], cwd=str(root), capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    model_dir = root / "experiments" / "darknet_r"
    text = (model_dir / "metric_output.txt").read_text()
    assert text.startswith("detect_AP:") and "detect_acc:" in text
    assert _png_size(str(model_dir / "detect_ap" / "d_AP.png")) == (
        800, 1000, 3)
    outs = sorted((model_dir / "output").iterdir())
    assert [o.name for o in outs] == [f"{i}.png" for i in range(len(frames))]
    x, _ = cli.load_test_frames(str(root / "data" / "GTSDB"), "darknet_r",
                                Params(**PARAMS))
    for got, want, o in zip(x, frames, outs):
        np.testing.assert_array_equal(got, want)
        img = cv2.imread(str(o))
        assert img.shape == want.shape and (img != want).any()
