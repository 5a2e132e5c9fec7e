"""PyTorch port, the two-stage detect-then-classify slice (CPU) at 64 px,
n_grid 2: the crop sampler, the host path's crops (against cv2), the
capped grid decode, `combine_y_hat`, `detect_and_recog_mAP`, the host
composition `dark_class_pred` and the fused `--device_crop` path with
the capsule and the cnn classifier, each against the JAX package on the
same numpy inputs and weights, and the CLI's --combine."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu.metrics import (
    detection as jax_det)
from cs231_capsule_yolo_traffic_sign_detection_tpu.ops import (
    boxes as jax_boxes, crop as jax_crop, decode as jax_decode)
from cs231_capsule_yolo_traffic_sign_detection_tpu.params import (
    Params as JaxParams)
from cs231_capsule_yolo_traffic_sign_detection_tpu import (
    predict as jax_predict)
from cs231_capsule_yolo_traffic_sign_detection_tpu.train import (
    checkpoint as jax_ckpt)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import (
    __main__ as cli, predict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import loader
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.interop import (
    jax_variables_to_state_dict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.metrics import (
    detection as det)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import (
    boxes, crop, decode)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    checkpoint as ckpt)

from torch_port_helpers import (jax_capsulenet, jax_convnet, jax_darknet,
                                torch_darknet)

cv2 = pytest.importorskip("cv2")

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cs231_capsule_yolo_traffic_sign_detection_tpu_torch"
# darknet_r's config cut to 64 px / n_grid 2; the classifiers' at batch 8
DARK = dict(model="darknet_r", n_classes=43, n_boxes=1, n_grid=2,
            darknet_input=64, capsule_input=32, batch_size=4,
            device_preprocess=True)
CLASS = {"capsule": dict(model="capsule", n_classes=43, batch_size=8),
         "cnn": dict(model="cnn", n_classes=43, batch_size=8, dropout=0.0)}
N_FRAMES = 8


# ---------------------------------------------------------------- crops

# the boxes of tests/test_crop.py: interior, fractional corners, the full
# frame, corner-hugging, past each edge (clipped), one source pixel,
# degenerate (zero width, zero height, outside) and masked
CROP_BOXES = np.array([
    [10.0, 20.0, 74.0, 90.0], [10.7, 20.2, 74.9, 90.6], [0.0, 0.0, 96.0, 96.0],
    [60.0, 60.0, 96.0, 96.0], [88.0, 88.0, 140.0, 140.0],
    [-20.0, -10.0, 40.0, 50.0], [5.0, 5.0, 6.0, 6.0],
    [10.0, 10.0, 10.0, 30.0], [10.0, 10.0, 30.0, 10.0],
    [100.0, 100.0, 120.0, 120.0], [-30.0, -30.0, -5.0, -5.0],
    [5.0, 5.0, 20.0, 20.0]], np.float32)


@pytest.mark.parametrize("out", [32, 7])
def test_crop_resize_bilinear_matches_jax(out):
    rng = np.random.RandomState(0)
    imgs = (rng.rand(2, 96, 96, 3) * 255).astype(np.float32)
    bx = np.stack([CROP_BOXES, CROP_BOXES[::-1] * 0.9])
    valid = np.ones(bx.shape[:2], bool)
    valid[:, -1] = False
    want = np.asarray(jax_crop.crop_resize_bilinear(
        jnp.asarray(imgs), jnp.asarray(bx), out, valid=jnp.asarray(valid)))
    got = crop.crop_resize_bilinear(torch.from_numpy(imgs),
                                    torch.from_numpy(bx), out,
                                    valid=torch.from_numpy(valid)).numpy()
    assert got.shape == (2, len(CROP_BOXES), out, out, 3)
    # XLA contracts the sample positions' and the mix's multiply-adds
    # into fused ones, the port rounds each step: a fraction off by an
    # ulp of its position moves a value by that ulp times the step
    # between its neighbours (measured: 3.5e-4 of values up to 255 at
    # out 7, 3e-5 at out 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got[0, 7:], 0.0)   # degenerate, masked
    assert (got[0, :7].reshape(7, -1).max(1) > 0).all()


def _cv2_crop(frame, box, out):
    """The JAX host path's crop (viz.draw_boxes + cv2.resize)."""
    h, w = frame.shape[:2]
    x1, y1, x2, y2 = box
    c = frame[max(int(y1), 0):max(min(int(y2), h), 0),
              max(int(x1), 0):max(min(int(x2), w), 0)]
    if c.size == 0:
        return np.zeros((out, out, 3), np.uint8)
    return cv2.resize(c, (out, out))


def test_frame_crops_within_one_level_of_cv2():
    """The host path's uint8 crops against cv2.resize on the same slices:
    one level at most (cv2 weighs in 11-bit fixed point), the share that
    differs printed (pytest -s)."""
    rng = np.random.RandomState(1)
    frames = [(rng.rand(96, 96, 3) * 255).astype(np.uint8),
              (rng.rand(80, 120, 3) * 255).astype(np.uint8)]
    idx = np.array([0] * 7 + [1] * 5)
    bx = CROP_BOXES.astype(np.float64) * np.where(idx == 0, 1.0, 1.2)[:, None]
    got = crop.frame_crops(frames, idx, bx, 32, "cpu")
    want = np.stack([_cv2_crop(frames[i], b, 32) for i, b in zip(idx, bx)])
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()
    print(f"\n[frame_crops] vs cv2.resize: max {diff.max()} level, "
          f"{(diff > 0).mean():.4f} of values differ")
    empty = crop.frame_crops(frames, np.zeros(0, np.int64),
                             np.zeros((0, 4)), 32, "cpu")
    assert empty.shape == (0, 32, 32, 3)


@pytest.mark.parametrize("max_boxes", [None, 3, 12])
def test_decode_grid_max_boxes_matches_jax(max_boxes):
    y = np.random.RandomState(2).rand(3, 2, 2, 2 * 5 + 43).astype(np.float32)
    kw = dict(n_classes=43, n_boxes=2, img_size=64, max_boxes=max_boxes)
    want = jax_decode.decode_grid(jnp.asarray(y), **kw)
    got = decode.decode_grid(torch.from_numpy(y), **kw)
    for k in ("conf", "classes", "valid", "idx"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["xy"].numpy(), np.asarray(want["xy"]),
                               rtol=1e-6, atol=1e-5)
    assert got["conf"].shape == (3, max_boxes or 8)


# ------------------------------------------------------ combine, metric

def test_combine_y_hat_matches_jax_exactly():
    """Frames of three sizes; boxes with a centre on the right and bottom
    edges (the last cell), and two boxes in one cell (the later wins)."""
    rng = np.random.RandomState(3)
    images = [np.zeros((64, 64, 3), np.uint8), np.zeros((80, 120, 3),
                                                        np.uint8),
              np.zeros((40, 50, 3), np.uint8)]
    dark = rng.rand(3, 2, 2, 48).astype(np.float32)
    idx = np.array([0, 0, 1, 1, 1, 2])
    bx = np.array([[10, 10, 20, 20], [12, 8, 22, 18],     # one cell, twice
                   [0, 0, 120, 80],                       # cell (1, 1)
                   [100, 60, 140, 100],                   # centre on both
                   [10, 70, 30, 90],                      # centre y = 80
                   [5, 5, 45, 35]], np.float64)
    scores = rng.rand(6, 43)
    p, jp = Params(**DARK), JaxParams(**DARK)
    got = boxes.combine_y_hat(images, dark, scores, idx, bx, p)
    want = jax_boxes.combine_y_hat(images, dark, scores, idx, bx, jp)
    assert got.dtype == np.float64 and got.shape == (3, 2, 2, 91)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0, 0, 48:], scores[1])  # last wins
    np.testing.assert_array_equal(got[1, 1, 1, 48:], scores[3])  # the edges
    np.testing.assert_array_equal(got[1, 1, 0, 48:], scores[4])
    assert boxes.cwh_to_xy([5, 6, 2, 4]) == jax_boxes.cwh_to_xy([5, 6, 2, 4])
    assert boxes.resize_box_xy((80, 120), (64, 64), [1, 2, 3, 4]) == \
        jax_boxes.resize_box_xy((80, 120), (64, 64), [1, 2, 3, 4])


@pytest.mark.parametrize("seed", [0, 1])
def test_detect_and_recog_map_matches_jax(seed):
    p = Params(**dict(DARK, n_classes=5))
    _, _, _, y = loader.synthetic_dataset("darknet_r", Params(**DARK), 0, 12)
    rng = np.random.RandomState(seed)
    y_hat = y + 0.02 * rng.randn(*y.shape)
    y_hat[..., 0] = np.clip(y[..., 0] * 0.6 + 0.5 * rng.rand(*y.shape[:3]),
                            0, 1)
    y_hat[..., 5:] = y[..., 5:] + rng.rand(*y.shape[:3], 43)
    jp = JaxParams(**dict(DARK, n_classes=5))
    want = jax_det.detect_and_recog_mAP(y, y_hat, jp)
    got = det.detect_and_recog_mAP(y, y_hat, p)
    assert p.n_classes == jp.n_classes == 43   # the reference's mutation
    assert 0 < got < 1
    np.testing.assert_allclose(got, want, rtol=1e-12)


# ------------------------------------------------------------- pipeline

def _frames(n=N_FRAMES, seed=0):
    """Noise frames of varied brightness and contrast at 64 px."""
    rng = np.random.RandomState(seed)
    lo = rng.uniform(0, 200, (n, 1, 1, 1))
    span = rng.uniform(20, 255, (n, 1, 1, 1))
    return list(np.clip(lo + span * rng.rand(n, 64, 64, 3), 0, 255).astype(
        np.uint8))


def _detector(frames, seed=2, head_scale=4.0):
    """JAX darknet_r variables whose BN statistics are those of
    ``frames`` (so the outputs depend on the frame, not only on the
    cell) and whose head is scaled so the confidences spread over
    (0.05, 0.9)."""
    _, variables = jax_darknet(1, 43, seed=seed)
    model = torch_darknet(variables, 1, 43)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None   # one batch: its statistics
    with torch.no_grad():
        model.train()(torch.from_numpy(np.stack(frames)).float())
    for i in range(1, 19):
        bn = getattr(model.model, f"bn_{i}")
        st = variables["batch_stats"][f"block_{i}"][f"bn_{i}"]
        st["mean"] = bn.running_mean.numpy().copy()
        st["var"] = bn.running_var.numpy().copy()
    head = variables["params"]["conv_19"]
    head["kernel"] = head["kernel"] * head_scale
    return variables


def _write(root, name, variables):
    """The same weights as a JAX checkpoint under root/jax/<name> and a
    port checkpoint under root/port/<name>; returns both dirs."""
    jdir, pdir = (os.path.join(root, k, name) for k in ("jax", "port"))
    state = {"params": variables["params"]}
    if "batch_stats" in variables:
        state["batch_stats"] = variables["batch_stats"]
    jax_ckpt.save_checkpoint({"epoch": 1, "state": state, "plateau": {}},
                             is_best=False, checkpoint_dir=jdir)
    ckpt.save_checkpoint(
        {"epoch": 1, "optim_dict": {},
         "state_dict": jax_variables_to_state_dict(variables, name)},
        is_best=False, checkpoint_dir=pdir)
    return jdir, pdir


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("two_stage"))
    frames = _frames()
    dark = _write(root, "darknet_r", _detector(frames))
    classifiers = {"capsule": _write(root, "capsule", jax_capsulenet(43)[1]),
                   "cnn": _write(root, "cnn", jax_convnet(seed=4)[1])}
    return frames, dark, classifiers


def _check_clear_of_ties(y_hat):
    """The comparison is well defined: no confidence within 1e-3 of the
    threshold and no box corner within 4e-3 px of an integer, where the
    crop window's int() would flip (the detectors differ by up to 5e-5 of
    the 64 px frame)."""
    conf = y_hat[..., 0]
    assert np.abs(conf - 0.5).min() > 1e-3
    assert 0 < (conf > 0.5).sum() < conf.size
    d = jax_decode.decode_grid(jnp.asarray(y_hat), n_classes=43, n_boxes=1,
                               img_size=64)
    xy = np.asarray(d["xy"])[np.asarray(d["valid"])]
    frac = np.abs(xy - np.round(xy))
    assert frac[(xy > 0) & (xy < 64)].min() > 4e-3


# classifier channels, host path: the port's crops lie within one uint8
# level of cv2's (6% of the values differ), 1/128 apart once centered,
# so the classifiers see slightly other inputs (measured here: 2.0e-3
# at capsule scores up to 0.3, 4.5e-4 at cnn logits up to 0.2); fused
# path: both sample the same f32 input (measured 2.2e-7)
CLASS_BANDS = {(False, "capsule"): 5e-3, (False, "cnn"): 2e-3,
               (True, "capsule"): 5e-5, (True, "cnn"): 5e-5}


@pytest.mark.parametrize("device_crop", [False, True],
                         ids=["host", "device_crop"])
@pytest.mark.parametrize("classifier", ["capsule", "cnn"])
def test_dark_class_pred_matches_jax(pipeline, classifier, device_crop):
    frames, (jdark, pdark), classifiers = pipeline
    jcls, pcls = classifiers[classifier]
    jdp, jcp = JaxParams(**DARK), JaxParams(**CLASS[classifier])
    # the fused path classifies the top 2 of each frame's 4 boxes
    max_crops = 2
    want, _ = jax_predict.dark_class_pred(
        frames, jdark, jdp, jcls, jcp, "last", device_crop=device_crop,
        max_crops=max_crops)
    _check_clear_of_ties(want[..., :48])
    got, (image_indices, boxes_xy, classes) = predict.dark_class_detect(
        frames, pdark, Params(**DARK), pcls, Params(**CLASS[classifier]),
        "last", device="cpu", device_crop=device_crop, max_crops=max_crops)
    assert got.dtype == np.float64 and got.shape == want.shape == (
        N_FRAMES, 2, 2, 91)
    np.testing.assert_allclose(got[..., :48], want[..., :48], rtol=0,
                               atol=5e-5)
    band = CLASS_BANDS[device_crop, classifier]
    np.testing.assert_allclose(got[..., 48:], want[..., 48:], rtol=0,
                               atol=band)
    print(f"\n[two-stage {classifier} {'fused' if device_crop else 'host'}]"
          f" class channels max_abs_err "
          f"{np.abs(got[..., 48:] - want[..., 48:]).max()}")
    n_cells = (want[..., 0] > 0.5).sum()
    kept = len(image_indices)
    if device_crop:
        assert kept == sum(min(max_crops, int((f > 0.5).sum()))
                           for f in want[..., 0])
        assert kept < n_cells   # the cap left some out
    else:
        assert kept == n_cells
    filled = (np.abs(got[..., 48:]).sum(-1) > 0).sum()
    assert 0 < filled <= kept and classes.shape == (kept,)
    assert boxes_xy.shape == (kept, 4)


def test_fused_bf16_tracks_f32(pipeline):
    """--dtype bfloat16 runs both stages in bf16: the detector channels
    near f32's (the mean in the bf16 serving band of
    tests/test_torch_port_slice.py; the largest error 4 times its band,
    as the head here is scaled x4: measured 0.17)."""
    frames, (_, pdark), classifiers = pipeline
    out = {}
    for dt in ("float32", "bfloat16"):
        out[dt], dets = predict.dark_class_detect(
            frames, pdark, Params(**DARK, compute_dtype=dt),
            classifiers["capsule"][1],
            Params(**CLASS["capsule"], compute_dtype=dt), "last",
            device="cpu", device_crop=True, max_crops=4)
        assert np.isfinite(out[dt]).all() and len(dets[0]) > 0
    err = np.abs(out["bfloat16"][..., :48] - out["float32"][..., :48])
    assert err.mean() < 0.01 and err.max() < 0.6


def test_zero_detections_launch_nothing(pipeline, tmp_path):
    """A detector whose confidences all fall under the threshold: no
    crop, no classifier call, the combined grid's class channels 0."""
    frames, _, classifiers = pipeline
    variables = _detector(frames, head_scale=0.0)   # confidences 0.5
    _, pdark = _write(str(tmp_path), "darknet_r", variables)
    for device_crop in (False, True):
        got, (idx, bx, classes) = predict.dark_class_detect(
            frames, pdark, Params(**DARK), classifiers["cnn"][1],
            Params(**CLASS["cnn"]), "last", device="cpu",
            device_crop=device_crop)
        assert len(idx) == 0 and bx.shape == (0, 4) and classes.shape == (0,)
        np.testing.assert_array_equal(got[..., 48:], 0.0)


# ------------------------------------------------------------------ CLI

@pytest.mark.parametrize("argv", [
    ["--combine", "capsule"],
    ["--combine", "cnn", "--device_crop", "--max_crops", "2"],
], ids=["capsule", "cnn_device_crop"])
def test_cli_combine_writes_metrics(pipeline, tmp_path, argv):
    """The CLI from a tmp dir: darknet_r's and the classifier's params and
    checkpoints under experiments/, the synthetic test set; the metric
    file holds what the same pipeline gives in-process."""
    _, (_, pdark), classifiers = pipeline
    name = argv[1]
    for model, src, params in (("darknet_r", pdark, DARK),
                               (name, classifiers[name][1], CLASS[name])):
        d = tmp_path / "experiments" / model
        d.mkdir(parents=True)
        Params(**params).save(str(d / "params.json"))
        (d / "last.ckpt").write_bytes(
            pathlib.Path(src, "last.ckpt").read_bytes())
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-m", PORT.name, "--model", "darknet_r", "--mode",
         "predict", "--restore", "last", "--device", "cpu"] + argv,
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    text = (tmp_path / "experiments" / "darknet_r"
            / f"combine-{name}_metric_output.txt").read_text()

    p = Params(**DARK)
    x, y = cli.load_test_frames(str(tmp_path / "data"), "darknet_r", p)
    y_hat, _ = predict.dark_class_pred(
        x, str(tmp_path / "experiments" / "darknet_r"), p,
        str(tmp_path / "experiments" / name), Params(**CLASS[name]), "last",
        device="cpu", device_crop="--device_crop" in argv,
        max_crops=int(argv[-1]) if "--max_crops" in argv else 16)
    assert text == "detect_and_recog_mAP:{}, detect_and_recog_acc:{}, ".format(
        det.detect_and_recog_mAP(y, y_hat, p),
        det.detect_and_recog_acc(y, y_hat, p))


@pytest.mark.parametrize("argv, message", [
    (["--model", "darknet_r", "--combine", "capsule", "--dtype", "fp8"],
     "unknown compute dtype"),
    (["--model", "darknet_d", "--combine", "cnn", "--dtype", "fp8"],
     "unknown compute dtype"),
    (["--model", "darknet_r", "--combine", "darknet_r"], "capsule | cnn"),
])
def test_cli_refuses_what_the_combine_path_lacks(argv, message):
    with pytest.raises(SystemExit, match=message):
        cli.main(argv + ["--mode", "predict", "--restore", "last"])
