"""PyTorch port, darknet_d (CPU) at 64 px / n_grid 2: the pure YOLO-v1
detector, B=2 and C=0.  `dark_loss` at B=2 with avg_iou in f64, the C=0
head and decode, `detect_acc` and `detect_AP` at C=0, `dark_pred`
through the plain K1/K2 versions, the Trainer with its avg_iou print,
the --combine quirk (nan / 0.0), each against the JAX package on the
same numpy inputs and weights; the CLI's train/predict round trip."""

import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu import losses as jax_losses
from cs231_capsule_yolo_traffic_sign_detection_tpu import (
    predict as jax_predict)
from cs231_capsule_yolo_traffic_sign_detection_tpu.metrics import (
    detection as jax_det)
from cs231_capsule_yolo_traffic_sign_detection_tpu.ops import (
    decode as jax_decode)
from cs231_capsule_yolo_traffic_sign_detection_tpu.params import (
    Params as JaxParams)
from cs231_capsule_yolo_traffic_sign_detection_tpu.train import (
    checkpoint as jax_ckpt, driver as jax_driver, steps as jax_steps)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import (
    __main__ as cli, losses, predict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import loader
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.interop import (
    jax_variables_to_state_dict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.metrics import (
    detection as det)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
    CapsuleNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models.darknet import (
    head)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import decode
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    checkpoint as ckpt, driver, steps)

from torch_port_helpers import (jax_convnet, jax_darknet, torch_darknet,
                                write_darknet19_npz)

cv2 = pytest.importorskip("cv2")  # the JAX dark_pred resizes with it

# experiments/darknet_d/params.json cut to 64 px / n_grid 2
DARK_D = dict(model="darknet_d", n_boxes=2, n_classes=0, n_grid=2,
              darknet_input=64, capsule_input=32, l_coord=5.0, l_noobj=0.5,
              batch_size=4, dropout=0.0, fine_tune=18, lr_runtime=1e-3,
              lr_decay=0.5, n_epochs=2, eval_every=1, train_frac=1,
              summary=False, device_preprocess=True)
CNN = dict(model="cnn", n_classes=43, batch_size=8, dropout=0.0)
CAPSULE = dict(model="capsule", n_classes=43, batch_size=8)
N_FRAMES = 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------- loss

def _loss_case(case):
    """(y_pred, y_true) in f64 at B=2, C=0: boxes in (0.02, 0.98), object
    cells with the target's centre in the cell and w, h in (0.05, 0.6)."""
    rng = np.random.RandomState({"objects": 0, "tie": 1,
                                 "no_object": 2}[case])
    y_pred = rng.uniform(0.02, 0.98, (4, 2, 2, 10))
    y_true = np.zeros((4, 2, 2, 5))
    for cell in rng.choice(16, 0 if case == "no_object" else 6,
                           replace=False):
        i, r, c = np.unravel_index(cell, (4, 2, 2))
        y_true[i, r, c] = [1.0, *rng.uniform(0, 1, 2),
                           *rng.uniform(0.05, 0.6, 2)]
    if case == "tie":
        # box 1 = box 0 but for the confidence: equal IoUs, and on both
        # sides the first is responsible
        y_pred[..., 6:10] = y_pred[..., 1:5]
    return y_pred, y_true


@pytest.mark.parametrize("case", ["objects", "tie", "no_object"])
def test_dark_loss_b2_c0_matches_jax_in_f64(case):
    y_pred, y_true = _loss_case(case)
    jcfg = jax_losses.LossConfig.from_params(JaxParams(**DARK_D))
    cfg = losses.LossConfig.from_params(Params(**DARK_D))
    assert (cfg.n_boxes, cfg.n_classes) == (2, 0)

    def jloss(yp):
        loss, aux = jax_losses.dark_loss(yp, jnp.asarray(y_true), jcfg)
        return loss, aux["avg_iou"]

    (want, want_iou), want_g = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(y_pred))
    yp = torch.from_numpy(y_pred).requires_grad_()
    got, aux = losses.dark_loss(yp, torch.from_numpy(y_true), cfg)
    got.backward()
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-12)
    np.testing.assert_allclose(aux["avg_iou"].item(), float(want_iou),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(yp.grad.numpy(), np.asarray(want_g),
                               rtol=1e-10, atol=1e-14)
    if case == "tie":
        # the second box of an object cell takes only the no-object push
        obj = y_true[..., 0] == 1
        np.testing.assert_allclose(yp.grad.numpy()[obj][:, 6:10], 0.0)
    if case == "no_object":
        assert aux["avg_iou"].item() == 0.0


# ---------------------------------------------------------------- head

def test_c0_head_and_decode_match_jax():
    """The C=0 head is a sigmoid over all 10 channels; the decode of a
    10-channel grid (classes 0, none on the host) as JAX's."""
    logits = torch.from_numpy(
        np.random.RandomState(3).randn(3, 2, 2, 10).astype(np.float32))
    y = head(logits, 2, 0)
    torch.testing.assert_close(y, torch.sigmoid(logits), rtol=0, atol=0)
    kw = dict(n_classes=0, n_boxes=2, img_size=64)
    want = jax_decode.decode_grid(jnp.asarray(y.numpy()), **kw)
    got = decode.decode_grid(y, **kw)
    for k in ("conf", "classes", "valid", "idx"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["xy"].numpy(), np.asarray(want["xy"]),
                               rtol=1e-6, atol=1e-5)
    hw = np.array([[64, 64], [80, 120], [40, 50]])
    g_idx, g_xy, g_cls = decode.to_flat_host(got, image_hw=hw, img_size=64,
                                             with_classes=False)
    w_idx, w_xy, w_cls = jax_decode.to_flat_host(want, image_hw=hw,
                                                 img_size=64,
                                                 with_classes=False)
    assert g_cls is None and w_cls is None and len(g_idx) > 0
    np.testing.assert_array_equal(g_idx, w_idx)
    np.testing.assert_allclose(g_xy, w_xy, rtol=1e-6, atol=1e-4)
    with pytest.raises(ValueError, match="channels"):
        decode.decode_grid(y, n_classes=43, n_boxes=1, img_size=64)


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize("seed", [0, 1])
def test_detect_acc_and_ap_at_c0_match_jax(seed):
    """darknet_d's train metric (detect_acc) and its predict metrics on
    the synthetic grids and noisy predictions of both boxes."""
    p, jp = Params(**DARK_D), JaxParams(**DARK_D)
    _, _, _, y = loader.synthetic_dataset("darknet_d", p, 0, 12)
    assert y.shape == (12, 2, 2, 5)
    rng = np.random.RandomState(seed)
    y_hat = np.concatenate([y + 0.03 * rng.randn(*y.shape),
                            rng.rand(*y.shape)], -1)
    y_hat[..., 0] = np.clip(y[..., 0] * 0.6 + 0.5 * rng.rand(*y.shape[:3]),
                            0, 1)
    for fn in ("detect_acc", "detect_AP"):
        want = getattr(jax_det, fn)(y, y_hat, jp)
        got = getattr(det, fn)(y, y_hat, p)
        assert 0 < want < 1, fn
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=fn)


# ---------------------------------------------------------------- predict

def _frames(seed=0):
    rng = np.random.RandomState(seed)
    lo = rng.uniform(0, 200, (N_FRAMES, 1, 1, 1))
    span = rng.uniform(20, 255, (N_FRAMES, 1, 1, 1))
    return list(np.clip(lo + span * rng.rand(N_FRAMES, 64, 64, 3), 0,
                        255).astype(np.uint8))


def _detector(frames, seed=2):
    """JAX darknet_d variables with the BN statistics of ``frames`` and a
    head scaled x4, so the confidences depend on the frame and spread."""
    _, variables = jax_darknet(2, 0, seed=seed)
    model = torch_darknet(variables, 2, 0, "darknet_d")
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None
    with torch.no_grad():
        model.train()(torch.from_numpy(np.stack(frames)).float())
    for i in range(1, 19):
        bn = getattr(model.model, f"bn_{i}")
        st = variables["batch_stats"][f"block_{i}"][f"bn_{i}"]
        st["mean"] = bn.running_mean.numpy().copy()
        st["var"] = bn.running_var.numpy().copy()
    head = variables["params"]["conv_19"]
    head["kernel"] = head["kernel"] * 4.0
    return variables


def _write(root, name, variables):
    """The same weights as a JAX checkpoint under root/jax/<name> and a
    port checkpoint under root/port/<name>; returns both dirs."""
    jdir, pdir = (str(root / k / name) for k in ("jax", "port"))
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
def served(tmp_path_factory):
    """Frames, the detector's (JAX, port) checkpoint dirs, the cnn's, and
    a seeded port CapsuleNet's dir."""
    root = tmp_path_factory.mktemp("darknet_d")
    frames = _frames()
    capsule_dir = str(root / "port" / "capsule")
    ckpt.save_checkpoint({"epoch": 1, "optim_dict": {},
                          "state_dict": CapsuleNet(seed=0).state_dict()},
                         is_best=False, checkpoint_dir=capsule_dir)
    return (frames, _write(root, "darknet_d", _detector(frames)),
            _write(root, "cnn", jax_convnet(seed=4)[1]), capsule_dir)


def test_dark_pred_matches_jax(served):
    """The port's serving path (BN folded, K2 and K1 as their plain
    versions on the CPU) against the JAX dark_pred on the same
    checkpoint: the grid, and the boxes of its decode."""
    frames, (jdir, pdir), _, _ = served
    want, _ = jax_predict.dark_pred(frames, jdir, JaxParams(**DARK_D),
                                    "last")
    conf = want[..., [0, 5]]
    assert np.abs(conf - 0.5).min() > 1e-3 and 0 < (conf > 0.5).mean() < 1
    got, (idx, xy, cls) = predict.dark_detect(frames, pdir, Params(**DARK_D),
                                            "last", device="cpu")
    assert got.shape == want.shape == (N_FRAMES, 2, 2, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    w_idx, w_xy, w_cls = jax_decode.to_flat_host(
        jax_decode.decode_grid(jnp.asarray(want), n_classes=0, n_boxes=2,
                               img_size=64),
        image_hw=np.array([f.shape[:2] for f in frames]), img_size=64,
        with_classes=False)
    assert cls is None and w_cls is None and len(idx) > 0
    np.testing.assert_array_equal(idx, w_idx)
    np.testing.assert_allclose(xy, w_xy, rtol=0, atol=5e-5 * 64)


def test_combine_cnn_gives_the_jax_nan_line(served):
    """--combine on darknet_d: the combined grid as JAX's, and the
    reference's quirk: detect_and_recog_mAP sets n_classes to 43, so the
    5-channel ground truth decodes to no box: mAP nan, acc 0.0."""
    frames, (jdir, pdir), (jcls, pcls), _ = served
    jp, p = JaxParams(**DARK_D), Params(**DARK_D)
    want, _ = jax_predict.dark_class_pred(frames, jdir, jp, jcls,
                                          JaxParams(**CNN), "last")
    got, (idx, _, classes) = predict.dark_class_detect(
        frames, pdir, p, pcls, Params(**CNN), "last", device="cpu")
    assert got.shape == want.shape == (N_FRAMES, 2, 2, 53)
    np.testing.assert_allclose(got[..., :10], want[..., :10], atol=5e-5)
    # the classifier sees crops within one uint8 level of cv2's
    # (tests/test_torch_port_two_stage.py's band for cnn)
    np.testing.assert_allclose(got[..., 10:], want[..., 10:], atol=2e-3)
    assert len(idx) > 0 and classes.shape == idx.shape
    _, _, _, y = loader.synthetic_dataset("darknet_d", p, 4, N_FRAMES)
    line = "detect_and_recog_mAP:{}, detect_and_recog_acc:{}, "
    with pytest.warns(RuntimeWarning, match="Mean of empty slice"):
        want_line = line.format(jax_det.detect_and_recog_mAP(y, want, jp),
                                jax_det.detect_and_recog_acc(y, want, jp))
    with pytest.warns(RuntimeWarning, match="Mean of empty slice"):
        got_line = line.format(det.detect_and_recog_mAP(y, got, p),
                               det.detect_and_recog_acc(y, got, p))
    assert got_line == want_line == line.format(float("nan"), 0.0)
    assert p.n_classes == jp.n_classes == 43   # mutated, as the reference


@pytest.mark.parametrize("argv", [
    ["--combine", "cnn"],
    ["--combine", "capsule", "--device_crop", "--max_crops", "2"],
], ids=["cnn", "capsule_device_crop"])
def test_cli_combine_on_darknet_d(served, tmp_path, monkeypatch, argv):
    """The CLI from a tmp dir: darknet_d and the classifier under
    experiments/, the synthetic test set: the nan / 0.0 line."""
    _, (_, pdark), (_, pcls), pcaps = served
    name = argv[1]
    classifier = {"cnn": (pcls, CNN), "capsule": (pcaps, CAPSULE)}[name]
    for model, (path, params) in (("darknet_d", (pdark, DARK_D)),
                                  (name, classifier)):
        d = tmp_path / "experiments" / model
        d.mkdir(parents=True)
        Params(**params).save(str(d / "params.json"))
        (d / "last.ckpt").write_bytes(
            pathlib.Path(path, "last.ckpt").read_bytes())
    monkeypatch.chdir(tmp_path)
    with pytest.warns(RuntimeWarning, match="Mean of empty slice"):
        cli.main(["--model", "darknet_d", "--mode", "predict", "--restore",
                  "last", "--device", "cpu"] + argv)
    text = (tmp_path / "experiments" / "darknet_d"
            / f"combine-{name}_metric_output.txt").read_text()
    assert text == "detect_and_recog_mAP:nan, detect_and_recog_acc:0.0, "


# ---------------------------------------------------------------- train

def test_trainer_trajectory_and_avg_iou_print_match_jax(capsys):
    """Two Trainer epochs of one batch from the JAX trainer's weights with
    the same np.random.seed, both models in f64: the losses, avg_iou,
    detect_acc, and the reference's "train/test avg iou" lines.  The
    scenes are noise under the synthetic grids: the synthetic signs'
    flat pixels tie in the max-pools, where each framework's rounding
    picks its own winner."""
    over = dict(DARK_D, batch_size=2)
    jp, p = JaxParams(**over), Params(**over)
    _, y_tr, _, y_ev = loader.synthetic_dataset("darknet_d", p, 2, 2)
    x_tr, x_ev = (np.random.RandomState(s).uniform(-1, 1, (2, 64, 64, 3))
                  .astype(np.float32) for s in (5, 6))
    jtrainer = jax_driver.Trainer(jp, seed=0, verbose=False)
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), jtrainer.state.variables)
    jtrainer.state = jtrainer.state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jax_steps.make_optimizer().init(variables["params"]))
    trainer = driver.Trainer(p, seed=0, device="cpu", verbose=False)
    trainer.model.double().load_state_dict(jax_variables_to_state_dict(
        _np(variables), "darknet_d"))
    trainer.model.dtype = torch.float64
    trainer.opt = steps.make_optimizer(trainer.model)
    capsys.readouterr()
    got, want, prints = [], [], []
    for t, out in ((jtrainer, want), (trainer, got)):
        np.random.seed(0)
        for _ in range(2):
            loss_tr, metric_tr = t.train_epoch(x_tr, y_tr, 1e-3)
            iou_tr = t.last_avg_iou
            loss_ev, metric_ev = t.eval_epoch(x_ev, y_ev)
            out.append((loss_tr, loss_ev, iou_tr, t.last_avg_iou,
                        metric_tr, metric_ev))
        prints.append(capsys.readouterr().out)
    got, want = np.array(got), np.array(want)
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=1e-8)
    np.testing.assert_array_equal(got[:, 4:], want[:, 4:])
    assert prints[0] == prints[1] and prints[0].count("avg iou: ") == 4
    assert prints[0].startswith("train avg iou: ")


def test_cli_train_fine_tune_then_predict(tmp_path, monkeypatch, capsys):
    """--mode train --fine_tune 1 from a tmp dir on the synthetic set
    (16 scenes at --train_frac 0.25): the darknet19 npz loaded and blocks
    1..18 frozen (params.json's fine_tune 18), the avg iou prints; then
    --mode predict finds the checkpoint and writes the JAX CLI's
    metrics."""
    npz = str(tmp_path / "darknet19_weights.npz")
    arrs = write_darknet19_npz(npz)
    d = tmp_path / "experiments" / "darknet_d"
    d.mkdir(parents=True)
    Params(**dict(DARK_D, pretrained_weights=npz, batch_size=8)).save(
        str(d / "params.json"))
    monkeypatch.chdir(tmp_path)
    cli.main(["--model", "darknet_d", "--mode", "train", "--fine_tune", "1",
              "--train_frac", "0.25", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"Load weights from {npz}" in out and out.count("epoch ") == 2
    assert out.count("train avg iou: ") == out.count("test avg iou: ") == 2
    raw = ckpt.load_checkpoint(str(tmp_path / "experiments" / "darknet_d0.25"
                                   / "last.ckpt"))
    np.testing.assert_array_equal(
        raw["state_dict"]["model.conv_18.weight"].numpy(),
        arrs["17-scope/kernel:0"].transpose(3, 2, 0, 1))
    assert raw["state_dict"]["model.conv_19.weight"].shape == (10, 1024, 1, 1)
    assert len(raw["optim_dict"]["param_groups"][0]["params"]) == 1
    cli.main(["--model", "darknet_d", "--mode", "predict", "--restore",
              "last", "--train_frac", "0.25", "--device", "cpu"])
    text = (d / "metric_output.txt").read_text()
    p = Params(**dict(DARK_D, batch_size=8, train_frac=0.25))
    x, y = cli.load_test_frames("data/GTSDB", "darknet_d", p)
    y_hat, _ = predict.dark_pred(x, str(d), p, "last", device="cpu")
    assert text == "detect_AP:{}, detect_acc:{}, ".format(
        det.detect_AP(y, y_hat, p), det.detect_acc(y, y_hat, p))
