"""PyTorch port, the darknet_r serving slice end to end (CPU): synthetic
data, checkpoint, `dark_pred` and the predict metrics against the JAX
package; the CLI; the port's independence from JAX; device rules."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu.data import (
    loader as jax_loader)
from cs231_capsule_yolo_traffic_sign_detection_tpu.metrics import (
    detection as jax_det)
from cs231_capsule_yolo_traffic_sign_detection_tpu.ops import (
    decode as jax_decode, preprocess as jax_pre)
from cs231_capsule_yolo_traffic_sign_detection_tpu.params import (
    Params as JaxParams)
import cs231_capsule_yolo_traffic_sign_detection_tpu_torch as cyt_torch
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import (
    __main__ as cli, device, predict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import loader
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.interop import (
    jax_variables_to_state_dict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.metrics import (
    detection as det)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
    DarkNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import (
    preprocess)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    checkpoint as ckpt)

from torch_port_helpers import jax_darknet

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cs231_capsule_yolo_traffic_sign_detection_tpu_torch"
PARAMS = dict(model="darknet_r", n_classes=43, n_boxes=1, n_grid=2,
              darknet_input=64, capsule_input=32, batch_size=4)


def _frames(x):
    """uint8 frames rebuilt from centered scenes, as both CLIs do."""
    return [np.clip(im * 128.0 + 128, 0, 255).astype(np.uint8) for im in x]


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    jmodel, variables = jax_darknet(1, 43)
    d = str(tmp_path_factory.mktemp("darknet_r"))
    ckpt.save_checkpoint(
        {"epoch": 1,
         "state_dict": jax_variables_to_state_dict(variables, "darknet_r"),
         "optim_dict": {}}, is_best=False, checkpoint_dir=d)
    _, _, x, y = loader.synthetic_dataset("darknet_r", Params(**PARAMS), 4, 8)
    return jmodel, variables, d, _frames(x), y


def test_synthetic_dataset_is_byte_equal_to_jax():
    got = loader.synthetic_dataset("darknet_r", Params(**PARAMS), 3, 5)
    want = jax_loader.synthetic_dataset("darknet_r", JaxParams(**PARAMS),
                                        3, 5)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    np.testing.assert_array_equal(loader.center_rgb(got[0]),
                                  jax_loader.center_rgb(want[0]))


def test_preprocess_matches_jax_resize():
    rng = np.random.RandomState(0)
    for shape in [(2, 100, 80, 3), (2, 40, 50, 3), (2, 64, 64, 3)]:
        x = (rng.rand(*shape) * 255).astype(np.uint8)
        want = np.asarray(jax_pre.preprocess_batch(jnp.asarray(x), 64))
        got = preprocess.preprocess_batch(torch.from_numpy(x), 64).numpy()
        # both plain bilinear, half-pixel centres, no antialias
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    same = (rng.rand(1, 64, 64, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(
        preprocess.preprocess_images(list(same), 64, "cpu").numpy(),
        same.astype(np.float32))


def _threshold_clear_of(conf, lo=0.2, hi=0.8):
    """Midpoint of the widest gap between confidences within [lo, hi]."""
    c = np.sort(np.concatenate([[lo, hi], conf[(conf > lo) & (conf < hi)]]))
    i = int(np.argmax(np.diff(c)))
    assert c[i + 1] - c[i] > 2e-3, "no threshold 1e-3 clear of the data"
    return float((c[i] + c[i + 1]) / 2)


def test_dark_pred_matches_jax(slice_setup):
    jmodel, variables, d, frames, y = slice_setup
    x = jnp.asarray(np.stack(frames).astype(np.float32))
    want = np.asarray(jmodel.apply(variables, x, train=False))
    conf_th = _threshold_clear_of(want[..., 0].ravel())
    image_hw = np.array([f.shape[:2] for f in frames])
    want_boxes = jax_decode.to_flat_host(
        jax_decode.decode_grid(jnp.asarray(want), n_classes=43, n_boxes=1,
                               img_size=64, conf_th=conf_th),
        image_hw=image_hw, img_size=64)

    y_hat, boxes = predict.dark_detect(frames, d, Params(**PARAMS), "last",
                                     device="cpu", conf_th=conf_th)
    assert y_hat.shape == want.shape == (8, 2, 2, 48)
    np.testing.assert_allclose(y_hat, want, atol=5e-5)
    np.testing.assert_array_equal(boxes[0], want_boxes[0])
    np.testing.assert_array_equal(boxes[2], want_boxes[2])
    np.testing.assert_allclose(boxes[1], want_boxes[1], atol=5e-5 * 64)

    # the predict metrics, on the same y_hat
    p, jp = Params(**PARAMS), JaxParams(**PARAMS)
    np.testing.assert_allclose(det.detect_AP(y, want, p),
                               jax_det.detect_AP(y, want, jp), rtol=1e-12)
    np.testing.assert_allclose(det.detect_acc(y, want, p),
                               jax_det.detect_acc(y, want, jp), rtol=1e-12)


def test_dark_pred_bf16_tracks_f32(slice_setup):
    _, _, d, frames, _ = slice_setup
    f32, _ = predict.dark_pred(frames, d, Params(**PARAMS), "last",
                               device="cpu")
    bf16, _ = predict.dark_pred(
        frames, d, Params(**PARAMS, compute_dtype="bfloat16"), "last",
        device="cpu")
    assert bf16.dtype == np.float32 and np.isfinite(bf16).all()
    err = np.abs(bf16 - f32)
    # the band of the JAX bf16 serving test (tests/test_input_stage.py)
    assert err.mean() < 0.01, err.mean()
    assert err.max() < 0.15, err.max()


def test_cli_predict_writes_metrics(slice_setup, tmp_path):
    _, _, d, _, _ = slice_setup
    Params(**PARAMS).save(str(tmp_path / "params.json"))
    (tmp_path / "last.ckpt").write_bytes(
        pathlib.Path(d, "last.ckpt").read_bytes())
    res = subprocess.run(
        [sys.executable, "-m", PORT.name, "--model", "darknet_r", "--mode",
         "predict", "--restore", "last", "--device", "cpu", "--model_dir",
         str(tmp_path)], cwd=str(REPO), capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    text = (tmp_path / "metric_output.txt").read_text()

    # the same numbers in-process: synthetic test set (16 scenes)
    p = Params(**PARAMS)
    _, _, x, y = loader.synthetic_dataset("darknet_r", p, 4, 16)
    y_hat, _ = predict.dark_pred(_frames(x), str(tmp_path), p, "last",
                                 device="cpu")
    assert text == "detect_AP:{}, detect_acc:{}, ".format(
        det.detect_AP(y, y_hat, p), det.detect_acc(y, y_hat, p))


@pytest.mark.parametrize("argv", [
    ["--model", "darkcapsule", "--mode", "export", "--restore", "last"],
    ["--model", "darknet_d", "--mode", "train", "--dtype", "int8"],
])
def test_cli_refuses_what_is_not_ported(argv, tmp_path, monkeypatch,
                                       capsys):
    """A mode the JAX CLI lacks runs nothing, as there (main.py falls
    through every branch); --dtype int8 is serving only, and training
    raises the JAX Trainer's message."""
    if "int8" in argv:
        with pytest.raises(ValueError, match="serving-only"):
            cli.main(argv)
    else:
        d = tmp_path / "experiments" / argv[1]
        d.mkdir(parents=True)
        Params(**PARAMS).save(str(d / "params.json"))
        monkeypatch.chdir(tmp_path)
        assert cli.main(argv) is None
        assert capsys.readouterr().out == ""
        assert sorted(p.name for p in tmp_path.rglob("*")) == [
            argv[1], "experiments", "params.json"]


def test_import_leaves_jax_out():
    mods = sorted(
        "{}.{}".format(PORT.name, ".".join(
            f.relative_to(PORT).with_suffix("").parts)).replace(
                ".__init__", "")
        for f in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'cv2', 'matplotlib', 'sklearn', "
            "'cs231_capsule_yolo_traffic_sign_detection_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_file_of_the_port_imports_jax():
    banned = ("jax", "jaxlib", "flax", "cv2", "matplotlib", "sklearn",
              "tqdm", "cs231_capsule_yolo_traffic_sign_detection_tpu")
    # the package and what runs on the card's machine, which has no JAX,
    # cv2, matplotlib, sklearn or tqdm (and the mesh tests' rank bodies,
    # which spawned ranks import alone); tqdm by name, as torch itself
    # imports it where it is installed
    files = list(PORT.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "k2_turns.py",
        REPO / "mesh_scaling.py", REPO / "tests" / "test_torch_port_cuda.py",
        REPO / "tests" / "torch_port_mesh_ranks.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in banned, (path, n)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        device.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        predict.dark_pred([], ".", Params(**PARAMS), "last")
    assert device.resolve_device("cpu") == torch.device("cpu")
    assert cyt_torch.Params is Params


def test_restore_darknet_falls_back_to_the_train_frac_dir(tmp_path):
    # training writes <model_dir><train_frac>/last.ckpt; restore reads it
    # from there when <model_dir>/last.ckpt is absent, as JAX
    # restore_variables does
    torch.manual_seed(0)
    sd = DarkNet(1, 43).state_dict()
    ckpt.save_checkpoint({"epoch": 1, "state_dict": sd, "optim_dict": {}},
                         is_best=False,
                         checkpoint_dir=str(tmp_path / "darknet_r1"))
    model = predict.restore_darknet(Params(**PARAMS),
                                    str(tmp_path / "darknet_r"), "last")
    for name, t in model.state_dict().items():
        torch.testing.assert_close(t, sd[name], rtol=0, atol=0, msg=name)


def test_restore_darknet_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        predict.restore_darknet(Params(**PARAMS),
                                str(tmp_path / "darknet_r"), "last")
