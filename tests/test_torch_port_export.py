"""PyTorch port, serving artifacts (CPU) at 64 px, n_grid 2: every export
factory's ``.pt2`` artifact, exported, saved and loaded through the
port's export.py, against the JAX package's ``jax.export`` artifact of
the same function exported, saved and loaded through JAX export.py, on
the same numpy weights and inputs: the detector (f32, bf16, int8), the
classifiers and darkcapsule's grid; the symbolic batch at two sizes;
the ``cyt::*`` kernel nodes in the graphs; the checkpoint exporters and
their int8 checks; selfcheck on a tampered artifact; the platforms
check; the export CLI.  The two-stage artifacts, the crops and the s2d
chain are in tests/test_torch_port_export_two_stage.py."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu import export as jexport
from cs231_capsule_yolo_traffic_sign_detection_tpu.models import (
    CapsuleNet as JaxCapsuleNet, ConvNet as JaxConvNet,
    DarkCapsuleNet as JaxDarkCapsuleNet, DarkNet as JaxDarkNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu.ops import quant as jq
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import (
    export, export_serving)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.interop import (
    jax_qparams_to_port)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
    CapsuleNet, DarkCapsuleNet, DarkNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import (
    quant as tq)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    checkpoint as ckpt)

from torch_port_helpers import (jax_convnet, jax_variables_from_port,
                                port_capsulenet, raise_bn, torch_convnet)
from test_torch_port_two_stage import DARK, _check_clear_of_ties, _frames

S = (64, 64, 3)
DET = dict(n_boxes=1, n_classes=43, img_size=64, conf_th=0.5)
TAIL = dict(DET, cap_input=32, max_crops=2)
# the bf16 detector against JAX's bf16 module, mean |error| by channel
# group of the decode (chip_smoke.py's BF16_BANDS: the two frameworks
# round the convs at other places, the port on BN-folded weights)
BF16_BANDS = {"conf": 2e-2, "xy": 2e-2 * 64}
# int8 against int8 on the same qparams, the artifacts compiled: XLA
# rewrites JAX's epilogues, so JAX's int8 bands (tests/test_quant.py:
# mean 0.01, max 0.12 of a confidence)
INT8_BANDS = (0.01, 0.12)


def _jax_artifact(tmp_path, name, fn, batch=None):
    blob = jexport.export_serving(fn, S if "cls" not in name else (32, 32, 3),
                                  batch=batch)
    return jexport.load_serving(jexport.save(
        blob, str(tmp_path / f"{name}.stablehlo")))


def _port_artifact(tmp_path, name, fn, shape=S, batch=None, **kw):
    blob = export.export_serving(fn, shape, batch=batch, device="cpu", **kw)
    return export.load_serving(export.save(blob, str(tmp_path /
                                                     f"{name}.pt2")),
                               device="cpu")


def _nodes(call):
    return sorted(export._kernel_nodes(call.exported))


def _by_candidate(d):
    """A decode dict as numpy, each image's slots put back in grid-scan
    order by their candidate index (tied confidences may sort apart)."""
    d = {k: np.asarray(v) for k, v in d.items()}
    order = np.argsort(d["idx"], axis=1, kind="stable")
    return {k: np.take_along_axis(v, order if v.ndim == 2 else
                                  order[..., None], axis=1)
            for k, v in d.items()}


@pytest.fixture(scope="module")
def setup():
    """One detector (as test_torch_port_two_stage._detector builds one:
    BN statistics from the frames, the head x4, so the confidences
    spread, clear of the threshold), its JAX variables, and 4 frames."""
    frames = _frames()
    model = raise_bn(DarkNet(1, 43, seed=2), 3)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None   # one batch: its statistics
    with torch.no_grad():
        model.train()(torch.from_numpy(np.stack(frames)).float())
        model.model.conv_19.weight.mul_(4.0)
    model.eval()
    dvars = jax_variables_from_port(model, "darknet_r",
                                    JaxDarkNet(1, 43, dropout=0.0), S)
    return dvars, model, np.stack(frames[:4]).astype(np.float32)


@pytest.fixture(scope="module")
def int8_net():
    """A DarkNet built as JAX's int8 test builds its network (JAX's int8
    bands are set on it; setup's detector, its head x4, drifts past
    them in int8 as in bf16), and its JAX variables."""
    model = raise_bn(DarkNet(1, 43, seed=0), 1).eval()
    return model, jax_variables_from_port(model, "darknet_r",
                                          JaxDarkNet(1, 43, dropout=0.0), S)


def test_detector_f32_and_symbolic_batch_match_jax(setup, tmp_path):
    """The f32 detector artifact (symbolic batch, NMS in) against JAX's at
    batch 4 and 1: the same kept boxes, the confidences and corners
    within the detectors' gap of tests/test_torch_port_two_stage.py (5e-5
    of a confidence, 4e-3 px: the port serves on BN-folded weights;
    measured 1.35e-5)."""
    dvars, model, x = setup
    jfn = jexport.make_detector_fn(JaxDarkNet(1, 43, dropout=0.0), dvars,
                                   use_nms=True, **DET)
    jcall = _jax_artifact(tmp_path, "det", jfn)
    fn = export.make_detector_fn(model, use_nms=True, **DET)
    call = _port_artifact(tmp_path, "det", fn)
    assert _nodes(call) == ["cyt.input_stage.default"] + [
        "cyt.pool_leaky.default"] * 4
    with torch.no_grad():
        _check_clear_of_ties(model(torch.from_numpy(x)).numpy())
    for xb in (x, x[1:2]):
        got, want = _by_candidate(call(xb)), _by_candidate(jcall(xb))
        for k in ("idx", "classes", "valid"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got["conf"], want["conf"], rtol=0,
                                   atol=5e-5)
        np.testing.assert_allclose(got["xy"], want["xy"], rtol=0, atol=4e-3)
    assert export.selfcheck(call, fn, S, batch=3)


def test_detector_bf16_matches_jax_by_channel_group(setup, int8_net,
                                                   tmp_path):
    """On int8_net's DarkNet: setup's detector (BN statistics from the
    frames, the head x4) takes bf16 0.03 (port) and 0.08 (JAX) of a
    confidence from f32."""
    _, _, x = setup
    model, dvars = int8_net
    jfn = jexport.make_detector_fn(JaxDarkNet(1, 43, dropout=0.0), dvars,
                                   dtype=jnp.bfloat16, **DET)
    want = _by_candidate(_jax_artifact(tmp_path, "det16", jfn, batch=4)(x))
    call = _port_artifact(tmp_path, "det16", export.make_detector_fn(
        model, dtype=torch.bfloat16, **DET))
    got = _by_candidate(call(x))
    assert _nodes(call).count("cyt.pool_leaky.default") == 4
    print(f"\n[export bf16] confidences' spread {want['conf'].std():.3g}")
    for k, band in BF16_BANDS.items():
        err = np.abs(got[k] - want[k]).mean()
        print(f"\n[export bf16] mean |{k} error| {err:.3g} (band {band})")
        assert err < band, k


def test_classifiers_match_jax(tmp_path):
    """CapsuleNet f32 (pallas routing: a cyt::routing node, the plain K3
    on the CPU) against JAX's XLA routing at rtol 1e-4 (the port's
    capsule parity band); the ConvNet in bf16 against JAX's bf16 artifact
    within a bf16 rounding of the scores (rtol 0.05, atol 5e-3); the bf16
    CapsuleNet artifact (the bf16 route weights cast inside the program)
    against its live module."""
    x = np.random.RandomState(3).uniform(-1, 1, (4, 32, 32, 3)).astype(
        np.float32)
    caps, cvars = port_capsulenet(43, seed=5)
    jcall = _jax_artifact(tmp_path, "cls_caps", jexport.make_classifier_fn(
        JaxCapsuleNet(43, routing_impl="xla"), cvars), batch=4)
    call = _port_artifact(tmp_path, "caps", export.make_classifier_fn(caps),
                          shape=(32, 32, 3))
    assert _nodes(call) == ["cyt.routing.default"]
    (scores, labels), (jscores, jlabels) = call(x), jcall(x)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))

    caps16, _ = port_capsulenet(43, seed=5, dtype=torch.bfloat16)
    fn = export.make_classifier_fn(caps16)
    call = _port_artifact(tmp_path, "caps16", fn, shape=(32, 32, 3))
    assert caps16.traffic_sign_capsules._bf16_key is None  # no live copy
    assert _nodes(call) == ["cyt.routing.default"]
    assert export.selfcheck(call, fn, (32, 32, 3), batch=3)

    _, nvars = jax_convnet(seed=4)
    jcall = _jax_artifact(tmp_path, "cls_cnn", jexport.make_classifier_fn(
        JaxConvNet(43, dropout=0.0), nvars, dtype=jnp.bfloat16), batch=4)
    call = _port_artifact(tmp_path, "cnn16", export.make_classifier_fn(
        torch_convnet(nvars, dtype=torch.bfloat16)), shape=(32, 32, 3))
    assert _nodes(call) == []
    np.testing.assert_allclose(call(x)[0].numpy(),
                               np.asarray(jcall(x)[0], np.float32),
                               rtol=0.05, atol=5e-3)


def test_darkcapsule_raw_grid_matches_jax(tmp_path):
    jmodel = JaxDarkCapsuleNet(n_grid=2, routing_impl="xla")
    model = raise_bn(DarkCapsuleNet(n_grid=2, seed=4), 5)
    jvars = jax_variables_from_port(model, "darkcapsule", jmodel, S)
    x = np.random.RandomState(4).rand(2, 64, 64, 3).astype(np.float32)
    want = _jax_artifact(tmp_path, "grid", jexport.make_grid_fn(
        jmodel, jvars), batch=2)(x)
    call = _port_artifact(tmp_path, "grid", export.make_grid_fn(model))
    got = call(x)
    assert got.shape == (2, 2, 2, 5) and _nodes(call) == []
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_int8_detector_symbolic_batch_matches_jax(setup, int8_net,
                                                  tmp_path):
    """The port's int8 artifact on JAX's qparams, symbolic batch, no
    kernel node: at batch 4 the confidences within JAX's int8 bands of
    JAX's artifact (XLA compiles JAX's epilogues differently); at batch
    4 and 1 equal to its live chain."""
    _, _, x = setup
    _, dvars = int8_net
    q = jq.quantize_darknet(dvars, x_cal=jnp.asarray(x))
    jcall = _jax_artifact(tmp_path, "int8", jexport.make_int8_detector_fn(
        q, **DET), batch=4)
    qp = jax_qparams_to_port(jax.tree_util.tree_map(np.asarray, q),
                             "darknet_r")
    fn = export.make_int8_detector_fn(qp, **DET)
    call = _port_artifact(tmp_path, "int8", fn)
    assert _nodes(call) == []
    got, want = _by_candidate(call(x)), _by_candidate(jcall(x))
    err = np.abs(got["conf"] - want["conf"])
    print(f"\n[export int8] conf vs JAX mean {err.mean():.3g} max "
          f"{err.max():.3g}")
    assert err.mean() < INT8_BANDS[0] and err.max() < INT8_BANDS[1]
    for xb in (x, x[2:3]):
        with torch.inference_mode():
            live = fn(torch.from_numpy(xb))
        for k, v in call(xb).items():
            assert torch.equal(v, live[k]), k


def _port_checkpoint(root, name, model):
    d = os.path.join(root, name)
    ckpt.save_checkpoint({"epoch": 1, "optim_dict": {},
                          "state_dict": model.state_dict()}, False, d)
    return d


def test_export_from_checkpoint_and_its_checks(setup, tmp_path):
    """From port checkpoints: the capsule artifact's scores equal the
    restored module's; the int8 exporters refuse a classifier and a
    missing x_cal before any restore; the two-stage exporter's artifact
    passes its selfcheck."""
    dvars, model, x = setup
    caps, _ = port_capsulenet(43, seed=0)
    cdir = _port_checkpoint(str(tmp_path), "capsule", caps)
    cparams = Params(model="capsule", n_classes=43, batch_size=4,
                     routing_impl="pallas")
    blob, fn = export.export_from_checkpoint(cparams, cdir, "last", batch=2,
                                             device="cpu")
    call = export.load_serving(export.save(blob, str(tmp_path / "c.pt2")),
                               device="cpu")
    assert export.selfcheck(call, fn, (32, 32, 3), batch=2)
    xc = np.random.RandomState(2).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        direct = caps(torch.from_numpy(xc))
    np.testing.assert_allclose(call(xc)[0].numpy(), direct.numpy(),
                               rtol=1e-6, atol=1e-7)

    with pytest.raises(ValueError, match="detectors only"):
        export.export_from_checkpoint(cparams, "/nonexistent", "last",
                                      dtype="int8", x_cal=None, device="cpu")
    dparams = Params(**DARK)
    with pytest.raises(ValueError, match="calibration"):
        export.export_from_checkpoint(dparams, "/nonexistent", "last",
                                      dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="calibration"):
        export.export_two_stage_from_checkpoints(
            dparams, "/nonexistent", cparams, cdir, "last", dtype="int8",
            device="cpu")
    ddir = _port_checkpoint(str(tmp_path), "darknet_r", model)
    blob, fn = export.export_two_stage_from_checkpoints(
        dparams, ddir, cparams, cdir, "last", max_crops=2, device="cpu")
    call = export.load_serving(export.save(blob, str(tmp_path / "t.pt2")),
                               device="cpu")
    assert export.selfcheck(call, fn, S, batch=2, atol=1e-4)


def test_selfcheck_platforms_and_batch_advice(tmp_path):
    """selfcheck raises on an artifact whose constants were changed; an
    artifact loads only on its platforms; a graph that fixes the batch
    gets the ``batch=`` advice, any other failure propagates."""
    _, nvars = jax_convnet(seed=4)
    fn = export.make_classifier_fn(torch_convnet(nvars))
    path = str(tmp_path / "cnn.pt2")
    export.save(export.export_serving(fn, (32, 32, 3), device="cpu"), path)
    call = export.load_serving(path, device="cpu")
    assert export.selfcheck(call, fn, (32, 32, 3))
    ep = torch.export.load(path)
    for t in ep.constants.values():
        t.mul_(1.5)
    torch.export.save(ep, path, extra_files={"cyt_platforms": "cpu"})
    with pytest.raises(AssertionError):
        export.selfcheck(export.load_serving(path, device="cpu"), fn,
                         (32, 32, 3))

    blob = export.export_serving(fn, (32, 32, 3), batch=2, device="cpu",
                                 platforms=("cuda",))
    with pytest.raises(ValueError, match="exported for platforms"):
        export.load_serving(export.save(blob, path), device="cpu")
    with pytest.raises(ValueError, match="platforms"):
        export.export_serving(fn, (32, 32, 3), device="cpu",
                              platforms=("tpu",))

    with pytest.raises(ValueError, match="batch="):
        export.export_serving(lambda x: x.reshape(2, -1).sum(1), (4, 4, 3),
                              device="cpu")

    def broken(x):
        raise RuntimeError("not a shape problem")

    with pytest.raises(RuntimeError, match="not a shape problem"):
        export.export_serving(broken, (4, 4, 3), device="cpu")


def test_export_cli(setup, tmp_path, monkeypatch):
    """``python -m ...export_serving`` from a dir holding experiments/
    <model>/params.json and the checkpoints: int8 two-stage with the
    ConvNet (the calibration batch from the synthetic test set), then the
    capsule classifier in bf16; each self-checked before it exits."""
    _, model, _ = setup
    _, nvars = jax_convnet(seed=4)
    for name, m, p in (("darknet_r", model, DARK),
                       ("cnn", torch_convnet(nvars), {"batch_size": 4}),
                       ("capsule", port_capsulenet(43, seed=0)[0],
                        {"batch_size": 4})):
        d = tmp_path / "experiments" / name
        d.mkdir(parents=True)
        Params(**dict({"n_classes": 43}, **{
            k: v for k, v in p.items() if k != "model"})).save(
                str(d / "params.json"))
        _port_checkpoint(str(tmp_path / "experiments"), name, m)
    monkeypatch.chdir(tmp_path)
    export_serving.main(["--model", "darknet_r", "--restore", "last",
                         "--combine", "cnn", "--max_crops", "2", "--dtype",
                         "int8", "--device", "cpu"])
    assert (tmp_path / "experiments/darknet_r/serving.pt2").exists()
    out = str(tmp_path / "caps16.pt2")
    export_serving.main(["--model", "capsule", "--restore", "last",
                         "--dtype", "bfloat16", "--out", out, "--batch", "3",
                         "--device", "cpu"])
    call = export.load_serving(out, device="cpu")
    # --routing auto is the plain composition on the CPU: no K3 node
    assert _nodes(call) == []
    assert call(np.zeros((3, 32, 32, 3), np.float32))[0].shape == (3, 43)
