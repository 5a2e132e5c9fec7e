"""PyTorch port, int8 serving (CPU) at 64 px, n_grid 2: the quantized
DarkNet and ConvNet (ops/quant.py) against the JAX ops/quant.py, the
fused int8 two-stage against JAX export.make_int8_two_stage_fn, the
int8 predict paths against the JAX dark_class_pred, the CLI's
``--combine cnn|capsule --device_crop --dtype int8``, and the Trainer's
refusal, on the same numpy inputs and weights."""

import functools
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu import (
    export as jax_export, predict as jax_predict)
from cs231_capsule_yolo_traffic_sign_detection_tpu.models import (
    DarkNet as JaxDarkNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu.ops import quant as jq
from cs231_capsule_yolo_traffic_sign_detection_tpu.params import (
    Params as JaxParams)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import (
    __main__ as cli, export, predict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.interop import (
    jax_qparams_to_port)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import (
    quant as tq)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train.driver import (
    Trainer)

from torch_port_helpers import (jax_capsulenet, jax_convnet,
                                torch_capsulenet, torch_convnet,
                                torch_darknet)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
    DARKNET_LAYERS, DarkNet)
from test_torch_port_two_stage import (CLASS, DARK, N_FRAMES, _detector,
                                       _frames, _write)

cv2 = pytest.importorskip("cv2")

# JAX's bands of int8 against f32 (tests/test_quant.py:64-65, :237-238;
# the ConvNet's relative to its largest logit)
DARK_BANDS, CNN_BANDS = (0.01, 0.12), (0.02, 0.15)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _agree(got, want, atol):
    """The rule for int8 against int8 on the same qparams: at least 99.9%
    of the elements within ``atol``.  Returns that share."""
    share = float((np.abs(got - want) <= atol).mean())
    assert share >= 0.999, share
    return share


def _darknet_variables(model):
    """The JAX package's variables of the port's DarkNet (numpy, HWIO),
    written out here: flax's init at 64 px runs op by op, for seconds."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    p, bs = {}, {}
    for i in range(1, len(DARKNET_LAYERS) + 1):
        bn = f"model.bn_{i}"
        p[f"block_{i}"] = {
            f"conv_{i}": {"kernel": sd[f"model.conv_{i}.weight"].transpose(
                2, 3, 1, 0).copy()},
            f"bn_{i}": {"scale": sd[bn + ".weight"], "bias": sd[bn + ".bias"]}}
        bs[f"block_{i}"] = {f"bn_{i}": {"mean": sd[bn + ".running_mean"],
                                        "var": sd[bn + ".running_var"]}}
    p["conv_19"] = {"kernel": sd["model.conv_19.weight"].transpose(
        2, 3, 1, 0).copy()}
    return {"params": p, "batch_stats": bs}


@pytest.fixture(scope="module")
def darknet_setup():
    """darknet_r built as JAX's int8 test builds its network: initial
    weights, each BN scale, bias, mean and variance raised by
    0.05 |N(0, 1)|."""
    model = DarkNet(1, 43, seed=0)
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            if ".bn_" in name and t.is_floating_point():
                t.add_(torch.from_numpy(
                    0.05 * np.abs(rng.randn(*t.shape))).float())
    variables = _darknet_variables(model.eval())
    x = (np.random.RandomState(0).rand(4, 64, 64, 3) * 255).astype(
        np.float32)
    return variables, model, x, _numpy(_jax_quantize_darknet(variables, x))


def _jax_quantize_darknet(variables, x_cal):
    """JAX's quantize_darknet(variables, x_cal=x_cal): the weights op by
    op, as the function runs them, and the calibration jitted (one
    program, where op by op compiles each of its ops)."""
    q = jq.quantize_darknet(variables)
    layers, _ = jq.fold_darknet(variables)
    q["act_scales"] = jax.jit(
        lambda x, ls: jq.calibrate_activation_scales(x, folded_layers=ls))(
            jnp.asarray(x_cal), layers)
    return q


def test_quantize_darknet_matches_jax(darknet_setup):
    _, model, x, want = darknet_setup
    got = tq.quantize_darknet(model.state_dict(), x_cal=torch.from_numpy(x))
    for g, w in zip(got["layers"], want["layers"]):
        assert g["wq"].dtype == torch.int8
        np.testing.assert_array_equal(g["wq"].numpy(), w["wq"])
        np.testing.assert_array_equal(g["ws"].numpy(), w["ws"])
        np.testing.assert_allclose(g["b"].numpy(), w["b"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["head"].numpy(), want["head"])
    np.testing.assert_allclose(got["act_scales"].numpy(),
                               want["act_scales"], rtol=1e-6, atol=0)


def test_resident_chain_is_bit_identical_to_static(darknet_setup):
    _, model, x, _ = darknet_setup
    xt = torch.from_numpy(x)
    q = tq.quantize_darknet(model.state_dict(), x_cal=xt)
    res = tq.darknet_int8_resident_apply(q, xt, n_boxes=1, n_classes=43)
    static = tq.darknet_int8_apply(q, xt, n_boxes=1, n_classes=43)
    assert torch.equal(res, static)


def test_int8_chain_matches_jax(darknet_setup):
    """On JAX's qparams: the resident chain and the dynamic layer-wise
    forward against JAX's, and both within JAX's bands of f32."""
    variables, model, x, jqp = darknet_setup
    qp = jax_qparams_to_port(jqp, "darknet_r")
    xt = torch.from_numpy(x)
    got = tq.darknet_int8_resident_apply(qp, xt, n_boxes=1,
                                         n_classes=43).numpy()
    want = np.asarray(jq.darknet_int8_resident_apply(
        jqp, jnp.asarray(x), n_boxes=1, n_classes=43))
    print(f"\n[int8] resident vs JAX: share within 1e-5 "
          f"{_agree(got, want, 1e-5)}, max {np.abs(got - want).max()}")
    dyn = {k: v for k, v in qp.items() if k != "act_scales"}
    jdyn = {k: v for k, v in jqp.items() if k != "act_scales"}
    _agree(tq.darknet_int8_apply(dyn, xt, n_boxes=1, n_classes=43).numpy(),
           np.asarray(jq.darknet_int8_apply(jdyn, jnp.asarray(x), n_boxes=1,
                                            n_classes=43)), 1e-5)
    with torch.no_grad():
        f32 = model(xt).numpy()
    err = np.abs(got - f32)
    assert err.mean() < DARK_BANDS[0] and err.max() < DARK_BANDS[1]


def test_int8_layers_differ_only_at_requant_ties(darknet_setup):
    """Layer by layer on the same int8 input: the s32 accumulators equal
    XLA's bit for bit, the f32 epilogues agree to 1e-6, and a requantized
    value differs from JAX's only where the epilogue lies within 1e-5 of
    a rounding tie."""
    _, _, x, jqp = darknet_setup
    qp = jax_qparams_to_port(jqp, "darknet_r")
    act = qp["act_scales"]
    z = tq._requant(torch.from_numpy(x), act[0])
    n_tied = 0
    for i, ((_, k, after), L, jL) in enumerate(zip(
            tq.DARKNET_LAYERS, qp["layers"], jqp["layers"])):
        acc = tq._int8_conv(z, L["wq"], k)
        jacc = jq._conv(jnp.asarray(z.numpy()), jL["wq"], k,
                        accum_dtype=jnp.int32)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
        a = tq._epilogue(acc, act[i], L["ws"], L["b"], 0.1)
        ja = np.asarray(jax.nn.leaky_relu(
            jacc.astype(jnp.float32) * (jqp["act_scales"][i] * jL["ws"])
            + jL["b"], 0.1))
        np.testing.assert_allclose(a.numpy(), ja, rtol=1e-6, atol=1e-6)
        if i + 1 == len(tq.DARKNET_LAYERS):
            break
        zq = tq._requant(a, act[i + 1])
        jz = np.asarray(jq._requant(jnp.asarray(ja),
                                    jqp["act_scales"][i + 1]))
        differ = zq.numpy() != jz
        r = (a / act[i + 1]).numpy()[differ]
        assert (np.abs(np.abs(r - np.floor(r)) - 0.5) < 1e-5).all()
        n_tied += int(differ.sum())
        z = tq._max_pool_int8(zq) if after == "mp" else zq
    print(f"\n[int8] requantized values differing from JAX's (ties): "
          f"{n_tied}")


@pytest.fixture(scope="module")
def convnet_setup():
    model, variables = jax_convnet(seed=4)
    x = np.random.RandomState(0).uniform(-1, 1, (24, 32, 32, 3)).astype(
        np.float32)
    jqc = _numpy(jq.quantize_convnet(variables, x_cal=jnp.asarray(x)))
    return model, variables, x, jqc


def test_quantize_convnet_matches_jax(convnet_setup):
    _, variables, x, want = convnet_setup
    got = tq.quantize_convnet(torch_convnet(variables).state_dict(),
                              torch.from_numpy(x))
    port_want = jax_qparams_to_port(want, "cnn")   # dense rows to CHW
    for g, w in zip(got["convs"] + [got["dense"]],
                    port_want["convs"] + [port_want["dense"]]):
        assert torch.equal(g["wq"], w["wq"]) and torch.equal(g["ws"],
                                                             w["ws"])
        torch.testing.assert_close(g["b"], w["b"], rtol=0, atol=1e-6)
    torch.testing.assert_close(got["act_scales"], port_want["act_scales"],
                               rtol=1e-6, atol=0)


def test_convnet_int8_matches_jax(convnet_setup):
    model, variables, x, jqc = convnet_setup
    got = tq.convnet_int8_apply(jax_qparams_to_port(jqc, "cnn"),
                                torch.from_numpy(x)).numpy()
    want = np.asarray(jq.convnet_int8_apply(jqc, jnp.asarray(x)))
    _agree(got, want, 1e-5)
    f32 = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    err = np.abs(got - f32) / np.abs(f32).max()
    assert err.mean() < CNN_BANDS[0] and err.max() < CNN_BANDS[1]


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("int8_two_stage"))
    frames = _frames()
    dvars = _detector(frames)
    cnn_model, cnn_vars = jax_convnet(seed=4)
    caps_model, caps_vars = jax_capsulenet(43)
    dirs = {"darknet_r": _write(root, "darknet_r", dvars),
            "cnn": _write(root, "cnn", cnn_vars),
            "capsule": _write(root, "capsule", caps_vars)}
    return root, frames, dvars, {"cnn": (cnn_model, cnn_vars),
                                 "capsule": (caps_model, caps_vars)}, dirs


TAIL = dict(n_boxes=1, n_classes=43, img_size=64, cap_input=32,
            max_crops=2, conf_th=0.5)


@pytest.mark.parametrize("classifier", ["cnn", "capsule"])
def test_fused_int8_two_stage_matches_jax(pipeline, classifier):
    """export.make_int8_two_stage_fn against the port's composition on
    the same qparams (JAX's, calibrated as JAX's dark_class_pred does):
    int8 detector, decode, crops, then the int8 ConvNet or the f32
    CapsuleNet.  JAX's function runs op by op here: under jax.jit XLA
    rewrites the epilogues and requants (the jitted path is held to the
    int8 bands in `test_int8_dark_class_pred_matches_jax`, which prints
    the gap)."""
    _, frames, dvars, classifiers, _ = pipeline
    # one detector batch: the shapes test_int8_chain_matches_jax ran op
    # by op, which JAX has compiled once already
    x = np.stack(frames[:4]).astype(np.float32)
    cls_model, cls_vars = classifiers[classifier]
    jqp = _jax_quantize_darknet(dvars, x)
    jqc = None
    if classifier == "cnn":
        crops = jax.jit(jax_export.make_crops_fn(
            JaxDarkNet(n_boxes=1, n_classes=43, dropout=0.0), dvars,
            **TAIL))(jnp.asarray(x))
        jqc = jq.quantize_convnet(cls_vars, x_cal=crops)
    fn = jax_export.make_int8_two_stage_fn(
        jqp, cls_model, cls_vars, qparams_cls=jqc, with_grid=True, **TAIL)
    want = fn(jnp.asarray(x))
    qp = jax_qparams_to_port(_numpy(jqp), "darknet_r")
    if classifier == "cnn":
        classify = functools.partial(
            tq.convnet_int8_apply, jax_qparams_to_port(_numpy(jqc), "cnn"))
    else:
        classify = torch_capsulenet(cls_vars, 43)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        grid = tq.darknet_int8_resident_apply(qp, xt, n_boxes=1, n_classes=43)
        got = export._two_stage_tail(xt, grid, classify=classify,
                                     use_nms=False, with_grid=False, **TAIL)
    _agree(grid.numpy(), np.asarray(want["grid"]), 1e-5)
    if classifier == "cnn":
        # this detector's BN statistics come from the frames and its head
        # is x4: int8 drifts from f32 past JAX's bands, in JAX as in the
        # port, and by the same amount
        f32 = np.asarray(JaxDarkNet(n_boxes=1, n_classes=43, dropout=0.0)
                         .apply(dvars, jnp.asarray(x), train=False))
        with torch.no_grad():
            port_f32 = torch_darknet(dvars, 1, 43)(xt).numpy()
        drift = (np.abs(grid.numpy() - port_f32).mean(),
                 np.abs(np.asarray(want["grid"]) - f32).mean())
        print(f"\n[int8] two-stage detector: int8 vs f32 mean drift, port "
              f"{drift[0]}, JAX {drift[1]}")
        assert abs(drift[0] - drift[1]) < 1e-4
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))
    assert got["valid"].any()
    # cnn: int8 on both sides; capsule: f32, XLA routing against the plain
    # routing (the band of tests/test_torch_port_two_stage.py's fused path)
    _agree(got["class_scores"].numpy(), np.asarray(want["class_scores"]),
           1e-4 if classifier == "cnn" else 5e-5)


@pytest.mark.parametrize("device_crop", [False, True],
                         ids=["host", "device_crop"])
def test_int8_dark_class_pred_matches_jax(pipeline, device_crop):
    """The int8 predict paths end to end, calibration included, against
    JAX dark_class_pred with --dtype int8 (cnn), which jits the chain:
    the detector channels within JAX's int8 bands of each other, the
    same cells classified where the two confidences lie 0.1 clear of the
    threshold, and their class scores in JAX's ConvNet bands (host: the
    f32 ConvNet on both sides).  (This detector's x4 head takes int8 0.022
    from f32 on average, in JAX as in the port; the bands of int8
    against f32 are held in `test_int8_chain_matches_jax`.)"""
    _, frames, _, _, dirs = pipeline
    (jdark, pdark), (jcls, pcls) = dirs["darknet_r"], dirs["cnn"]
    int8 = dict(compute_dtype="int8")
    want, _ = jax_predict.dark_class_pred(
        frames, jdark, JaxParams(**DARK, **int8), jcls,
        JaxParams(**CLASS["cnn"], **int8), "last", device_crop=device_crop,
        max_crops=2)
    got, (idx, _, _) = predict.dark_class_detect(
        frames, pdark, Params(**DARK, **int8), pcls,
        Params(**CLASS["cnn"], **int8), "last", device="cpu",
        device_crop=device_crop, max_crops=2)
    assert got.shape == want.shape == (N_FRAMES, 2, 2, 91) and len(idx)
    err = np.abs(got[..., :48] - want[..., :48])
    print(f"\n[int8 {'fused' if device_crop else 'host'}] detector "
          f"channels vs JAX (jitted): mean {err.mean()} max {err.max()}")
    assert err.mean() < DARK_BANDS[0] and err.max() < DARK_BANDS[1]
    clear = (np.abs(got[..., 0] - 0.5) > 0.1) & (np.abs(want[..., 0] - 0.5)
                                                 > 0.1)
    has = [np.abs(g[..., 48:]).sum(-1) > 0 for g in (got, want)]
    np.testing.assert_array_equal(has[0][clear], has[1][clear])
    both = has[0] & has[1]
    assert both.any()
    rel = np.abs(got[both][:, 48:] - want[both][:, 48:]) / np.abs(
        want[both][:, 48:]).max()
    assert rel.mean() < CNN_BANDS[0] and rel.max() < CNN_BANDS[1]


@pytest.mark.parametrize("classifier", ["cnn", "capsule"])
def test_cli_combine_device_crop_int8(pipeline, classifier, monkeypatch):
    """--combine cnn|capsule --device_crop --dtype int8 from a dir holding
    experiments/<model>/: the metric file, the mAP plots and one
    output/<i>.png a frame (the synthetic test set)."""
    root, _, _, _, dirs = pipeline
    monkeypatch.chdir(root)
    exp = root + "/experiments"
    for name, d in (("darknet_r", dirs["darknet_r"][1]),
                    (classifier, dirs[classifier][1])):
        shutil.copytree(d, f"{exp}/{name}", dirs_exist_ok=True)
    Params(**DARK).save(f"{exp}/darknet_r/params.json")
    Params(**CLASS[classifier]).save(f"{exp}/{classifier}/params.json")
    cli.main(["--model", "darknet_r", "--mode", "predict", "--restore",
              "last", "--combine", classifier, "--device_crop", "--dtype",
              "int8", "--device", "cpu"])
    text = open(f"{exp}/darknet_r/combine-{classifier}_metric_output.txt"
                ).read()
    assert text.startswith("detect_and_recog_mAP:")
    plot = cv2.imread(
        f"{exp}/darknet_r/combine-{classifier}_mAP/d&r_mAP_class_0.png")
    assert plot.shape == (800, 1000, 3)
    out = cv2.imread(f"{exp}/darknet_r/output/0.png")
    assert out.shape == (64, 64, 3)


def test_trainer_refuses_int8():
    with pytest.raises(ValueError, match="serving-only"):
        Trainer(Params(**DARK, compute_dtype="int8"), device="cpu")
