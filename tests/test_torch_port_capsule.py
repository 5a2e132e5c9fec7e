"""PyTorch port, the capsule classifier's serving slice (CPU): capsule
ops, K3's plain version, interop, CapsuleNet, synthetic crops, the
classification metrics, `class_pred` and the CLI, each against the JAX
package on the same numpy inputs.  K3's CUDA kernel is held against
its plain version on the card by tests/test_torch_port_cuda.py."""

import pathlib
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu import (
    interop as jax_interop)
from cs231_capsule_yolo_traffic_sign_detection_tpu.data import (
    loader as jax_loader)
from cs231_capsule_yolo_traffic_sign_detection_tpu.metrics import (
    classification as jax_cls)
from cs231_capsule_yolo_traffic_sign_detection_tpu.ops import (
    capsule as jax_caps, routing_pallas as RP)
from cs231_capsule_yolo_traffic_sign_detection_tpu.params import (
    Params as JaxParams)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import predict
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import loader
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.interop import (
    jax_variables_to_state_dict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.metrics import (
    classification as cls)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models.capsule_net \
    import CapsuleRouting
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import (
    capsule as caps, routing)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    checkpoint as ckpt)

from torch_port_helpers import jax_capsulenet, torch_capsulenet

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cs231_capsule_yolo_traffic_sign_detection_tpu_torch"
PARAMS = dict(model="capsule", n_classes=43, batch_size=4, capsule_input=32)


def _routing_inputs(seed, b=2, n=160, k=43):
    """JAX test shapes (tests/test_pallas_routing.py): x ~ N(0, 1), W ~
    0.1 N(0, 1) as models/init.py draws it."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, 8).astype(np.float32)
    w = (0.1 * rng.randn(n, k, 8, 16)).astype(np.float32)
    return x, w


# ---------------------------------------------------------------- capsule ops

@pytest.mark.parametrize("op", ["squash", "compute_priors", "dynamic_routing",
                                "routed_single_capsule", "capsule_norm"])
def test_capsule_ops_match_jax(op):
    x, w = _routing_inputs(0, n=24, k=5)
    if op == "squash":
        v = np.random.RandomState(1).randn(3, 7, 16).astype(np.float32)
        got, want = caps.squash(torch.from_numpy(v)), jax_caps.squash(v)
    elif op == "compute_priors":
        got = caps.compute_priors(torch.from_numpy(x), torch.from_numpy(w))
        want = jax_caps.compute_priors(x, w)
    elif op == "dynamic_routing":
        priors = np.array(jax_caps.compute_priors(x, w))
        got = caps.dynamic_routing(torch.from_numpy(priors), n_iter=3)
        want = jax_caps.dynamic_routing(jnp.asarray(priors), n_iter=3)
    elif op == "routed_single_capsule":
        w1 = np.ascontiguousarray(w[:, :1])
        got = caps.routed_single_capsule(torch.from_numpy(x),
                                         torch.from_numpy(w1))
        want = jax_caps.routed_single_capsule(x, w1)
    else:
        c = np.random.RandomState(2).randn(3, 5, 16).astype(np.float32)
        got, want = caps.capsule_norm(torch.from_numpy(c)), \
            jax_caps.capsule_norm(c)
    want = np.asarray(want)
    assert got.shape == want.shape
    # f32, sums in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------- K3

@pytest.mark.parametrize("bf16", [False, True])
def test_routing_plain_matches_pallas_interpret(bf16):
    x, w = _routing_inputs(3)
    want = np.asarray(RP._route(jnp.asarray(x), jnp.asarray(w), 3,
                                interpret=True, bf16=bf16))
    got = routing.routed_capsules_plain(torch.from_numpy(x),
                                        torch.from_numpy(w), 3, bf16=bf16)
    assert got.dtype == torch.float32 and got.shape == (2, 43, 16)
    # the bands of tests/test_pallas_routing.py
    tol = dict(rtol=0.05, atol=5e-3) if bf16 else dict(rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_routing_wrapper_cpu_is_plain():
    x, w = (torch.from_numpy(a) for a in _routing_inputs(4, n=40, k=7))
    before = routing.routed_capsules.launches
    for bf16 in (False, True):
        torch.testing.assert_close(
            routing.routed_capsules(x, w, 3, bf16=bf16),
            routing.routed_capsules_plain(x, w, 3, bf16=bf16), rtol=0, atol=0)
    assert routing.routed_capsules.launches == before  # no kernel on the CPU


def test_routing_wrapper_rejects_unsupported_devices():
    x = torch.empty((2, 16, 8), device="meta")
    w = torch.empty((16, 5, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        routing.routed_capsules(x, w)


def test_bf16_serving_reuses_one_copy_of_the_route_weights():
    x, w = (torch.from_numpy(a) for a in _routing_inputs(5, n=40, k=7))
    layer = CapsuleRouting(7, 40, 8, 16)
    with torch.no_grad():
        layer.route_weights.copy_(w[None])

    def uncached():  # what the op computes from the f32 parameter
        return routing.routed_capsules(x, layer.route_weights[0].detach(), 3,
                                       bf16=True)

    with torch.no_grad():
        first = layer(x, bf16=True)
        copy = layer._bf16_w
        assert copy.dtype == torch.bfloat16
        second = layer(x, bf16=True)
        assert layer._bf16_w is copy  # made once, reused
        assert torch.equal(first, uncached()) and torch.equal(second, first)
        layer.route_weights.mul_(2.0)  # an in-place update: a new copy
        third = layer(x, bf16=True)
        assert layer._bf16_w is not copy
        assert torch.equal(third, uncached())
    # with a gradient the op casts inside, and the gradient reaches f32
    layer(x, bf16=True).sum().backward()
    assert layer.route_weights.grad.dtype == torch.float32
    assert layer.route_weights.grad.abs().max() > 0


# ---------------------------------------------------------------- interop

def test_interop_matches_jax_converter():
    _, variables = jax_capsulenet(43)
    got = jax_variables_to_state_dict(variables, "capsule")
    want = jax_interop.variables_to_torch_state_dict(variables, "capsule")
    assert list(got) == list(want)  # keys and their order
    for key, arr in want.items():
        assert tuple(got[key].shape) == arr.shape, key
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)


# ---------------------------------------------------------------- CapsuleNet

@pytest.mark.parametrize("n_classes", [43, 5])
def test_capsulenet_matches_jax(n_classes):
    jmodel, variables = jax_capsulenet(n_classes, seed=n_classes)
    x = np.random.RandomState(5).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    model = torch_capsulenet(variables, n_classes)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, n_classes)
    assert want.std() > 1e-3  # the scores are not trivial
    # weights carried from JAX through the node permutation: a wrong node
    # order fails here and nowhere else
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_capsulenet_bf16_matches_jax():
    jmodel, variables = jax_capsulenet(43, seed=7, dtype=jnp.bfloat16)
    x = np.random.RandomState(6).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)), np.float32)
    model = torch_capsulenet(variables, 43, dtype=torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    # bf16 convs round at other places in the two frameworks
    np.testing.assert_allclose(got.numpy(), want, rtol=0.05, atol=5e-3)


def test_decoder_keys_and_shape():
    _, variables = jax_capsulenet(43)
    model = torch_capsulenet(variables, 43)
    assert [k for k in model.state_dict() if k.startswith("decoder.")] == [
        f"decoder.{i}.{p}" for i in (0, 4, 7, 10, 12)
        for p in ("weight", "bias")]
    out = model.decoder(torch.zeros((2, 16)))
    assert out.shape == (2, 32, 32, 3) and out.dtype == torch.float32


# ---------------------------------------------------------------- data

def test_synthetic_classifier_data_is_byte_equal_to_jax():
    got = loader.synthetic_dataset("capsule", Params(**PARAMS), 5, 7)
    want = jax_loader.synthetic_dataset("capsule", JaxParams(**PARAMS), 5, 7)
    assert got[0].shape == (5, 32, 32, 3) and got[3].shape == (7,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize("ties", [False, True])
def test_recog_metrics_match_jax(ties):
    rng = np.random.RandomState(8)
    n, n_classes = 120, 43
    y = rng.permutation(np.arange(n) % n_classes)
    y_hat = rng.rand(n, n_classes).astype(np.float32)
    y_hat[np.arange(n), y] += rng.rand(n).astype(np.float32)
    if ties:  # few distinct scores: most thresholds hold many ties
        y_hat = np.round(y_hat * 4) / 4
    p, jp = Params(**PARAMS), JaxParams(**PARAMS)
    assert cls.recog_acc(y, y_hat, p) == jax_cls.recog_acc(y, y_hat, jp)
    for name in ("recog_auc", "recog_pr"):
        np.testing.assert_allclose(getattr(cls, name)(y, y_hat, p),
                                   getattr(jax_cls, name)(y, y_hat, jp),
                                   rtol=1e-12, err_msg=name)


# ---------------------------------------------------------------- class_pred

@pytest.fixture(scope="module")
def capsule_setup(tmp_path_factory):
    jmodel, variables = jax_capsulenet(43, seed=11)
    d = tmp_path_factory.mktemp("capsule")
    ckpt.save_checkpoint(
        {"epoch": 1, "optim_dict": {},
         "state_dict": jax_variables_to_state_dict(variables, "capsule")},
        is_best=False, checkpoint_dir=str(d))
    return jmodel, variables, d


def test_class_pred_matches_jax(capsule_setup):
    jmodel, variables, d = capsule_setup
    _, _, x, y = loader.synthetic_dataset("capsule", Params(**PARAMS), 0, 10)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    # batches of 4: the last one is ragged
    y_hat, classes = predict.class_pred(x, str(d), Params(**PARAMS), "last",
                                        device="cpu")
    assert y_hat.shape == (10, 43) and y_hat.dtype == np.float32
    np.testing.assert_allclose(y_hat, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(classes, np.argmax(y_hat, axis=1))
    empty, none = predict.class_pred(np.zeros((0, 32, 32, 3)), str(d),
                                     Params(**PARAMS), "last", device="cpu")
    assert empty.shape == (0, 43) and none.shape == (0,)


def test_cli_capsule_predict_writes_jax_metrics(capsule_setup, tmp_path):
    _, _, d = capsule_setup
    Params(**PARAMS).save(str(tmp_path / "params.json"))
    (tmp_path / "last.ckpt").write_bytes((d / "last.ckpt").read_bytes())
    res = subprocess.run(
        [sys.executable, "-m", PORT.name, "--model", "capsule", "--mode",
         "predict", "--restore", "last", "--device", "cpu", "--model_dir",
         str(tmp_path)], cwd=str(REPO), capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    text = (tmp_path / "metric_output.txt").read_text()

    # the JAX metrics on the port's scores of the synthetic test set
    p, jp = Params(**PARAMS), JaxParams(**PARAMS)
    _, _, x, y = loader.synthetic_dataset("capsule", p, 4, 16)
    y_hat, _ = predict.class_pred(x, str(tmp_path), p, "last", device="cpu")
    want = {"recog_pr": jax_cls.recog_pr(y, y_hat, jp),
            "recog_acc": jax_cls.recog_acc(y, y_hat, jp),
            "recog_auc": jax_cls.recog_auc(y, y_hat, jp)}
    fields = [f.split(":") for f in text.split(", ") if f]
    assert [k for k, _ in fields] == list(want)  # the JAX CLI's order
    for k, v in fields:
        np.testing.assert_allclose(float(v), want[k], rtol=1e-12, err_msg=k)
