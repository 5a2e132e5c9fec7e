"""PyTorch port: weights interop, DarkNet forward, BN fold and the
serving forward, each held against the JAX package on the same numpy
weights and inputs (CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu import (
    interop as jax_interop)
from cs231_capsule_yolo_traffic_sign_detection_tpu.ops import (
    input_stage as jax_is, quant as jax_quant)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.interop import (
    jax_variables_to_state_dict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import DarkNet
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import (
    input_stage as ist, quant)

from torch_port_helpers import jax_darknet, torch_darknet


@pytest.mark.parametrize("model_name,nb,nc", [("darknet_r", 1, 43),
                                              ("darknet_d", 2, 0)])
def test_state_dict_matches_jax_interop(model_name, nb, nc):
    _, variables = jax_darknet(nb, nc)
    want = jax_interop.variables_to_torch_state_dict(variables, model_name)
    got = jax_variables_to_state_dict(variables, model_name)
    assert list(got) == list(want)  # keys, in registration order
    for k in want:
        assert tuple(got[k].shape) == tuple(np.shape(want[k])), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    model = DarkNet(n_boxes=nb, n_classes=nc)
    model.load_state_dict(got, strict=True)
    assert list(model.state_dict()) == list(want)


@pytest.mark.parametrize("nb,nc", [(1, 43), (2, 0)])
def test_darknet_eval_forward_matches_jax(nb, nc):
    jmodel, variables = jax_darknet(nb, nc)
    x = np.random.RandomState(0).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = torch_darknet(variables, nb, nc)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, 2, 5 * nb + nc)
    # f32 conv sums in another order over 18 layers
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_fold_matches_jax():
    _, variables = jax_darknet(1, 43)
    want_layers, want_head = jax_quant.fold_darknet(variables)
    layers, head = quant.fold_darknet(
        jax_variables_to_state_dict(variables, "darknet_r"))
    for L, W in zip(layers, want_layers):
        np.testing.assert_allclose(L["w"].numpy(), np.asarray(W["w"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(L["b"].numpy(), np.asarray(W["b"]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(head.numpy(), np.asarray(want_head))


@pytest.fixture(scope="module")
def serving_setup():
    _, variables = jax_darknet(1, 43)
    x = np.random.RandomState(0).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    sd = jax_variables_to_state_dict(variables, "darknet_r")
    return variables, sd, x


def test_serving_forward_f32_matches_jax(serving_setup):
    """f32 contract: JAX pallas_pool=True, pallas_input=False (the JAX
    Pallas input stage forces bf16; the port's K2 keeps f32)."""
    variables, sd, x = serving_setup
    want = np.asarray(jax_is.darknet_serving_apply(
        jax_is.prepare_serving(variables, fuse_input=True), jnp.asarray(x),
        n_boxes=1, n_classes=43, dtype=jnp.float32, pallas_pool=True,
        pallas_input=False))
    with torch.no_grad():
        got = ist.darknet_serving_apply(
            ist.prepare_serving(sd), torch.from_numpy(x), n_boxes=1,
            n_classes=43, dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_serving_forward_bf16_matches_jax(serving_setup):
    """bf16 contract: JAX pallas_input=True, pallas_pool=True, bf16."""
    variables, sd, x = serving_setup
    want = np.asarray(jax_is.darknet_serving_apply(
        jax_is.prepare_serving(variables, fuse_input=True), jnp.asarray(x),
        n_boxes=1, n_classes=43, dtype=jnp.bfloat16, pallas_pool=True,
        pallas_input=True))
    with torch.no_grad():
        got = ist.darknet_serving_apply(
            ist.prepare_serving(sd, torch.bfloat16), torch.from_numpy(x),
            n_boxes=1, n_classes=43, dtype=torch.bfloat16)
    assert got.dtype == torch.float32  # heads stay f32
    err = np.abs(got.numpy() - want)
    # both sides round to bf16 at different places; the band of the
    # JAX bf16-vs-f32 serving test (tests/test_input_stage.py)
    assert err.mean() < 0.01, err.mean()
    assert err.max() < 0.15, err.max()


def test_serving_forward_keeps_nhwc_without_copies(serving_setup,
                                                   monkeypatch):
    """Every K1 input is the NHWC-contiguous view of a channels_last
    conv output: the wrapper's contiguity check never fires."""
    _, sd, x = serving_setup
    seen = []
    orig = ist.maxpool2_leaky

    def spy(t, slope):
        seen.append(t.is_contiguous())
        return orig(t, slope)

    monkeypatch.setattr(ist, "maxpool2_leaky", spy)
    with torch.no_grad():
        ist.darknet_serving_apply(ist.prepare_serving(sd),
                                  torch.from_numpy(x), n_boxes=1,
                                  n_classes=43)
    assert seen == [True] * 4
