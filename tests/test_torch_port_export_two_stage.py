"""PyTorch port, the two-stage serving artifacts (CPU) at 64 px, n_grid
2, max_crops 2: the fused detect -> crop -> classify artifact with the
cnn and the capsule classifier against the JAX package's on the same
numpy weights and inputs, the int8 two-stage artifact against its live
fn and JAX's, `make_crops_fn` against the tail and JAX's, and the
space-to-depth int8 chain against the resident chain and JAX's."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu import export as jexport
from cs231_capsule_yolo_traffic_sign_detection_tpu.models import (
    CapsuleNet as JaxCapsuleNet, DarkNet as JaxDarkNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu.ops import quant as jq
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import export
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.interop import (
    jax_qparams_to_port)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import (
    quant as tq)

from torch_port_helpers import jax_convnet, port_capsulenet, torch_convnet
from test_torch_port_export import (INT8_BANDS, S, TAIL, _by_candidate,
                                    _jax_artifact, _nodes, _port_artifact,
                                    int8_net, setup)

# pytest finds the fixtures by these names in this module
assert setup and int8_net


@pytest.mark.parametrize("classifier", ["cnn", "capsule"])
def test_two_stage_matches_jax(setup, classifier, tmp_path):
    """The fused two-stage artifacts in f32 (K2, K1, and K5 and K3 with
    CapsuleNet): the same valid crops as JAX's artifact and the class
    scores within the two-stage parity band (rtol 1e-4, atol 5e-5: the
    detectors differ by the BN fold's rounding, the crops by XLA's fused
    multiply-adds)."""
    dvars, model, x = setup
    if classifier == "capsule":
        cls, cvars = port_capsulenet(43, seed=0)
        jcls = JaxCapsuleNet(43, routing_impl="xla")
    else:
        jcls, cvars = jax_convnet(seed=4)
        cls = torch_convnet(cvars)
    jfn = jexport.make_two_stage_fn(JaxDarkNet(1, 43, dropout=0.0), dvars,
                                    jcls, cvars, **TAIL)
    want = _by_candidate(_jax_artifact(tmp_path, "two", jfn, batch=4)(x))
    call = _port_artifact(tmp_path, "two", export.make_two_stage_fn(
        model, cls, **TAIL), batch=4)
    assert _nodes(call) == sorted(
        ["cyt.input_stage.default"] + ["cyt.pool_leaky.default"] * 4
        + ["cyt.primary_caps.default", "cyt.routing.default"]
        * (classifier == "capsule"))
    got = _by_candidate(call(x))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["valid"].any()
    np.testing.assert_allclose(got["class_scores"], want["class_scores"],
                               rtol=1e-4, atol=5e-5)


def test_int8_two_stage_matches_live_and_jax(setup, int8_net, tmp_path):
    """The int8 two-stage artifact (the detector calibrated on the frames,
    the ConvNet quantized on the crops `make_crops_fn` cuts, symbolic
    batch, no kernel node) equal to its live fn to the bit, and its grid
    within JAX's int8 bands of JAX's int8 two-stage artifact on the same
    weights (each side calibrated by its own quantize)."""
    _, _, x = setup
    model, dvars = int8_net
    jcls, cvars = jax_convnet(seed=4)
    xt = torch.from_numpy(x)
    fn = export.make_serving_two_stage_fn(
        model, torch_convnet(cvars), dtype=torch.int8, x_cal=xt,
        with_grid=True, **TAIL)
    call = _port_artifact(tmp_path, "two8", fn)
    assert _nodes(call) == []
    with torch.inference_mode():
        live = fn(xt)
    got = call(x)
    for k in live:
        assert torch.equal(got[k], live[k]), k
    q = jq.quantize_darknet(dvars, x_cal=jnp.asarray(x))
    jgrid = np.asarray(_jax_artifact(
        tmp_path, "two8", jexport.make_int8_two_stage_fn(
            q, jcls, cvars, with_grid=True, **TAIL), batch=4)(x)["grid"])
    err = np.abs(got["grid"].numpy() - jgrid)
    print(f"\n[export int8 two-stage] grid vs JAX mean {err.mean():.3g} "
          f"max {err.max():.3g}")
    assert err.mean() < INT8_BANDS[0] and err.max() < INT8_BANDS[1]
    assert got["class_scores"].shape == (4, 2, 43)


def test_make_crops_fn_matches_the_tail_and_jax(setup):
    """make_crops_fn's crops equal the tail's composition by hand on the
    same detector forward, and JAX's make_crops_fn within a fraction of
    a pixel level (atol 1e-3 of centered values: XLA fuses the
    sampler's multiply-adds)."""
    dvars, model, x = setup
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = export.make_crops_fn(model, **TAIL)(xt)
        d = export._decode(model(xt).float(), n_boxes=1, n_classes=43,
                           img_size=64, max_boxes=2, conf_th=0.5,
                           use_nms=False)
        want = export._crops(xt, d, 32)
    assert got.shape == (8, 32, 32, 3)
    assert torch.equal(got, want)
    jgot = jax.jit(jexport.make_crops_fn(JaxDarkNet(1, 43, dropout=0.0),
                                         dvars, **TAIL))(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=0,
                               atol=1e-3)


def test_s2d_int8_chain_is_bit_identical(setup, int8_net):
    """The s2d input stage against the resident chain (port), bit for
    bit, and against JAX's darknet_int8_resident_s2d_apply op by op on
    the same qparams within 1e-5 on 99.9% of elements (the band of the
    port's int8 chain against JAX's: requantization may differ at
    ties)."""
    _, _, x = setup
    _, dvars = int8_net
    x = x[:1]
    q = jq.quantize_darknet(dvars, x_cal=jnp.asarray(x))
    qp = tq.prepare_s2d_int8(jax_qparams_to_port(
        jax.tree_util.tree_map(np.asarray, q), "darknet_r"))
    xt = torch.from_numpy(x)
    got = tq.darknet_int8_resident_s2d_apply(qp, xt, n_boxes=1, n_classes=43)
    assert qp["s2d"]["wq"].dtype == torch.int8
    assert tuple(qp["s2d"]["wq"].shape) == (3, 3, 12, 128)
    assert torch.equal(got, tq.darknet_int8_resident_apply(
        qp, xt, n_boxes=1, n_classes=43))
    want = np.asarray(jq.darknet_int8_resident_s2d_apply(
        jq.prepare_s2d_int8(q), jnp.asarray(x), n_boxes=1, n_classes=43))
    assert (np.abs(got.numpy() - want) <= 1e-5).mean() >= 0.999


