"""The plain references against the port's plain versions on the CPU, at
small sizes: what the card's comparison holds the program to is the
same mathematics the port computes."""

import numpy as np
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import losses
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
    CapsuleNet, DarkNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import decode
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops.input_stage \
    import darknet_serving_apply, prepare_serving
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops.preprocess \
    import preprocess_batch
from h100_bench import traffic as tr
from h100_bench.reference import capsule as rcap
from h100_bench.reference import darknet as rdark
from h100_bench.reference.common import Adam, resize_bilinear
from h100_bench.systems import capsule as scap
from h100_bench.systems import darknet as sdark
from h100_bench.tests.small import SMALL

CFG = {**{"n_boxes": 1, "n_classes": 43, "conf_th": 0.5},
       **SMALL["darknet_r"]}
CAPS = dict(n_classes=43, in_dim=8, out_dim=16, conv1_channels=256,
            conv1_kernel=9, primary_caps=8, primary_channels=16,
            primary_kernel=8, routing_nodes=1296)


def _darknet(seed=3, dropout=0.0):
    sd = sdark.make_state(CFG, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(sd[k].shape, generator=g)
        elif k.endswith("running_mean"):
            sd[k] = 0.1 * torch.randn(sd[k].shape, generator=g)
    model = DarkNet(n_boxes=1, n_classes=43, dropout=dropout)
    model.load_state_dict(sd)
    return sd, model


def test_resize_matches_the_port():
    g = torch.Generator().manual_seed(0)
    frames = torch.randint(0, 256, (2, 96, 160, 3), generator=g,
                           dtype=torch.uint8)
    np.testing.assert_allclose(resize_bilinear(frames, 64),
                               preprocess_batch(frames, 64), atol=2e-4)


def test_darknet_eval_matches_the_port_and_its_serving_forward():
    sd, model = _darknet()
    x = torch.rand(2, 64, 64, 3)
    want = rdark.forward(sd, x, 1, 43)
    assert 0.05 < float(want[..., :5].std()) and float(want.max()) < 1
    with torch.no_grad():
        np.testing.assert_allclose(model.eval()(x), want, atol=2e-5)
    served = darknet_serving_apply(prepare_serving(sd), x, n_boxes=1,
                                   n_classes=43)
    np.testing.assert_allclose(served, want, atol=2e-5)


def test_darknet_train_forward_draws_the_port_s_dropout_masks():
    sd, model = _darknet(dropout=0.5)
    x = tr.center(torch.rand(3, 64, 64, 3) * 255)
    got = model.train()(x, generator=torch.Generator().manual_seed(9))
    want = rdark.forward(sd, x, 1, 43, train=True, dropout=0.5,
                         generator=torch.Generator().manual_seed(9))
    np.testing.assert_allclose(got.detach(), want, atol=2e-5)


def test_yolo_loss_matches_dark_loss():
    g = torch.Generator().manual_seed(1)
    img, box, cls, valid = tr.scenes(4, (64, 64), (1, 3), (0.1, 0.4), 43,
                                     g, "cpu")
    y_true = tr.yolo_grid(box, cls, valid, 64, 2, 43)
    y_pred = torch.rand(4, 2, 2, 48, generator=g)
    cfg = losses.LossConfig(n_classes=43, n_boxes=1, n_grid=2,
                            darknet_input=64)
    want, _ = losses.dark_loss(y_pred, y_true, cfg)
    got = rdark.yolo_loss(y_pred, y_true, 1, 43, 64, 5.0, 0.5)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_reference_decode_matches_the_port_s_boxes():
    g = torch.Generator().manual_seed(2)
    y = torch.rand(2, 2, 2, 48, generator=g)
    d = decode.decode_grid(y, n_classes=43, n_boxes=1, img_size=64)
    img, xy, cls = decode.to_flat_host(d, image_hw=np.array([[96, 160]] * 2),
                                       img_size=64)
    conf, rxy, rcls, _ = (t.numpy() for t in rdark.decode(y, 1, 64,
                                                          (96, 160)))
    keep = conf > 0.5
    np.testing.assert_allclose(xy, rxy[keep], rtol=1e-6)
    np.testing.assert_array_equal(cls, rcls[keep])


def test_capsulenet_matches_the_port_s_plain_routing():
    cfg = dict(CAPS, n_iter=3)
    sd = scap.make_state(cfg, 4, "cpu")
    model = CapsuleNet(n_classes=43, routing_impl="xla")
    model.load_state_dict(sd)
    x = tr.center(torch.rand(3, 32, 32, 3) * 255)
    y = torch.tensor([0, 5, 42])
    scores, rec = model(x, y, recon=True)
    np.testing.assert_allclose(
        scores.detach(), rcap.scores(rcap.capsules(sd, x)), rtol=1e-5,
        atol=1e-7)
    want, _ = losses.capsule_loss(scores, y, losses.LossConfig(), x, rec)
    assert float(rcap.loss(sd, x, y, 43, 5e-4)) == pytest.approx(
        float(want.detach()), rel=1e-5)


def test_adam_matches_torch_adam():
    g = torch.Generator().manual_seed(5)
    p0 = [torch.randn(7, 3, generator=g), torch.randn(4, generator=g)]
    a = [t.clone().requires_grad_(True) for t in p0]
    b = [t.clone() for t in p0]
    opt, ref = torch.optim.Adam(a, lr=3e-3), Adam(b, 3e-3)
    for _ in range(3):
        grads = [torch.randn(t.shape, generator=g) for t in p0]
        for t, gr in zip(a, grads):
            t.grad = gr.clone()
        opt.step()
        ref.step(grads)
    for t, r in zip(a, b):
        np.testing.assert_allclose(t.detach(), r, rtol=1e-6, atol=1e-7)
