"""PyTorch port on the card: the CUDA kernels against their plain
versions, dark_pred, class_pred (CapsuleNet and ConvNet), the crop
sampler and the two-stage pipeline on the card against the same calls
on the CPU, one capsule train step on the card, --stream's batches and
losses against the resident loop's, and one darknet_r train
step on the card against the same step on the CPU, with its dropout
masks from a seeded generator; the NMS, the int8 products
(``torch._int_mm``) and int8 serving on the card against the CPU; the
serving artifacts (export.py) loaded on the card, their launch counts
and outputs; --remat's step; the general routing kernels K3g/K4g and
the dispatch between them and the tuned K3/K4; tools.capsule_interpret
through K3 against its CPU run; each kernel through its registered
operator after a NaN fill of shared memory; K5 (CapsuleNet's primary
capsules) against its plain version, its launches in serving and the
fused two-stage scores through it; --scan_epoch's captured
epochs against the eager loop (CapsuleNet through K3/K4, dropout
masks, --remat, bf16 capsule eval after train replays, the launch
counts under replay).

Every test here needs a CUDA card and skips without one.  This file
imports nothing of JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import (
    export, losses, predict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import loader
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.device import (
    resolve_device)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
    CapsuleNet, ConvNet, DarkNet, capsule_net)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import (
    _build, crop, decode, input_stage as ist, pool, primary_caps as pc,
    quant, routing)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.tools import (
    capsule_interpret)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    checkpoint as ckpt, driver, steps)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    resolve_device("cuda")  # TF32 off for the plain convs
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 56, 56, 256), (3, 6, 10, 5)])
def test_pool_kernel_matches_plain(card, dtype, shape):
    x = torch.randn(shape, generator=card, device="cuda").to(dtype)
    got = pool.maxpool2_leaky(x)
    torch.cuda.synchronize()
    # exact in both types: max and the slope round once, as the plain
    assert torch.equal(got, pool.maxpool2_leaky_plain(x))


def test_pool_kernel_refuses_non_nhwc(card):
    x = torch.randn((2, 8, 8, 16), generator=card, device="cuda")
    with pytest.raises(ValueError, match="NHWC"):
        pool.maxpool2_leaky(x.transpose(1, 2))


# K2 at 448 px (16-byte halo loads), then ragged: pooled 33 x 65 with
# W2 % 4 != 0 (scalar halo loads) and pooled 33 x 68 with 16-byte
# loads; neither fills the kernels' tiles, and a block walks 4 row
# tiles then 1
INPUT_STAGE_SHAPES = [(2, 448, 448, 3), (3, 66, 130, 3), (2, 66, 136, 3)]


def _input_stage_operands(card, shape):
    x = torch.rand(shape, generator=card, device="cuda") * 2 - 1
    w = 0.3 * torch.randn((3, 3, 3, 32), generator=card, device="cuda")
    b = torch.randn((32,), generator=card, device="cuda")
    return x, w, b


@pytest.mark.parametrize("shape", INPUT_STAGE_SHAPES)
def test_input_stage_kernel_matches_plain(card, shape):
    x, w, b = _input_stage_operands(card, shape)
    # NaN wherever the kernel would read shared memory it never wrote
    _build.fill_shared_memory(float("nan"))
    got = ist.input_stage(x, w, b)
    torch.cuda.synchronize()
    wp, bp = ist.phase_kernel(w, b)
    # f32 as 3xTF32 on the tensor cores (split operands, ~2^-22 each),
    # 27-term sums in another order
    torch.testing.assert_close(got, ist.input_stage_apply(x, wp, bp, 32),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ist.input_stage(x, w, b))


def _pixel_operands(card, shape):
    """0-255 integer frames, as the serving path feeds them, and conv1 at
    the serving slice's scale: He-normal weights with BN folded from the
    frames' own statistics (unit-scale outputs from cancelling sums)."""
    x = torch.randint(0, 256, shape, generator=card, device="cuda").float()
    w0 = (torch.randn((3, 3, 3, 32), generator=card, device="cuda",
                      dtype=torch.float64) * (2 / 27) ** 0.5)
    y = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2),
                                   w0.permute(3, 2, 0, 1), padding=1)
    scale = (y.var((0, 2, 3)) + 1e-5).rsqrt()
    return (x, (w0 * scale).float().contiguous(),
            (-y.mean((0, 2, 3)) * scale).float())


@pytest.mark.parametrize("shape", INPUT_STAGE_SHAPES)
def test_input_stage_f32_kernel_on_pixels(card, shape):
    x, w, b = _pixel_operands(card, shape)
    _build.fill_shared_memory(float("nan"))
    got = ist.input_stage(x, w, b)
    torch.cuda.synchronize()
    want = ist.input_stage_apply(
        x.double(), *ist.phase_kernel(w.double(), b.double()), 32)
    # the f32 band, atol 1e-5 of the largest output: the sums cancel from
    # ~10 to ~1 (x is exact in TF32; only the weights' split rounds)
    torch.testing.assert_close(got.double(), want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    assert torch.equal(got, ist.input_stage(x, w, b))


@pytest.mark.parametrize("shape", INPUT_STAGE_SHAPES)
def test_input_stage_bf16_kernel_matches_one_rounding(card, shape):
    x, w, b = _input_stage_operands(card, shape)
    xb, wb = x.bfloat16(), w.bfloat16().float()  # the operands it serves
    before = ist.input_stage.launches
    # NaN wherever the kernel would read shared memory it never wrote
    _build.fill_shared_memory(float("nan"))
    got = ist.input_stage(xb, wb, b)
    torch.cuda.synchronize()
    assert ist.input_stage.launches == before + 1
    assert got.dtype == torch.bfloat16
    wp, bp = ist.phase_kernel(wb, b)
    want = ist.input_stage_apply(xb.float(), wp, bp, 32).to(torch.bfloat16)
    # f32 sums in another order, then one rounding: within one bf16 ulp
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-7,
                               atol=1e-5)
    # no atomics, a fixed order of sums: two calls agree bit for bit
    assert torch.equal(got, ist.input_stage(xb, wb, b))


def test_dark_pred_on_card_matches_cpu(card, tmp_path):
    params = Params(model="darknet_r", n_classes=43, n_boxes=1, n_grid=2,
                    darknet_input=64, batch_size=4)
    torch.manual_seed(0)
    ckpt.save_checkpoint({"epoch": 0, "optim_dict": {}, "state_dict":
                          DarkNet(1, 43).state_dict()}, False, str(tmp_path))
    _, _, x, _ = loader.synthetic_dataset("darknet_r", params, 0, 8)
    frames = list(np.clip(x * 128.0 + 128, 0, 255).astype(np.uint8))
    ist.input_stage.launches = pool.maxpool2_leaky.launches = 0
    y_card, _ = predict.dark_pred(frames, str(tmp_path), params, "last",
                                  device="cuda")
    assert (ist.input_stage.launches, pool.maxpool2_leaky.launches) == (2, 8)
    y_cpu, _ = predict.dark_pred(frames, str(tmp_path), params, "last",
                                 device="cpu")
    np.testing.assert_allclose(y_card, y_cpu, atol=5e-5)


# CapsuleNet's shape, then the edges of the kernels' tiling: B not a
# multiple of the element groups, N not a multiple of the node tiles
# times the cluster, one capsule and the most the kernels take; then the
# two-stage pipeline's batches: the fused path's 32 frames x 16 crops,
# and one crop (the host path's ragged last batch)
ROUTING_SHAPES = [(64, 1296, 43), (3, 150, 5), (17, 1297, 48), (3, 150, 1),
                  (512, 1296, 43), (1, 1296, 43)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", ROUTING_SHAPES)
def test_routing_kernel_matches_plain(card, bf16, shape):
    b, n, k = shape
    x = torch.randn((b, n, 8), generator=card, device="cuda")
    w = 0.1 * torch.randn((n, k, 8, 16), generator=card, device="cuda")
    io = torch.bfloat16 if bf16 else torch.float32
    xi, wi = x.to(io), w.to(io)
    before = routing.routed_capsules.launches
    # NaN wherever the kernel would read shared memory it never wrote
    _build.fill_shared_memory(float("nan"))
    got = routing.routed_capsules(xi, wi, 3, bf16=bf16)
    torch.cuda.synchronize()
    assert routing.routed_capsules.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, k, 16)
    # the bands of tests/test_pallas_routing.py; the kernel sums in
    # another order
    tol = dict(rtol=0.05, atol=5e-3) if bf16 else dict(rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(
        got, routing.routed_capsules_plain(x, w, 3, bf16=bf16), **tol)


def test_class_pred_on_card_matches_cpu(card, tmp_path):
    params = Params(model="capsule", n_classes=43, batch_size=8)
    torch.manual_seed(0)
    ckpt.save_checkpoint({"epoch": 0, "optim_dict": {}, "state_dict":
                          CapsuleNet(43).state_dict()}, False, str(tmp_path))
    _, _, x, _ = loader.synthetic_dataset("capsule", params, 0, 20)
    routing.routed_capsules.launches = 0
    y_card, c_card = predict.class_pred(x, str(tmp_path), params, "last",
                                        device="cuda")
    assert routing.routed_capsules.launches == 3  # one per batch of 8
    y_cpu, _ = predict.class_pred(x, str(tmp_path), params, "last",
                                  device="cpu")
    np.testing.assert_allclose(y_card, y_cpu, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(c_card, np.argmax(y_card, axis=1))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", [(8, 1296, 43, 3), (3, 150, 5, 3),
                                   (17, 1297, 48, 3), (3, 150, 1, 3),
                                   (17, 150, 43, 1), (17, 150, 43, 5),
                                   (5, 1297, 48, 5)])
def test_routing_backward_kernel_matches_plain(card, bf16, shape):
    b, n, k, n_iter = shape
    x = torch.randn((b, n, 8), generator=card, device="cuda")
    w = 0.1 * torch.randn((n, k, 8, 16), generator=card, device="cuda")
    g = torch.randn((b, k, 16), generator=card, device="cuda")
    _, s = routing.routing_states_plain(x, w, n_iter, bf16)
    before = routing.routed_capsules_backward.launches
    io = torch.bfloat16 if bf16 else torch.float32
    xi, wi = x.to(io), w.to(io)
    _build.fill_shared_memory(float("nan"))
    dx, dw = routing.routed_capsules_backward(xi, wi, s, g, n_iter, bf16)
    torch.cuda.synchronize()
    assert routing.routed_capsules_backward.launches == before + 1
    assert dx.dtype == dw.dtype == torch.float32
    want = routing.routed_capsules_backward_plain(x, w, s, g, n_iter, bf16)
    # the kernel sums in another order; bf16 operands are rounded alike
    # on both sides, so the f32 band of tests/test_pallas_routing.py
    # holds in both modes
    for got, ref in zip((dx, dw), want):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("bf16", [False, True])
def test_routing_kernels_are_deterministic(card, bf16):
    # no atomics: every sum over node tiles, cluster ranks and warps goes
    # in a fixed order, so two calls agree bit for bit
    b, n, k = 64, 1296, 43
    io = torch.bfloat16 if bf16 else torch.float32
    x = torch.randn((b, n, 8), generator=card, device="cuda").to(io)
    w = (0.1 * torch.randn((n, k, 8, 16), generator=card,
                           device="cuda")).to(io)
    g = torch.randn((b, k, 16), generator=card, device="cuda")
    runs = []
    for _ in range(2):
        s = torch.empty((3, b, k, 16), device="cuda")
        caps = routing._k3(x, w, 3, bf16, s)
        runs.append((caps, *routing.routed_capsules_backward(x, w, s, g, 3,
                                                             bf16)))
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


# the general kernels K3g/K4g: DarkCapsuleNet2's routing (K 49, D 48) and
# DarkCapsuleNet3's (K 43, D 21) at small N and B, ragged element groups
# (16 a block) and node tiles, in_C and D off the tuned 8 / 16, and the
# largest shape they take; then the launch plans' edges: K 64 and D 64
# (clusters of blocks over the capsules, the final launch's capsule
# ranges), in_C 16, DarkCapsuleNet2's B 32 at full N, batch shares of the
# final launch (few node tiles), W copied by threads (in_C D 15, not a
# multiple of 4)
GENERAL_SHAPES = [(2, 24, 49, 8, 48), (3, 150, 43, 8, 21),
                  (33, 77, 43, 8, 21), (5, 30, 3, 3, 5), (4, 40, 49, 8, 16),
                  (3, 40, 64, 16, 64), (17, 67, 64, 8, 64),
                  (19, 33, 43, 16, 21), (32, 784, 49, 8, 48),
                  (40, 24, 43, 8, 21), (33, 130, 49, 8, 48),
                  (16, 64, 64, 16, 64)]


@pytest.mark.parametrize("shape", GENERAL_SHAPES)
def test_general_routing_kernels_match_plain(card, shape):
    """K3g and K4g after NaN fills of shared memory, against their plain
    versions in K3's and K4's f32 bands; two calls bit-identical; one
    launch each, none of the tuned kernels."""
    b, n, k, c, d = shape
    assert routing.kernel_for(c, k, d) == "general"
    x = torch.randn((b, n, c), generator=card, device="cuda")
    w = 0.1 * torch.randn((n, k, c, d), generator=card, device="cuda")
    g = torch.randn((b, k, d), generator=card, device="cuda")
    counts = (routing.routed_capsules.launches,
              routing.routed_capsules_backward.launches,
              routing.routed_capsules.launches_general,
              routing.routed_capsules_backward.launches_general)
    runs = []
    for _ in range(2):
        _build.fill_shared_memory(float("nan"))
        caps, s = torch.ops.cyt.routing(x, w, 3, False, True)
        _build.fill_shared_memory(float("nan"))
        runs.append((caps, s) + routing.routed_capsules_backward(
            x, w, s, g, 3))
    torch.cuda.synchronize()
    assert (routing.routed_capsules.launches,
            routing.routed_capsules_backward.launches,
            routing.routed_capsules.launches_general,
            routing.routed_capsules_backward.launches_general) == (
        counts[0], counts[1], counts[2] + 2, counts[3] + 2)
    for first, second in zip(*runs):
        assert torch.equal(first, second)
    caps, s, dx, dw = runs[0]
    want, want_s = routing.routing_states_plain(x, w, 3)
    assert caps.shape == (b, k, d) and s.shape == (3, b, k, d)
    torch.testing.assert_close(caps, want, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(s, want_s, rtol=2e-5, atol=2e-6)
    for got, ref in zip((dx, dw),
                        routing.routed_capsules_backward_plain(x, w, s, g,
                                                               3)):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape, n_iter", [((33, 77, 43, 8, 21), 1),
                                           ((17, 40, 49, 8, 48), 2),
                                           ((33, 77, 43, 8, 21), 5)])
def test_general_routing_kernels_other_n_iter(card, shape, n_iter):
    """K3g and K4g at n_iter 1 (no pass launch in K4g), 2 and 5 (K4g's
    terms in two batches) against their plain versions."""
    b, n, k, c, d = shape
    x = torch.randn((b, n, c), generator=card, device="cuda")
    w = 0.1 * torch.randn((n, k, c, d), generator=card, device="cuda")
    g = torch.randn((b, k, d), generator=card, device="cuda")
    _build.fill_shared_memory(float("nan"))
    caps, s = torch.ops.cyt.routing(x, w, n_iter, False, True)
    _build.fill_shared_memory(float("nan"))
    dx, dw = routing.routed_capsules_backward(x, w, s, g, n_iter)
    torch.cuda.synchronize()
    want, want_s = routing.routing_states_plain(x, w, n_iter)
    torch.testing.assert_close(caps, want, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(s, want_s, rtol=2e-5, atol=2e-6)
    for got, ref in zip((dx, dw),
                        routing.routed_capsules_backward_plain(x, w, s, g,
                                                               n_iter)):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-6)


def test_routing_dispatch_on_card(card):
    """CapsuleNet's shape goes to the tuned K3/K4, the variants' to
    K3g/K4g (through the autograd op, gradients against autograd through
    the plain forward); bf16 off the tuned shape and shapes past the
    general kernels' limits raise."""
    for (b, n, k, c, d), kind in (((4, 64, 43, 8, 16), "tuned"),
                                  ((4, 64, 43, 8, 21), "general"),
                                  ((4, 64, 49, 8, 48), "general")):
        x = torch.randn((b, n, c), generator=card, device="cuda")
        w = 0.1 * torch.randn((n, k, c, d), generator=card, device="cuda")
        cot = torch.randn((b, k, d), generator=card, device="cuda")
        for fn in (routing.routed_capsules, routing.routed_capsules_backward):
            fn.launches = fn.launches_general = 0
        grads = []
        for route in (routing.routed_capsules, routing.routed_capsules_plain):
            xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
            (route(xa, wa, 3) * cot).sum().backward()
            grads.append((xa.grad, wa.grad))
        torch.cuda.synchronize()
        tuned = int(kind == "tuned")
        assert (routing.routed_capsules.launches,
                routing.routed_capsules_backward.launches,
                routing.routed_capsules.launches_general,
                routing.routed_capsules_backward.launches_general) == (
            tuned, tuned, 1 - tuned, 1 - tuned), kind
        for got, ref in zip(*grads):
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-6)
    x = torch.randn((2, 16, 8), device="cuda")
    with pytest.raises(ValueError, match="bf16 routing at in_C 8, K 43, D 21"):
        routing.routed_capsules(x, torch.zeros((16, 43, 8, 21),
                                               device="cuda"), 3, bf16=True)
    with pytest.raises(ValueError, match="K 65"):
        routing.routed_capsules(x, torch.zeros((16, 65, 8, 16),
                                               device="cuda"), 3)
    with pytest.raises(ValueError, match="D 65"):
        routing.routed_capsules_backward(
            x, torch.zeros((16, 4, 8, 65), device="cuda"),
            torch.zeros((3, 2, 4, 65), device="cuda"),
            torch.zeros((2, 4, 65), device="cuda"), 3)


def test_train_step_on_card(card):
    params = Params(model="capsule", n_classes=43, recon=True,
                    recon_coef=5e-4)
    model = CapsuleNet(43, seed=0).cuda().train()
    opt = steps.make_optimizer(model)
    _, _, x, y = loader.synthetic_dataset("capsule", params, 0, 8)
    routing.routed_capsules.launches = 0
    routing.routed_capsules_backward.launches = 0
    loss, _, _ = steps.train_step(model, opt, torch.from_numpy(x).cuda(),
                                  torch.from_numpy(y).cuda(), 1e-3,
                                  losses.LossConfig.from_params(params),
                                  "capsule")
    assert (routing.routed_capsules.launches,
            routing.routed_capsules_backward.launches) == (1, 1)
    assert torch.isfinite(loss)
    for name, p in model.named_parameters():
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, name


def test_streamed_loop_bit_equals_resident_on_card(card):
    """--stream on the card (ConvNet: BN, dropout 0.5): the batches
    `ops.preprocess.stage` copies in through pinned memory, and the first
    epoch's losses, equal the resident loop's to the bit under cuDNN's
    deterministic algorithms, as tests/test_torch_port_stream.py holds
    on the CPU."""
    p = Params(model="cnn", n_classes=43, batch_size=8, dropout=0.5,
               lr_runtime=1e-3, lr_decay=0.5, n_epochs=1, eval_every=1,
               train_frac=1, summary=False, scan_epoch="off")
    x, y, _, _ = loader.synthetic_dataset("cnn", p, 36, 4)
    order = np.random.RandomState(1).permutation(36)
    runs = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for stream in (False, True):
            p.stream = stream
            t = driver.Trainer(p, seed=0, device="cuda", verbose=False)
            assert t.stream == stream and not t.scan_epoch
            batches = [(xb.clone(), yb.clone(), n) for xb, yb, n in
                       t._batches("train", x, y, order, 5)]
            np.random.seed(0)
            t.train_epoch(x, y, 1e-3, metric_on=False)
            runs.append((batches, t.last_losses.clone()))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (resident, losses_r), (streamed, losses_s) = runs
    assert len(streamed) == len(resident) == 5
    for (xr, yr, nr), (xs, ys, ns) in zip(resident, streamed):
        assert xs.is_cuda and ys.is_cuda and nr == ns
        assert xs.dtype == xr.dtype and torch.equal(xs, xr)
        assert ys.dtype == yr.dtype and torch.equal(ys, yr)
    assert losses_s.shape == (5,) and torch.equal(losses_s, losses_r)


def _darknet_step(device, dtype, x, y):
    """One darknet_r train step (dropout 0) from seed-0 weights on
    ``device``; returns the model, the loss and the outputs.  On the card
    the step raises if it waits for the device."""
    params = Params(model="darknet_r", n_boxes=1, n_classes=43, n_grid=2,
                    darknet_input=64)
    model = DarkNet(1, 43, dtype=dtype, seed=0)
    if dtype == torch.float64:
        model.double()
    model = model.to(device).train()
    opt = steps.make_optimizer(model)
    x, y = x.to(device, dtype), y.to(device)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        loss, y_hat, aux = steps.train_step(
            model, opt, x, y, 1e-3, losses.LossConfig.from_params(params),
            "darknet_r")
    finally:
        if device == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    return model, loss, y_hat, aux


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_darknet_train_step_on_card_matches_cpu(card, dtype):
    """The same step on the card (cuDNN, TF32 off) and on the CPU, on
    noise (flat images tie in the max-pools, which each device breaks by
    its own rounding); the card's step never waits on the host.

    f64: the same step to rounding, gradients included.  f32 and bf16:
    the loss and the outputs within rtol 1e-4 / .05.  Their gradients
    are compared with the exact (f64) step by cosine similarity, per
    parameter: at batch 2 the last blocks normalise 8 values per channel
    and a BN after a BN makes some gradients sums that cancel, so single
    entries carry each device's rounding (on the card cuDNN's f32 conv_18
    gradient lies 0.28 of its largest value from the exact one, the
    CPU's worst gradient 0.04; bf16 up to 1.1 on both).  Least cosines
    measured (the line this test prints): f32 card 0.9987, CPU 0.99998;
    bf16 card 0.68, CPU 0.65.  f32 must reach 0.99; bf16 at least the
    CPU's less 0.1."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32))
    _, y, _, _ = loader.synthetic_dataset("darknet_r", Params(
        model="darknet_r", n_classes=43, n_grid=2, darknet_input=64), 2, 0)
    y = torch.from_numpy(y)
    exact = _darknet_step("cpu", torch.float64, x, y)
    want = exact if dtype == torch.float64 else _darknet_step(
        "cpu", dtype, x, y)
    got = _darknet_step("cuda", dtype, x, y)
    rtol = {torch.float64: 1e-9, torch.float32: 1e-4,
            torch.bfloat16: 0.05}[dtype]
    for a, b in zip(got[1:3], want[1:3]):
        torch.testing.assert_close(a.cpu(), b, rtol=rtol, atol=rtol)
    cpu, ref = dict(want[0].named_parameters()), dict(
        exact[0].named_parameters())

    def cosine(g, name):
        return torch.nn.functional.cosine_similarity(
            g.double().flatten(), ref[name].grad.flatten(), 0).item()

    def err(g, name):
        r = ref[name].grad
        return ((g.double() - r).abs().max() / r.abs().max()).item()

    # the measurement the bands rest on (shown with pytest -s)
    rows = [(err(p.grad.cpu(), n), err(cpu[n].grad, n),
             cosine(p.grad.cpu(), n), cosine(cpu[n].grad, n), n)
            for n, p in got[0].named_parameters()]
    print(f"\n[darknet step {dtype}] largest error over max|g|, card "
          f"{max(rows)[0]:.3g} ({max(rows)[4]}), cpu "
          f"{max(r[1] for r in rows):.3g}; least cosine with f64, card "
          f"{min(r[2] for r in rows):.6g}, cpu {min(r[3] for r in rows):.6g}")
    for name, p in got[0].named_parameters():
        g = p.grad.cpu()
        assert torch.isfinite(g).all(), name
        if dtype == torch.float64:
            torch.testing.assert_close(
                g, ref[name].grad, rtol=1e-7,
                atol=1e-9 * ref[name].grad.abs().max().item(),
                msg=lambda m: f"{name}: {m}")
        elif dtype == torch.float32:
            assert cosine(g, name) >= 0.99, (name, cosine(g, name))
        else:
            assert cosine(g, name) >= cosine(cpu[name].grad, name) - 0.1, (
                name, cosine(g, name), cosine(cpu[name].grad, name))


def test_darknet_dropout_on_card_follows_its_seed(card):
    model = DarkNet(1, 43, dropout=0.5, seed=0).cuda().train()
    x = torch.rand((2, 64, 64, 3), generator=card, device="cuda")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    outs = []
    for seed in (3, 3, 4):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        outs.append(model(x, generator=gen))
        model.load_state_dict(state)
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_convnet_on_card_matches_cpu(card, tmp_path):
    """ConvNet's eval forward through class_pred, and one train-mode
    forward and backward, on the card against the CPU (f32, TF32 off)."""
    params = Params(model="cnn", n_classes=43, batch_size=8)
    ckpt.save_checkpoint({"epoch": 0, "optim_dict": {}, "state_dict":
                          ConvNet(43, seed=1).state_dict()}, False,
                         str(tmp_path))
    _, _, x, y = loader.synthetic_dataset("cnn", params, 0, 20)
    y_card, c_card = predict.class_pred(x, str(tmp_path), params, "last",
                                        device="cuda")
    y_cpu, _ = predict.class_pred(x, str(tmp_path), params, "last",
                                  device="cpu")
    np.testing.assert_allclose(y_card, y_cpu, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(c_card, np.argmax(y_card, axis=1))
    cfg = losses.LossConfig.from_params(params)
    grads = []
    for dev in ("cpu", "cuda"):
        model = ConvNet(43, dropout=0.0, seed=1).to(dev).train()
        loss, _, _ = steps.loss_and_scores(
            model, torch.from_numpy(x[:8]).to(dev),
            torch.from_numpy(y[:8]).to(dev), cfg, "cnn")
        loss.backward()
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        if name in ("cnn.0.bias", "cnn.4.bias"):   # zero: rounding noise
            continue
        torch.testing.assert_close(grads[1][name], g, rtol=1e-3,
                                   atol=1e-4 * g.abs().max().item(),
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("entry", ["detector", "classifier", "two_stage"])
def test_serving_entries_keep_f32_on_the_card(card, entry):
    """A model moved to the card with .cuda(), built into a serving fn
    with TF32 on and no `resolve_device`: the entry turns TF32 off."""
    det, cls = DarkNet(1, 43, seed=2).cuda(), CapsuleNet(43, seed=3).cuda()
    build = {
        "detector": lambda: export.make_detector_fn(
            det, n_boxes=1, n_classes=43, img_size=64),
        "classifier": lambda: export.make_classifier_fn(cls),
        "two_stage": lambda: export.make_two_stage_fn(
            det, cls, n_boxes=1, n_classes=43, img_size=64)}[entry]
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        build()
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def test_crop_resize_bilinear_on_card_matches_cpu(card):
    imgs = torch.rand((2, 96, 120, 3), generator=card, device="cuda") * 255
    boxes = torch.tensor([[[10.0, 20.0, 74.0, 90.0], [-20.0, -10.0, 40.0,
                                                      50.0],
                           [5.0, 5.0, 6.0, 6.0], [10.0, 10.0, 10.0, 30.0]],
                          [[0.0, 0.0, 120.0, 96.0], [100.5, 80.2, 140.0,
                                                     120.0],
                           [30.7, 3.3, 90.1, 60.9], [1.0, 1.0, 3.0, 2.0]]],
                         device="cuda")
    valid = torch.tensor([[True, True, True, True], [True, True, False,
                                                     True]], device="cuda")
    for out in (32, 7):
        got = crop.crop_resize_bilinear(imgs, boxes, out, valid)
        want = crop.crop_resize_bilinear(imgs.cpu(), boxes.cpu(), out,
                                         valid.cpu())
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("classifier", ["capsule", "cnn"])
def test_dark_class_pred_on_card_matches_cpu(card, tmp_path, classifier):
    """Both two-stage paths at 64 px: the card's launches (K2 and K1 per
    detector batch, K3 per classifier batch on the host path and once
    per detector batch fused) and the combined grid against the CPU."""
    dparams = Params(model="darknet_r", n_classes=43, n_boxes=1, n_grid=2,
                     darknet_input=64, capsule_input=32, batch_size=4)
    cparams = Params(model=classifier, n_classes=43, batch_size=8)
    _, _, x, _ = loader.synthetic_dataset("darknet_r", dparams, 0, 8)
    frames = list(np.clip(x * 128.0 + 128, 0, 255).astype(np.uint8))
    # BN statistics of these frames (one batch), the head scaled: 12 of
    # the 32 confidences above 0.5, none within 0.017 of it
    model = DarkNet(1, 43, seed=2)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None
    with torch.no_grad():
        model.train()(torch.from_numpy(np.stack(frames)).float())
        model.model.conv_19.weight.mul_(8.0)
    ddir, cdir = str(tmp_path / "dark"), str(tmp_path / "cls")
    cls = CapsuleNet(43, seed=3) if classifier == "capsule" else ConvNet(
        43, seed=3)
    for d, m in ((ddir, model), (cdir, cls)):
        ckpt.save_checkpoint({"epoch": 0, "optim_dict": {},
                              "state_dict": m.state_dict()}, False, d)
    for device_crop in (False, True):
        kw = dict(device_crop=device_crop, max_crops=4)
        y_cpu, (idx, _, _) = predict.dark_class_detect(
            frames, ddir, dparams, cdir, cparams, "last", device="cpu", **kw)
        for fn in (ist.input_stage, pool.maxpool2_leaky,
                   routing.routed_capsules):
            fn.launches = 0
        y_card, (idx_card, _, _) = predict.dark_class_detect(
            frames, ddir, dparams, cdir, cparams, "last", device="cuda",
            **kw)
        n_k3 = 0 if classifier == "cnn" else (
            2 if device_crop else -(-len(idx) // 8))
        assert (ist.input_stage.launches, pool.maxpool2_leaky.launches,
                routing.routed_capsules.launches) == (2, 8, n_k3)
        np.testing.assert_array_equal(idx_card, idx)
        assert 0 < len(idx) < 32
        # dark_pred's card band (test_dark_pred_on_card_matches_cpu)
        np.testing.assert_allclose(y_card, y_cpu, rtol=1e-4, atol=5e-5)


def test_nms_on_card_matches_cpu(card):
    y = torch.rand((4, 14, 14, 48), generator=card, device="cuda")
    y[..., 3:5] = 0.2 + 0.3 * y[..., 3:5]   # wide, overlapping boxes
    kw = dict(n_classes=43, n_boxes=1, img_size=448)
    got, want = (decode.decode_grid(t, **kw) for t in (y, y.cpu()))
    keep = decode.nms_mask(got["xy"], got["conf"], got["valid"])
    assert keep.device.type == "cuda"
    assert torch.equal(keep.cpu(), decode.nms_mask(
        want["xy"], want["conf"], want["valid"]))
    assert 0 < keep.sum() < got["valid"].sum()


@pytest.mark.parametrize("shape", [(5, 32, 64), (200, 288, 64),
                                   (40, 9216, 1024)])
def test_int8_matmul_on_card_is_exact(card, shape):
    """torch._int_mm on the card (a short operand padded past 16 rows)
    against the CPU's f64 product of the same int8 operands."""
    m, k, n = shape
    a = torch.randint(-127, 128, (m, k), generator=card, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=card, device="cuda",
                      dtype=torch.int8)
    got = quant.int8_matmul(a, w)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu().double(),
                       a.cpu().double() @ w.cpu().double().t())


def test_int8_dark_pred_on_card_matches_cpu(card, tmp_path):
    """--dtype int8 serving at 64 px: no K1/K2 launch on the card, and
    y_hat within 1e-5 of the CPU's on 99.9% of its elements and within
    JAX's int8 bands everywhere (the calibration's f32 convs differ by
    rounding, so a requantization may flip at a tie)."""
    params = Params(model="darknet_r", n_classes=43, n_boxes=1, n_grid=2,
                    darknet_input=64, batch_size=4, compute_dtype="int8")
    ckpt.save_checkpoint({"epoch": 0, "optim_dict": {}, "state_dict":
                          DarkNet(1, 43, seed=1).state_dict()}, False,
                         str(tmp_path))
    _, _, x, _ = loader.synthetic_dataset("darknet_r", params, 0, 8)
    frames = list(np.clip(x * 128.0 + 128, 0, 255).astype(np.uint8))
    ist.input_stage.launches = pool.maxpool2_leaky.launches = 0
    y_card, _ = predict.dark_detect(frames, str(tmp_path), params, "last",
                                    device="cuda")
    assert (ist.input_stage.launches, pool.maxpool2_leaky.launches) == (0, 0)
    y_cpu, _ = predict.dark_detect(frames, str(tmp_path), params, "last",
                                   device="cpu")
    err = np.abs(y_card - y_cpu)
    assert (err <= 1e-5).mean() >= 0.999
    assert err.mean() < 0.01 and err.max() < 0.12


def test_int8_convnet_on_card_matches_cpu(card):
    """The int8 ConvNet on the card against the CPU from the same
    qparams: the products are exact and the f32 epilogues the same IEEE
    operations, so the logits agree to the f32 head's rounding."""
    x = torch.rand((40, 32, 32, 3), generator=card, device="cuda") * 2 - 1
    qc = quant.quantize_convnet(ConvNet(43, seed=2).eval().state_dict(),
                                x.cpu())
    got = quant.convnet_int8_apply(
        {k: ([{n: t.cuda() for n, t in L.items()} for L in v]
             if isinstance(v, list) else {n: t.cuda() for n, t in v.items()}
             if isinstance(v, dict) else v.cuda()) for k, v in qc.items()},
        x)
    want = quant.convnet_int8_apply(qc, x.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- PR 12

def _launches():
    return (ist.input_stage.launches, pool.maxpool2_leaky.launches,
            routing.routed_capsules.launches,
            routing.routed_capsules_backward.launches)


def _artifact(fn, shape, tmp_path, name):
    """``fn`` exported on the card with a symbolic batch, saved, loaded."""
    blob = export.export_serving(fn, shape, device="cuda")
    return export.load_serving(export.save(blob, str(tmp_path / name)),
                               device="cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_detector_artifact_on_card(card, tmp_path, dtype):
    """A darknet_r artifact (128 px: at 64 px the int8 head's 2 x 2 maps
    make the cuBLASLt row padding of `quant.int8_matmul` depend on the
    batch, and a symbolic export refuses it) called at batch 3 and 2: K2
    once and K1 four times a call (none under int8), counted only at the
    call, and the outputs equal the live fn's (the same kernels and
    ops)."""
    model = DarkNet(1, 43, seed=0).cuda().eval()
    x = torch.rand((3, 128, 128, 3), generator=card, device="cuda") * 255
    kw = dict(n_boxes=1, n_classes=43, img_size=128, conf_th=0.5)
    with torch.inference_mode():
        fn = (export.make_int8_detector_fn(quant.quantize_darknet(
            model.state_dict(), x_cal=x), **kw) if dtype == "int8" else
            export.make_detector_fn(model, dtype=getattr(torch, dtype),
                                    **kw))
    before = _launches()
    call = _artifact(fn, (128, 128, 3), tmp_path, f"det_{dtype}.pt2")
    assert _launches() == before   # the trace launched nothing
    k = 0 if dtype == "int8" else 1
    for xb in (x, x[:2]):
        before = _launches()
        got = call(xb)
        torch.cuda.synchronize()
        after = _launches()
        assert (after[0] - before[0], after[1] - before[1]) == (k, 4 * k)
        with torch.inference_mode():
            want = fn(xb)
        for key in want:
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_capsule_artifact_on_card(card, tmp_path, dtype):
    """A CapsuleNet artifact (pallas routing): K3 once a call at batch 5,
    the scores within K3's bands of the plain routing's."""
    model = CapsuleNet(43, dtype=dtype, seed=0).cuda().eval()
    fn = export.make_classifier_fn(model)
    call = _artifact(fn, (32, 32, 3), tmp_path, "caps.pt2")
    x = torch.rand((5, 32, 32, 3), generator=card, device="cuda") * 2 - 1
    before = routing.routed_capsules.launches
    scores, _ = call(x)
    torch.cuda.synchronize()
    assert routing.routed_capsules.launches == before + 1
    model.traffic_sign_capsules.impl = "xla"
    with torch.inference_mode():
        want = model(x)
    tol = (dict(rtol=0.05, atol=5e-3) if dtype == torch.bfloat16
           else dict(rtol=2e-5, atol=2e-6))
    torch.testing.assert_close(scores, want, **tol)


def test_capsule_interpret_on_card_runs_k3(card, tmp_path):
    """tools.capsule_interpret on the card routes its crop through K3
    (one launch, no K3g), and its capsule matches the same tool on the
    CPU (plain routing) in the cross-device f32 band."""
    model_dir = tmp_path / "capsule"
    model_dir.mkdir()
    Params(batch_size=64, n_classes=43).save(str(model_dir / "params.json"))
    ckpt.save_checkpoint({"epoch": 0, "optim_dict": {},
                          "state_dict": CapsuleNet(43, seed=0).state_dict()},
                         True, str(model_dir))
    before = (routing.routed_capsules.launches,
              routing.routed_capsules.launches_general)
    got = capsule_interpret.main(3, model_dir=str(model_dir), device="cuda",
                                 out_dir=str(tmp_path / "img_cuda"))
    torch.cuda.synchronize()
    assert (routing.routed_capsules.launches,
            routing.routed_capsules.launches_general) == (before[0] + 1,
                                                          before[1])
    want = capsule_interpret.main(3, model_dir=str(model_dir), device="cpu",
                                  out_dir=str(tmp_path / "img_cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_step_on_card(card, dtype):
    """One darknet_r step (64 px, batch 2, dropout 0.5) with and without
    --remat on the card, cuDNN deterministic: the loss to the bit, each
    gradient's cosine with the plain step's at least 0.99999, the BN
    buffers and the generator's state equal."""
    x = (torch.rand((2, 64, 64, 3), generator=card, device="cuda") * 2
         - 1).to(dtype)
    _, y, _, _ = loader.synthetic_dataset("darknet_r", Params(
        model="darknet_r", n_classes=43, n_grid=2, darknet_input=64), 2, 0)
    y = torch.from_numpy(y).cuda()
    cfg = losses.LossConfig.from_params(Params(
        model="darknet_r", n_boxes=1, n_classes=43, n_grid=2,
        darknet_input=64))
    runs = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            model = DarkNet(1, 43, dropout=0.5, dtype=dtype, seed=0,
                            remat=remat).cuda().train()
            gen = torch.Generator(device="cuda").manual_seed(7)
            loss = steps.loss_and_scores(model, x, y, cfg, "darknet_r",
                                         gen)[0]
            loss.backward()
            runs.append((loss.item(), dict(model.named_parameters()),
                         dict(model.named_buffers()), gen.get_state()))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (la, pa, ba, ga), (lb, pb, bb, gb) = runs
    assert la == lb
    for name, p in pa.items():
        cos = torch.nn.functional.cosine_similarity(
            p.grad.double().flatten(), pb[name].grad.double().flatten(), 0)
        assert cos.item() >= 0.99999, (name, cos.item())
    for name, b in ba.items():
        assert torch.equal(b, bb[name]), name
    assert torch.equal(ga, gb)


def test_ops_after_nan_fill(card):
    """Each kernel called as its registered operator (torch.ops.cyt.*)
    just after every SM's shared memory was filled with NaN, against its
    plain version: K1 exact, K2 f32 1e-5, K3 and K4 in their f32 bands;
    each call counted once."""
    x = torch.randn((2, 16, 24, 64), generator=card, device="cuda")
    before = _launches()
    _build.fill_shared_memory(float("nan"))
    got = torch.ops.cyt.pool_leaky(x, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(got, pool.maxpool2_leaky_plain(x).contiguous())

    xi, w, b = _input_stage_operands(card, (2, 66, 136, 3))
    _build.fill_shared_memory(float("nan"))
    got = torch.ops.cyt.input_stage(xi, w, b, 0.1)
    torch.cuda.synchronize()
    wp, bp = ist.phase_kernel(w, b)
    torch.testing.assert_close(got, ist.input_stage_apply(xi, wp, bp, 32),
                               rtol=1e-5, atol=1e-5)

    xr = torch.randn((5, 150, 8), generator=card, device="cuda")
    wr = 0.1 * torch.randn((150, 7, 8, 16), generator=card, device="cuda")
    _build.fill_shared_memory(float("nan"))
    caps, s = torch.ops.cyt.routing(xr, wr, 3, False, True)
    torch.cuda.synchronize()
    want, s_want = routing.routing_states_plain(xr, wr, 3)
    torch.testing.assert_close(caps, want, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(s, s_want, rtol=2e-5, atol=2e-6)
    g = torch.randn((5, 7, 16), generator=card, device="cuda")
    _build.fill_shared_memory(float("nan"))
    dx, dw = torch.ops.cyt.routing_bwd(xr, wr, s, g, 3, False)
    torch.cuda.synchronize()
    for got_g, want_g in zip((dx, dw), routing.routed_capsules_backward_plain(
            xr, wr, s, g, 3)):
        torch.testing.assert_close(got_g, want_g, rtol=1e-4, atol=1e-6)
    after = _launches()
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1, 1)


# ------------------------------------------------------------ K5

# B 1 (one ragged tile, K split over all 8 chunks), 7, 64 (41 tiles, K
# split in 3), 65, 512 (324 tiles, split in 2) and 513 (a ragged last
# tile)
PRIMARY_CAPS_BATCHES = [1, 7, 64, 65, 512, 513]


def _primary_caps_operands(card, b, kind):
    """A map (B, 256, 24, 24) channels-last, as cuDNN leaves conv1's, and
    stacked weights and bias at torch's initial scale (U(+-1/128))."""
    x = torch.randn((b, 24, 24, 256), generator=card, device="cuda")
    if kind == "relu":  # conv1's map: relu'd, half of it zeros
        x = torch.relu(x)
    w = (torch.rand((128, 256, 8, 8), generator=card, device="cuda") * 2
         - 1) / 128
    bias = (torch.rand((128,), generator=card, device="cuda") * 2 - 1) / 128
    return x.permute(0, 3, 1, 2), w, bias


@pytest.mark.parametrize("kind", ["randn", "relu"])
@pytest.mark.parametrize("b", PRIMARY_CAPS_BATCHES)
def test_primary_caps_kernel_matches_plain(card, b, kind):
    """K5 after a NaN fill of shared memory, within rtol/atol 1e-5 of the
    plain version (cuDNN with TF32 off): each 3xTF32 product keeps about
    2^-22 of |a b|, and the kernel sums K = 16,384 products in another
    order (the tensor cores' partial sums over 64 of K, added in IEEE
    f32), some 1e-6 of the capsules' unit scale; one-pass TF32 is ~1e-3
    off."""
    x, w, bias = _primary_caps_operands(card, b, kind)
    before = pc.primary_caps.launches
    _build.fill_shared_memory(float("nan"))
    got = pc.primary_caps(x, pc.prepare_weights(w), bias)
    torch.cuda.synchronize()
    assert pc.primary_caps.launches == before + 1
    assert got.shape == (b, 1296, 8)
    torch.testing.assert_close(got, pc.primary_caps_plain(x, w, bias, 8, 2),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b", [64, 512])
def test_primary_caps_kernel_is_deterministic(card, b):
    """Two calls on the same input give the same bits, the split K's
    partial sums included (added in split order)."""
    x, w, bias = _primary_caps_operands(card, b, "relu")
    wp = pc.prepare_weights(w)
    runs = []
    for _ in range(2):
        _build.fill_shared_memory(float("nan"))
        runs.append(pc.primary_caps(x, wp, bias))
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


def test_primary_caps_kernel_refuses_what_it_does_not_take(card):
    x, w, bias = _primary_caps_operands(card, 2, "relu")
    wp = pc.prepare_weights(w)
    with pytest.raises(ValueError, match="channels-last"):
        pc.primary_caps(x.contiguous(), wp, bias)
    with pytest.raises(TypeError, match="f32"):
        pc.primary_caps(x.double(), wp, bias)
    with pytest.raises(ValueError, match="need x"):
        pc.primary_caps(x[:, :, :16], wp, bias)
    with pytest.raises(ValueError, match="need wp"):
        pc.primary_caps(x, w, bias)


def test_primary_caps_launches_in_serving_only(card):
    """K5 launches once a serving forward of CapsuleNet (eager and
    through `make_classifier_fn`), on conv1's map as cuDNN leaves it
    (channels-last: no copy), and not under grad mode with trainable
    weights."""
    model = CapsuleNet(43, seed=0).cuda().eval()
    x = torch.rand((5, 32, 32, 3), generator=card, device="cuda")
    seen = []
    model.primary_capsules.register_forward_pre_hook(
        lambda m, args: seen.append(
            args[0].is_contiguous(memory_format=torch.channels_last)))
    before = pc.primary_caps.launches
    with torch.inference_mode():
        model(x)
    assert pc.primary_caps.launches == before + 1
    fn = export.make_classifier_fn(model)
    with torch.inference_mode():
        fn(x)
    assert pc.primary_caps.launches == before + 2
    with torch.enable_grad():
        scores = model(x)
    assert scores.requires_grad
    assert pc.primary_caps.launches == before + 2
    with torch.no_grad():
        model(x)
    torch.cuda.synchronize()
    assert pc.primary_caps.launches == before + 3
    assert seen == [True] * 4


def test_two_stage_class_scores_through_k5(card, monkeypatch):
    """`make_two_stage_fn` at 32 frames of 448 px, its 16 boxes a frame
    cropped (conf_th 0): the 512 crops' class scores through K5
    within 1e-5 of the same fn on the plain primary capsules."""
    det = DarkNet(1, 43, seed=2).cuda()
    cls = CapsuleNet(43, seed=3).cuda()
    fn = export.make_two_stage_fn(det, cls, n_boxes=1, n_classes=43,
                                  img_size=448, max_crops=16, conf_th=0.0)
    x = torch.rand((32, 448, 448, 3), generator=card, device="cuda")
    before = pc.primary_caps.launches
    with torch.inference_mode():
        out = fn(x)
    assert pc.primary_caps.launches == before + 1
    assert bool(out["valid"].any())
    monkeypatch.setattr(capsule_net, "takes_k5", lambda *args: False)
    with torch.inference_mode():
        want = fn(x)["class_scores"]
    torch.cuda.synchronize()
    assert pc.primary_caps.launches == before + 1
    assert out["class_scores"].shape == (32, 16, 43)
    torch.testing.assert_close(out["class_scores"], want, rtol=0, atol=1e-5)


# ------------------------------------------------------------ --scan_epoch

SCAN = dict(n_classes=43, lr_runtime=1e-3, lr_decay=0.1, n_epochs=2,
            eval_every=1, train_frac=1, recon=True, recon_coef=5e-4,
            l_coord=5.0, l_noobj=0.5, n_boxes=1, n_grid=2, darknet_input=64,
            summary=False)


def _scan_runs(params, data, n_epochs=2, before_epoch=None):
    """``n_epochs`` train and eval epochs of a seed-0 Trainer on the card
    through the loop and captured (cuDNN deterministic); each returns
    every epoch's per-batch losses and outputs and the state after
    (weights, BN buffers, Adam's state, the generator's state), and the
    captured Trainer."""
    x, y, xe, ye = data
    runs = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for scan in ("off", "on"):
            params.scan_epoch = scan
            t = driver.Trainer(params, seed=0, device="cuda", verbose=False)
            assert t.scan_epoch == (scan == "on")
            np.random.seed(0)
            out = []
            for _ in range(n_epochs):
                if before_epoch is not None:
                    before_epoch()
                t.train_epoch(x, y, 1e-3, metric_on=False)
                out.append((t.last_losses.clone(), torch.cat(t.last_outputs)))
                t.eval_epoch(xe, ye, metric_on=False)
                out.append((t.last_losses.clone(), torch.cat(t.last_outputs)))
            torch.cuda.synchronize()
            state = steps.optimizer_state(t.opt)["state"]
            runs.append((out, {k: v.clone() for k, v in
                               t.model.state_dict().items()}, state,
                         None if t.generator is None
                         else t.generator.get_state(), t))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return runs


def _assert_equal_runs(runs):
    (oa, sa, aa, ga, _), (ob, sb, ab, gb, _) = runs
    for (la, ya), (lb, yb) in zip(oa, ob):
        assert torch.equal(la, lb) and torch.equal(ya, yb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for i in aa:
        for k in aa[i]:
            assert torch.equal(aa[i][k], ab[i][k]), (i, k)
    assert (ga is None and gb is None) or torch.equal(ga, gb)


def test_scan_capsule_k3_k4_matches_eager(card):
    """CapsuleNet at batch 17 over 50 crops (batches of 17, 17, 16: two
    graphs) through K3 and K4, shared memory filled with NaN before each
    epoch (so before the capture): the captured epochs equal the loop's
    to the bit, and the kernels' counts grow by one a replayed batch."""
    p = Params(**dict(SCAN, model="capsule", batch_size=17,
                      routing_impl="pallas"))
    data = loader.synthetic_dataset("capsule", p, 50, 20)
    before = _launches()
    runs = _scan_runs(p, data, before_epoch=lambda: _build.fill_shared_memory(
        float("nan")))
    _assert_equal_runs(runs)
    after = _launches()
    # the loop and the captured run: 2 epochs of 3 train + 2 eval batches
    assert tuple(a - b for a, b in zip(after, before)) == (0, 0, 20, 12)
    assert set(runs[1][4]._epochs) == {(True, 17, 2), (True, 16, 1),
                                       (False, 10, 2)}


def test_scan_launch_counts_under_replay(card):
    """`.launches` counts device launches under replay: a captured train
    epoch adds K3 and K4 once a batch, an eval epoch K3 once a batch,
    though the host calls the wrappers only at the capture."""
    p = Params(**dict(SCAN, model="capsule", batch_size=8,
                      routing_impl="pallas", scan_epoch="on"))
    x, y, xe, ye = loader.synthetic_dataset("capsule", p, 24, 16)
    t = driver.Trainer(p, seed=0, device="cuda", verbose=False)
    for epoch in range(3):
        routing.routed_capsules.launches = 0
        routing.routed_capsules_backward.launches = 0
        t.train_epoch(x, y, 1e-3, metric_on=False)
        assert (routing.routed_capsules.launches,
                routing.routed_capsules_backward.launches) == (3, 3), epoch
        t.eval_epoch(xe, ye, metric_on=False)
        assert routing.routed_capsules.launches == 5, epoch
    assert all(e.graph is not None for e in t._epochs.values())


def test_scan_dropout_masks_move_with_the_generator(card):
    """A captured darknet_r forward in training (64 px, dropout 0.5) on
    the same batch, replayed: each replay draws new masks (the outputs
    differ), the outputs equal the eager sequence's from the same seed,
    and so does the generator's state after."""
    x = torch.rand((2, 64, 64, 3), generator=card, device="cuda")
    table = torch.zeros((4, 2), dtype=torch.int64, device="cuda")
    table[:, 1] = 1
    y = torch.zeros((2,), device="cuda")
    outs, states = [], []
    for capture in (False, True):
        model = DarkNet(1, 43, dropout=0.5, seed=0).cuda().train()
        gen = torch.Generator(device="cuda").manual_seed(3)

        def step(xb, yb, model=model, gen=gen):
            with torch.no_grad():
                out = model(xb, generator=gen)
            return out.sum(), out, {}

        epoch = steps.Epoch(step, capture=steps.GraphCapture(
            torch.device("cuda"), [gen]) if capture else None)
        _, _, out = epoch(x, y, table)
        assert (epoch.graph is not None) == capture
        outs.append(out.clone())
        states.append(gen.get_state())
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(states[0], states[1])
    for i in range(1, 4):
        assert not torch.equal(outs[1][i], outs[1][i - 1]), i


def test_scan_remat_matches_eager_remat(card):
    """--remat --scan_epoch on against eager --remat: darknet_r at 64 px,
    dropout 0.5, batch 2 over 8 scenes (one eager batch, then 3 replays
    an epoch, 7 in all): equal to the bit, the generator's state too."""
    p = Params(**dict(SCAN, model="darknet_r", batch_size=2, dropout=0.5,
                      remat=True))
    x, y, xe, ye = loader.synthetic_dataset("darknet_r", p, 8, 4)
    rng = np.random.RandomState(0)
    data = (rng.uniform(-1, 1, x.shape).astype(np.float32), y,
            rng.uniform(-1, 1, xe.shape).astype(np.float32), ye)
    runs = _scan_runs(p, data)
    _assert_equal_runs(runs)
    assert runs[1][4].model.remat


def test_scan_bf16_capsule_eval_reads_current_weights(card):
    """bf16 CapsuleNet: after train replays (Adam moves the route weights
    inside the train graph, without a version bump) an eval replay's
    outputs equal an eager eval forward on the current weights, and the
    whole run equals the loop's."""
    p = Params(**dict(SCAN, model="capsule", batch_size=8,
                      routing_impl="pallas", compute_dtype="bfloat16"))
    data = loader.synthetic_dataset("capsule", p, 24, 8)
    runs = _scan_runs(p, data)
    _assert_equal_runs(runs)
    t = runs[1][4]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t.train_epoch(data[0], data[1], 1e-3, metric_on=False)
        t.eval_epoch(data[2], data[3], metric_on=False)
        got = t.last_outputs[0].clone()
        want = steps.eval_step(
            t.model, torch.from_numpy(data[2]).cuda(),
            torch.from_numpy(np.asarray(data[3], np.int64)).cuda(),
            t.loss_cfg, "capsule")[1]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert torch.equal(got, want)
