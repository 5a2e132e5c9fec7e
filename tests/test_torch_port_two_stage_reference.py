"""The benchmark's plain two-stage reference (h100_bench/reference/
two_stage.py) against the port's fused two-stage fn
(`export.make_two_stage_fn`) on the CPU at 64 px, n_grid 2, batch 2:
the served boxes, the crops and the CapsuleNet scores; the reference's
crop sampler against `ops/crop.py:crop_resize_bilinear` at integer pixel
edges; the fused tail's spans and counts (`profiling`); and the serving
entries' f32 policy on the host."""

import numpy as np
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import (
    export, profiling)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
    CapsuleNet, DarkNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import decode
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops.crop import \
    crop_resize_bilinear
from h100_bench.reference import two_stage as ref
from h100_bench.traffic import center
from h100_bench.systems import capsule as scap
from h100_bench.systems import darknet as sdark

CPU = [torch.profiler.ProfilerActivity.CPU]
CFG = {"darknet_input": 64, "n_grid": 2, "n_boxes": 1, "n_classes": 43,
       "batch_size": 2, "conf_th": 0.5, "capsule_input": 32, "n_iter": 3,
       "in_dim": 8, "out_dim": 16, "conv1_channels": 256, "conv1_kernel": 9,
       "primary_caps": 8, "primary_channels": 16, "primary_kernel": 8,
       "routing_nodes": 1296}
# the port's CapsuleNet (plain routing) against the reference's on the
# same crops: test_reference.py's band for CapsuleNet
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-7
# boxes: the serving forward's band against the reference (2e-5 of the
# grid, test_reference.py) times 64 px is 1.3e-3 px; read 1.0e-3
BOX_ATOL = 5e-3


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def setup():
    """Two 64-px frames, a detector calibrated on them (about two of each
    frame's four candidates over conf_th) and a seeded CapsuleNet, as
    state_dicts and as the port's modules."""
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (2, 64, 64, 3), generator=g).float()
    det_sd = sdark.calibrate(sdark.make_state(CFG, 5, "cpu"), x, CFG, 2.0, 5)
    cls_sd = scap.make_state(CFG, 6, "cpu")
    det = DarkNet(n_boxes=1, n_classes=43)
    det.load_state_dict(det_sd)
    cls = CapsuleNet(n_classes=43, routing_impl="xla")
    cls.load_state_dict(cls_sd)
    return x, det_sd, cls_sd, det.eval(), cls.eval()


def _fn(setup, max_crops):
    _, _, _, det, cls = setup
    return export.make_two_stage_fn(det, cls, n_boxes=1, n_classes=43,
                                    img_size=64, max_crops=max_crops,
                                    conf_th=0.5)


@pytest.mark.parametrize("max_crops", [4, 2])
def test_the_reference_serves_what_the_fused_fn_serves(setup, max_crops):
    x, det_sd, cls_sd, _, _ = setup
    cfg = {**CFG, "max_crops": max_crops}
    with torch.no_grad():
        conf = ref.candidates(det_sd, x, 1, 43)[0]
        # well posed: no candidate within rounding of conf_th
        assert float((conf - 0.5).abs().min()) > 1e-4
        frame, boxes, cls, scores = ref.pipeline(det_sd, cls_sd, x, cfg)
        out = _fn(setup, max_crops)(x)
        (img, xy, classes), extras = decode.to_flat_host_with_extras(
            out, {"scores": out["class_scores"]}, img_size=64)
        crops = export._crops(x, out, 32).reshape(2, max_crops, 32, 32, 3)
    assert 0 < len(frame) <= 2 * max_crops
    np.testing.assert_array_equal(img, frame)
    np.testing.assert_array_equal(classes, cls)
    np.testing.assert_allclose(xy, boxes, rtol=0, atol=BOX_ATOL)
    # the crops the classifier took and its scores: the reference's at
    # the served boxes (as the benchmark holds them), zeros at every slot
    # not served
    img_t, xy_t = torch.from_numpy(img), torch.from_numpy(xy)
    with torch.no_grad():
        want_scores = ref.crop_scores(cls_sd, x, img_t, xy_t, 32, 3)
    np.testing.assert_allclose(extras["scores"], want_scores,
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-3)
    valid = out["valid"]
    want = center(ref.crop_resize(x, img_t, xy_t, 32))
    got = []
    for i in range(2):    # the served order: grid-scan within a frame
        slots = torch.nonzero(valid[i]).flatten()
        got.append(crops[i, slots[torch.argsort(out["idx"][i][slots])]])
    np.testing.assert_allclose(torch.cat(got), want, rtol=0, atol=1e-4)
    assert torch.all(crops[~valid] == -1.0)    # a zero crop, centred


# sizes that divide the windows' widths in binary (the classifier's 32):
# there the sample coordinates are exact in f32 in both samplers; at 7
# the port's f32 coordinate is an ulp off (up to 1e-3 of 255)
@pytest.mark.parametrize("out", [32, 16])
def test_the_reference_sampler_is_the_port_s(out):
    g = torch.Generator().manual_seed(1)
    images = torch.rand((2, 40, 56, 3), generator=g) * 255
    boxes = torch.tensor([
        [[10.0, 5.0, 30.0, 25.0],             # on integer edges
         [9.9999, 5.0001, 30.0001, 24.9999],  # beside them
         [-3.5, -1.0, 12.0, 8.0],             # truncated toward zero
         [20.0, 20.0, 20.5, 30.0]],           # empty: x2 truncates to x1
        [[50.0, 30.0, 70.0, 45.0],            # clipped at the far edges
         [60.0, 10.0, 80.0, 20.0],            # wholly outside: empty
         [0.5, 0.5, 55.99, 39.99],            # nearly the whole image
         [3.0, 4.0, 5.0, 6.0]]])              # masked out by valid
    valid = torch.ones(2, 4, dtype=torch.bool)
    valid[1, 3] = False
    got = crop_resize_bilinear(images, boxes, out, valid)
    frame = torch.arange(2).repeat_interleave(4)
    want = ref.crop_resize(images, frame, boxes.reshape(8, 4), out)
    want[7] = 0.0                              # the reference skips it
    np.testing.assert_allclose(got.reshape(8, out, out, 3), want, rtol=0,
                               atol=1e-4)
    assert float(want[[3, 5, 7]].abs().max()) == 0.0
    assert float(want[[0, 1, 2, 4, 6]].abs().amin((1, 2, 3)).min()) > 0


def test_the_tail_records_its_spans_and_counts_only_traced(setup):
    x = setup[0]
    fn = _fn(setup, 4)
    with torch.no_grad():
        fn(x)
        profiling.clear()
        out = fn(x)
        decode.to_flat_host_with_extras(out, {"s": out["class_scores"]},
                                        img_size=64)
        assert profiling.spans() == []
        with torch.profiler.profile(activities=CPU):
            out = fn(x)
            (img, _, _), _ = decode.to_flat_host_with_extras(
                out, {"s": out["class_scores"]}, img_size=64)
    spans = profiling.spans()
    tail, = [s for s in spans if s.name == profiling.TAIL]
    crop, = [s for s in spans if s.name == profiling.TAIL_CROP]
    classify, = [s for s in spans if s.name == profiling.TAIL_CLASSIFY]
    fetch, = [s for s in spans if s.name == profiling.FETCH]
    assert tail.args == {"crops": 2 * 4}
    assert crop.parent is tail and classify.parent is tail
    assert crop.seq < classify.seq and tail.parent is None
    assert fetch.args == {"images": 2, "boxes": len(img)}
    assert 0 < len(img) == int(out["valid"].sum())


def test_the_fused_fn_records_its_set_up(setup):
    fn = _fn(setup, 2)
    assert [s.name for s in profiling.spans()] == [profiling.SETUP_PREPARE]
    with torch.no_grad():
        fn(setup[0])
        fn(setup[0])
    assert [s.name for s in profiling.spans()] == [
        profiling.SETUP_PREPARE, profiling.SETUP_FIRST_CALL]


def test_a_model_on_the_host_leaves_tf32_as_it_was(setup):
    """`device.keep_f32` acts on a card's models only (the card's side:
    test_torch_port_cuda.py)."""
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        _fn(setup, 2)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = saved
