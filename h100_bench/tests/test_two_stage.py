"""The two_stage.fused cell on the CPU at a small size: a run with and
without a trace, its configuration run as it says or refused, the
faults `correct` has to catch, and the cell's own metrics read from the
port's spans and the device trace; the control and the fault at full
size on a card."""

import math
import time
import types

import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import (
    export, profiling)
from h100_bench import check, harness
from h100_bench.systems import two_stage as sys2
from h100_bench.tests.small import SEED, small_cell
from h100_bench.work import k3_work, roofline_s

CELL = "two_stage.fused"
NEW_METRICS = ("k3_roofline.two_stage", "tail_ms.two_stage",
               "crop_fill.two_stage")


def run(trace=False):
    profiling.clear()
    return harness.run_cell(small_cell(CELL), SEED, 0.3, trace, "cpu",
                            time.time())


@pytest.mark.parametrize("trace", [False, True])
def test_the_small_cell_runs_and_is_correct(trace):
    r = run(trace)
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["crops_scored"]["value"] > 0
    m = r["metrics"]
    if not trace:
        assert set(m) == {"serve_img_s", "serve_p95_ms", "setup_s"}
        return
    # the CPU has no K3 launch: its roofline alone reads nothing here
    for name in ("tail_ms.two_stage", "crop_fill.two_stage",
                 "setup_program_s", "setup_first_call_s", "mfu.serve"):
        assert math.isfinite(m[name]["value"]) and m[name]["value"] > 0
    assert "k3_roofline.two_stage" not in m
    assert 0 < m["crop_fill.two_stage"]["value"] <= 100
    names = [s.name for s in profiling.spans("cyt.tail")]
    assert names.count(profiling.TAIL) == r["attempted"]
    tail = next(s for s in profiling.spans(profiling.TAIL)
                if s.name == profiling.TAIL)
    cfg = small_cell(CELL).config
    assert tail.args == {"crops": cfg["batch_size"] * cfg["max_crops"]}


def test_a_key_the_system_does_not_read_is_refused():
    cell = small_cell(CELL)
    with pytest.raises(ValueError, match="not honoured"):
        sys2.Serve({**cell.config, "anchors": 5}, cell.traffic, SEED, "cpu")


def test_a_detector_grid_that_does_not_follow_is_refused():
    cell = small_cell(CELL)
    with pytest.raises(ValueError, match="n_grid"):
        sys2.honoured({**cell.config, "n_grid": 3}, "cpu")


def test_crops_cut_from_the_wrong_frame_are_not_correct(monkeypatch):
    """Half of each batch's crops cut from the next frame's image, where
    the program cuts them: the boxes still pass, the scores do not."""
    real = export._crops

    def shifted(x, d, cap_input):
        half = x.shape[0] // 2
        wrong = x.clone()
        wrong[half:] = x.roll(-1, 0)[half:]
        return real(wrong, d, cap_input)

    monkeypatch.setattr(export, "_crops", shifted)
    r = run()
    assert r["checks"]["box_px"]["value"] <= r["checks"]["box_px"]["limit"]
    assert r["correct"] is False
    assert r["checks"]["score_err"]["value"] > \
        r["checks"]["score_err"]["limit"]


def test_the_half_batch_fault_of_the_control_is_not_correct():
    cell = small_cell(CELL)
    correct, checks = check.judge(
        sys2.serve_control(cell.config, cell.traffic, SEED, "cpu",
                           fault="half"), cell.limits)
    assert correct is False, checks


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, "half"])
def test_the_control_and_the_fault_fail_the_limits_on_the_card(fault):
    """The full-size cell's control (the reference in TF32) and its
    half-batch fault, on one batch of the pool: each fails a limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is the reference in "
                    "TF32, which only the card computes")
    cell = harness.Cell(harness.load_spec(), CELL)
    cell.traffic.update({"pool": cell.config["batch_size"]})
    correct, checks = check.judge(
        sys2.serve_control(cell.config, cell.traffic, SEED, "cuda",
                           fault=fault), cell.limits)
    assert correct is False, checks


def _span(name, **args):
    return types.SimpleNamespace(name=name, args=args, seconds=0.004)


def test_the_cell_s_metrics_read_what_the_program_records(monkeypatch):
    cfg = small_cell(CELL).config
    ctx = types.SimpleNamespace(config=cfg, trace=types.SimpleNamespace(
        kernels=[("void routing_kernel<float>", 2e-3),
                 ("void other_kernel", 1.0)]))
    ctx.kernels = lambda *p: [(n, s) for n, s in ctx.trace.kernels
                              if any(q in n for q in p)]
    want = roofline_s(*k3_work(cfg["batch_size"] * cfg["max_crops"],
                               cfg["routing_nodes"], cfg["n_classes"],
                               cfg["n_iter"], cfg["in_dim"],
                               cfg["out_dim"])) / 2e-3 * 100
    assert harness.metric_reader("k3_roofline.two_stage")(ctx) == \
        pytest.approx(want)
    recorded = []
    monkeypatch.setattr(profiling, "spans", lambda prefix="": [
        s for s in recorded if s.name.startswith(prefix)])
    for name in NEW_METRICS[1:]:
        assert harness.metric_reader(name)(ctx) is None
    recorded += [_span("cyt.tail", crops=32), _span("cyt.tail.crop"),
                 _span("cyt.tail", crops=32), _span("cyt.fetch", images=4,
                                                     boxes=6),
                 _span("cyt.fetch", images=4, boxes=2)]
    assert harness.metric_reader("tail_ms.two_stage")(ctx) == \
        pytest.approx(4.0)
    assert harness.metric_reader("crop_fill.two_stage")(ctx) == \
        pytest.approx(12.5)
    ctx.trace.kernels = []
    assert harness.metric_reader("k3_roofline.two_stage")(ctx) is None
