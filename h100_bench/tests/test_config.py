"""A configuration file is run as it says or refused: every key is read
or recorded, the dtype reaches the port, the widths are the port's, and
a training window whose losses go non-finite is not correct."""

import math
import time

import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import export
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import steps
from h100_bench import harness, traffic
from h100_bench.reference.common import control_tf32
from h100_bench.systems import capsule as scap
from h100_bench.systems import darknet as sdark
from h100_bench.tests.small import SEED, small_cell


def _job(name, **changes):
    cell = small_cell(name)
    cell.config.update(changes)
    sysmod = harness.system(cell.config["system"])
    kind = sysmod.Serve if cell.traffic["task"] == "serve" else sysmod.Train
    return kind(cell.config, cell.traffic, SEED, "cpu")


@pytest.mark.parametrize("name", ["darknet_r.serve", "capsule.serve",
                                  "capsule.train", "darknet_r.train"])
def test_a_key_no_system_reads_is_refused(name):
    with pytest.raises(ValueError, match="not honoured"):
        _job(name, anchors=5)


@pytest.mark.parametrize("name", ["darknet_r.serve", "capsule.train"])
def test_a_dtype_the_system_does_not_run_is_refused(name):
    with pytest.raises(ValueError, match="dtype"):
        _job(name, dtype="int8")


def test_the_detector_is_built_in_the_configuration_s_dtype(monkeypatch):
    seen = {}
    real = export.make_detector_fn

    def spy(model, **kw):
        seen["dtype"], seen["module"] = kw["dtype"], model.dtype
        return real(model, **kw)

    monkeypatch.setattr(export, "make_detector_fn", spy)
    _job("darknet_r.serve", dtype="bfloat16")
    assert seen == {"dtype": torch.bfloat16, "module": torch.bfloat16}


def test_the_classifier_is_built_in_the_configuration_s_dtype(monkeypatch):
    seen = {}
    real = export.make_classifier_fn

    def spy(model):
        seen["module"] = model.dtype
        return real(model)

    monkeypatch.setattr(export, "make_classifier_fn", spy)
    _job("capsule.serve", dtype="bfloat16")
    assert seen == {"module": torch.bfloat16}


def test_the_control_of_another_dtype_is_not_guessed():
    assert control_tf32({"dtype": "float32"}) is True
    with pytest.raises(NotImplementedError):
        control_tf32({"dtype": "bfloat16"})


@pytest.mark.parametrize("key,value", [("conv1_channels", 128),
                                       ("n_iter", 2),
                                       ("primary_stride", 1)])
def test_capsule_widths_other_than_the_port_s_are_refused(key, value):
    cell = small_cell("capsule.serve")
    cfg = {**cell.config, key: value}
    if key == "primary_stride":   # keep the nodes consistent with it
        cfg["routing_nodes"] = 16 * 17 * 17
    with pytest.raises(ValueError):
        scap.Serve(cfg, cell.traffic, SEED, "cpu")


def test_darknet_grid_must_follow_from_the_input():
    with pytest.raises(ValueError, match="n_grid"):
        sdark.honoured({**small_cell("darknet_r.serve").config,
                        "n_grid": 3})


def test_a_mix_key_the_generator_does_not_read_is_refused(tmp_path,
                                                          monkeypatch):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "odd.json").write_text(
        '{"task": "serve", "input": "crops", "crop": 32, "pool": 16, '
        '"burst": 4}')
    monkeypatch.setattr(traffic, "HERE", str(tmp_path))
    with pytest.raises(ValueError, match="burst"):
        traffic.load("odd")


def test_serving_calibration_is_left_out_of_setup():
    job = _job("darknet_r.serve")
    assert job.reference_s > 0


@pytest.mark.parametrize("name", ["capsule.train", "darknet_r.train"])
def test_a_loss_that_goes_non_finite_in_the_window(monkeypatch, name):
    """Steps past the set-up epoch's first three go NaN (the weights
    poisoned where they are produced): the comparison of the first
    three steps still passes, the window's count of losses does not."""
    real = steps.train_step
    calls = {"n": 0}

    def poisoned(model, opt, *a, **kw):
        calls["n"] += 1
        out = real(model, opt, *a, **kw)
        if calls["n"] > 4:
            with torch.no_grad():
                next(model.parameters()).fill_(math.nan)
        return out

    monkeypatch.setattr(steps, "train_step", poisoned)
    r = harness.run_cell(small_cell(name), SEED, 0.3, False, "cpu",
                         time.time())
    assert r["checks"]["grad_gap"]["value"] < r["checks"]["grad_gap"]["limit"]
    assert r["checks"]["nonfinite_loss"]["value"] > 0
    assert r["correct"] is False
