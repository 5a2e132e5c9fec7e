"""A run on the CPU with the timed path broken underneath, for each
fault a cell can have: `correct` has to come out false (and true with
nothing broken).  The harness's look for a card is skipped; everything
else of a run is driven at a small size."""

import time

import numpy as np
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import export
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import decode
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import steps
from h100_bench import harness
from h100_bench.tests.small import SEED, small_cell


def run(name):
    return harness.run_cell(small_cell(name), SEED, 0.3, False, "cpu",
                            time.time())


@pytest.mark.parametrize("name", ["darknet_r.serve", "capsule.serve",
                                  "capsule.train", "darknet_r.train"])
def test_unbroken_runs_are_correct(name):
    r = run(name)
    assert r["correct"] is True, r["checks"]


def test_darknet_serving_box_altered_where_produced(monkeypatch):
    real = decode.to_flat_host

    def moved(*a, **kw):
        img, xy, cls = real(*a, **kw)
        xy = xy.copy()
        xy[:1] += 2.0   # one box of each batch moved by 2 px
        return img, xy, cls

    monkeypatch.setattr(decode, "to_flat_host", moved)
    r = run("darknet_r.serve")
    assert r["correct"] is False and r["checks"]["box_px"]["value"] >= 2.0


def test_darknet_serving_class_altered_where_produced(monkeypatch):
    real = decode.to_flat_host

    def relabelled(*a, **kw):
        img, xy, cls = real(*a, **kw)
        cls = cls.copy()
        cls[:1] = (cls[:1] + 1) % 43
        return img, xy, cls

    monkeypatch.setattr(decode, "to_flat_host", relabelled)
    r = run("darknet_r.serve")
    assert r["correct"] is False and r["checks"]["class_flip"]["value"] > 0


def test_capsule_serving_answer_altered_where_produced(monkeypatch):
    real = export.make_classifier_fn

    def make(model):
        fn = real(model)

        def altered(x):
            scores, ids = fn(x)
            return scores, torch.cat([(ids[:1] + 1) % 43, ids[1:]])
        return altered

    monkeypatch.setattr(export, "make_classifier_fn", make)
    r = run("capsule.serve")
    assert r["correct"] is False and r["checks"]["class_flip"]["value"] > 0


def test_capsule_serving_scores_altered_where_produced(monkeypatch):
    real = export.make_classifier_fn

    def make(model):
        fn = real(model)

        def altered(x):
            scores, ids = fn(x)
            return scores * 1.01, ids
        return altered

    monkeypatch.setattr(export, "make_classifier_fn", make)
    assert run("capsule.serve")["correct"] is False


@pytest.mark.parametrize("name", ["capsule.train", "darknet_r.train"])
def test_a_step_that_leaves_the_state_unchanged(monkeypatch, name):
    real = steps.train_step

    def unchanged(model, opt, *a, **kw):
        before = [p.detach().clone() for p in model.parameters()]
        out = real(model, opt, *a, **kw)
        with torch.no_grad():
            for p, b in zip(model.parameters(), before):
                p.copy_(b)
        return out

    monkeypatch.setattr(steps, "train_step", unchanged)
    r = run(name)
    assert r["correct"] is False
    assert r["checks"]["delta_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["capsule.train", "darknet_r.train"])
def test_half_of_the_batch_left_out(monkeypatch, name):
    real = steps.train_step

    def half(model, opt, x, y, *a, **kw):
        n = x.shape[0] // 2
        return real(model, opt, x[:n], y[:n], *a, **kw)

    monkeypatch.setattr(steps, "train_step", half)
    r = run(name)
    assert r["correct"] is False
    assert np.isfinite(r["checks"]["grad_gap"]["value"])
