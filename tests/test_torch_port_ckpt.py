"""PyTorch port, checkpoints under scale-out (CPU): the asynchronous
writer (round trip, a worker's error, the flush on an exception), the
--ckpt_every write pattern against the JAX driver's, a checkpoint of a
data=1,model=2 darkcapsule run (route weights split over the nodes)
restored on one process and on two, and darknet_r predict under --mesh
data=2 equal to single-process (tiny models: 64 px / n_grid 2, batch
8)."""

import json
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu.params import (
    Params as JaxParams)
from cs231_capsule_yolo_traffic_sign_detection_tpu.train import (
    checkpoint as jax_ckpt, driver as jax_driver)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import (
    __main__ as cli)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
    DarkNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    checkpoint as ckpt, driver)


@pytest.fixture(autouse=True)
def _two_threads(monkeypatch):
    """Two CPU threads a process for this file's runs and the ranks they
    spawn: the suite's workers share the machine's cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_async_checkpointer_round_trip(tmp_path):
    """A queued save holds the state as it was when saved (the optimizer
    updates in place), writes last and best, and equals a sync save."""
    w = torch.arange(6.0).reshape(2, 3)
    state = {"epoch": 1, "state_dict": {"w": w},
             "optim_dict": {"state": {0: {"exp_avg": w * 2}}}}
    writer = ckpt.AsyncCheckpointer()
    writer.save(state, True, str(tmp_path / "a"))
    w.add_(100.0)                       # the next step, in place
    writer.flush()
    ckpt.save_checkpoint(dict(state, state_dict={"w": w - 100.0},
                              optim_dict={"state": {0: {
                                  "exp_avg": (w - 100.0) * 2}}}),
                         True, str(tmp_path / "b"))
    for name in ("last.ckpt", "best.ckpt"):
        got = ckpt.load_checkpoint(str(tmp_path / "a" / name))
        want = ckpt.load_checkpoint(str(tmp_path / "b" / name))
        assert torch.equal(got["state_dict"]["w"], want["state_dict"]["w"])
        assert torch.equal(got["state_dict"]["w"],
                           torch.arange(6.0).reshape(2, 3))
        assert torch.equal(got["optim_dict"]["state"][0]["exp_avg"],
                           want["optim_dict"]["state"][0]["exp_avg"])
    with pytest.raises(RuntimeError, match="after flush"):
        writer.save(state, False, str(tmp_path / "a"))


def test_async_checkpointer_surfaces_worker_errors(tmp_path):
    """A write that fails on the worker raises at the next save; one at
    the end raises at the flush."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    writer = ckpt.AsyncCheckpointer()
    writer.save({"epoch": 1}, False, str(blocker / "sub"))
    writer._q.join()
    with pytest.raises(OSError):
        writer.save({"epoch": 2}, False, str(tmp_path / "ok"))
    writer.save({"epoch": 3}, False, str(blocker / "sub"))
    with pytest.raises(OSError):
        writer.flush()


class _Scripted:
    """A Trainer stand-in: the eval metric of each epoch from a script."""

    metrics = []
    raise_at = None

    def __init__(self, *a, **kw):
        self.stream, self.epoch = False, 0

    def train_epoch(self, x, y, lr, metric_on=True, progress=None):
        return 1.0, 0.0

    def eval_epoch(self, x, y, metric_on=True):
        self.epoch += 1
        if self.epoch == self.raise_at:
            raise KeyboardInterrupt("stopped mid-training")
        return 1.0, self.metrics[self.epoch - 1]

    def state_dict(self, epoch, plateau):
        return {"epoch": epoch, "state_dict": {"w": torch.full((2,),
                                                               float(epoch))}}


METRICS = [0.1, 0.3, 0.2, 0.2, 0.5, 0.4, 0.45]
RUN = dict(model="cnn", n_classes=43, batch_size=64, n_epochs=len(METRICS),
           lr_runtime=1e-3, lr_decay=0.1, eval_every=1, train_frac=1,
           summary=False, dropout=0.0)


@pytest.mark.parametrize("every,async_ckpt", [(1, False), (3, False),
                                               (2, True), (3, True)])
def test_ckpt_every_writes_jax_pattern(tmp_path, monkeypatch, every,
                                       async_ckpt):
    """--ckpt_every N (sync and --async_ckpt): the epochs written and
    their best flags are those of the JAX driver's rule on the same
    metrics (last every Nth epoch and on the final one, best whenever the
    metric improves); the files hold the last such epoch."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(_Scripted, "metrics", METRICS)
    calls = {"jax": [], "port": []}

    def spy(tag, inner):
        def save(state, is_best, checkpoint_dir):
            calls[tag].append((state["epoch"], bool(is_best)))
            if inner is not None:
                inner(state, is_best, checkpoint_dir)
        return save

    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    monkeypatch.setattr(jax_driver, "Trainer", _Scripted)
    monkeypatch.setattr(jax_ckpt, "save_checkpoint", spy("jax", None))
    jax_driver.train_and_evaluate(
        JaxParams(**RUN, ckpt_every=every), "data/GTSRB", "jax",
        progress=False)
    monkeypatch.setattr(driver, "Trainer", _Scripted)
    monkeypatch.setattr(ckpt, "save_checkpoint",
                        spy("port", ckpt.save_checkpoint))
    driver.train_and_evaluate(
        Params(**RUN, ckpt_every=every, async_ckpt=async_ckpt),
        "data/GTSRB", str(tmp_path / "port"), device="cpu", progress=False)
    assert calls["port"] == calls["jax"]
    assert [e for e, _ in calls["jax"]] == (
        list(range(1, 8)) if every == 1 else
        sorted({1, 2, 5, 7} | set(range(every, 8, every))))
    last = ckpt.load_checkpoint(str(tmp_path / "port1" / "last.ckpt"))
    best = ckpt.load_checkpoint(str(tmp_path / "port1" / "best.ckpt"))
    assert last["epoch"] == 7 and best["epoch"] == 5


def test_async_flush_runs_when_training_fails(tmp_path, monkeypatch):
    """An exception in epoch 3 still lands the queued checkpoints on disk
    (the flush in the driver's finally) before it propagates."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(_Scripted, "metrics", METRICS)
    monkeypatch.setattr(_Scripted, "raise_at", 3)
    monkeypatch.setattr(driver, "Trainer", _Scripted)
    (tmp_path / "run").mkdir()
    with pytest.raises(KeyboardInterrupt):
        driver.train_and_evaluate(
            Params(**RUN, async_ckpt=True), "data/GTSRB",
            str(tmp_path / "run"), device="cpu", progress=False)
    last = ckpt.load_checkpoint(str(tmp_path / "run1" / "last.ckpt"))
    assert last["epoch"] == 2
    assert torch.equal(last["state_dict"]["w"], torch.full((2,), 2.0))


# darkcapsule cut to n_grid 2 (64 px): its route weights' 512 nodes split
# over the model axis
DARKCAPSULE = {"batch_size": 8, "n_epochs": 1, "l_coord": 5, "l_noobj": 0.5,
               "n_boxes": 2, "n_classes": 43, "darknet_input": 64,
               "capsule_input": 32, "n_grid": 2, "lr_decay": 0.1}


def _train(d, *extra):
    cli.main(["--model", "darkcapsule", "--mode", "train", "--device",
              "cpu", "--no_metric", "--train_frac", "0.25", "--model_dir",
              str(d), *extra])
    return np.load(d / "losses_tr.npy"), np.load(d / "losses_ev.npy")


def test_tp_checkpoint_restores_on_one_process_and_two(tmp_path,
                                                       monkeypatch):
    """darkcapsule under --mesh data=1,model=2 (the route weights' 512
    nodes split over two spawned ranks) with --async_ckpt --ckpt_every 2:
    rank 0 writes one checkpoint holding the whole route weights and
    Adam moments; it resumes on one process and on two (cut to each
    rank's nodes) to the same losses (JAX's rtol 1e-3,
    tests/test_multiprocess.py:261), both below the cold run's."""
    monkeypatch.chdir(tmp_path)
    base = tmp_path / "cap"
    base.mkdir()
    (base / "params.json").write_text(json.dumps(DARKCAPSULE))
    cold_tr, _ = _train(base, "--mesh", "data=1,model=2", "--async_ckpt",
                        "--ckpt_every", "2")
    raw = ckpt.load_checkpoint(str(base) + "0.25/last.ckpt")
    key = "traffic_sign_capsules.route_weights"
    assert raw["state_dict"][key].shape == (1, 512, 1, 8, 5)
    moments = [st["exp_avg"] for st in raw["optim_dict"]["state"].values()
               if st["exp_avg"].shape == (1, 512, 1, 8, 5)]
    assert len(moments) == 1 and moments[0].abs().max() > 0

    resumed = {}
    for tag, mesh in (("one", "off"), ("two", "data=1,model=2")):
        d = tmp_path / tag
        d.mkdir()
        (d / "params.json").write_text(json.dumps(DARKCAPSULE))
        os.makedirs(str(d) + "0.25")
        os.link(str(base) + "0.25/last.ckpt", str(d) + "0.25/last.ckpt")
        resumed[tag] = _train(d, "--mesh", mesh, "--restore", "last")
        shutil.rmtree(str(d) + "0.25")
    for a, b in zip(resumed["two"], resumed["one"]):
        np.testing.assert_allclose(a, b, rtol=1e-3)
    assert resumed["one"][0][0] < cold_tr[0]


DARK = {"batch_size": 8, "n_classes": 43, "n_boxes": 1, "n_grid": 2,
        "darknet_input": 64, "capsule_input": 32, "lr": 1e-3,
        "n_epochs": 1, "dropout": 0.0, "lr_decay": 0.1, "l_coord": 5,
        "l_noobj": 0.5}


def test_predict_under_mesh_equals_single(tmp_path, monkeypatch, capfd):
    """darknet_r predict (K2 and K1's plain versions) under --mesh data=2,
    each rank serving its 4 frames of each batch of 8: the metric file
    and every annotated frame equal the single-process run's, and only
    rank 0 prints the metrics."""
    monkeypatch.chdir(tmp_path)
    outputs = {}
    ckpt.save_checkpoint({"epoch": 0, "optim_dict": {}, "state_dict":
                          DarkNet(n_boxes=1, n_classes=43,
                                  seed=3).state_dict()}, False,
                         str(tmp_path / "weights"))
    for tag, mesh in (("off", "off"), ("mesh", "data=2")):
        d = pathlib.Path(tmp_path / tag)
        d.mkdir()
        (d / "params.json").write_text(json.dumps(DARK))
        os.link(tmp_path / "weights" / "last.ckpt", d / "last.ckpt")
        cli.main(["--model", "darknet_r", "--mode", "predict", "--restore",
                  "last", "--device", "cpu", "--model_dir", str(d),
                  "--mesh", mesh])
        assert capfd.readouterr().out.count("detect_acc:") == 1
        frames = sorted(os.listdir(d / "output"))
        outputs[tag] = ((d / "metric_output.txt").read_text(),
                        [(d / "output" / f).read_bytes() for f in frames])
        assert len(frames) == 16
    assert outputs["mesh"] == outputs["off"]
