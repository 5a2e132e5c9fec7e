"""PyTorch port, the darknet_r training slice (CPU), part 2: the Trainer
against the JAX Trainer, its bf16 dataset and its dropout generator, the
fine-tune branch, and the train/overfit CLI then predict, at 64 px
(n_grid 2)."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu.params import (
    Params as JaxParams)
from cs231_capsule_yolo_traffic_sign_detection_tpu.train import (
    driver as jax_driver, steps as jax_steps)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import loader
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.interop import (
    jax_variables_to_state_dict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    checkpoint as ckpt, driver, steps)

from torch_port_helpers import write_darknet19_npz

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cs231_capsule_yolo_traffic_sign_detection_tpu_torch"
# darknet_r's config (experiments/darknet_r/params.json) cut to 64 px
TRAIN = dict(model="darknet_r", n_boxes=1, n_classes=43, n_grid=2,
             darknet_input=64, l_coord=5.0, l_noobj=0.5, batch_size=4,
             dropout=0.0, lr_runtime=1e-3, lr_decay=0.5, n_epochs=3,
             eval_every=1, train_frac=1, summary=False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------- Trainer

def test_trainer_trajectory_matches_jax():
    """Three epochs from the JAX trainer's initial weights with the same
    np.random.seed (so the same batches), dropout 0, both trainers'
    models in f64 (the data stays f32): in f32 the trajectories part by
    about 1% in three epochs, as Adam's first steps follow the sign of
    each gradient component and flax's f32 BatchNorm gradient is off by
    up to 4% (tests/test_torch_port_darknet_train.py)."""
    jp, p = JaxParams(**TRAIN), Params(**TRAIN)
    x_tr, y_tr, x_ev, y_ev = loader.synthetic_dataset("darknet_r", p, 8, 4)
    jtrainer = jax_driver.Trainer(jp, seed=0, verbose=False)
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), jtrainer.state.variables)
    jtrainer.state = jtrainer.state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jax_steps.make_optimizer().init(variables["params"]))
    trainer = driver.Trainer(p, seed=0, device="cpu", verbose=False)
    trainer.model.double().load_state_dict(jax_variables_to_state_dict(
        _np(variables), "darknet_r"))
    trainer.model.dtype = torch.float64
    trainer.opt = steps.make_optimizer(trainer.model)
    got, want = [], []
    for t, out in ((jtrainer, want), (trainer, got)):
        np.random.seed(0)
        for _ in range(3):
            loss_tr, metric_tr = t.train_epoch(x_tr, y_tr, 1e-3,
                                               metric_on=True)
            iou_tr = t.last_avg_iou
            loss_ev, metric_ev = t.eval_epoch(x_ev, y_ev, metric_on=True)
            out.append((loss_tr, loss_ev, iou_tr, t.last_avg_iou,
                        metric_tr, metric_ev))
    got, want = np.array(got), np.array(want)
    assert want[-1, 0] < want[0, 0] and got[-1, 0] < got[0, 0]
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=1e-6)
    np.testing.assert_array_equal(got[:, 4:], want[:, 4:])


def test_trainer_bf16_keeps_its_images_in_bf16():
    p = Params(**dict(TRAIN, compute_dtype="bfloat16", dropout=0.5))
    x, y, _, _ = loader.synthetic_dataset("darknet_r", p, 4, 0)
    trainer = driver.Trainer(p, seed=3, device="cpu", verbose=False)
    np.random.seed(0)
    loss, _ = trainer.train_epoch(x, y, 1e-3, metric_on=False)
    (x_dev, y_dev), = trainer._data.values()
    assert x_dev.dtype == torch.bfloat16 and y_dev.dtype == torch.float32
    assert np.isfinite(loss) and 0 <= trainer.last_avg_iou <= 1


def test_same_seed_same_dropout_other_seed_other():
    p = Params(**dict(TRAIN, dropout=0.5))
    x, y, _, _ = loader.synthetic_dataset("darknet_r", p, 8, 0)
    losses = []
    for seed in (4, 4, 5):
        trainer = driver.Trainer(p, seed=seed, device="cpu", verbose=False)
        trainer.model.load_state_dict(
            driver.Trainer(p, seed=4, device="cpu",
                           verbose=False).model.state_dict())
        np.random.seed(0)
        losses.append(trainer.train_epoch(x, y, 1e-3, metric_on=False)[0])
    assert losses[0] == losses[1] != losses[2]


# ---------------------------------------------------------------- fine-tune

def test_fine_tune_through_the_trainer(tmp_path, capsys):
    """params.do_fine_tune with the npz present: loaded, blocks 1..18
    frozen and out of Adam, the head trains; BN statistics move."""
    path = str(tmp_path / "darknet19_weights.npz")
    arrs = write_darknet19_npz(path)
    p = Params(**dict(TRAIN, do_fine_tune=True, fine_tune=18,
                      pretrained_weights=path, summary=True))
    trainer = driver.Trainer(p, seed=0, device="cpu")
    out = capsys.readouterr().out
    assert f"Load weights from {path}" in out and "Frozen params" in out
    assert len(trainer.opt.param_groups[0]["params"]) == 1
    x, y, _, _ = loader.synthetic_dataset("darknet_r", p, 8, 0)
    head = trainer.model.model.conv_19.weight.detach().clone()
    np.random.seed(0)
    trainer.train_epoch(x, y, 1e-3, metric_on=False)
    sd = trainer.model.state_dict()
    np.testing.assert_array_equal(
        sd["model.conv_18.weight"].numpy(),
        arrs["17-scope/kernel:0"].transpose(3, 2, 0, 1))
    assert not torch.equal(sd["model.conv_19.weight"], head)
    assert not np.array_equal(sd["model.bn_1.running_mean"].numpy(),
                              arrs["0-scope/moving_mean:0"])


def test_fine_tune_without_the_npz_trains_from_scratch(tmp_path, capsys):
    missing = str(tmp_path / "absent.npz")
    p = Params(**dict(TRAIN, do_fine_tune=True, fine_tune=5,
                      pretrained_weights=missing))
    trainer = driver.Trainer(p, seed=0, device="cpu", verbose=False)
    assert (f"[fine_tune] pretrained weights {missing!r} not found; "
            "training from scratch") in capsys.readouterr().out
    frozen = [n for n, q in trainer.model.named_parameters()
              if not q.requires_grad]
    assert len(frozen) == 15 and frozen[-1] == "model.bn_5.bias"


# ---------------------------------------------------------------- CLI

def test_cli_overfit_then_predict(tmp_path):
    """--mode overfit with dropout and the --fine_tune switch (no npz
    here: it trains from scratch with blocks 1..18 frozen), then
    --mode predict --restore last finds the checkpoint."""
    model_dir = tmp_path / "darknet_r"
    model_dir.mkdir()
    Params(**dict(TRAIN, batch_size=32, n_epochs=2, fine_tune=18,
                  dropout=0.5, summary=True)).save(
                      str(model_dir / "params.json"))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    base = [sys.executable, "-m", PORT.name, "--model", "darknet_r",
            "--device", "cpu", "--model_dir", str(model_dir)]
    res = subprocess.run(base + ["--mode", "overfit", "--fine_tune", "1",
                                 "--dropout", "0.25"],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "3 train / 3 eval" in res.stdout
    assert "not found; training from scratch" in res.stdout
    assert "Frozen params" in res.stdout
    assert res.stdout.count("epoch ") == 2
    raw = ckpt.load_checkpoint(str(tmp_path / "darknet_r1" / "last.ckpt"))
    assert raw["epoch"] == 2 and set(raw) == {
        "epoch", "state_dict", "optim_dict", "plateau"}
    assert len(raw["optim_dict"]["param_groups"][0]["params"]) == 1
    assert (tmp_path / "darknet_r1" / "best.ckpt").exists()
    assert len(np.load(model_dir / "losses_tr.npy")) == 2
    res = subprocess.run(base + ["--mode", "predict", "--restore", "last"],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    text = (model_dir / "metric_output.txt").read_text()
    assert "detect_AP" in text and "detect_acc" in text
