"""PyTorch port: its checkpoints carried into the JAX package (CPU).  A
port trainer's last.ckpt, darknet_r and capsule, goes through the JAX
package's own `convert_torch_checkpoint` into a TrainState whose eval
forward matches the port's and whose Adam moments are the port's; a
fine-tuned checkpoint's optimizer state (the head only) is refused, with
the reason the JAX function prints."""

import os

import numpy as np
import jax
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu import (
    interop as jax_interop)
from cs231_capsule_yolo_traffic_sign_detection_tpu.params import (
    Params as JaxParams)
from cs231_capsule_yolo_traffic_sign_detection_tpu.train import (
    driver as jax_driver)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import loader
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.interop import (
    jax_variables_to_state_dict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    checkpoint as ckpt, driver, plateau)

# darknet_r's and capsule's configs (experiments/*/params.json) cut to
# 64 px / 8 samples
DARKNET = dict(model="darknet_r", n_boxes=1, n_classes=43, n_grid=2,
               darknet_input=64, l_coord=5.0, l_noobj=0.5, batch_size=4,
               dropout=0.0, lr_runtime=1e-3, lr_decay=0.5, n_epochs=1,
               eval_every=1, train_frac=1, summary=False)
CAPSULE = dict(model="capsule", n_classes=43, batch_size=4, capsule_input=32,
               lr_runtime=1e-3, lr_decay=0.1, n_epochs=1, eval_every=1,
               train_frac=1, recon=True, recon_coef=5e-4, summary=False)
N_DARKNET_PARAMS = 18 * 3 + 1   # conv + BN scale and bias, then the head


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_checkpoint(cfg, path, seed=1, epochs=1):
    """A port trainer's last.ckpt after ``epochs`` epochs of 8 samples;
    returns (trainer, checkpoint dict)."""
    p = Params(**cfg)
    trainer = driver.Trainer(p, seed=seed, device="cpu", verbose=False)
    x, y, _, _ = loader.synthetic_dataset(cfg["model"], p, 8, 0)
    np.random.seed(0)
    for _ in range(epochs):
        trainer.train_epoch(x, y, 1e-3, metric_on=False)
    ckpt.save_checkpoint(trainer.state_dict(epochs, plateau.ReduceLROnPlateau(
        lr=1e-3)), False, path)
    return trainer, ckpt.load_checkpoint(os.path.join(path, "last.ckpt"))


@pytest.mark.parametrize("cfg", [DARKNET, CAPSULE], ids=["darknet_r",
                                                       "capsule"])
def test_port_checkpoint_converts_into_jax(tmp_path, cfg, capsys):
    """convert_torch_checkpoint reads the port's last.ckpt into a JAX
    TrainState: the eval forward matches the port's, the Adam moments
    are the port's."""
    name = cfg["model"]
    trainer, raw = _port_checkpoint(cfg, str(tmp_path / "port"))
    out = jax_interop.convert_torch_checkpoint(
        str(tmp_path / "port" / "last.ckpt"), JaxParams(**cfg),
        str(tmp_path / "jax"))
    assert "[interop] Adam moments converted (step=2)" in \
        capsys.readouterr().out
    jtrainer = jax_driver.Trainer(JaxParams(**cfg), seed=7, verbose=False)
    jtrainer.restore(out)
    state = jtrainer.state
    size = 32 if name == "capsule" else 64
    x = np.random.RandomState(2).uniform(-1, 1, (3, size, size, 3)).astype(
        np.float32)
    want = np.asarray(jtrainer.model.apply(state.variables, x, train=False))
    with torch.no_grad():
        got = trainer.model.eval()(torch.from_numpy(x)).numpy()
    # f32 sums in another order (the eval-forward bands of
    # tests/test_torch_port_model.py and tests/test_torch_port_capsule.py)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # the moments, back in the port's layout, are the port's
    sd = {k: v.numpy() for k, v in raw["state_dict"].items()}
    mu, nu, count = jax_interop.torch_optim_to_adam_moments(
        raw["optim_dict"], sd, name)
    assert count == int(state.opt_state.count) == int(state.step) == 2
    stats = {"batch_stats": _np(state.batch_stats)} if state.batch_stats \
        else {}
    for key, tree in (("exp_avg", state.opt_state.mu),
                      ("exp_avg_sq", state.opt_state.nu)):
        mapped = jax_variables_to_state_dict(
            dict(stats, params=_np(tree)), name)
        for pname, p in trainer.model.named_parameters():
            np.testing.assert_array_equal(
                mapped[pname].numpy(), trainer.opt.state[p][key].numpy(),
                err_msg=f"{key} {pname}")
    assert set(mu) == set(nu) and len(mu) > 0


def test_fine_tuned_checkpoint_keeps_no_moments(tmp_path, capsys):
    """Frozen parameters stay out of Adam, so its state covers only the
    head: the JAX mapping refuses it, with its reason."""
    cfg = dict(DARKNET, do_fine_tune=True, fine_tune=18,
               pretrained_weights=str(tmp_path / "absent.npz"))
    _, raw = _port_checkpoint(cfg, str(tmp_path / "port"))
    sd = {k: v.numpy() for k, v in raw["state_dict"].items()}
    capsys.readouterr()
    assert jax_interop.torch_optim_to_adam_moments(
        raw["optim_dict"], sd, "darknet_r") is None
    assert (f"[interop] optimizer state covers 1 of {N_DARKNET_PARAMS} "
            "params") in capsys.readouterr().out
