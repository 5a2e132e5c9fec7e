"""PyTorch port, the cnn classifier (CPU): ConvNet's eval and train-mode
forward, its BatchNorm statistics, `cnn_loss` and its gradient, the
interop (the first dense layer's CHW permutation), the seeded init and
dropout, a train step's gradients and Adam steps, the Trainer, and the
CLI's --model cnn train/overfit/predict, each against the JAX package on
the same numpy inputs, at the config's width (32 px crops, 43 classes)
and small batches."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu import (
    interop as jax_interop, losses as jax_losses)
from cs231_capsule_yolo_traffic_sign_detection_tpu.models import (
    ConvNet as JaxConvNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu.params import (
    Params as JaxParams)
from cs231_capsule_yolo_traffic_sign_detection_tpu.train import (
    driver as jax_driver, steps as jax_steps)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import (
    losses, predict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import loader
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.interop import (
    dense_chw_perm, jax_variables_to_state_dict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.metrics import (
    classification as clsm)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
    ConvNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    checkpoint as ckpt, driver, steps)

from torch_port_helpers import jax_convnet, torch_convnet

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cs231_capsule_yolo_traffic_sign_detection_tpu_torch"
# experiments/cnn/params.json at batch 4, dropout 0 where held to JAX
CNN = dict(model="cnn", n_classes=43, batch_size=4, lr_runtime=1e-3,
           lr_decay=0.1, n_epochs=3, dropout=0.0, eval_every=1,
           train_frac=1, summary=False)


def _crops(seed, n=4):
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, 32, 32, 3)).astype(np.float32)


def _labels(seed, n=4):
    return np.random.RandomState(seed + 100).randint(0, 43, n)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------- model

# f32: the reference's band for the eval forward; bf16: both frameworks
# round the convs' and dense layers' operands to bf16, each its own way
# (measured here: 1.0e-3 apart at logits up to 0.21, each 1e-3 from f32)
FORWARD_BANDS = {"float32": dict(rtol=1e-5, atol=1e-5),
                 "bfloat16": dict(rtol=0.02, atol=4e-3)}


@pytest.mark.parametrize("dtype", list(FORWARD_BANDS))
def test_convnet_eval_forward_matches_jax(dtype):
    bf16 = dtype == "bfloat16"
    _, variables = jax_convnet(seed=0)
    jmodel = JaxConvNet(n_classes=43, dropout=0.0,
                        dtype=jnp.bfloat16 if bf16 else None)
    x = _crops(1, n=6)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    model = torch_convnet(variables, dtype=getattr(torch, dtype))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (6, 43)
    assert np.abs(want).max() > 0.1  # logits not all near zero
    np.testing.assert_allclose(got.numpy(), want, **FORWARD_BANDS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_forward_and_running_stats_match_flax(dtype):
    """Three train-mode forwards at batch 4: batch statistics, and flax's
    running statistics (momentum 0.9, the biased variance) in f32."""
    bf16 = dtype == "bfloat16"
    _, variables = jax_convnet(seed=3)
    jmodel = JaxConvNet(n_classes=43, dropout=0.0,
                        dtype=jnp.bfloat16 if bf16 else None)
    model = torch_convnet(variables, dtype=getattr(torch, dtype)).train()
    stats = variables["batch_stats"]
    # bf16: train-mode logits reach 0.5 (measured: 6.6e-3 apart at most)
    band = (dict(rtol=0.02, atol=0.01) if bf16
            else FORWARD_BANDS["float32"])
    for i in range(3):
        x = _crops(10 + i)
        want, upd = jmodel.apply(
            {"params": variables["params"], "batch_stats": stats},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        got = model(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(want, np.float32), **band)
    want_sd = jax_variables_to_state_dict(
        {"params": variables["params"], "batch_stats": _np(stats)}, "cnn")
    got_sd = model.state_dict()
    for k, w in want_sd.items():
        if k.endswith(("running_mean", "running_var")):
            assert got_sd[k].dtype == torch.float32, k
            np.testing.assert_allclose(
                got_sd[k].numpy(), w.numpy(), err_msg=k,
                **(dict(rtol=0.05, atol=5e-3) if bf16
                   else dict(rtol=1e-5, atol=1e-6)))
    assert int(got_sd["cnn.5.num_batches_tracked"]) == 3


def test_state_dict_keys_are_the_references():
    sd = ConvNet(43).state_dict()
    assert [k for k in sd if not k.endswith("num_batches_tracked")] == [
        f"cnn.{i}.{n}" for i, names in (
            (0, ("weight", "bias")),
            (1, ("weight", "bias", "running_mean", "running_var")),
            (4, ("weight", "bias")),
            (5, ("weight", "bias", "running_mean", "running_var")),
            (10, ("weight", "bias")), (12, ("weight", "bias")))
        for n in names]
    assert tuple(sd["cnn.10.weight"].shape) == (128, 128 * 16 * 16)


def test_interop_round_trip_and_chw_permutation():
    """The port's state_dict from JAX variables equals the JAX package's
    own export, goes back through its import to the same variables, and
    its first dense layer reads the CHW flatten: an activation laid out
    HWC through the JAX kernel gives what the same values laid out CHW
    give through the port's."""
    _, variables = jax_convnet(seed=5)
    sd = jax_variables_to_state_dict(variables, "cnn")
    want = jax_interop.variables_to_torch_state_dict(variables, "cnn")
    assert list(sd) == list(want)
    for k, w in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), w, err_msg=k)
    back = jax_interop.torch_to_variables(
        {k: v.numpy() for k, v in sd.items()}, "cnn", variables)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)
    act = np.random.RandomState(0).randn(16, 16, 128).astype(np.float32)
    k0 = variables["params"]["Dense_0"]["kernel"]
    np.testing.assert_allclose(
        sd["cnn.10.weight"].numpy() @ act.transpose(2, 0, 1).ravel(),
        act.ravel() @ k0, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(dense_chw_perm(128 * 256),
                                  jax_interop._dense_chw_perm(128 * 256))


def test_init_convnet_is_seeded_and_torch_default():
    a, b, c = ConvNet(43, seed=0), ConvNet(43, seed=0), ConvNet(43, seed=1)
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(p, q), name
        if name.startswith(("cnn.1.", "cnn.5.")):   # BN: scale 1, bias 0
            assert torch.equal(p, torch.full_like(p, float(
                name.endswith("weight")))), name
            continue
        assert not torch.equal(p, r), name
        fan_in = (a.get_submodule(name.rsplit(".", 1)[0]).weight[0].numel())
        assert p.abs().max() <= fan_in ** -0.5, name


def test_dropout_needs_and_follows_the_generator():
    model = ConvNet(43, dropout=0.5, seed=0).train()
    x = torch.from_numpy(_crops(2))
    with pytest.raises(ValueError, match="torch.Generator"):
        model(x)
    a = model(x, generator=torch.Generator().manual_seed(3))
    b = model(x, generator=torch.Generator().manual_seed(3))
    c = model(x, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.eval()
    torch.testing.assert_close(model(x), model(x), rtol=0, atol=0)


# ---------------------------------------------------------------- loss

def test_cnn_loss_and_grad_match_jax():
    rng = np.random.RandomState(7)
    scores = (3 * rng.randn(5, 43)).astype(np.float64)
    y = rng.randint(0, 43, 5)
    jcfg = jax_losses.LossConfig.from_params(JaxParams(**CNN))
    (want, _), want_g = jax.value_and_grad(
        lambda s: jax_losses.cnn_loss(s, jnp.asarray(y), jcfg),
        has_aux=True)(jnp.asarray(scores))
    s = torch.from_numpy(scores).requires_grad_()
    got, aux = losses.cnn_loss(s, torch.from_numpy(y),
                               losses.LossConfig.from_params(Params(**CNN)))
    got.backward()
    assert aux == {}
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-12)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_g),
                               rtol=1e-10, atol=1e-14)
    assert steps.LOSS_REGISTRY["cnn"] is losses.cnn_loss


# ---------------------------------------------------------------- steps

def _jax_state(variables):
    params = variables["params"]
    return jax_steps.TrainState(
        params=params, batch_stats=variables["batch_stats"],
        opt_state=jax_steps.make_optimizer().init(params),
        rng=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))


def _port_layout64(tree, name, kind):
    """``tree`` (params or batch_stats, f64) at the port's ``name``: the
    JAX export run on an f64 copy (it writes f32, so map by hand)."""
    i = int(name.split(".")[1])
    leaf = name.split(".")[2]
    if kind == "batch_stats":
        j = {1: 0, 5: 1}[i]
        return np.asarray(tree[f"BatchNorm_{j}"][
            {"running_mean": "mean", "running_var": "var"}[leaf]])
    if i in (1, 5):
        return np.asarray(tree[f"BatchNorm_{ {1: 0, 5: 1}[i] }"][
            {"weight": "scale", "bias": "bias"}[leaf]])
    if i in (0, 4):
        a = np.asarray(tree[f"Conv_{ {0: 0, 4: 1}[i] }"][
            {"weight": "kernel", "bias": "bias"}[leaf]])
        return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a
    a = np.asarray(tree[f"Dense_{ {10: 0, 12: 1}[i] }"][
        {"weight": "kernel", "bias": "bias"}[leaf]])
    if a.ndim == 1:
        return a
    if i == 10:
        return a.T[:, np.argsort(dense_chw_perm(a.shape[0]))]
    return a.T


# f64: both frameworks in f64, the same step to rounding; f32: the port
# in f32 against the JAX step in f64, atol a share of each gradient's
# largest value
STEP_DTYPES = {"float64": (torch.float64, dict(rtol=1e-9, atol=1e-12)),
               "float32": (torch.float32, dict(rtol=1e-4, atol=5e-5))}


@pytest.mark.parametrize("dtype", list(STEP_DTYPES))
def test_train_step_grads_match_jax(dtype):
    tdt, band = STEP_DTYPES[dtype]
    _, variables = jax_convnet(seed=12)
    variables = _f64(variables)
    jmodel = JaxConvNet(n_classes=43, dropout=0.0)
    x, y = _crops(20), _labels(20)
    jcfg = jax_losses.LossConfig.from_params(JaxParams(**CNN))
    loss_w, grads = jax_steps.make_grad_fn(jmodel, "cnn", jcfg)(
        _jax_state(variables), jnp.asarray(x, jnp.float64), jnp.asarray(y))
    assert loss_w.dtype == jnp.float64
    model = torch_convnet(variables, dtype=tdt).train()
    cfg = losses.LossConfig.from_params(Params(**CNN))
    loss, scores, aux = steps.loss_and_scores(
        model, torch.from_numpy(x).to(tdt), torch.from_numpy(y), cfg, "cnn")
    loss.backward()
    assert aux == {} and scores.shape == (4, 43)
    np.testing.assert_allclose(loss.item(), float(loss_w),
                               rtol=band["rtol"] / 10)
    named = dict(model.named_parameters())
    for name, p in named.items():
        w = _port_layout64(grads, name, "params")
        if name in ("cnn.0.bias", "cnn.4.bias"):
            # a conv bias before a train-mode BN has no gradient: both
            # frameworks give rounding noise, small beside the weight's
            scale = np.abs(_port_layout64(grads, name[:-4] + "weight",
                                          "params")).max()
            assert np.abs(w).max() <= 1e-12 * scale, name
            assert p.grad.abs().max().item() <= band["atol"] * scale, name
            continue
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=band["rtol"],
                                   atol=band["atol"] * np.abs(w).max(),
                                   err_msg=name)


def test_adam_steps_match_jax():
    """Three Adam steps, both frameworks in f64 (BN statistics too)."""
    _, variables = jax_convnet(seed=13)
    variables = _f64(variables)
    jmodel = JaxConvNet(n_classes=43, dropout=0.0)
    jcfg = jax_losses.LossConfig.from_params(JaxParams(**CNN))
    step = jax_steps.make_train_step(jmodel, "cnn", jcfg, donate=False)
    state = _jax_state(variables)
    model = torch_convnet(variables, dtype=torch.float64).train()
    opt = steps.make_optimizer(model)
    cfg = losses.LossConfig.from_params(Params(**CNN))
    for i in range(3):
        x, y = _crops(30 + i), _labels(30 + i)
        state, loss_w, _, _ = step(state, jnp.asarray(x, jnp.float64),
                                   jnp.asarray(y), 1e-3)
        loss, _, _ = steps.train_step(
            model, opt, torch.from_numpy(x).double(), torch.from_numpy(y),
            1e-3, cfg, "cnn")
        np.testing.assert_allclose(loss.item(), float(loss_w), rtol=1e-10)
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        kind = "batch_stats" if "running" in name else "params"
        tree = state.batch_stats if kind == "batch_stats" else state.params
        np.testing.assert_allclose(t.numpy(), _port_layout64(tree, name,
                                                             kind),
                                   rtol=1e-9, atol=1e-8, err_msg=name)


def test_bf16_step_keeps_master_params_and_moments_f32():
    model = ConvNet(43, dropout=0.5, dtype=torch.bfloat16, seed=0).train()
    opt = steps.make_optimizer(model)
    loss, scores, _ = steps.train_step(
        model, opt, torch.from_numpy(_crops(0)), torch.from_numpy(_labels(0)),
        1e-3, losses.LossConfig.from_params(Params(**CNN)), "cnn",
        torch.Generator().manual_seed(0))
    assert torch.isfinite(loss) and scores.dtype == torch.float32
    for p in model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert p.grad.abs().max() > 0
        st = opt.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32


# ---------------------------------------------------------------- Trainer

def test_trainer_trajectory_matches_jax():
    """Three epochs from the JAX trainer's initial weights with the same
    np.random.seed (the same batches), dropout 0, both models in f64."""
    jp, p = JaxParams(**CNN), Params(**CNN)
    x_tr, y_tr, x_ev, y_ev = loader.synthetic_dataset("cnn", p, 16, 8)
    jtrainer = jax_driver.Trainer(jp, seed=0, verbose=False)
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), jtrainer.state.variables)
    jtrainer.state = jtrainer.state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jax_steps.make_optimizer().init(variables["params"]))
    trainer = driver.Trainer(p, seed=0, device="cpu", verbose=False)
    assert isinstance(trainer.model, ConvNet) and trainer.generator is not None
    trainer.model.double().load_state_dict(
        jax_variables_to_state_dict(_np(variables), "cnn"))
    trainer.model.dtype = torch.float64
    trainer.opt = steps.make_optimizer(trainer.model)
    got, want = [], []
    for t, out in ((jtrainer, want), (trainer, got)):
        np.random.seed(0)
        for _ in range(3):
            loss_tr, metric_tr = t.train_epoch(x_tr, y_tr, 1e-3,
                                               metric_on=True)
            loss_ev, metric_ev = t.eval_epoch(x_ev, y_ev, metric_on=True)
            out.append((loss_tr, loss_ev, metric_tr, metric_ev))
    got, want = np.array(got), np.array(want)
    assert want[-1, 0] < want[0, 0] and got[-1, 0] < got[0, 0]
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=1e-6)
    np.testing.assert_array_equal(got[:, 2:], want[:, 2:])
    assert driver.METRICS["cnn"] is clsm.recog_acc


def test_trainer_bf16_keeps_its_crops_in_bf16():
    p = Params(**dict(CNN, compute_dtype="bfloat16", dropout=0.5))
    x_tr, y_tr, _, _ = loader.synthetic_dataset("cnn", p, 8, 0)
    trainer = driver.Trainer(p, seed=0, device="cpu", verbose=False)
    np.random.seed(0)
    loss, _ = trainer.train_epoch(x_tr, y_tr, 1e-3, metric_on=False)
    assert np.isfinite(loss)
    (x_dev, _), = trainer._data.values()
    assert x_dev.dtype == torch.bfloat16


# ---------------------------------------------------------------- CLI

def test_cli_overfit_then_predict(tmp_path):
    """--mode overfit (dropout 0.5 from the json), then --mode predict
    --restore last finds the checkpoint and writes the classifier's
    metrics; the same numbers in-process."""
    model_dir = tmp_path / "cnn"
    model_dir.mkdir()
    Params(**dict(CNN, n_epochs=2, dropout=0.5, batch_size=64)).save(
        str(model_dir / "params.json"))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    base = [sys.executable, "-m", PORT.name, "--model", "cnn", "--device",
            "cpu", "--model_dir", str(model_dir)]
    res = subprocess.run(base + ["--mode", "overfit"], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "3 train / 3 eval" in res.stdout
    assert res.stdout.count("epoch ") == 2
    raw = ckpt.load_checkpoint(str(tmp_path / "cnn1" / "last.ckpt"))
    assert raw["epoch"] == 2 and "cnn.10.weight" in raw["state_dict"]
    res = subprocess.run(base + ["--mode", "predict", "--restore", "last"],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    text = (model_dir / "metric_output.txt").read_text()

    p = Params(**dict(CNN, batch_size=64))
    _, _, x, y = loader.synthetic_dataset("cnn", p, 4, 16)
    y_hat, classes = predict.class_pred(x, str(model_dir), p, "last",
                                        device="cpu")
    assert y_hat.shape == (16, 43) and (classes == y_hat.argmax(1)).all()
    assert text == "recog_pr:{}, recog_acc:{}, recog_auc:{}, ".format(
        clsm.recog_pr(y, y_hat, p), clsm.recog_acc(y, y_hat, p),
        clsm.recog_auc(y, y_hat, p))
