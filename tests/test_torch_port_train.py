"""PyTorch port, the capsule classifier's training slice (CPU): K4's plain
version, the differentiable routing op, the capsule loss, CapsuleNet's
reconstruction branch, the gradients and Adam steps of a train step,
the plateau schedule, the Trainer's loss trajectory, resume, the data
helpers and the train/overfit CLI, each against the JAX package on the
same numpy inputs.  K4's CUDA kernel is held against its plain version
on the card by tests/test_torch_port_cuda.py."""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu import losses as jax_losses
from cs231_capsule_yolo_traffic_sign_detection_tpu.data import (
    loader as jax_loader)
from cs231_capsule_yolo_traffic_sign_detection_tpu.ops import (
    routing_pallas as RP)
from cs231_capsule_yolo_traffic_sign_detection_tpu.params import (
    Params as JaxParams)
from cs231_capsule_yolo_traffic_sign_detection_tpu.train import (
    driver as jax_driver, plateau as jax_plateau, steps as jax_steps,
    summary as jax_summary)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import losses
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import loader
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.interop import (
    jax_variables_to_state_dict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
    CapsuleNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import routing
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    checkpoint as ckpt, driver, plateau, steps, summary)

from torch_port_helpers import jax_capsulenet, torch_capsulenet

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cs231_capsule_yolo_traffic_sign_detection_tpu_torch"
TRAIN = dict(model="capsule", n_classes=43, batch_size=8, capsule_input=32,
             lr_runtime=1e-3, lr_decay=0.1, n_epochs=3, eval_every=1,
             train_frac=1, recon=True, recon_coef=5e-4, summary=False)


def _routing_inputs(seed, b=2, n=64, k=7):
    """The shapes of tests/test_pallas_routing.py's gradient tests: x ~
    N(0, 1), W ~ 0.1 N(0, 1), and a cotangent ~ N(0, 1)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, 8).astype(np.float32)
    w = (0.1 * rng.randn(n, k, 8, 16)).astype(np.float32)
    g = rng.randn(b, k, 16).astype(np.float32)
    return x, w, g


def _grad_band(bf16, want):
    """The bands of tests/test_pallas_routing.py: f32 rtol 1e-4 / atol
    1e-6; bf16 rtol 0.08 / atol 0.02 of the gradient's largest value."""
    if bf16:
        return dict(rtol=0.08, atol=0.02 * float(np.abs(want).max()))
    return dict(rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------- K4

@pytest.mark.parametrize("bf16", [False, True])
def test_routing_backward_plain_matches_pallas_grad(bf16):
    x, w, g = _routing_inputs(0)

    def f(x, w):
        return jnp.sum(RP.routed_capsules_pallas(x, w, 3, bf16) * g)

    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    _, s = routing.routing_states_plain(xt, wt, 3, bf16)
    got = routing.routed_capsules_backward_plain(xt, wt, s,
                                                 torch.from_numpy(g), 3, bf16)
    for name, a, b in zip(("dx", "dW"), got, want):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, err_msg=name,
                                   **_grad_band(bf16, b))


def test_routing_backward_plain_matches_autograd():
    x, w, g = (torch.from_numpy(a) for a in _routing_inputs(1))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    (routing.routed_capsules_plain(xa, wa, 3) * g).sum().backward()
    _, s = routing.routing_states_plain(x, w, 3)
    dx, dw = routing.routed_capsules_backward_plain(x, w, s, g, 3)
    # f32, the same sums in another order
    torch.testing.assert_close(dx, xa.grad, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(dw, wa.grad, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("bf16", [False, True])
def test_routed_capsules_is_differentiable_on_cpu(bf16):
    x, w, g = (torch.from_numpy(a) for a in _routing_inputs(2))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = (routing.routed_capsules.launches,
              routing.routed_capsules_backward.launches)
    out = routing.routed_capsules(xa, wa, 3, bf16=bf16)
    assert out.grad_fn is not None
    # the forward is the plain one to the bit
    assert torch.equal(out, routing.routed_capsules_plain(x, w, 3, bf16))
    (out * g).sum().backward()
    _, s = routing.routing_states_plain(x, w, 3, bf16)
    dx, dw = routing.routed_capsules_backward_plain(x, w, s, g, 3, bf16)
    torch.testing.assert_close(xa.grad, dx, rtol=0, atol=0)
    torch.testing.assert_close(wa.grad, dw, rtol=0, atol=0)
    assert (routing.routed_capsules.launches,
            routing.routed_capsules_backward.launches) == before


def test_routed_capsules_gradcheck():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 6, 8), generator=gen, dtype=torch.float64)
    w = 0.3 * torch.randn((6, 3, 8, 16), generator=gen, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda a, b: routing.RoutedCapsules.apply(a, b, 3, False),
        (x.requires_grad_(), w.requires_grad_()))


def test_serving_call_saves_nothing():
    x, w, _ = (torch.from_numpy(a) for a in _routing_inputs(4))
    w.requires_grad_()
    with torch.inference_mode():
        out = routing.routed_capsules(x, w, 3)
    assert out.grad_fn is None and not out.requires_grad
    with torch.no_grad():
        assert routing.routed_capsules(x, w, 3).grad_fn is None
    assert routing.routed_capsules(x, w, 3).grad_fn is not None


# ---------------------------------------------------------------- loss

@pytest.mark.parametrize("recon", [False, True])
def test_capsule_loss_matches_jax(recon):
    rng = np.random.RandomState(5)
    scores = rng.uniform(0, 1, (6, 43)).astype(np.float32)
    y = rng.randint(0, 43, 6)
    x = rng.uniform(-1, 1, (6, 32, 32, 3)).astype(np.float32)
    rec = np.tanh(rng.randn(6, 32, 32, 3)).astype(np.float32)
    jcfg = jax_losses.LossConfig.from_params(JaxParams(recon=recon))
    cfg = losses.LossConfig.from_params(Params(recon=recon))
    assert dataclass_dict(cfg) == dataclass_dict(jcfg)

    def jloss(s, r):
        return jax_losses.capsule_loss(s, jnp.asarray(y), jcfg, x,
                                       r if recon else None)[0]

    want, (gs_want, gr_want) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(scores), jnp.asarray(rec))
    s_t = torch.from_numpy(scores).requires_grad_()
    r_t = torch.from_numpy(rec).requires_grad_()
    got, aux = losses.capsule_loss(s_t, torch.from_numpy(y), cfg,
                                   torch.from_numpy(x),
                                   r_t if recon else None)
    got.backward()
    assert aux == {}
    # f32 sums over 3072 pixels per crop in another order
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(s_t.grad.numpy(), np.asarray(gs_want),
                               rtol=1e-5, atol=1e-7)
    if recon:
        np.testing.assert_allclose(r_t.grad.numpy(), np.asarray(gr_want),
                                   rtol=1e-5, atol=1e-8)
    else:
        assert r_t.grad is None


def dataclass_dict(cfg):
    return {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_capsulenet_recon_forward_matches_jax(dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    jmodel, variables = jax_capsulenet(43, seed=9, dtype=jdt)
    rng = np.random.RandomState(6)
    x = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    y = np.array([0, 17, 42])
    scores_w, dec_w = jmodel.apply(variables, jnp.asarray(x),
                                   y=jnp.asarray(y), recon=True)
    model = torch_capsulenet(variables, 43, dtype=getattr(torch, dtype))
    with torch.no_grad():
        scores, dec = model(torch.from_numpy(x), torch.from_numpy(y),
                            recon=True)
    assert scores.dtype == dec.dtype == torch.float32
    assert dec.shape == (3, 32, 32, 3)
    # f32: weights carried from JAX, sums in another order; bf16: the
    # convs and the decoder round at other places in the two frameworks
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == "float32"
           else dict(rtol=0.05, atol=5e-3))
    np.testing.assert_allclose(scores.numpy(),
                               np.asarray(scores_w, np.float32), **tol)
    np.testing.assert_allclose(dec.numpy(), np.asarray(dec_w, np.float32),
                               **tol)


def test_init_is_seeded_and_torch_default():
    a, b, c = CapsuleNet(43, seed=1), CapsuleNet(43, seed=1), \
        CapsuleNet(43, seed=2)
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(p, q) and not torch.equal(p, r), name
    w = a.traffic_sign_capsules.route_weights
    assert abs(w.std().item() - 0.1) < 2e-3 and abs(w.mean().item()) < 1e-3
    bound = 1 / (3 * 9 * 9) ** 0.5
    assert a.conv1.weight.abs().max().item() <= bound
    assert a.conv1.weight.abs().max().item() > 0.99 * bound


def test_summary_counts_the_jax_parameters(capsys):
    _, variables = jax_capsulenet(43)
    want = jax_summary.summarize(variables)
    assert summary.summarize(CapsuleNet(43)) == want == 9299759


# ---------------------------------------------------------------- steps

def _jax_state(variables):
    params = variables["params"]
    return jax_steps.TrainState(
        params=params, batch_stats=None,
        opt_state=jax_steps.make_optimizer().init(params),
        rng=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))


def _grads_as_state_dict(grads):
    """JAX gradients in the port's layout: the same linear maps as the
    weights (HWIO -> OIHW, the split primary-capsule conv, the route
    weights' node permutation)."""
    return jax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.array, grads)}, "capsule")


def _batch(seed, n=4):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32),
            rng.randint(0, 43, n).astype(np.int64))


def test_train_step_grads_match_jax():
    jmodel, variables = jax_capsulenet(43, seed=12)
    x, y = _batch(7)
    jcfg = jax_losses.LossConfig.from_params(JaxParams(**TRAIN))
    loss_w, grads = jax_steps.make_grad_fn(jmodel, "capsule", jcfg)(
        _jax_state(variables), jnp.asarray(x), jnp.asarray(y))
    want = _grads_as_state_dict(grads)

    model = torch_capsulenet(variables, 43).train()
    cfg = losses.LossConfig.from_params(Params(**TRAIN))
    loss, _, _ = steps.loss_and_scores(model, torch.from_numpy(x),
                                       torch.from_numpy(y), cfg, "capsule")
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_w), rtol=1e-5)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        assert np.abs(w).max() > 0, name
        # f32; the route weights' gradient sums 4 elements x 43 capsules
        # x 16 dims in another order, the convs' run through cuDNN-free
        # CPU kernels in both: atol at 1e-5 of each gradient's scale
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_adam_steps_match_jax():
    jmodel, variables = jax_capsulenet(43, seed=13)
    jcfg = jax_losses.LossConfig.from_params(JaxParams(**TRAIN))
    step = jax_steps.make_train_step(jmodel, "capsule", jcfg, donate=False)
    state = _jax_state(variables)
    model = torch_capsulenet(variables, 43).train()
    opt = steps.make_optimizer(model)
    cfg = losses.LossConfig.from_params(Params(**TRAIN))
    for i in range(3):
        x, y = _batch(20 + i)
        state, loss_w, _, _ = step(state, jnp.asarray(x), jnp.asarray(y),
                                   1e-3)
        loss, _, _ = steps.train_step(model, opt, torch.from_numpy(x),
                                      torch.from_numpy(y), 1e-3, cfg,
                                      "capsule")
        np.testing.assert_allclose(loss.item(), float(loss_w), rtol=1e-4)
    want = _grads_as_state_dict(state.params)
    for name, p in model.named_parameters():
        # three steps of at most lr = 1e-3 each: a gradient component
        # near zero may take Adam's normalised step with the other sign
        # in the other framework, so the band is a fraction of one step
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=2e-4, err_msg=name)
    assert all(s["exp_avg"].dtype == torch.float32
               for s in opt.state.values())


def test_bf16_keeps_master_params_and_moments_f32():
    model = CapsuleNet(43, dtype=torch.bfloat16, seed=0).train()
    opt = steps.make_optimizer(model)
    x, y = _batch(8, n=2)
    loss, scores, _ = steps.train_step(
        model, opt, torch.from_numpy(x), torch.from_numpy(y), 1e-3,
        losses.LossConfig.from_params(Params(**TRAIN)), "capsule")
    assert torch.isfinite(loss) and scores.dtype == torch.float32
    for p in model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        st = opt.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32


def test_plateau_sequence_matches_jax():
    rng = np.random.RandomState(9)
    seq = list(np.abs(rng.randn(40))) + [0.01] * 30
    ours = plateau.ReduceLROnPlateau(lr=1e-3, factor=0.1, patience=3)
    ref = jax_plateau.ReduceLROnPlateau(lr=1e-3, factor=0.1, patience=3)
    for loss in seq:
        assert ours.step(loss) == ref.step(loss)
    assert ours.state_dict() == ref.state_dict()
    assert ours.lr < 1e-3  # the schedule decayed at least once


# ---------------------------------------------------------------- Trainer

def test_trainer_trajectory_matches_jax():
    jp, p = JaxParams(**TRAIN), Params(**TRAIN)
    x_tr, y_tr, x_ev, y_ev = loader.synthetic_dataset("capsule", p, 32, 8)
    jtrainer = jax_driver.Trainer(jp, seed=0, verbose=False)
    trainer = driver.Trainer(p, seed=0, device="cpu", verbose=False)
    trainer.model.load_state_dict(jax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.array,
                                          jtrainer.state.params)},
        "capsule"))
    got, want = [], []
    for t, out in ((jtrainer, want), (trainer, got)):
        np.random.seed(0)
        for _ in range(3):
            out.append(t.train_epoch(x_tr, y_tr, 1e-3, metric_on=True)
                       + t.eval_epoch(x_ev, y_ev, metric_on=True))
    got, want = np.array(got), np.array(want)
    assert want[-1, 0] < want[0, 0]  # the loss falls
    # shared initial weights and batches: the losses agree to f32
    # accumulation over 3 epochs of 4 Adam steps
    np.testing.assert_allclose(got[:, [0, 2]], want[:, [0, 2]], rtol=1e-3)
    np.testing.assert_array_equal(got[:, [1, 3]], want[:, [1, 3]])


def test_resume_equals_two_epochs_straight(tmp_path):
    p = Params(**dict(TRAIN, batch_size=4))
    x, y, _, _ = loader.synthetic_dataset("capsule", p, 8, 0)
    lr = plateau.ReduceLROnPlateau(lr=1e-3)
    straight = driver.Trainer(p, seed=4, device="cpu", verbose=False)
    np.random.seed(1)
    for _ in range(2):
        straight.train_epoch(x, y, lr.lr, metric_on=False)

    first = driver.Trainer(p, seed=4, device="cpu", verbose=False)
    np.random.seed(1)
    first.train_epoch(x, y, lr.lr, metric_on=False)
    # written where training writes, read back through the fallback
    ckpt.save_checkpoint(first.state_dict(1, lr), False,
                         str(tmp_path / "run") + "1")
    resumed = driver.Trainer(p, seed=5, device="cpu", verbose=False)
    raw = resumed.restore(str(tmp_path / "run" / "last.ckpt"),
                          str(tmp_path / "run"), 1)
    assert raw["epoch"] == 1 and set(raw) == {
        "epoch", "state_dict", "optim_dict", "plateau"}
    resumed.train_epoch(x, y, lr.lr, metric_on=False)
    for (name, a), b in zip(straight.model.named_parameters(),
                            resumed.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("is_small", [False, True])
def test_load_or_synthesize_matches_jax(tmp_path, is_small):
    p, jp = Params(model="capsule"), JaxParams(model="capsule")
    got = loader.load_or_synthesize(str(tmp_path / "none"), p, is_small)
    want = jax_loader.load_or_synthesize(str(tmp_path / "none"), jp,
                                         is_small)
    assert got[0].shape[0] == (3 if is_small else 512)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_make_small_data_and_shuffle_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    x, y = rng.rand(7, 4).astype(np.float32), np.arange(7)
    for name in ("train.p", "eval.p"):
        with open(tmp_path / name, "wb") as f:
            pickle.dump((x, y), f)
    loader.make_small_data(str(tmp_path), 3)
    got = loader.load_data(str(tmp_path), is_small=True)
    want = jax_loader.load_data(str(tmp_path), is_small=True)
    assert got[0].shape == (3, 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.random.seed(3)
    a = loader.shuffle(x, y)
    np.random.seed(3)
    b = jax_loader.shuffle(x, y)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


# ---------------------------------------------------------------- CLI

def test_cli_overfit_then_predict(tmp_path):
    model_dir = tmp_path / "capsule"
    model_dir.mkdir()
    Params(model="capsule", n_classes=43, batch_size=64, n_epochs=2,
           lr_decay=0.1).save(str(model_dir / "params.json"))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    base = [sys.executable, "-m", PORT.name, "--model", "capsule",
            "--device", "cpu", "--model_dir", str(model_dir)]
    res = subprocess.run(base + ["--mode", "overfit"], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "3 train / 3 eval" in res.stdout
    assert res.stdout.count("epoch ") == 2
    raw = ckpt.load_checkpoint(str(tmp_path / "capsule1" / "last.ckpt"))
    assert raw["epoch"] == 2 and set(raw) == {
        "epoch", "state_dict", "optim_dict", "plateau"}
    assert (tmp_path / "capsule1" / "best.ckpt").exists()
    assert len(np.load(model_dir / "losses_tr.npy")) == 2
    # predict finds the checkpoint under <model_dir><train_frac>
    res = subprocess.run(base + ["--mode", "predict", "--restore", "last"],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "recog_acc" in (model_dir / "metric_output.txt").read_text()
