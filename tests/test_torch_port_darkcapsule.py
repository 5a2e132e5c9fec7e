"""PyTorch port, darkcapsule (CPU) at 64 px / n_grid 2: the polar
transform, the grid-capsule reshape, DarkCapsuleNet's eval and
train-mode forward, `darkcapsule_loss` and its gradient, a train step's
gradients and one Adam step, the Trainer, `darkcapsule_cell_f1`, the
converter and the fine-tune branch, each against the JAX package on the
same numpy inputs and weights; the CLI's train/overfit/predict."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu import interop as jax_interop
from cs231_capsule_yolo_traffic_sign_detection_tpu import losses as jax_losses
from cs231_capsule_yolo_traffic_sign_detection_tpu.metrics import (
    detection as jax_det)
from cs231_capsule_yolo_traffic_sign_detection_tpu.models.darkcapsule import (
    DarkCapsuleNet as JaxDarkCapsuleNet, _grid_capsules)
from cs231_capsule_yolo_traffic_sign_detection_tpu.ops import (
    polar as jax_polar)
from cs231_capsule_yolo_traffic_sign_detection_tpu.params import (
    Params as JaxParams)
from cs231_capsule_yolo_traffic_sign_detection_tpu.train import (
    driver as jax_driver, steps as jax_steps)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import (
    __main__ as cli, losses)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import loader
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.interop import (
    jax_variables_to_state_dict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.metrics import (
    detection as det)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
    DarkCapsuleNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models.darkcapsule import (  # noqa: E501
    grid_capsules)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import polar
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    checkpoint as ckpt, driver, steps)

from torch_port_helpers import write_darknet19_npz

# experiments/darkcapsule/params.json cut to n_grid 2 (64 px) and batch 4
SMALL = dict(model="darkcapsule", n_classes=43, n_boxes=2, n_grid=2,
             darknet_input=64, l_coord=5.0, l_noobj=0.5, batch_size=4,
             lr_runtime=1e-3, lr_decay=0.1, n_epochs=2, eval_every=1,
             train_frac=1, summary=False, device="cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


_INIT = {}


def jax_darkcapsule(seed=0, dtype=None, n_grid=2):
    """(flax DarkCapsuleNet, numpy variables) with BN scale, bias and
    running statistics moved off their defaults by ``seed``; the flax
    init is drawn once per n_grid."""
    model = JaxDarkCapsuleNet(n_grid=n_grid, dtype=dtype)
    if n_grid not in _INIT:
        size = 32 * n_grid
        _INIT[n_grid] = _np(model.init(jax.random.PRNGKey(0), jnp.zeros(
            (1, size, size, 3), jnp.float32)))
    variables = jax.tree_util.tree_map(np.copy, _INIT[n_grid])
    rng = np.random.RandomState(seed + 1)
    for i in range(1, 6):
        bn_p = variables["params"][f"block_{i}"][f"bn_{i}"]
        bn_s = variables["batch_stats"][f"block_{i}"][f"bn_{i}"]
        c = bn_p["scale"].shape
        bn_p["scale"] = (1 + 0.2 * rng.randn(*c)).astype(np.float32)
        bn_p["bias"] = (0.1 * rng.randn(*c)).astype(np.float32)
        bn_s["mean"] = (0.1 * rng.randn(*c)).astype(np.float32)
        bn_s["var"] = (0.5 + rng.rand(*c)).astype(np.float32)
    return model, variables


def port_darkcapsule(variables, dtype=torch.float32, n_grid=2):
    """The port's DarkCapsuleNet with the JAX weights (float64: parameters
    and buffers too)."""
    model = DarkCapsuleNet(n_grid=n_grid, dtype=dtype)
    if dtype == torch.float64:
        model.double()
    model.load_state_dict(jax_variables_to_state_dict(_np(variables),
                                                      "darkcapsule"),
                          strict=True)
    return model


def _port_layout(params, batch_stats, name):
    """The leaf of JAX (params, batch_stats) that the port's ``name``
    holds, in the port's layout and the tree's own dtype."""
    if name == "traffic_sign_capsules.route_weights":
        return np.asarray(params["traffic_sign_capsules"]["route_weights"])[
            None]
    _, layer, kind = name.split(".")
    i = int(layer.split("_")[1])
    if kind in ("running_mean", "running_var"):
        return np.asarray(batch_stats[f"block_{i}"][layer][kind[8:]])
    leaf = np.asarray(params[f"block_{i}"][layer][
        {"weight": "kernel" if layer.startswith("conv") else "scale",
         "bias": "bias"}[kind]])
    return leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4 else leaf


def _grids(seed, b=4, n_obj=3, n_classes=43):
    """Target grids (b, 2, 2, 5 + C): ``n_obj`` object cells with x, y in
    (0, 1) and w, h in (0.05, 0.6), a one-hot class."""
    rng = np.random.RandomState(seed)
    y = np.zeros((b, 2, 2, 5 + n_classes))
    for cell in rng.choice(b * 4, n_obj, replace=False):
        i, r, c = np.unravel_index(cell, (b, 2, 2))
        y[i, r, c, :5] = [1.0, *rng.uniform(0, 1, 2),
                          *rng.uniform(0.05, 0.6, 2)]
        y[i, r, c, 5 + rng.randint(n_classes)] = 1.0
    return y


def _scenes(seed, n=4, size=64):
    """Noise scenes: no flat regions, BN's statistics well spread."""
    return np.random.RandomState(seed).uniform(-1, 1, (n, size, size, 3))


# ---------------------------------------------------------------- ops

def test_polar_transform_matches_jax():
    y = np.random.RandomState(0).rand(3, 7, 7, 5)
    y[..., 0] = np.round(y[..., 0])
    for dt in (np.float32, np.float64):
        want_r, want_phi = jax_polar.polar_transform(jnp.asarray(y, dt))
        got_r, got_phi = polar.polar_transform(torch.from_numpy(y.astype(dt)))
        np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
        np.testing.assert_allclose(got_phi.numpy(), np.asarray(want_phi),
                                   rtol=1e-6, atol=1e-7)
    # h before w: the 3rd component follows h (index 4), not w
    _, a = polar.polar_transform(torch.tensor([1.0, 0.5, 0.5, 0.2, 0.0]))
    assert a[2].item() == pytest.approx(1.0)
    with pytest.raises(ValueError, match="dimension"):
        polar.polar_transform(torch.zeros(2, 4))


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_grid_capsules_is_jax_bit_for_bit(layout):
    """The reference's reinterpretation of NCHW memory, on logical dims:
    the same values in the same places whatever the memory format."""
    x = np.random.RandomState(1).randn(3, 8, 8, 256).astype(np.float32)
    want = np.asarray(_grid_capsules(jnp.asarray(x), 2))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    t = (t.contiguous() if layout == "contiguous"
         else t.contiguous(memory_format=torch.channels_last))
    got = grid_capsules(t, 2).numpy()
    assert got.shape == want.shape == (4 * 3, 512, 8)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="32 \\* n_grid"):
        grid_capsules(t, 3)


# ---------------------------------------------------------------- model

# bf16: the conv stack rounds at other places in the two frameworks; the
# capsules are unit-scale (lengths near 1)
FORWARD_BANDS = {"float32": dict(rtol=1e-4, atol=1e-5),
                 "bfloat16": dict(rtol=0.05, atol=0.03)}


@pytest.mark.parametrize("dtype", list(FORWARD_BANDS))
def test_eval_forward_matches_jax(dtype):
    bf16 = dtype == "bfloat16"
    _, variables = jax_darkcapsule(seed=2)
    jmodel = JaxDarkCapsuleNet(n_grid=2, dtype=jnp.bfloat16 if bf16 else None)
    x = _scenes(3, n=3).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    model = port_darkcapsule(variables, getattr(torch, dtype)).eval()
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 2, 2, 5)
    lengths = np.sqrt((want ** 2).sum(-1))
    assert lengths.min() > 0.1 and lengths.max() < 1   # squashed, spread
    np.testing.assert_allclose(got.detach().numpy(), want,
                               **FORWARD_BANDS[dtype])
    # the routing runs in f32 on the bf16 stack's nodes, as in JAX
    assert model.traffic_sign_capsules.route_weights.dtype == torch.float32


def test_train_forward_and_running_stats_match_flax_in_f64():
    """Two train-mode forwards at batch 2, both frameworks in f64: the
    outputs, and the running statistics with torch momentum 0.1 (flax
    0.9) and flax's biased variance."""
    _, variables = jax_darkcapsule(seed=4)
    variables = _f64(variables)
    jmodel = JaxDarkCapsuleNet(n_grid=2)
    model = port_darkcapsule(variables, torch.float64).train()
    stats = variables["batch_stats"]
    for seed in range(2):
        x = _scenes(10 + seed, n=2)
        want, upd = jmodel.apply(
            {"params": variables["params"], "batch_stats": stats},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        got = model(torch.from_numpy(x))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-9, atol=1e-12)
    for name, t in model.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(
                t.numpy(), _port_layout(variables["params"], stats, name),
                rtol=1e-10, atol=1e-13, err_msg=name)
    assert model.conv.bn_1.momentum == 0.1
    assert int(model.state_dict()["conv.bn_5.num_batches_tracked"]) == 2


def test_init_darkcapsule_is_seeded_and_torch_default():
    a, b, c = (DarkCapsuleNet(n_grid=7, seed=s) for s in (3, 3, 4))
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(p, q), name
        if name.startswith("conv.conv"):
            assert not torch.equal(p, r), name
            bound = 1 / p[0].numel() ** 0.5 if p.dim() == 4 else None
            if bound is not None:
                assert p.abs().max() <= bound
    w = a.traffic_sign_capsules.route_weights
    assert w.shape == (1, 512, 1, 8, 5)
    assert 0.09 < w.std().item() < 0.11 and abs(w.mean().item()) < 0.01
    assert torch.equal(a.conv.bn_3.weight, torch.ones(64))
    assert torch.equal(a.conv.bn_3.running_var, torch.ones(64))


# ---------------------------------------------------------------- loss

@pytest.mark.parametrize("case", ["objects", "no_object", "recon"])
def test_darkcapsule_loss_and_grad_match_jax_in_f64(case):
    rng = np.random.RandomState(5)
    caps = rng.uniform(-0.6, 0.6, (4, 2, 2, 5))
    y = _grids(6, n_obj=0 if case == "no_object" else 5)
    recon = case == "recon"
    x = rng.rand(4, 8, 8, 3)
    r = rng.rand(4, 8, 8, 3)
    jcfg = jax_losses.LossConfig.from_params(JaxParams(**SMALL, recon=recon))
    cfg = losses.LossConfig.from_params(Params(**SMALL, recon=recon))

    def jloss(c):
        if recon:
            return jax_losses.darkcapsule_loss(c, jnp.asarray(y), jcfg,
                                               jnp.asarray(x),
                                               jnp.asarray(r))[0]
        return jax_losses.darkcapsule_loss(c, jnp.asarray(y), jcfg)[0]

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(caps))
    c = torch.from_numpy(caps).requires_grad_()
    got, aux = (losses.darkcapsule_loss(c, torch.from_numpy(y), cfg,
                                        torch.from_numpy(x),
                                        torch.from_numpy(r))
                if recon else
                losses.darkcapsule_loss(c, torch.from_numpy(y), cfg))
    got.backward()
    assert aux == {} and got.dtype == torch.float64
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-12)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(want_g),
                               rtol=1e-10, atol=1e-14)
    if recon:   # outside the division, without recon_coef (COMPAT #5)
        plain, _ = losses.darkcapsule_loss(c, torch.from_numpy(y), cfg)
        np.testing.assert_allclose(got.item() - plain.item(),
                                   ((x - r) ** 2).sum(), rtol=1e-12)


# ---------------------------------------------------------------- steps

def _jax_state(variables):
    return jax_steps.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jax_steps.make_optimizer().init(variables["params"]),
        rng=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))


def test_train_step_grads_and_adam_step_match_jax_in_f64():
    """One step's gradients, then the parameters and BN statistics after
    one Adam step, both frameworks in f64, at batch 1 (XLA's f64 convs
    on the CPU take seconds a step).  The conv biases feed a train-mode
    BN: their gradient is 0 but for rounding, held against their
    weight's largest gradient."""
    _, variables = jax_darkcapsule(seed=7)
    variables = _f64(variables)
    jmodel = JaxDarkCapsuleNet(n_grid=2)
    x, y = _scenes(8, n=1), _grids(9, b=1, n_obj=2)
    jcfg = jax_losses.LossConfig.from_params(JaxParams(**SMALL))
    loss_w, grads = jax_steps.make_grad_fn(jmodel, "darkcapsule", jcfg)(
        _jax_state(variables), jnp.asarray(x), jnp.asarray(y))
    state, loss_s, _, _ = jax_steps.make_train_step(
        jmodel, "darkcapsule", jcfg, donate=False)(
            _jax_state(variables), jnp.asarray(x), jnp.asarray(y), 1e-3)

    model = port_darkcapsule(variables, torch.float64).train()
    opt = steps.make_optimizer(model)
    cfg = losses.LossConfig.from_params(Params(**SMALL))
    loss, y_hat, aux = steps.train_step(
        model, opt, torch.from_numpy(x), torch.from_numpy(y), 1e-3, cfg,
        "darkcapsule")
    assert aux == {} and y_hat.shape == (1, 2, 2, 5)
    np.testing.assert_allclose(loss.item(), float(loss_w), rtol=1e-10)
    np.testing.assert_allclose(loss.item(), float(loss_s), rtol=1e-10)
    named = dict(model.named_parameters())
    for name, p in named.items():
        if name.startswith("decoder."):
            assert p.grad is None   # registered, never called
            continue
        w = _port_layout(grads, None, name)
        if name.startswith("conv.conv") and name.endswith(".bias"):
            scale = np.abs(_port_layout(grads, None,
                                        name[:-4] + "weight")).max()
            assert np.abs(w).max() <= 1e-9 * scale, name
            assert p.grad.abs().max().item() <= 1e-9 * scale, name
            continue
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-9,
                                   atol=1e-12 * np.abs(w).max(),
                                   err_msg=name)
    for name, t in model.state_dict().items():
        if name.startswith("decoder.") or name.endswith("batches_tracked"):
            continue
        # atol 1e-5 of a step (lr 1e-3), as for darknet; the biases before
        # BN, whose rounding-noise gradient g steps by lr g / (|g| + 1e-8),
        # measured 1.9e-10 apart
        np.testing.assert_allclose(
            t.numpy(), _port_layout(state.params, state.batch_stats, name),
            rtol=1e-9, atol=1e-8, err_msg=name)


def test_trainer_trajectory_matches_jax_in_f64():
    """Two Trainer epochs of one batch from the JAX trainer's weights
    with the same np.random.seed (so the same batches), both models in
    f64: the train and eval losses, and the cell F1 metric exactly.  At
    n_grid 1 (32 px): XLA's f64 convs on the CPU are slow."""
    small = dict(SMALL, batch_size=2, n_grid=1)
    jp, p = JaxParams(**small), Params(**small)
    x_tr, y_tr, x_ev, y_ev = loader.synthetic_dataset("darkcapsule", p, 2, 2)
    assert x_tr.shape == (2, 32, 32, 3) and y_tr.shape == (2, 1, 1, 48)
    jtrainer = jax_driver.Trainer(jp, seed=0, verbose=False)
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), jtrainer.state.variables)
    jtrainer.state = jtrainer.state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jax_steps.make_optimizer().init(variables["params"]))
    trainer = driver.Trainer(p, seed=0, device="cpu", verbose=False)
    assert trainer.generator is None   # no dropout in DarkCapsuleNet
    trainer.model = port_darkcapsule(_np(variables), torch.float64, 1)
    trainer.opt = steps.make_optimizer(trainer.model)
    got, want = [], []
    for t, out in ((jtrainer, want), (trainer, got)):
        np.random.seed(0)
        for _ in range(2):
            loss_tr, metric_tr = t.train_epoch(x_tr, y_tr, 1e-3)
            loss_ev, metric_ev = t.eval_epoch(x_ev, y_ev)
            out.append((loss_tr, loss_ev, metric_tr, metric_ev))
    got, want = np.array(got), np.array(want)
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=1e-8)
    np.testing.assert_array_equal(got[:, 2:], want[:, 2:])


# ---------------------------------------------------------------- metric

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cell_f1_matches_jax(seed):
    rng = np.random.RandomState(seed)
    y = _grids(seed, b=6, n_obj=8)
    caps = rng.uniform(-0.45, 0.45, (6, 2, 2, 5)).astype(np.float32)
    got = det.darkcapsule_cell_f1(y, caps, Params(**SMALL))
    want = jax_det.darkcapsule_cell_f1(y, caps, JaxParams(**SMALL))
    assert 0 < want < 1 and got == want


# ---------------------------------------------------------------- interop

def test_converter_matches_jax_key_for_key():
    """The port's converter against JAX variables_to_torch_state_dict:
    the same keys in the same order, the same values (the decoder
    zeros), and a strict load."""
    _, variables = jax_darkcapsule(seed=11)
    got = jax_variables_to_state_dict(variables, "darkcapsule")
    want = jax_interop.variables_to_torch_state_dict(variables,
                                                     "darkcapsule")
    assert list(got) == list(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    assert list(got) == list(DarkCapsuleNet(n_grid=2).state_dict())


def test_jax_export_loads_strictly_and_runs():
    """A JAX-exported state_dict (numpy) as torch tensors loads with
    strict=True and gives the JAX forward."""
    jmodel, variables = jax_darkcapsule(seed=12)
    sd = jax_interop.variables_to_torch_state_dict(variables, "darkcapsule")
    model = DarkCapsuleNet(n_grid=2)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in sd.items()}, strict=True)
    x = _scenes(13, n=2).astype(np.float32)
    np.testing.assert_allclose(
        model.eval()(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False)),
        rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- fine-tune

def test_fine_tune_is_the_jax_trainers(tmp_path, capsys):
    """--fine_tune on darkcapsule, as the JAX Trainer: no npz -> the
    message and training from scratch with nothing frozen (its
    params.json has no fine_tune); a darknet19 npz -> both raise (its
    blocks are not darknet19's)."""
    missing = str(tmp_path / "absent.npz")
    over = dict(SMALL, do_fine_tune=True, pretrained_weights=missing)
    jax_driver.Trainer(JaxParams(**over), seed=0, verbose=False)
    want = capsys.readouterr().out
    trainer = driver.Trainer(Params(**over), seed=0, device="cpu",
                             verbose=False)
    got = capsys.readouterr().out
    assert got == want == (f"[fine_tune] pretrained weights {missing!r} not "
                           "found; training from scratch\n")
    assert all(q.requires_grad for q in trainer.model.parameters())
    npz = str(tmp_path / "darknet19_weights.npz")
    write_darknet19_npz(npz)
    over["pretrained_weights"] = npz
    with pytest.raises(AssertionError):
        jax_driver.Trainer(JaxParams(**over), seed=0, verbose=False)
    with pytest.raises(ValueError, match="0-scope/kernel:0: shape"):
        driver.Trainer(Params(**over), seed=0, device="cpu", verbose=False)


# ---------------------------------------------------------------- CLI

def _experiment(root, over=None):
    d = root / "experiments" / "darkcapsule"
    d.mkdir(parents=True)
    # the reference's params.json carries "device": "cpu"; the port
    # never reads it
    Params(**dict(SMALL, **(over or {}))).save(str(d / "params.json"))
    return d


def test_cli_overfit_then_predict(tmp_path, monkeypatch, capsys):
    """--mode overfit from a tmp dir writes last.ckpt; --mode predict then
    loads the test set and writes an empty metric file, as the JAX CLI
    with no predict function; --mode train on the synthetic set."""
    d = _experiment(tmp_path)
    monkeypatch.chdir(tmp_path)
    cli.main(["--model", "darkcapsule", "--mode", "overfit", "--device",
              "cpu"])
    out = capsys.readouterr().out
    assert "3 train / 3 eval" in out and out.count("epoch ") == 2
    raw = ckpt.load_checkpoint(str(tmp_path / "experiments" / "darkcapsule1"
                                   / "last.ckpt"))
    assert raw["epoch"] == 2
    DarkCapsuleNet(n_grid=2).load_state_dict(raw["state_dict"], strict=True)
    assert len(np.load(d / "losses_tr.npy")) == 2
    cli.main(["--model", "darkcapsule", "--mode", "predict", "--restore",
              "last", "--device", "cpu"])
    assert "[predict] dataset absent" in capsys.readouterr().out
    assert (d / "metric_output.txt").read_text() == ""


@pytest.mark.parametrize("mode", ["train", "predict"])
def test_cli_needs_the_card_unless_told_cpu(tmp_path, monkeypatch, mode):
    """params.json's "device": "cpu" moves nothing to the CPU: without
    --device cpu and without a card, the run raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is available here")
    _experiment(tmp_path)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["--model", "darkcapsule", "--mode", mode, "--restore",
                  "last"])
