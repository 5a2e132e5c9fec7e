"""PyTorch port, the darknet_r training slice (CPU), part 1: dark_loss and
its gradients, DarkNet in training (BatchNorm with flax's running
statistics, bf16, dropout from an explicit generator), the seeded init,
the darknet19 npz and the fine-tuning freeze, detect_and_recog_acc, and
a train step's gradients and Adam steps, each against the JAX package
on the same numpy inputs at 64 px (n_grid 2).  The Trainer, the CLI and
the checkpoints' way into JAX are in
tests/test_torch_port_darknet_trainer.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from cs231_capsule_yolo_traffic_sign_detection_tpu import losses as jax_losses
from cs231_capsule_yolo_traffic_sign_detection_tpu.metrics import (
    detection as jax_det)
from cs231_capsule_yolo_traffic_sign_detection_tpu.models import (
    DarkNet as JaxDarkNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu.models.darknet import (
    load_darknet19_npz as jax_load_npz)
from cs231_capsule_yolo_traffic_sign_detection_tpu.params import (
    Params as JaxParams)
from cs231_capsule_yolo_traffic_sign_detection_tpu.train import (
    steps as jax_steps)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import losses
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import loader
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.interop import (
    jax_variables_to_state_dict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.metrics import (
    detection as det)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
    DarkNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models.darknet import (
    freeze_darknet, load_darknet19_npz)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models.layers import (
    dropout)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    steps, summary)

from torch_port_helpers import jax_darknet, write_darknet19_npz

# darknet_r's config (experiments/darknet_r/params.json) cut to 64 px
SMALL = dict(model="darknet_r", n_boxes=1, n_classes=43, n_grid=2,
             darknet_input=64, l_coord=5.0, l_noobj=0.5, batch_size=4,
             dropout=0.0)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _state_dict(params, batch_stats):
    """A JAX (params, batch_stats) pair in the port's layout."""
    return jax_variables_to_state_dict(
        {"params": _to_np(params), "batch_stats": _to_np(batch_stats)},
        "darknet_r")


def _port_darknet(variables, dtype=torch.float32):
    """The port's DarkNet with the JAX weights, computing in ``dtype``
    (float64: parameters and buffers too)."""
    model = DarkNet(1, 43, dtype=dtype)
    if dtype == torch.float64:
        model.double()
    model.load_state_dict(_state_dict(variables["params"],
                                      variables["batch_stats"]))
    return model


# ---------------------------------------------------------------- loss

def _grids(seed, b, g, nb, nc, n_obj):
    """(y_pred, y_true) grids: predictions in (0, 1) (softmax classes),
    ``n_obj`` object cells with the target's center in the cell and w, h
    in (0.05, 0.6) of the image."""
    rng = np.random.RandomState(seed)
    y_pred = rng.uniform(0.02, 0.98, (b, g, g, 5 * nb + nc))
    if nc:
        logits = rng.randn(b, g, g, nc)
        y_pred[..., 5 * nb:] = np.exp(logits) / np.exp(logits).sum(
            -1, keepdims=True)
    y_true = np.zeros((b, g, g, 5 + nc))
    for cell in rng.choice(b * g * g, n_obj, replace=False):
        i, r, c = np.unravel_index(cell, (b, g, g))
        y_true[i, r, c, :5] = [1.0, *rng.uniform(0, 1, 2),
                               *rng.uniform(0.05, 0.6, 2)]
        if nc:
            y_true[i, r, c, 5 + rng.randint(nc)] = 1.0
    return y_pred.astype(np.float32), y_true.astype(np.float32)


def _loss_case(case):
    """(n_boxes, n_classes, y_pred, y_true) of one named case."""
    if case == "b1_c43":
        return (1, 43) + _grids(0, 4, 2, 1, 43, 5)
    if case == "b2_c0":
        return (2, 0) + _grids(1, 4, 2, 2, 0, 5)
    if case == "no_object":
        return (1, 43) + _grids(2, 3, 2, 1, 43, 0)
    y_pred, y_true = _grids(3, 4, 2, 2, 0, 6)
    obj = y_true[..., 0] == 1
    if case == "tie":
        # box 1 = box 0 everywhere: equal IoUs, the first is responsible
        y_pred[..., 6:10] = y_pred[..., 1:5]
    elif case == "masked_w_zero":
        # box 0 on the target (IoU 1, responsible); box 1's w, and every
        # box's w in the empty cells, underflowed to 0
        y_pred[obj, 1:5] = y_true[obj, 1:5]
        y_pred[obj, 8] = 0.0
        y_pred[~obj, 3] = 0.0
        y_pred[~obj, 8] = 0.0
    elif case == "responsible_w_zero":
        # the responsible box's w underflowed to 0 (box 1 far off)
        y_pred[obj, 6:10] = [0.0, 0.0, 1e-3, 1e-3]
        y_pred[obj, 3] = 0.0
    return (2, 0, y_pred, y_true)


LOSS_CASES = ["b1_c43", "b2_c0", "no_object", "tie", "masked_w_zero",
              "responsible_w_zero"]


@pytest.mark.parametrize("case", LOSS_CASES)
def test_dark_loss_and_grad_match_jax(case):
    nb, nc, y_pred, y_true = _loss_case(case)
    p = dict(SMALL, n_boxes=nb, n_classes=nc)
    jcfg = jax_losses.LossConfig.from_params(JaxParams(**p))
    cfg = losses.LossConfig.from_params(Params(**p))

    def jloss(yp):
        loss, aux = jax_losses.dark_loss(yp, jnp.asarray(y_true), jcfg)
        return loss, aux["avg_iou"]

    (want, want_iou), want_g = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(y_pred))
    want_g = np.asarray(want_g)
    yp = torch.from_numpy(y_pred).requires_grad_()
    got, aux = losses.dark_loss(yp, torch.from_numpy(y_true), cfg)
    got.backward()
    got_g = yp.grad.numpy()
    assert got.dim() == 0 and aux["avg_iou"].dim() == 0
    assert not aux["avg_iou"].requires_grad  # no gradient reaches it
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(aux["avg_iou"].item(), float(want_iou),
                               rtol=1e-5, atol=1e-7)
    finite = np.isfinite(want_g)
    if case == "responsible_w_zero":
        # the responsible lane keeps the reference's infinite gradient of
        # sqrt at 0 (JAX losses.py:149-155); nothing else is touched
        assert not finite.all() and (finite == np.isfinite(got_g)).all()
        assert (got_g[~finite] == want_g[~finite]).all()
    else:
        assert finite.all() and np.isfinite(got_g).all()
    scale = np.abs(want_g[finite]).max()
    np.testing.assert_allclose(got_g[finite], want_g[finite], rtol=1e-4,
                               atol=1e-6 * scale)
    if case == "no_object":
        assert aux["avg_iou"].item() == 0.0  # COMPAT #1


# ---------------------------------------------------------------- model

def _train_band(bf16):
    """f32: the band of the eval forward (tests/test_torch_port_model.py),
    f32 conv sums in another order over 18 layers (measured here: 5.8e-5
    relative, 1.5e-5 absolute at most); bf16: the convs round at other
    places."""
    return (dict(rtol=0.05, atol=5e-3) if bf16
            else dict(rtol=1e-4, atol=1e-5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_forward_and_running_stats_match_flax(dtype):
    """Three train-mode forwards at batch 2, where the last grid is 2x2
    and flax's biased running variance differs from torch's unbiased one
    by 8/7 (n = 8 values per channel)."""
    bf16 = dtype == "bfloat16"
    _, variables = jax_darknet(1, 43, seed=3)
    jmodel = JaxDarkNet(n_boxes=1, n_classes=43, dropout=0.0,
                        dtype=jnp.bfloat16 if bf16 else None)
    model = _port_darknet(variables, getattr(torch, dtype)).train()
    rng = np.random.RandomState(4)
    stats = variables["batch_stats"]
    for _ in range(3):
        x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
        want, upd = jmodel.apply(
            {"params": variables["params"], "batch_stats": stats},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        got = model(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == (2, 2, 2, 48)
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(want, np.float32),
                                   **_train_band(bf16))
    want_sd = _state_dict(variables["params"], stats)
    got_sd = model.state_dict()
    for k, w in want_sd.items():
        if k.endswith(("running_mean", "running_var")):
            assert got_sd[k].dtype == torch.float32, k
            # bf16: statistics of bf16 activations
            np.testing.assert_allclose(
                got_sd[k].numpy(), w.numpy(), err_msg=k,
                **(dict(rtol=0.05, atol=5e-3) if bf16
                   else dict(rtol=1e-5, atol=1e-6)))
    assert int(got_sd["model.bn_18.num_batches_tracked"]) == 3


def test_biased_running_variance_at_batch_two():
    """The BN buffer takes the biased batch variance: (1 - m) rv + m var."""
    gen = torch.Generator().manual_seed(0)
    model = DarkNet(1, 43, seed=0).train()
    model(torch.rand(2, 64, 64, 3, generator=gen))  # rv away from 1
    bn = model.model.bn_18
    # block 18 runs on the last 2x2 map: n = 8 values per channel
    seen = {}
    model._blocks[-1][0].register_forward_hook(
        lambda m, i, o: seen.update(x=i[0]))
    rv = bn.running_var.clone()
    model(torch.rand(2, 64, 64, 3, generator=gen))
    assert seen["x"].shape[2:] == (2, 2)
    var = F.conv2d(seen["x"], model.model.conv_18.weight, padding=1).var(
        dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.99 * rv + 0.01 * var,
                               rtol=1e-5, atol=1e-7)


def test_dropout_is_flax_dropout_from_the_generator():
    x = torch.rand(4, 8, 6, 6) + 0.5
    g = torch.Generator().manual_seed(11)
    a = dropout(x, 0.5, g)
    b = dropout(x, 0.5, torch.Generator().manual_seed(11))
    c = dropout(x, 0.5, g)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert 0.35 < kept.float().mean().item() < 0.65
    torch.testing.assert_close(a[kept], 2 * x[kept], rtol=0, atol=0)


def test_darknet_dropout_needs_and_follows_the_generator():
    model = DarkNet(1, 43, dropout=0.5, seed=0).train()
    x = torch.rand(2, 64, 64, 3)
    with pytest.raises(ValueError, match="torch.Generator"):
        model(x)
    torch.manual_seed(0)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    a = model(x, generator=torch.Generator().manual_seed(5))
    model.load_state_dict(state)
    torch.manual_seed(1)  # the global RNG plays no part
    b = model(x, generator=torch.Generator().manual_seed(5))
    model.load_state_dict(state)
    c = model(x, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.eval()  # eval: no dropout, no generator needed
    torch.testing.assert_close(model(x), model(x), rtol=0, atol=0)


def test_init_darknet_is_seeded_and_torch_default():
    a, b, c = (DarkNet(1, 43, seed=s) for s in (1, 1, 2))
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(p, q), name
        if ".conv_" in name:
            assert not torch.equal(p, r), name
            bound = 1 / p[0].numel() ** 0.5
            # U(-bound, bound) drawn in f32
            assert p.abs().max().item() <= bound * (1 + 1e-6), name
            assert p.abs().max().item() > 0.9 * bound, name
    for i in range(1, 19):
        bn = getattr(a.model, f"bn_{i}")
        assert bool((bn.weight == 1).all() and (bn.bias == 0).all()
                    and (bn.running_mean == 0).all()
                    and (bn.running_var == 1).all())


# ---------------------------------------------------------------- npz

def test_npz_load_matches_jax(tmp_path):
    path = str(tmp_path / "darknet19_weights.npz")
    write_darknet19_npz(path)
    _, variables = jax_darknet(1, 43, seed=5)
    want = jax_load_npz(variables, path, n_load_layer=18)
    model = _port_darknet(variables)
    load_darknet19_npz(model, path, n_load_layer=18)
    want_sd = _state_dict(want["params"], want["batch_stats"])
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want_sd[k].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("fine_tune", [5, 18])
def test_freeze_keeps_frozen_weights_and_moves_their_stats(tmp_path,
                                                           fine_tune,
                                                           capsys):
    """Two Adam steps with blocks 1..fine_tune frozen: their weights stay
    the npz's to the bit, they stay out of Adam, their BN running
    statistics still move; the rest trains."""
    path = str(tmp_path / "w.npz")
    arrs = write_darknet19_npz(path)
    model = DarkNet(1, 43, seed=0)
    load_darknet19_npz(model, path)
    n_frozen = freeze_darknet(model, fine_tune)
    opt = steps.make_optimizer(model)
    trained = {id(p) for g in opt.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        idx = int(name.split("_")[1].split(".")[0])
        assert p.requires_grad == (idx > fine_tune), name
        assert (id(p) in trained) == p.requires_grad, name
    assert summary.summarize(model) == sum(
        p.numel() for p in model.parameters()) - n_frozen
    assert "Frozen params: {:,}".format(n_frozen) in capsys.readouterr().out
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = losses.LossConfig.from_params(Params(**SMALL))
    model.train()
    for i in range(2):
        x, y = _batch(i)
        steps.train_step(model, opt, torch.from_numpy(x), torch.from_numpy(y),
                         1e-3, cfg, "darknet_r")
    sd = model.state_dict()
    for i in range(1, fine_tune + 1):
        np.testing.assert_array_equal(
            sd[f"model.conv_{i}.weight"].numpy(),
            arrs[f"{i - 1}-scope/kernel:0"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd[f"model.bn_{i}.weight"].numpy(),
                                      arrs[f"{i - 1}-scope/gamma:0"])
        np.testing.assert_array_equal(sd[f"model.bn_{i}.bias"].numpy(),
                                      arrs[f"{i - 1}-scope/biases:0"])
    assert not torch.equal(sd["model.bn_1.running_mean"],
                           before["model.bn_1.running_mean"])
    nxt = f"model.conv_{fine_tune + 1}.weight"
    assert not torch.equal(sd[nxt], before[nxt])


# ---------------------------------------------------------------- metric

@pytest.mark.parametrize("seed", [0, 1])
def test_detect_and_recog_acc_matches_jax(seed):
    rng = np.random.RandomState(seed)
    p = Params(**dict(SMALL, n_grid=4))
    y = np.zeros((6, 4, 4, 48), np.float32)
    for i, r, c in zip(range(6), rng.randint(0, 4, 6), rng.randint(0, 4, 6)):
        y[i, r, c, :5] = [1.0, *rng.uniform(0.2, 0.8, 2),
                          *rng.uniform(0.1, 0.4, 2)]
        y[i, r, c, 5 + rng.randint(3)] = 1.0
    # predictions: the targets jittered, some confident boxes elsewhere,
    # classes among the first three so that some agree
    y_hat = y + 0.05 * rng.randn(*y.shape).astype(np.float32)
    y_hat[..., 0] = np.where(y[..., 0] == 1, 0.9,
                             rng.uniform(0, 0.6, y[..., 0].shape))
    y_hat[..., 5:8] += rng.uniform(0, 0.6, y_hat[..., 5:8].shape)
    want = jax_det.detect_and_recog_acc(y, y_hat, JaxParams(**dict(
        SMALL, n_grid=4)))
    got = det.detect_and_recog_acc(y, y_hat, p)
    assert 0 < want < 1
    assert got == want


# ---------------------------------------------------------------- steps

def _jax_state(variables):
    params = variables["params"]
    return jax_steps.TrainState(
        params=params, batch_stats=variables["batch_stats"],
        opt_state=jax_steps.make_optimizer().init(params),
        rng=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))


def _batch(seed, n=4):
    """n scenes of noise with darknet_r's synthetic grids: noise, not the
    synthetic set's flat signs, whose equal pixels tie in the max-pools
    (a tie takes the gradient to whichever value the conv's rounding
    made larger, in each framework its own)."""
    _, y, _, _ = loader.synthetic_dataset("darknet_r", Params(**SMALL),
                                          n * (seed + 1), 0)
    x = np.random.RandomState(seed).uniform(-1, 1, (n, 64, 64, 3))
    return x.astype(np.float32), y[-n:]


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _port_layout(tree, name):
    """The leaf of a JAX params (or batch_stats) tree that the port's
    ``name`` holds, in the port's layout and the tree's own dtype (the
    interop's state_dict is f32)."""
    layer, kind = name.split(".")[1:]
    i = int(layer.split("_")[1])
    node = tree[layer] if i == 19 else tree[f"block_{i}"][layer]
    leaf = node[{"weight": "kernel" if layer.startswith("conv") else "scale",
                 "bias": "bias", "running_mean": "mean",
                 "running_var": "var"}[kind]]
    leaf = np.asarray(leaf)
    return leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4 else leaf


# float64: both frameworks in f64, the same step to rounding; float32:
# the port in f32 against the JAX step in f64, atol a share of each
# gradient's largest value (measured: 3e-5 at most, through 18
# train-mode batch norms).  The JAX step in f32 is no reference here:
# flax's BatchNorm takes the variance as E[x^2] - E[x]^2, which cancels
# in f32 for a channel whose mean is large beside its spread; on these
# inputs its conv_1..conv_5 gradients are off by up to 3.8% of their
# largest value (the float32 case prints both)
STEP_DTYPES = {"float64": (torch.float64, dict(rtol=1e-9, atol=1e-12)),
               "float32": (torch.float32, dict(rtol=1e-4, atol=5e-5))}


@pytest.mark.parametrize("dtype", list(STEP_DTYPES))
def test_train_step_grads_match_jax(dtype):
    tdt, band = STEP_DTYPES[dtype]
    _, variables = jax_darknet(1, 43, seed=12)
    variables = _f64(variables)
    jmodel = JaxDarkNet(n_boxes=1, n_classes=43, dropout=0.0)
    x, y = _batch(0)
    jcfg = jax_losses.LossConfig.from_params(JaxParams(**SMALL))
    loss_w, grads = jax_steps.make_grad_fn(jmodel, "darknet_r", jcfg)(
        _jax_state(variables), jnp.asarray(x, jnp.float64),
        jnp.asarray(y, jnp.float64))
    assert loss_w.dtype == jnp.float64
    model = _port_darknet(variables, tdt).train()
    cfg = losses.LossConfig.from_params(Params(**SMALL))
    loss, y_hat, aux = steps.loss_and_scores(
        model, torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt), cfg,
        "darknet_r")
    loss.backward()
    assert set(aux) == {"avg_iou"} and y_hat.shape == (4, 2, 2, 48)
    np.testing.assert_allclose(loss.item(), float(loss_w),
                               rtol=band["rtol"] / 10)
    for name, p in model.named_parameters():
        w = _port_layout(grads, name)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=band["rtol"],
                                   atol=band["atol"] * np.abs(w).max(),
                                   err_msg=name)
    if dtype == "float32":
        # the measurement behind STEP_DTYPES' note (shown with pytest -s):
        # the JAX step's own f32 gradients against its f64 ones
        _, grads32 = jax_steps.make_grad_fn(jmodel, "darknet_r", jcfg)(
            _jax_state(_to_np(jax_darknet(1, 43, seed=12)[1])),
            jnp.asarray(x), jnp.asarray(y))

        def worst(get):
            return max(float(np.abs(get(n) - _port_layout(grads, n)).max()
                             / np.abs(_port_layout(grads, n)).max())
                       for n, _ in model.named_parameters())

        print("\n[darknet step f32] largest gradient error over max|g| "
              "against f64: port {:.3g}, JAX {:.3g}".format(
                  worst(lambda n: dict(model.named_parameters())[n]
                        .grad.numpy()),
                  worst(lambda n: _port_layout(grads32, n))))


def test_adam_steps_match_jax():
    """Three Adam steps, both frameworks in f64 (the BN statistics
    too).  Not in f32: Adam's first steps move each parameter by about
    lr times the sign of its gradient, so a component near zero whose
    sign the rounding flips moves 2 lr the other way."""
    _, variables = jax_darknet(1, 43, seed=13)
    variables = _f64(variables)
    jmodel = JaxDarkNet(n_boxes=1, n_classes=43, dropout=0.0)
    jcfg = jax_losses.LossConfig.from_params(JaxParams(**SMALL))
    step = jax_steps.make_train_step(jmodel, "darknet_r", jcfg, donate=False)
    state = _jax_state(variables)
    model = _port_darknet(variables, torch.float64).train()
    opt = steps.make_optimizer(model)
    cfg = losses.LossConfig.from_params(Params(**SMALL))
    for i in range(3):
        x, y = _batch(i + 1)
        state, loss_w, aux_w, _ = step(
            state, jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64),
            1e-3)
        loss, _, aux = steps.train_step(
            model, opt, torch.from_numpy(x).double(),
            torch.from_numpy(y).double(), 1e-3, cfg, "darknet_r")
        np.testing.assert_allclose(loss.item(), float(loss_w), rtol=1e-10)
        np.testing.assert_allclose(aux["avg_iou"].item(),
                                   float(aux_w["avg_iou"]), rtol=1e-10)
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        tree = state.batch_stats if "running" in name else state.params
        # atol 1e-5 of a step (lr 1e-3): m / (sqrt(v) + 1e-8) carries the
        # rounding of a gradient near 1e-8 into the update (measured up
        # to 2e-10)
        np.testing.assert_allclose(t.numpy(), _port_layout(tree, name),
                                   rtol=1e-9, atol=1e-8, err_msg=name)
    for p in model.parameters():
        assert opt.state[p]["exp_avg"].dtype == torch.float64


def test_bf16_keeps_master_params_and_moments_f32():
    model = DarkNet(1, 43, dropout=0.5, dtype=torch.bfloat16, seed=0).train()
    opt = steps.make_optimizer(model)
    x, y = _batch(0, n=2)
    loss, y_hat, aux = steps.train_step(
        model, opt, torch.from_numpy(x), torch.from_numpy(y), 1e-3,
        losses.LossConfig.from_params(Params(**SMALL)), "darknet_r",
        torch.Generator().manual_seed(0))
    assert torch.isfinite(loss) and y_hat.dtype == torch.float32
    assert aux["avg_iou"].dtype == torch.float32
    for p in model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        st = opt.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    for name, t in model.named_buffers():
        if not name.endswith("num_batches_tracked"):
            assert t.dtype == torch.float32 and torch.isfinite(t).all(), name
