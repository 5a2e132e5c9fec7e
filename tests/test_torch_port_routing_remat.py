"""PyTorch port, ``--routing`` and ``--remat`` (CPU): the routing rule
against the JAX registry's, CapsuleNet's forward and train step under
the two routings against each other and against the JAX CapsuleNet with
XLA routing, one detector step with and without rematerialization
against the JAX package's remat gradients (the cases of
tests/test_remat.py), with the BN buffers and the dropout generator
left as without it, and the flags from the CLI and params.json to
`build_model`."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu import (
    losses as jax_losses)
from cs231_capsule_yolo_traffic_sign_detection_tpu.models import (
    CapsuleNet as JaxCapsuleNet, DarkCapsuleNet as JaxDarkCapsuleNet,
    DarkNet as JaxDarkNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu.models import (
    registry as jax_registry)
from cs231_capsule_yolo_traffic_sign_detection_tpu.params import (
    Params as JaxParams)
from cs231_capsule_yolo_traffic_sign_detection_tpu.train import (
    steps as jax_steps)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import (
    __main__ as cli, losses)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.interop import (
    jax_variables_to_state_dict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
    CapsuleNet, DarkCapsuleNet, DarkNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models.registry \
    import resolve_routing_impl
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import routing
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    driver, steps)

from torch_port_helpers import (jax_variables_from_port, port_capsulenet,
                                raise_bn)
from test_torch_port_darkcapsule import (SMALL as DCAPS, _jax_state,
                                         _port_layout, _scenes, _grids,
                                         port_darkcapsule)
from test_torch_port_train import TRAIN, _batch, _grads_as_state_dict

# tests/test_remat.py's detector: 64 px, one box, 3 classes, batch 2
REMAT = dict(model="darknet_r", n_boxes=1, n_classes=3, n_grid=2,
             darknet_input=64, l_coord=5.0, l_noobj=0.5, dropout=0.0)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


# ---------------------------------------------------------------- routing

def test_resolve_routing_impl_rules():
    for impl in ("xla", "pallas"):
        for model in ("capsule", "darkcapsule"):
            for dev in ("cuda", "cpu"):
                assert resolve_routing_impl(impl, model, dev) == impl
    assert resolve_routing_impl("auto", "capsule", "cuda") == "pallas"
    assert resolve_routing_impl("auto", "darkcapsule", "cuda") == "xla"
    assert resolve_routing_impl("auto", "capsule", "cpu") == "xla"
    # the JAX rule off the TPU, as these tests run it
    assert jax_registry.resolve_routing_impl("auto", "capsule") == "xla"
    with pytest.raises(ValueError, match="auto | xla | pallas"):
        resolve_routing_impl("triton", "capsule")


# the capsule training config at 5 classes: the same graph, a fifth of
# the routing's work on both sides
TRAIN5 = dict(TRAIN, n_classes=5)


def _capsule_step(model, x, y):
    cfg = losses.LossConfig.from_params(Params(**TRAIN5))
    loss, _, _ = steps.loss_and_scores(model.train(), torch.from_numpy(x),
                                       torch.from_numpy(y), cfg, "capsule")
    loss.backward()
    return loss.item(), {n: p.grad.numpy() for n, p in
                         model.named_parameters()}


def test_capsulenet_routings_match_each_other_and_jax():
    """Forward and one train step (recon loss) under ``xla`` (the plain
    composition, autograd) and ``pallas`` (K3/K4's plain versions), both
    on the CPU, against each other and JAX ``CapsuleNet(routing_impl=
    "xla")`` (jax.grad): scores at rtol 1e-4 (the capsule parity band),
    gradients at rtol 1e-4 / atol 1e-5 of each one's largest value (the
    port's step band against JAX)."""
    model, variables = port_capsulenet(5, seed=12)
    jmodel = JaxCapsuleNet(5, routing_impl="xla")
    x, y = _batch(7, n=2)
    y = y % 5
    want_scores = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    jcfg = jax_losses.LossConfig.from_params(JaxParams(**TRAIN5))
    loss_w, grads = jax_steps.make_grad_fn(jmodel, "capsule", jcfg)(
        jax_steps.TrainState(
            params=variables["params"], batch_stats=None,
            opt_state=jax_steps.make_optimizer().init(variables["params"]),
            rng=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32)),
        jnp.asarray(x), jnp.asarray(y))
    want = {k: v.numpy() for k, v in _grads_as_state_dict(grads).items()}
    runs = {}
    state = model.state_dict()
    for impl in ("xla", "pallas"):
        model = CapsuleNet(5, routing_impl=impl)
        model.load_state_dict(state)
        before = routing.routed_capsules_backward.launches
        with torch.no_grad():
            scores = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(scores, want_scores, rtol=1e-4, atol=1e-5)
        runs[impl] = (scores,) + _capsule_step(model, x, y)
        assert routing.routed_capsules_backward.launches == before
    np.testing.assert_allclose(runs["xla"][0], runs["pallas"][0], rtol=2e-5,
                               atol=2e-6)
    for impl, (_, loss, got) in runs.items():
        np.testing.assert_allclose(loss, float(loss_w), rtol=1e-5)
        for name, g in got.items():
            for ref in (want[name], runs["pallas"][2][name]):
                np.testing.assert_allclose(
                    g, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max(),
                    err_msg=f"{impl} {name}")


# ---------------------------------------------------------------- remat

def _remat_batch(seed=0):
    """tests/test_remat.py's batch: uniform [0, 1) scenes, one object."""
    rng = np.random.RandomState(seed)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    y = np.zeros((2, 2, 2, 8), np.float32)
    y[:, 0, 1, 0] = 1.0
    y[:, 0, 1, 1:5] = [0.5, 0.5, 0.2, 0.3]
    y[:, 0, 1, 6] = 1.0
    return x, y


def _port_step(model, x, y, model_name, cfg, generator=None):
    """Loss, gradients, buffers and the generator's state after one
    forward and backward in train mode."""
    loss, _, _ = steps.loss_and_scores(model.train(), x, y, cfg, model_name,
                                       generator)
    loss.backward()
    return (loss.item(),
            {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None},
            {n: b.clone() for n, b in model.named_buffers()},
            None if generator is None else generator.get_state())


def _assert_same_step(a, b):
    """Remat against the plain step on the CPU: the same operations on
    the same values, so everything to the bit."""
    assert a[0] == b[0]
    assert a[1].keys() == b[1].keys() and a[2].keys() == b[2].keys()
    for n in a[1]:
        assert torch.equal(a[1][n], b[1][n]), n
    for n in a[2]:
        assert torch.equal(a[2][n], b[2][n]), n
    assert (a[3] is None) == (b[3] is None)
    assert a[3] is None or torch.equal(a[3], b[3])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_darknet_remat_matches_plain_and_jax(dtype):
    """One step in ``dtype`` with and without ``--remat``, dropout 0.5:
    the same loss, gradients, BN buffers (``num_batches_tracked`` moved
    once) and generator state, to the bit (JAX's test_remat holds its
    own remat step to its plain one).  Then, dropout 0 (JAX draws its
    own masks), against JAX ``DarkNet(remat=True)``: f32 in f64 on both
    sides (flax's f32 BN gradient is 4% off,
    tests/test_torch_port_darknet_train.py), the loss at rtol 1e-10 and
    every gradient at rtol 1e-9 / atol 1e-12 of its largest value; bf16
    the loss at rtol 2e-2.  bf16 gradients are not compared across the
    frameworks at this size: 18 train-mode BNs at batch 2 over maps down
    to 2x2 take both frameworks' bf16 gradients far from their f64 ones
    (cosine 0.56 for JAX's conv_1, 0.42-0.71 over the layers, measured
    on these inputs)."""
    tdt = getattr(torch, dtype)
    x, y = _remat_batch()
    cfg = losses.LossConfig.from_params(Params(**REMAT))
    runs = []
    for remat in (False, True):
        model = DarkNet(1, 3, dropout=0.5, dtype=tdt, seed=3, remat=remat)
        gen = torch.Generator().manual_seed(11)
        runs.append(_port_step(model, torch.from_numpy(x),
                               torch.from_numpy(y), "darknet_r", cfg, gen))
    _assert_same_step(*runs)
    assert runs[1][2]["model.bn_1.num_batches_tracked"].item() == 1

    f64 = dtype == "float32"
    jmodel = JaxDarkNet(n_boxes=1, n_classes=3, dropout=0.0,
                        dtype=None if f64 else jnp.bfloat16, remat=True)
    variables = jax_variables_from_port(
        raise_bn(DarkNet(1, 3, seed=4), 5), "darknet_r", jmodel, (64, 64, 3))
    if f64:
        variables, x, y = _f64(variables), x.astype(np.float64), \
            y.astype(np.float64)
    jcfg = jax_losses.LossConfig.from_params(JaxParams(**REMAT))
    loss_w, grads = jax_steps.make_grad_fn(jmodel, "darknet_r", jcfg)(
        jax_steps.TrainState(
            params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=jax_steps.make_optimizer().init(variables["params"]),
            rng=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32)),
        jnp.asarray(x), jnp.asarray(y))
    model = DarkNet(1, 3, dropout=0.0, remat=True,
                    dtype=torch.float64 if f64 else tdt)
    model.load_state_dict(jax_variables_to_state_dict(variables,
                                                      "darknet_r"))
    if f64:  # parameters and buffers too, from the f64 variables
        model.double()
        for name, t in model.state_dict().items():
            if t.is_floating_point():
                t.copy_(torch.from_numpy(_darknet_leaf(variables, name)))
    loss, got, _, _ = _port_step(model, torch.from_numpy(x),
                                 torch.from_numpy(y), "darknet_r", cfg)
    np.testing.assert_allclose(loss, float(loss_w),
                               rtol=1e-10 if f64 else 2e-2)
    print(f"\n[remat {dtype}] loss {loss} against JAX's {float(loss_w)}")
    for name, g in got.items():
        w = _darknet_leaf(grads, name)
        assert np.abs(w).max() > 0 and g.abs().max() > 0, name
        if f64:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-9,
                                       atol=1e-12 * np.abs(w).max(),
                                       err_msg=name)


def _darknet_leaf(tree, name):
    """The leaf of a JAX DarkNet tree (params or variables) that the
    port's ``name`` holds, in the port's layout and the tree's dtype."""
    params = tree.get("params", tree)
    layer, kind = name.split(".")[1:]
    i = int(layer.split("_")[1])
    if kind in ("running_mean", "running_var"):
        return np.asarray(tree["batch_stats"][f"block_{i}"][layer][kind[8:]])
    node = params[layer] if i == 19 else params[f"block_{i}"][layer]
    leaf = np.asarray(node[{"weight": "kernel" if layer.startswith("conv")
                            else "scale", "bias": "bias"}[kind]])
    return leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4 else leaf


def test_darkcapsule_remat_matches_plain_and_jax():
    """darkcapsule (no dropout; BN momentum 0.1): remat against the plain
    step to the bit, buffers included, and against JAX
    ``DarkCapsuleNet(remat=True)``'s gradients, both in f64 at batch 1
    (the band of tests/test_torch_port_darkcapsule.py's step)."""
    variables = _f64(jax_variables_from_port(
        raise_bn(DarkCapsuleNet(n_grid=2, seed=7), 8), "darkcapsule",
        JaxDarkCapsuleNet(n_grid=2), (64, 64, 3)))
    x, y = _scenes(8, n=1), _grids(9, b=1, n_obj=2)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    cfg = losses.LossConfig.from_params(Params(**DCAPS))
    runs = []
    for remat in (False, True):
        model = port_darkcapsule(variables, torch.float64)
        model.remat = remat
        runs.append(_port_step(model, xt, yt, "darkcapsule", cfg))
    _assert_same_step(*runs)
    assert runs[1][2]["conv.bn_1.num_batches_tracked"].item() == 1

    jmodel = JaxDarkCapsuleNet(n_grid=2, remat=True)
    jcfg = jax_losses.LossConfig.from_params(JaxParams(**DCAPS))
    loss_w, grads = jax_steps.make_grad_fn(jmodel, "darkcapsule", jcfg)(
        _jax_state(variables), jnp.asarray(x), jnp.asarray(y))
    loss, got, _, _ = runs[1]
    np.testing.assert_allclose(loss, float(loss_w), rtol=1e-10)
    for name, g in got.items():
        w = _port_layout(grads, None, name)
        if name.startswith("conv.conv") and name.endswith(".bias"):
            continue   # 0 but for rounding: in front of a train-mode BN
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9,
                                   atol=1e-12 * np.abs(w).max(),
                                   err_msg=name)


# ---------------------------------------------------------------- flags

def test_flags_reach_build_model(tmp_path):
    """--routing and --remat through the CLI's params, and routing_impl /
    remat from params.json alone, to the models `build_model` makes."""
    (tmp_path / "params.json").write_text(
        '{"n_classes": 43, "n_boxes": 1, "n_grid": 2, "darknet_input": 64, '
        '"routing_impl": "pallas", "remat": true}')
    for model_name in ("capsule", "darknet_r", "darkcapsule"):
        params = Params(str(tmp_path / "params.json"), model=model_name)
        model = driver.build_model(params, 0, "cpu")
        if model_name == "capsule":
            assert model.traffic_sign_capsules.impl == "pallas"
        else:
            assert model.remat is True
        args = cli.parser.parse_args(["--model", model_name, "--routing",
                                      "xla", "--remat"])
        params = cli.load_params(str(tmp_path), args, model_name)
        assert params.routing_impl == "xla" and params.remat is True
        model = driver.build_model(params, 0, "cpu")
        if model_name != "darknet_r":
            assert model.traffic_sign_capsules.impl == "xla"
        if model_name != "capsule":
            assert model.remat is True
    args = cli.parser.parse_args(["--model", "capsule"])
    params = cli.load_params(str(tmp_path), args, "capsule")
    assert (params.routing_impl, params.remat) == ("auto", False)
    assert driver.build_model(params, 0, "cpu").traffic_sign_capsules.impl \
        == "xla"   # auto on the CPU
    with pytest.raises(SystemExit):
        cli.main(["--model", "capsule", "--routing", "fused", "--mode",
                  "train"])
