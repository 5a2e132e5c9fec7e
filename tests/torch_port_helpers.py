"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_port_*).

Weights are made once on the JAX side (flax init, plus randomised BN
statistics for DarkNet so the BN fold is not trivial) and cross to the
port as numpy arrays through the port's own interop; or, where a flax
init would take seconds, made by the port and carried to JAX by the JAX
package's converter (`jax_variables_from_port`).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu.models import (
    CapsuleNet as JaxCapsuleNet, ConvNet as JaxConvNet, DarkNet as JaxDarkNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.interop import (
    jax_variables_to_state_dict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
    CapsuleNet as TorchCapsuleNet, ConvNet as TorchConvNet,
    DarkNet as TorchDarkNet)


def jax_darknet(n_boxes, n_classes, size=64, seed=0):
    """(flax module, numpy variables with perturbed BN params/stats)."""
    model = JaxDarkNet(n_boxes=n_boxes, n_classes=n_classes, dropout=0.0)
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed), x, train=False)
    rng = np.random.RandomState(seed + 1)

    def perturb(path, a):
        a = np.asarray(a)
        names = [str(getattr(p, "key", "")) for p in path]
        if any(n.startswith("bn_") for n in names):
            return (a + 0.05 * np.abs(rng.randn(*a.shape))).astype(a.dtype)
        return a

    variables = jax.tree_util.tree_map_with_path(perturb, dict(variables))
    return model, variables


def jax_capsulenet(n_classes, seed=0, dtype=None):
    """(flax CapsuleNet with XLA routing, numpy variables).

    The two convs are scaled up (x3, x10) so the primary capsules are
    near unit length and the class scores spread over ~0.05-0.3: flax's
    torch-default init leaves them at ~2e-3, under the tests' atol.
    """
    model = JaxCapsuleNet(n_classes=n_classes, routing_impl="xla",
                          dtype=dtype)
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed), x)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    p = variables["params"]
    p["conv1"]["kernel"] *= 3.0
    p["primary_capsules"]["Conv_0"]["kernel"] *= 10.0
    return model, variables


def torch_capsulenet(variables_np, n_classes, dtype=torch.float32):
    """The port's eval-mode CapsuleNet loaded (strict) from JAX variables."""
    model = TorchCapsuleNet(n_classes=n_classes, dtype=dtype)
    model.load_state_dict(
        jax_variables_to_state_dict(variables_np, "capsule"), strict=True)
    return model.eval()


def torch_darknet(variables_np, n_boxes, n_classes, model_name="darknet_r"):
    """The port's eval-mode DarkNet loaded (strict) from JAX variables."""
    model = TorchDarkNet(n_boxes=n_boxes, n_classes=n_classes)
    model.load_state_dict(
        jax_variables_to_state_dict(variables_np, model_name), strict=True)
    return model.eval()


def write_darknet19_npz(path, seed=7):
    """A synthetic pretrained npz in the TF-format key layout both
    loaders read ('{i}-scope/kernel:0' HWIO kernels, biases / gamma /
    moving_mean / moving_variance per layer, layers 1-18), as
    tests/test_convergence_parity.py writes it; returns its arrays."""
    from cs231_capsule_yolo_traffic_sign_detection_tpu.models.darknet import (
        DARKNET_LAYERS)

    rng = np.random.RandomState(seed)
    arrs = {}
    in_c = 3
    for i, (out_c, k, _) in enumerate(DARKNET_LAYERS[:18]):
        arrs[f"{i}-scope/kernel:0"] = (
            0.05 * rng.randn(k, k, in_c, out_c)).astype(np.float32)
        arrs[f"{i}-scope/biases:0"] = (
            0.1 * rng.randn(out_c)).astype(np.float32)
        arrs[f"{i}-scope/gamma:0"] = (
            1.0 + 0.1 * rng.randn(out_c)).astype(np.float32)
        arrs[f"{i}-scope/moving_mean:0"] = (
            0.1 * rng.randn(out_c)).astype(np.float32)
        arrs[f"{i}-scope/moving_variance:0"] = (
            0.5 + rng.rand(out_c)).astype(np.float32)
        in_c = out_c
    np.savez(path, **arrs)
    return arrs


def jax_convnet(n_classes=43, seed=0, dtype=None, dropout=0.0):
    """(flax ConvNet, numpy variables) with BN scale, bias and running
    statistics perturbed away from their defaults, so the BN in eval
    mode is not an identity."""
    model = JaxConvNet(n_classes=n_classes, dropout=dropout, dtype=dtype)
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed), x)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    rng = np.random.RandomState(seed + 1)
    for j in range(2):
        bn_p = variables["params"][f"BatchNorm_{j}"]
        bn_s = variables["batch_stats"][f"BatchNorm_{j}"]
        c = bn_p["scale"].shape
        bn_p["scale"] = (1 + 0.2 * rng.randn(*c)).astype(np.float32)
        bn_p["bias"] = (0.1 * rng.randn(*c)).astype(np.float32)
        bn_s["mean"] = (0.1 * rng.randn(*c)).astype(np.float32)
        bn_s["var"] = (0.5 + rng.rand(*c)).astype(np.float32)
    return model, variables


def torch_convnet(variables_np, n_classes=43, dtype=torch.float32):
    """The port's eval-mode ConvNet loaded (strict) from JAX variables
    (float64: parameters and buffers too)."""
    model = TorchConvNet(n_classes=n_classes, dropout=0.0, dtype=dtype)
    if dtype == torch.float64:
        model.double()
    model.load_state_dict(
        jax_variables_to_state_dict(variables_np, "cnn"), strict=True)
    return model.eval()


def jax_variables_from_port(model, model_name, jmodel, input_shape):
    """The JAX variables (numpy) holding ``model``'s weights, through the
    JAX package's own converter (interop.torch_to_variables) on a
    template from ``jax.eval_shape`` of ``jmodel``'s init: no flax init
    runs (op by op it takes seconds)."""
    from cs231_capsule_yolo_traffic_sign_detection_tpu import (
        interop as jax_interop)

    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + tuple(input_shape))))
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    sd = {k: v.detach().float().numpy() for k, v in model.state_dict().items()
          if v.is_floating_point()}
    return jax_interop.torch_to_variables(sd, model_name, template)


def raise_bn(model, seed):
    """``model`` with each BN parameter and statistic raised by 0.05
    |N(0, 1)|, as JAX's int8 test builds its network."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in (list(model.named_parameters())
                        + list(model.named_buffers())):
            if ".bn_" in name and t.is_floating_point():
                t.add_(torch.from_numpy(0.05 * np.abs(rng.randn(*t.shape))))
    return model


def port_capsulenet(n_classes, seed, dtype=torch.float32):
    """The port's CapsuleNet with its two convs scaled up (x3, x10), as
    `jax_capsulenet` scales JAX's (class scores spread over ~0.05-0.3),
    and the same weights as JAX variables (`jax_variables_from_port`)."""
    model = TorchCapsuleNet(n_classes, dtype=dtype, seed=seed).eval()
    with torch.no_grad():
        model.conv1.weight.mul_(3.0)
        for m in model.primary_capsules.capsules:
            m.weight.mul_(10.0)
    return model, jax_variables_from_port(
        model, "capsule", JaxCapsuleNet(n_classes, routing_impl="xla"),
        (32, 32, 3))
