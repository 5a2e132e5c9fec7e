"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_port_*).

Weights are made once on the JAX side (flax init plus randomised BN
statistics so the BN fold is not trivial) and cross to the port as
numpy arrays through the port's own interop.
"""

import numpy as np
import jax
import jax.numpy as jnp

from cs231_capsule_yolo_traffic_sign_detection_tpu.models import (
    DarkNet as JaxDarkNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.interop import (
    jax_variables_to_state_dict)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
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


def torch_darknet(variables_np, n_boxes, n_classes, model_name="darknet_r"):
    """The port's eval-mode DarkNet loaded (strict) from JAX variables."""
    model = TorchDarkNet(n_boxes=n_boxes, n_classes=n_classes)
    model.load_state_dict(
        jax_variables_to_state_dict(variables_np, model_name), strict=True)
    return model.eval()
