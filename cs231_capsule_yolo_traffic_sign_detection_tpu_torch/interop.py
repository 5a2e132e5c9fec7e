"""JAX variables -> the port's state_dict (darknet models).

The JAX package keeps ``{"params", "batch_stats"}`` trees with HWIO
conv kernels; the port registers the reference state_dict keys and
OIHW layouts.  `jax_variables_to_state_dict` is the darknet half of the
JAX package's ``interop.variables_to_torch_state_dict``, written again
here on numpy arrays so the port imports nothing of that package.
"""

from collections import OrderedDict

import numpy as np
import torch

from .models.darknet import DARKNET_LAYERS

DARKNET_MODELS = ("darknet_d", "darknet_r")


def _conv(kernel_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(kernel_hwio, np.float32), (3, 2, 0, 1))))


def _f32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def jax_variables_to_state_dict(variables_np, model_name):
    """``{"params", "batch_stats"}`` of numpy arrays -> DarkNet state_dict.

    Kernels go HWIO -> OIHW; BN scale/bias/mean/var go to
    weight/bias/running_mean/running_var; ``num_batches_tracked`` is 0.
    Keys are inserted in the reference's registration order, so
    ``DarkNet.load_state_dict(strict=True)`` accepts the result.
    """
    if model_name not in DARKNET_MODELS:
        raise ValueError(f"{model_name!r} is not ported yet: "
                         f"{' | '.join(DARKNET_MODELS)}")
    p, bs = variables_np["params"], variables_np["batch_stats"]
    out = OrderedDict()
    for i in range(1, len(DARKNET_LAYERS) + 1):
        block_p, block_s = p[f"block_{i}"], bs[f"block_{i}"]
        out[f"model.conv_{i}.weight"] = _conv(block_p[f"conv_{i}"]["kernel"])
        bn, st = block_p[f"bn_{i}"], block_s[f"bn_{i}"]
        out[f"model.bn_{i}.weight"] = _f32(bn["scale"])
        out[f"model.bn_{i}.bias"] = _f32(bn["bias"])
        out[f"model.bn_{i}.running_mean"] = _f32(st["mean"])
        out[f"model.bn_{i}.running_var"] = _f32(st["var"])
        out[f"model.bn_{i}.num_batches_tracked"] = torch.zeros(
            (), dtype=torch.int64)
    out["model.conv_19.weight"] = _conv(p["conv_19"]["kernel"])
    return out
