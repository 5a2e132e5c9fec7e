"""JAX variables -> the port's state_dict (darknet models and CapsuleNet).

The JAX package keeps ``{"params", "batch_stats"}`` trees with HWIO
conv kernels; the port registers the reference state_dict keys and
OIHW layouts.  `jax_variables_to_state_dict` is the darknet and capsule
half of the JAX package's ``interop.variables_to_torch_state_dict``,
written again here on numpy arrays so the port imports nothing of that
package.
"""

from collections import OrderedDict

import numpy as np
import torch

from .models.darknet import DARKNET_LAYERS

DARKNET_MODELS = ("darknet_d", "darknet_r")
MODELS = DARKNET_MODELS + ("capsule",)
# CapsuleNet's primary capsules: 16 channels at 9 x 9 positions, 8 convs
CAPS_CHANNELS, CAPS_POSITIONS, CAPS_CONVS = 16, 81, 8


def _conv(kernel_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(kernel_hwio, np.float32), (3, 2, 0, 1))))


def _f32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _darknet(p, bs):
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


def _capsule(p):
    """CapsuleNet: split the fused primary-capsule conv into the
    reference's eight, and reorder the route weights' nodes from the JAX
    package's (position, channel) to the reference's (channel, position)."""
    out = OrderedDict()
    out["conv1.weight"] = _conv(p["conv1"]["kernel"])
    out["conv1.bias"] = _f32(p["conv1"]["bias"])
    pc = p["primary_capsules"]["Conv_0"]
    kernels = np.split(np.asarray(pc["kernel"]), CAPS_CONVS, axis=3)
    biases = np.split(np.asarray(pc["bias"]), CAPS_CONVS)
    for j in range(CAPS_CONVS):
        out[f"primary_capsules.capsules.{j}.weight"] = _conv(kernels[j])
        out[f"primary_capsules.capsules.{j}.bias"] = _f32(biases[j])
    # JAX node p*16 + c holds reference node c*81 + p
    pos, ch = np.meshgrid(np.arange(CAPS_POSITIONS), np.arange(CAPS_CHANNELS),
                          indexing="ij")
    jax_node_of_ref = np.empty(CAPS_POSITIONS * CAPS_CHANNELS, np.int64)
    jax_node_of_ref[(ch * CAPS_POSITIONS + pos).ravel()] = \
        (pos * CAPS_CHANNELS + ch).ravel()
    w = np.asarray(p["traffic_sign_capsules"]["route_weights"])
    out["traffic_sign_capsules.route_weights"] = _f32(w[jax_node_of_ref][None])
    dec = p["decoder"]
    out["decoder.0.weight"] = _f32(np.transpose(dec["Dense_0"]["kernel"]))
    out["decoder.0.bias"] = _f32(dec["Dense_0"]["bias"])
    for j, idx in enumerate((4, 7, 10, 12)):
        out[f"decoder.{idx}.weight"] = _conv(dec[f"Conv_{j}"]["kernel"])
        out[f"decoder.{idx}.bias"] = _f32(dec[f"Conv_{j}"]["bias"])
    return out


def jax_variables_to_state_dict(variables_np, model_name):
    """``{"params"[, "batch_stats"]}`` of numpy arrays -> the port's
    state_dict for ``model_name``, keys in the reference's registration
    order, so ``load_state_dict(strict=True)`` accepts it.

    Kernels go HWIO -> OIHW and dense kernels (in, out) -> (out, in);
    DarkNet's BN scale/bias/mean/var go to weight/bias/running_mean/
    running_var with ``num_batches_tracked`` 0.
    """
    if model_name not in MODELS:
        raise ValueError(f"{model_name!r} is not ported yet: "
                         f"{' | '.join(MODELS)}")
    if model_name == "capsule":
        return _capsule(variables_np["params"])
    return _darknet(variables_np["params"], variables_np["batch_stats"])
