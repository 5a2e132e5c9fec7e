"""JAX variables -> the port's state_dict (darknet models, CapsuleNet,
ConvNet and DarkCapsuleNet).

The JAX package keeps ``{"params", "batch_stats"}`` trees with HWIO
conv kernels; the port registers the reference state_dict keys and
OIHW layouts.  `jax_variables_to_state_dict` is the JAX package's
``interop.variables_to_torch_state_dict`` for the five models,
written again here on numpy arrays so the port imports nothing of that
package.
"""

from collections import OrderedDict

import numpy as np
import torch

from .models.darkcapsule import DARKCAPSULE_LAYERS
from .models.darknet import DARKNET_LAYERS
from .models.layers import ReconDecoder

DARKNET_MODELS = ("darknet_d", "darknet_r")
MODELS = DARKNET_MODELS + ("capsule", "cnn", "darkcapsule")
# CapsuleNet's primary capsules: 16 channels at 9 x 9 positions, 8 convs
CAPS_CHANNELS, CAPS_POSITIONS, CAPS_CONVS = 16, 81, 8


def _conv(kernel_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(kernel_hwio, np.float32), (3, 2, 0, 1))))


def _f32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _bn(out, prefix, scale_bias, stats):
    """flax BatchNorm scale/bias/mean/var -> ``<prefix>.weight``, bias,
    running_mean, running_var, num_batches_tracked 0."""
    out[f"{prefix}.weight"] = _f32(scale_bias["scale"])
    out[f"{prefix}.bias"] = _f32(scale_bias["bias"])
    out[f"{prefix}.running_mean"] = _f32(stats["mean"])
    out[f"{prefix}.running_var"] = _f32(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def _darknet(p, bs):
    out = OrderedDict()
    for i in range(1, len(DARKNET_LAYERS) + 1):
        block_p, block_s = p[f"block_{i}"], bs[f"block_{i}"]
        out[f"model.conv_{i}.weight"] = _conv(block_p[f"conv_{i}"]["kernel"])
        _bn(out, f"model.bn_{i}", block_p[f"bn_{i}"], block_s[f"bn_{i}"])
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


def dense_chw_perm(chw, channels=128):
    """Index map: the JAX ConvNet's HWC-flattened dense input -> the
    reference's CHW index (the JAX interop's ``_dense_chw_perm``)."""
    hw = chw // channels
    side = int(round(hw ** 0.5))
    if side * side * channels != chw:
        raise ValueError(f"{chw} inputs are not a square of {channels} "
                         "channels")
    h, w, c = np.meshgrid(np.arange(side), np.arange(side),
                          np.arange(channels), indexing="ij")
    return (c * side * side + h * side + w).reshape(-1)


def _convnet(p, bs):
    """ConvNet: the reference's ``cnn`` Sequential; the first dense
    layer's input goes from the JAX package's HWC flatten to the
    reference's CHW one."""
    out = OrderedDict()
    for j, (conv, bn) in enumerate(((0, 1), (4, 5))):
        out[f"cnn.{conv}.weight"] = _conv(p[f"Conv_{j}"]["kernel"])
        out[f"cnn.{conv}.bias"] = _f32(p[f"Conv_{j}"]["bias"])
        _bn(out, f"cnn.{bn}", p[f"BatchNorm_{j}"], bs[f"BatchNorm_{j}"])
    k0 = np.asarray(p["Dense_0"]["kernel"])              # (HWC, out)
    out["cnn.10.weight"] = _f32(k0.T[:, np.argsort(dense_chw_perm(
        k0.shape[0]))])
    out["cnn.10.bias"] = _f32(p["Dense_0"]["bias"])
    out["cnn.12.weight"] = _f32(np.transpose(p["Dense_1"]["kernel"]))
    out["cnn.12.bias"] = _f32(p["Dense_1"]["bias"])
    return out


def _darkcapsule(p, bs):
    """DarkCapsuleNet: five biased conv blocks, the route weights with the
    reference's leading 1, and zeros for the decoder the reference
    registers and never calls (so a strict load accepts the result)."""
    out = OrderedDict()
    for i in range(1, len(DARKCAPSULE_LAYERS) + 1):
        block_p, block_s = p[f"block_{i}"], bs[f"block_{i}"]
        out[f"conv.conv_{i}.weight"] = _conv(block_p[f"conv_{i}"]["kernel"])
        out[f"conv.conv_{i}.bias"] = _f32(block_p[f"conv_{i}"]["bias"])
        _bn(out, f"conv.bn_{i}", block_p[f"bn_{i}"], block_s[f"bn_{i}"])
    out["traffic_sign_capsules.route_weights"] = _f32(
        np.asarray(p["traffic_sign_capsules"]["route_weights"])[None])
    for key, t in ReconDecoder().state_dict().items():
        out["decoder." + key] = torch.zeros_like(t)
    return out


def jax_variables_to_state_dict(variables_np, model_name):
    """``{"params"[, "batch_stats"]}`` of numpy arrays -> the port's
    state_dict for ``model_name``, keys in the reference's registration
    order, so ``load_state_dict(strict=True)`` accepts it.

    Kernels go HWIO -> OIHW and dense kernels (in, out) -> (out, in);
    BN scale/bias/mean/var go to weight/bias/running_mean/running_var
    with ``num_batches_tracked`` 0.
    """
    if model_name not in MODELS:
        raise ValueError(f"{model_name!r} is not ported yet: "
                         f"{' | '.join(MODELS)}")
    if model_name == "capsule":
        return _capsule(variables_np["params"])
    if model_name == "cnn":
        return _convnet(variables_np["params"], variables_np["batch_stats"])
    if model_name == "darkcapsule":
        return _darkcapsule(variables_np["params"],
                            variables_np["batch_stats"])
    return _darknet(variables_np["params"], variables_np["batch_stats"])


def _tensors(tree):
    """numpy leaves of dicts and lists -> torch tensors (copies)."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def jax_qparams_to_port(qparams_np, model_name):
    """The JAX package's quantized pytree (ops/quant.py, numpy leaves) ->
    the port's (ops/quant.py): the same int8 kernels, scales and biases
    as tensors.  darknet_r / darknet_d: `quantize_darknet`'s layout,
    unchanged.  cnn: `quantize_convnet`'s, with the dense layer's int8
    rows moved from JAX's HWC flatten to the port's CHW one (its
    per-output scales are per column, so they stay)."""
    q = _tensors(qparams_np)
    if model_name in DARKNET_MODELS:
        return q
    if model_name != "cnn":
        raise ValueError(f"no int8 form of {model_name!r}: cnn | "
                         f"{' | '.join(DARKNET_MODELS)}")
    wq = q["dense"]["wq"]
    q["dense"]["wq"] = wq[torch.from_numpy(np.argsort(
        dense_chw_perm(wq.shape[0])))].contiguous()
    return q
