"""BN folding for the DarkNet serving forward (subset of the JAX
ops/quant.py; the int8 tiers are not ported yet)."""

import torch

from ..models.darknet import DARKNET_LAYERS


def fold_darknet(state_dict, eps=1e-5):
    """Fold each BN into its conv.  Returns (layers, head_kernel).

    ``state_dict`` is a DarkNet state_dict (OIHW kernels, reference
    keys).  ``layers`` is a list of {"w": HWIO f32, "b": (O,) f32} and
    ``head_kernel`` the HWIO 1x1 head kernel: the JAX package's layout,
    so the two folds compare directly.

    With y = BN(conv(x, w)) = scale * (conv(x, w) - mean) / sqrt(var +
    eps) + bias, the folded form is conv(x, w * inv) + (bias - mean *
    inv) with inv = scale / sqrt(var + eps) per output channel.
    """
    layers = []
    for i in range(1, len(DARKNET_LAYERS) + 1):
        w = state_dict[f"model.conv_{i}.weight"].float().permute(2, 3, 1, 0)
        scale = state_dict[f"model.bn_{i}.weight"].float()
        inv = scale / torch.sqrt(
            state_dict[f"model.bn_{i}.running_var"].float() + eps)
        layers.append({
            "w": (w * inv).contiguous(),  # broadcasts over O, HWIO's last
            "b": state_dict[f"model.bn_{i}.bias"].float()
            - state_dict[f"model.bn_{i}.running_mean"].float() * inv,
        })
    head = state_dict["model.conv_19.weight"].float().permute(2, 3, 1, 0)
    return layers, head.contiguous()
