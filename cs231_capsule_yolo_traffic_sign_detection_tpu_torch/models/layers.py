"""Shared building blocks (PyTorch port of the JAX models/layers.py):
DarkNet's conv+BN+leaky block and the capsule reconstruction decoder."""

import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvBNLeaky(nn.Module):
    """conv -> BatchNorm -> LeakyReLU(0.1) [-> dropout], DarkNet's block.

    A bias-free ``nn.Conv2d`` with symmetric padding (1 for k=3, 0 for
    k=1), then ``nn.BatchNorm2d(eps=1e-5, momentum=0.01)`` (torch
    momentum 0.01 is flax momentum 0.99, as the JAX block uses),
    LeakyReLU(0.1) and dropout.
    Children are named ``conv{suffix}``/``bn{suffix}``/``drop{suffix}``
    with ``suffix = _{name_idx}``, the reference state_dict names.
    Works on NCHW tensors, like every ``nn.Conv2d``.
    """

    def __init__(self, in_channels, features, kernel=3, dropout=0.0,
                 name_idx=None):
        super().__init__()
        self.suffix = f"_{name_idx}" if name_idx is not None else ""
        self.add_module("conv" + self.suffix, nn.Conv2d(
            in_channels, features, kernel, padding=kernel // 2, bias=False))
        self.add_module("bn" + self.suffix, nn.BatchNorm2d(
            features, eps=1e-5, momentum=0.01))
        self.add_module("drop" + self.suffix,
                        nn.Dropout(dropout) if dropout > 0 else nn.Identity())

    def forward(self, x):
        x = getattr(self, "conv" + self.suffix)(x)
        x = getattr(self, "bn" + self.suffix)(x)
        x = F.leaky_relu(x, 0.1)
        return getattr(self, "drop" + self.suffix)(x)


class ReconDecoder(nn.Sequential):
    """Capsule reconstruction decoder: dense 16->256, unflatten to
    (16, 4, 4), then 3x (nearest 2x upsample + 3x3 conv + relu) and a
    final 3-channel tanh conv.

    A ``Sequential`` so the state_dict keys are the reference's:
    ``decoder.0`` (Linear) and ``decoder.{4,7,10,12}`` (convs).  Takes a
    (B, 16) capsule and returns (B, 32, 32, 3) NHWC in f32, as the JAX
    decoder does: the layers run in ``dtype`` (the f32 parameters cast
    to it, as the convs of CapsuleNet do), the tanh in f32.  Training
    feeds it the true class's capsule; serving never calls it.
    """

    def __init__(self):
        super().__init__(
            nn.Linear(16, 16 * 4 * 4), nn.ReLU(), nn.Unflatten(1, (16, 4, 4)),
            nn.Upsample(scale_factor=2), nn.Conv2d(16, 4, 3, padding=1),
            nn.ReLU(),
            nn.Upsample(scale_factor=2), nn.Conv2d(4, 8, 3, padding=1),
            nn.ReLU(),
            nn.Upsample(scale_factor=2), nn.Conv2d(8, 16, 3, padding=1),
            nn.ReLU(),
            nn.Conv2d(16, 3, 3, padding=1), nn.Tanh())

    def forward(self, t, dtype=torch.float32):
        x = t.to(dtype)
        for m in list(self)[:-1]:
            if isinstance(m, nn.Linear):
                x = F.linear(x, m.weight.to(dtype), m.bias.to(dtype))
            elif isinstance(m, nn.Conv2d):
                x = F.conv2d(x, m.weight.to(dtype), m.bias.to(dtype),
                             padding=m.padding)
            else:
                x = m(x)
        return torch.tanh(x.float()).permute(0, 2, 3, 1)
