"""DarkCapsuleNet — detection through a capsule head over grid cells
(PyTorch port of the JAX models/darkcapsule.py).

Five conv+BN+leaky blocks (with conv biases, BN momentum torch 0.1),
stride 8: 224 -> 28 at n_grid 7.  `grid_capsules` reproduces the
reference's reading of the (B, 256, 28, 28) activation as g^2 cells of
512 capsule nodes of 8 dims (reference models.py:393-396), one
`CapsuleRouting` with a single 5-d output capsule (the closed form,
`ops.capsule.routed_single_capsule`) runs over all g^2 * B cells at
once, and the output is the (B, g, g, 5) capsule grid.  The input must
be 32 * n_grid px.

``dtype`` is the compute dtype of the conv stack only: the routing
runs in f32 (f64 for a float64 model) on the nodes cast up, as in the
JAX module.  The state_dict is the reference's: ``conv.conv_i.*`` and
``conv.bn_i.*`` (i = 1..5), ``traffic_sign_capsules.route_weights``
(1, 512, 1, 8, 5) and the decoder the reference registers and never
calls, ``decoder.{0,4,7,10,12}.*``.  Initial weights come from
``seed`` alone (models/init.py).  ``routing_impl`` is the resolved
``--routing`` (the one capsule takes the closed form whatever it is);
``remat`` rematerializes each block in the backward
(`layers.remat_block`).  The reference's unregistered variants
DarkCapsuleNet2 and DarkCapsuleNet3 are not ported.
"""

import torch
import torch.nn as nn

from .capsule_net import CapsuleRouting
from .init import init_darkcapsule
from .layers import ConvBNLeaky, ReconDecoder, remat_block

# (out_channels, kernel, stride); padding 1 (reference models.py:346-365)
DARKCAPSULE_LAYERS = [(128, 3, 1), (256, 3, 1), (64, 4, 2), (128, 4, 2),
                      (256, 4, 2)]


def grid_capsules(x, n_grid):
    """NCHW conv activations (B, C, H, W) -> (g^2 * B, 512, 8) capsule
    nodes, cell-major.

    The reference views its NCHW memory as (B, C, 4, 4 g^2), takes g^2
    chunks of (B, C, 4, 4) and reads each as (B, 4, 4, C) -> (B, 512, 8);
    this is the same map on logical dims (any memory format), the JAX
    `_grid_capsules`'s sequence after its NHWC -> NCHW transpose."""
    b, c, h, w = x.shape
    g2 = n_grid * n_grid
    if c * h * w != 512 * 8 * g2:
        raise ValueError(f"grid_capsules: {tuple(x.shape)} does not hold "
                         f"{g2} cells of 512 x 8 (input must be 32 * "
                         f"n_grid px)")
    x = x.reshape(b, c, 4, g2, 4).permute(3, 0, 2, 4, 1)  # (g2, B, 4, 4, C)
    return x.reshape(g2 * b, 512, 8)


class DarkCapsuleNet(nn.Module):
    """The conv blocks' children are registered under ``self.conv`` so the
    keys are the reference's (``conv.conv_1.weight``, ...); the
    ConvBNLeaky objects that run them sit in a plain list, as in
    DarkNet."""

    def __init__(self, n_grid=7, dtype=torch.float32, seed=0,
                 routing_impl="xla", remat=False):
        super().__init__()
        self.n_grid = n_grid
        self.dtype, self.remat = dtype, remat
        self.conv = nn.Module()
        blocks, in_ch = [], 3
        for i, (feats, k, s) in enumerate(DARKCAPSULE_LAYERS, start=1):
            blk = ConvBNLeaky(in_ch, feats, k, name_idx=i, stride=s,
                              padding=1, bias=True, bn_momentum=0.1)
            for name, child in blk.named_children():
                self.conv.add_module(name, child)
            blocks.append(blk)
            in_ch = feats
        self._blocks = blocks  # plain list: not registered twice
        self.traffic_sign_capsules = CapsuleRouting(
            n_caps=1, n_nodes=512, in_c=8, out_c=5, impl=routing_impl)
        self.decoder = ReconDecoder()
        init_darkcapsule(self, seed)

    @property
    def layers(self):
        """The module holding conv_i / bn_i (the fine-tune branch's)."""
        return self.conv

    def forward(self, x, shard=None):
        """x: (B, 32 g, 32 g, 3) NHWC -> capsules (B, g, g, 5), f32 (f64
        for a float64 model).  ``shard`` (a `BatchShard`: x holds a data
        rank's rows) makes BN the global batch's."""
        b, g = x.shape[0], self.n_grid
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        remat = self.remat and torch.is_grad_enabled()
        for blk in self._blocks:
            x = (remat_block(blk, x, self.dtype, shard=shard) if remat
                 else blk(x, self.dtype, shard=shard))
        w = self.traffic_sign_capsules.route_weights
        caps = self.traffic_sign_capsules(grid_capsules(x, g).to(w.dtype))
        return caps.reshape(g, g, b, 5).permute(2, 0, 1, 3)
