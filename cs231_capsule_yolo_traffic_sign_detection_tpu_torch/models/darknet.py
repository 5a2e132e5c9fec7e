"""DarkNet — Darknet-19-style YOLO-v1 backbone + grid head (PyTorch port).

Counterpart of the JAX models/darknet.py: 18 conv+BN+LeakyReLU(0.1)
blocks with 5 max-pools (stride 32: 448 -> 14 grid), then a bias-free
1x1 head conv with 5*n_boxes + n_classes channels; sigmoid over the box
part, softmax over the class part.  The forward takes NHWC and returns
the NHWC grid, as the JAX module does.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import ConvBNLeaky

# (out_channels, kernel_size, what follows: 'mp' max-pool | 'drop' | None)
DARKNET_LAYERS = [
    (32, 3, "mp"),
    (64, 3, "mp"),
    (128, 3, "drop"),
    (64, 1, "drop"),
    (128, 3, "mp"),
    (256, 3, "drop"),
    (128, 1, "drop"),
    (256, 3, "mp"),
    (512, 3, "drop"),
    (256, 1, "drop"),
    (512, 3, "drop"),
    (256, 1, "drop"),
    (512, 3, "mp"),
    (1024, 3, "drop"),
    (512, 1, "drop"),
    (1024, 3, "drop"),
    (512, 1, "drop"),
    (1024, 3, "drop"),
]


def head(out, n_boxes, n_classes):
    """NHWC head logits -> sigmoid box channels ++ softmax class channels."""
    split = 5 * n_boxes
    y_box = torch.sigmoid(out[..., :split])
    if n_classes == 0:
        return y_box
    y_cls = torch.softmax(out[..., split:], dim=-1)
    return torch.cat([y_box, y_cls], dim=-1)


class DarkNet(nn.Module):
    """state_dict keys are the reference's: ``model.conv_{i}``,
    ``model.bn_{i}`` (i = 1..18) and ``model.conv_19``, in that order.

    The blocks' children are registered directly under ``self.model``
    so the keys carry no block prefix; the ConvBNLeaky objects that own
    the forward sit in a plain list and share those same children, so
    ``.to()``, ``.eval()`` and ``load_state_dict`` reach them.
    """

    def __init__(self, n_boxes=2, n_classes=0, dropout=0.0):
        super().__init__()
        self.n_boxes, self.n_classes = n_boxes, n_classes
        self.model = nn.Module()
        blocks = []
        in_ch = 3
        for i, (feats, k, after) in enumerate(DARKNET_LAYERS, start=1):
            blk = ConvBNLeaky(
                in_ch, feats, k, dropout=dropout if after == "drop" else 0.0,
                name_idx=i)
            for name, child in blk.named_children():
                self.model.add_module(name, child)
            blocks.append((blk, after))
            in_ch = feats
        self.model.add_module("conv_19", nn.Conv2d(
            in_ch, 5 * n_boxes + n_classes, 1, bias=False))
        self._blocks = blocks  # plain list: not registered twice

    def forward(self, x):
        """x: (B, H, W, 3) NHWC -> (B, H/32, W/32, 5B+C) NHWC grid."""
        x = x.permute(0, 3, 1, 2)  # NHWC -> channels_last NCHW view
        for blk, after in self._blocks:
            x = blk(x)
            if after == "mp":
                x = F.max_pool2d(x, 2, 2)
        out = self.model.conv_19(x).permute(0, 2, 3, 1).float()
        return head(out, self.n_boxes, self.n_classes)
