"""DarkNet — Darknet-19-style YOLO-v1 backbone + grid head (PyTorch port).

Counterpart of the JAX models/darknet.py: 18 conv+BN+LeakyReLU(0.1)
blocks with 5 max-pools (stride 32: 448 -> 14 grid), then a bias-free
1x1 head conv with 5*n_boxes + n_classes channels; sigmoid over the box
part, softmax over the class part.  The forward takes NHWC and returns
the NHWC grid, as the JAX module does.

``dtype`` is the compute dtype: the input is cast to it first, the
convs run in it on the f32 parameters cast to it, BN keeps f32
statistics and parameters, and the head's output goes to f32 before the
sigmoid and softmax.  In training, dropout follows the "drop" blocks
with masks drawn from the ``generator`` the caller passes (the trainer
owns one, seeded from ``--seed``), never from the global RNG.  With
``remat`` (``--remat``) each block is rematerialized in the backward
(`layers.remat_block`).  Initial
weights come from ``seed`` alone (models/init.py).

`load_darknet19_npz` and `freeze_darknet` are the pretrained-weight
loader and the fine-tuning freeze of the JAX module.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .init import init_darknet
from .layers import ConvBNLeaky, remat_block

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

    def __init__(self, n_boxes=2, n_classes=0, dropout=0.0,
                 dtype=torch.float32, seed=0, remat=False):
        super().__init__()
        self.n_boxes, self.n_classes = n_boxes, n_classes
        self.dtype, self.remat = dtype, remat
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
        init_darknet(self, seed)

    @property
    def layers(self):
        """The module holding conv_i / bn_i (for the npz and the freeze)."""
        return self.model

    def forward(self, x, generator=None, shard=None):
        """x: (B, H, W, 3) NHWC -> (B, H/32, W/32, 5B+C) NHWC grid, f32
        (f64 for a float64 model).
        ``generator`` (on x's device) draws the dropout masks in
        training; ``shard`` (a `BatchShard`: x holds a data rank's rows)
        makes BN and dropout the global batch's."""
        dt = self.dtype
        x = x.permute(0, 3, 1, 2).to(dt)  # NHWC -> channels_last NCHW view
        remat = self.remat and torch.is_grad_enabled()
        for blk, after in self._blocks:
            x = (remat_block(blk, x, dt, generator, shard) if remat
                 else blk(x, dt, generator, shard=shard))
            if after == "mp":
                x = F.max_pool2d(x, 2, 2)
        out = F.conv2d(x, self.model.conv_19.weight.to(dt))
        # the head and the loss in f32 at least
        out = out.to(torch.promote_types(dt, torch.float32))
        return head(out.permute(0, 2, 3, 1), self.n_boxes, self.n_classes)


def load_darknet19_npz(model, npz_path, n_load_layer=18):
    """Copy pretrained darknet19 weights into ``model`` (a DarkNet, or any
    model whose ``layers`` holds conv_i / bn_i) in place.

    npz keys are ``'{i}-<scope>/<name>:0'`` with i 0-based (layer i + 1):
    ``kernel:0`` is a TF-format HWIO conv kernel (transposed to OIHW
    here), ``gamma:0``/``biases:0`` the BN scale and bias,
    ``moving_mean:0``/``moving_variance:0`` its running statistics.
    Layers above ``n_load_layer`` are skipped (the head always trains
    from scratch).  A tensor the model lacks, or of another shape, raises
    ValueError (DarkCapsuleNet's five blocks take no darknet19 weights;
    the JAX loader raises there too).  Counterpart of the JAX
    ``load_darknet19_npz``."""
    targets = {"kernel:0": "conv_{}.weight", "gamma:0": "bn_{}.weight",
               "biases:0": "bn_{}.bias", "moving_mean:0": "bn_{}.running_mean",
               "moving_variance:0": "bn_{}.running_var"}
    state = model.layers.state_dict(keep_vars=True)
    pretrained = np.load(npz_path)
    with torch.no_grad():
        for key in pretrained.files:
            index_s, layer = key.split("-")
            index = int(index_s) + 1
            if index > n_load_layer:
                continue
            name = layer.split("/")[1]
            if name not in targets:
                raise ValueError(f"unknown pretrained tensor {key}")
            v = pretrained[key]
            if name == "kernel:0":
                v = np.transpose(v, (3, 2, 0, 1))
            key_t = targets[name].format(index)
            if key_t not in state:
                raise ValueError(f"{key}: the model has no {key_t}")
            tgt = state[key_t]
            if tuple(tgt.shape) != v.shape:
                raise ValueError(f"{key}: shape {v.shape}, the model's "
                                 f"{tuple(tgt.shape)}")
            tgt.copy_(torch.from_numpy(np.ascontiguousarray(v)))
    return model


def freeze_darknet(model, fine_tune):
    """``requires_grad=False`` on every parameter of ``model.layers`` with
    index <= ``fine_tune`` (conv_i and bn_i; DarkNet's head is 19), as the
    reference's fine-tuning loop (main.py:273-278); returns the count of
    frozen parameters.  Their BN running statistics still update in
    training: the blocks stay in train mode."""
    n = 0
    for name, p in model.layers.named_parameters():
        if int(name.split(".")[0].split("_")[1]) <= fine_tune:
            p.requires_grad_(False)
            n += p.numel()
    return n
