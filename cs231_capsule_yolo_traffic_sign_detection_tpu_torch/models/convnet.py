"""ConvNet — the plain CNN classifier for GTSRB crops (PyTorch port).

Counterpart of the JAX models/convnet.py: two blocks of conv 3x3 (64,
then 128 channels) -> BatchNorm -> LeakyReLU(0.01) -> dropout, a 2x2
max-pool, then dense 128*16*16 -> 128 -> ReLU -> n_classes logits.  The
forward takes NHWC crops, as the JAX module does, and flattens the
pooled (C, H, W) activation in the reference's CHW order (the JAX
package flattens HWC; interop.py permutes the first dense layer's
input on the way across).

``dtype`` is the compute dtype (the JAX bf16 policy): the convs and
dense layers run in it on the f32 parameters cast to it, BatchNorm
keeps f32 statistics and parameters (`layers.batch_norm`, flax's
biased running variance, torch momentum 0.1 = flax 0.9), and the
logits come out in f32.  Dropout, in training only, draws its masks
from the ``generator`` the caller passes.  Initial weights come from
``seed`` alone (models/init.py).

The state_dict is the reference's ``nn.Sequential`` named ``cnn``:
``cnn.0`` conv, ``cnn.1`` BN, ``cnn.4`` conv, ``cnn.5`` BN, ``cnn.10``
and ``cnn.12`` dense.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from .init import init_convnet
from .layers import batch_norm, dropout


class ConvNet(nn.Module):

    def __init__(self, n_classes=43, dropout=0.5, dtype=torch.float32,
                 seed=0):
        super().__init__()
        self.dropout = dropout
        self.dtype = dtype
        # the reference's layer indices; the parameter-free ones hold
        # their places so the keys stay cnn.{0,1,4,5,10,12}
        self.cnn = nn.Sequential(
            nn.Conv2d(3, 64, 3, padding=1), nn.BatchNorm2d(64),
            nn.LeakyReLU(), nn.Dropout(dropout),
            nn.Conv2d(64, 128, 3, padding=1), nn.BatchNorm2d(128),
            nn.LeakyReLU(), nn.Dropout(dropout),
            nn.MaxPool2d(2), nn.Flatten(),
            nn.Linear(128 * 16 * 16, 128), nn.ReLU(),
            nn.Linear(128, n_classes))
        init_convnet(self, seed)

    def forward(self, x, generator=None, shard=None):
        """NHWC crops (B, 32, 32, 3) -> logits (B, n_classes), f32 (f64
        for a float64 model).  ``generator`` (on x's device) draws the
        dropout masks in training; ``shard`` (a `BatchShard`: x holds a
        data rank's rows) makes BN and dropout the global batch's."""
        dt = self.dtype
        x = x.permute(0, 3, 1, 2).to(dt)  # NHWC -> channels_last NCHW view
        for conv, bn in ((self.cnn[0], self.cnn[1]),
                         (self.cnn[4], self.cnn[5])):
            x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1)
            x = F.leaky_relu(batch_norm(x, bn, bn.training, shard=shard),
                             0.01)
            if bn.training and self.dropout > 0:
                if generator is None:
                    raise ValueError("ConvNet: training with dropout draws "
                                     "its masks from a torch.Generator; "
                                     "none was given")
                x = dropout(x, self.dropout, generator, shard)
        x = F.max_pool2d(x, 2, 2).reshape(x.shape[0], -1)  # CHW flatten
        fc1, fc2 = self.cnn[10], self.cnn[12]
        x = F.relu(F.linear(x, fc1.weight.to(dt), fc1.bias.to(dt)))
        out = F.linear(x, fc2.weight.to(dt), fc2.bias.to(dt))
        return out.to(torch.promote_types(dt, torch.float32))
