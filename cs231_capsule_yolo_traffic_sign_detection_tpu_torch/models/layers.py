"""Shared building blocks (PyTorch port of the JAX models/layers.py):
the detectors' conv+BN+leaky block (DarkNet's and DarkCapsuleNet's),
with the flax BatchNorm and dropout it trains with, and the capsule
reconstruction decoder."""

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import global_batch_stats


def batch_norm(x, bn, training, update=True, shard=None):
    """``bn`` (an ``nn.BatchNorm2d``) over NCHW x as flax's BatchNorm runs
    it: the statistics, scale, bias and running buffers in f32 whatever
    x's dtype, the output in x's dtype.  ``update=False`` normalizes by
    the batch's statistics in training and leaves the running buffers
    and the batch count as they are (a rematerialized block's recompute).

    In training the running variance takes the BIASED batch variance, as
    flax stores it (``nn.BatchNorm2d`` stores the unbiased one).
    ``F.batch_norm`` updates copies of the buffers (autograd keeps them,
    so they may not change after) to rv' = (1 - m) rv + m n/(n-1) var
    for n values per channel; the buffer then takes rv' - (rv' - (1 - m)
    rv) / n = (1 - m) rv + m var.

    With ``shard`` (a `parallel.collectives.BatchShard`: x holds a data
    rank's rows of a batch split over a mesh's data axis) the statistics
    are the global batch's, as JAX's BatchNorm under GSPMD reduces over
    the sharded batch: one differentiable all-reduce of the channel sums,
    sums of squares and count, and the running variance takes the
    global batch's biased variance.
    """
    if not training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    m = bn.momentum
    if m is None:  # nn.BatchNorm2d's cumulative average: reads the count
        m = 1.0 / (float(bn.num_batches_tracked) + 1.0)
    if shard is not None:
        return _global_batch_norm(x, bn, m, update, shard)
    mean, var = bn.running_mean.clone(), bn.running_var.clone()
    y = F.batch_norm(x, mean, var, bn.weight, bn.bias, True, m, bn.eps)
    if not update:
        return y
    with torch.no_grad():
        n = x.numel() // x.shape[1]
        bn.running_mean.copy_(mean)
        bn.running_var.mul_((1.0 - m) / n).add_(var, alpha=1.0 - 1.0 / n)
        bn.num_batches_tracked.add_(1)
    return y


def _global_batch_norm(x, bn, m, update, shard):
    """`batch_norm` in training on the global batch's statistics."""
    mean, var = global_batch_stats(x, shard)
    inv = torch.rsqrt(var + bn.eps) * bn.weight.to(mean.dtype)
    y = ((x.to(mean.dtype) - mean[:, None, None]) * inv[:, None, None]
         + bn.bias.to(mean.dtype)[:, None, None])
    if update:
        with torch.no_grad():
            bn.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            bn.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
            bn.num_batches_tracked.add_(1)
    return y.to(x.dtype)


def dropout(x, p, generator, shard=None):
    """Flax's dropout: keep each value with probability 1 - p, drawn from
    ``generator`` (on x's device), and scale the kept ones by 1/(1 - p).
    With ``shard`` (a `BatchShard`), the mask of the global batch is
    drawn, in x's layout, and x's rows kept: the masks and the
    generator's state are the single-process run's."""
    keep = 1.0 - p
    return torch.where(dropout_mask(x, keep, generator, shard), x / keep,
                       0.0)


def dropout_mask(x, keep, generator, shard=None):
    """`dropout`'s mask: True with probability ``keep``, in x's layout;
    with ``shard`` the global batch's mask drawn, x's rows kept."""
    # in x's memory format: a contiguous (NCHW) mask would turn the
    # result, and every later activation, NCHW
    if shard is None:
        mask = torch.empty_like(x, dtype=torch.bool)
    else:
        mask = torch.empty_strided(
            (shard.n_global,) + tuple(x.shape[1:]),
            (x[0].numel(),) + tuple(x.stride()[1:]), dtype=torch.bool,
            device=x.device)
    mask.bernoulli_(keep, generator=generator)
    if shard is not None:
        mask = mask[shard.lo:shard.hi]
    return mask


class ConvBNLeaky(nn.Module):
    """conv -> BatchNorm -> LeakyReLU(0.1) [-> dropout], the detectors'
    block.

    An ``nn.Conv2d`` (``kernel``, ``stride``, symmetric ``padding``,
    by default kernel // 2: 1 for k=3, 0 for k=1; a bias only with
    ``bias``), then ``nn.BatchNorm2d(eps=1e-5, momentum=bn_momentum)``
    run by `batch_norm`, LeakyReLU(0.1) and, in training, `dropout`.
    Torch momentum m is flax momentum 1 - m: DarkNet's blocks take 0.01
    (flax 0.99), DarkCapsuleNet's torch's default 0.1 (flax 0.9), as the
    JAX blocks.  Children are named ``conv{suffix}``/``bn{suffix}`` with
    ``suffix = _{name_idx}``, the reference state_dict names.  Works on
    NCHW tensors, like every ``nn.Conv2d``.
    """

    def __init__(self, in_channels, features, kernel=3, dropout=0.0,
                 name_idx=None, stride=1, padding=None, bias=False,
                 bn_momentum=0.01):
        super().__init__()
        self.suffix = f"_{name_idx}" if name_idx is not None else ""
        self.dropout = dropout
        self.add_module("conv" + self.suffix, nn.Conv2d(
            in_channels, features, kernel, stride=stride,
            padding=kernel // 2 if padding is None else padding, bias=bias))
        self.add_module("bn" + self.suffix, nn.BatchNorm2d(
            features, eps=1e-5, momentum=bn_momentum))

    def forward(self, x, dtype=torch.float32, generator=None, memo=None,
                shard=None):
        """The conv in ``dtype`` on the f32 weight (and bias) cast to it,
        BN (f32 statistics, output in ``dtype``), leaky and dropout in
        ``dtype``.  Dropout, in training only, draws from
        ``generator``.  ``shard`` (a `BatchShard`, under a mesh) makes
        BN and dropout the global batch's.  ``memo`` (a dict,
        `remat_block`'s) marks a second run of the same call: the first
        records the generator's state before the dropout draw, the
        second updates no BN buffer and draws the same mask from a copy
        of that state, so the trainer's generator moves once.  Under a
        CUDA graph's capture the first run keeps its mask for the second
        instead: a state read at capture is the capture's, while the
        graph's draws move with the generator at every replay."""
        conv = getattr(self, "conv" + self.suffix)
        bn = getattr(self, "bn" + self.suffix)
        # the mode is the children's: the model registers them, not the block
        training = bn.training
        rerun = memo is not None and "ran" in memo
        bias = None if conv.bias is None else conv.bias.to(dtype)
        x = F.conv2d(x.to(dtype), conv.weight.to(dtype), bias,
                     stride=conv.stride, padding=conv.padding)
        x = batch_norm(x, bn, training, update=not rerun, shard=shard)
        x = F.leaky_relu(x, 0.1)
        if training and self.dropout > 0:
            if generator is None:
                raise ValueError("ConvBNLeaky: training with dropout draws "
                                 "its masks from a torch.Generator; none "
                                 "was given")
            keep = 1.0 - self.dropout
            if rerun and "mask" in memo:
                mask = memo["mask"]
            elif rerun:
                replay = torch.Generator(device=generator.device)
                replay.set_state(memo["rng"])
                mask = dropout_mask(x, keep, replay, shard)
            elif memo is not None and x.is_cuda and \
                    torch.cuda.is_current_stream_capturing():
                mask = memo["mask"] = dropout_mask(x, keep, generator, shard)
            else:
                if memo is not None:
                    memo["rng"] = generator.get_state()
                mask = dropout_mask(x, keep, generator, shard)
            x = torch.where(mask, x / keep, 0.0)
        if memo is not None:
            memo["ran"] = True
        return x


def remat_block(block, x, dtype=torch.float32, generator=None, shard=None):
    """``block(x, dtype, generator, shard=shard)`` (a `ConvBNLeaky`)
    rematerialized
    (``--remat``, JAX COMPAT #26): under `torch.utils.checkpoint` its
    activations are not kept for the backward, which runs the block
    again.  As flax's lifted ``nn.remat``, the second run replays the
    first's dropout mask and leaves the BN buffers as the first set
    them (the block's ``memo``), so the loss, the gradients, the
    buffers and the generator's state are those of the plain block."""
    memo = {}
    return checkpoint(lambda t: block(t, dtype, generator, memo, shard), x,
                      use_reentrant=False, preserve_rng_state=False)


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
