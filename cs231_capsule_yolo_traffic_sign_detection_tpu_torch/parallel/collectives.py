"""The collectives of a mesh step, with their gradients.

Under GSPMD the JAX package's steps are global-batch programs; here each
rank runs its rows and these functions supply what the partitioner
inserted:

  * `all_reduce_sum`: a sum over a group whose backward is the same sum
    (every rank's downstream gradient holds only its rows' part), for
    BatchNorm's global-batch statistics (`BatchShard`);
  * `enter_shard` / `leave_shard`: the two ends of the node-sharded
    routing region (Megatron's f and g): identity forward and an
    all-reduce of the gradient backward on the way in, an all-reduce
    forward and the gradient unchanged on the way out;
  * `all_reduce_grads`: the data-parallel gradient mean, one flattened
    all-reduce.

Only ``all_reduce``, ``broadcast`` and ``all_gather`` are used: gloo
takes CUDA tensors for those, and a one-card machine runs two ranks on
gloo.
"""

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """A train step's rows [lo, hi) of a global batch of ``n_global``,
    split over ``group`` (the data group): BatchNorm takes its statistics
    over the global batch, dropout draws the global batch's masks."""

    group: object
    n_global: int
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True)
class NodeShard:
    """A rank's nodes [lo, hi) of a capsule routing split over ``group``
    (the model group)."""

    group: object
    lo: int
    hi: int


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _EnterShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _LeaveShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x, group):
    """Sum of ``x`` over ``group``; its gradient is the group's sum of
    the incoming gradients."""
    return _AllReduceSum.apply(x, group)


def enter_shard(x, group):
    """``x`` (replicated over ``group``) entering a sharded region: the
    same tensor, and backward the sum of the ranks' partial gradients."""
    return _EnterShard.apply(x, group)


def leave_shard(x, group):
    """The ranks' partial sums ``x`` leaving a sharded region: their sum,
    replicated; backward the gradient as it is (every rank's downstream
    is the same)."""
    return _LeaveShard.apply(x, group)


def all_reduce_grads(params, group):
    """Replace each ``.grad`` of ``params`` by its mean over ``group``, in
    one all-reduce of the flattened gradients.  Parameters without a
    gradient are left out (the same on every rank: the ranks run the
    same graph)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view(g.shape))
        offset += n


def global_batch_stats(x, shard):
    """Per-channel mean and biased variance of NCHW ``x`` over the global
    batch ``shard`` splits, in f32 (f64 for an f64 ``x``): one
    all-reduce of the channel sums, the sums of squares and the count,
    differentiable."""
    dt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dt)
    c = x.shape[1]
    stats = torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                       xf.new_full((1,), x.numel() // c)])
    stats = all_reduce_sum(stats, shard.group)
    n = stats[2 * c]
    mean = stats[:c] / n
    return mean, stats[c:2 * c] / n - mean * mean
