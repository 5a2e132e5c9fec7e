"""k5_roofline: K5 (csrc/primary_caps.cu, CapsuleNet's primary capsules:
the conv as a 3xTF32 implicit GEMM with the bias and the squash in its
epilogue, and the sum of a split K in the same kernel) against its
roofline: the least time of one call over its device time, in percent.
Device trace, attributed by kernel name: every kernel of K5 summed,
over the launches of its main kernel, at B = ``batch_size`` x
``max_crops`` (1 where the configuration has none).  The one-word fill
of the split's arrival counts is a memset, not a kernel: not counted.
A program without K5 reads nothing."""

from h100_bench.work import F32, roofline_s

MAIN = "primary_caps_kernel"
KERNELS = (MAIN,)


def k5_work(b):
    """(FLOP, bytes) of one call on ``b`` crops: the conv as M = b x 81
    rows, N = 128, K = 256 x 64; conv1's map read once, the weights and
    the bias once, the (b, 1296, 8) capsules written once."""
    flop = 2 * b * 81 * 128 * 256 * 64
    n_bytes = F32 * (b * 256 * 24 * 24 + 128 * 256 * 64 + 128
                     + b * 1296 * 8)
    return flop, n_bytes


def read(ctx):
    ks = ctx.kernels(*KERNELS)
    launches = sum(MAIN in n for n, _ in ks)
    if not launches:
        return None
    per_call = sum(s for _, s in ks) / launches
    c = ctx.config
    return roofline_s(*k5_work(c["batch_size"] * c.get("max_crops", 1))) \
        / per_call * 100
