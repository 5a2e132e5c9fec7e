"""k2_roofline: K2 (csrc/input_stage.cu, conv1 + bias + leaky + 2x2 pool
of the detector's first block) against its roofline: the least time of
one call (work.k2_work) over its device time, in percent.  Device
trace, attributed by kernel name."""

from h100_bench.work import k2_work, roofline_s

KERNELS = ("input_stage_tf32x3_kernel", "input_stage_mma_kernel")


def read(ctx):
    ks = ctx.kernels(*KERNELS)
    if not ks:
        return None
    per_call = sum(s for _, s in ks) / len(ks)
    flop, n_bytes = k2_work(ctx.batch, ctx.config["darknet_input"])
    return roofline_s(flop, n_bytes) / per_call * 100
