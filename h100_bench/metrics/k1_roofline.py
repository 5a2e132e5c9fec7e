"""k1_roofline: K1 (csrc/pool_leaky.cu, the four 2x2 max-pools with
leaky after block 1 of the detector's forward) against its roofline:
the least time of one forward's four pools (work.k1_work: bytes at
HBM's rate) over their device time, in percent.  Device trace,
attributed by kernel name."""

from h100_bench.work import k1_work, roofline_s

KERNELS = ("pool_leaky_kernel",)
POOLS = 4


def read(ctx):
    ks = ctx.kernels(*KERNELS)
    if not ks:
        return None
    per_forward = sum(s for _, s in ks) / (len(ks) / POOLS)
    flop, n_bytes = k1_work(ctx.batch, ctx.config["darknet_input"])
    return roofline_s(flop, n_bytes) / per_forward * 100
