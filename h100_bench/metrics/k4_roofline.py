"""k4_roofline: K4 (csrc/routing_bwd.cu, the routing's backward: a prep,
per iteration a pass and a finish, and a final launch) against its
roofline: the least time of one call (work.k4_work) over the device
time of its launches, in percent.  Device trace, attributed by kernel
name; one call a prep launch."""

from h100_bench.work import k4_work, roofline_s

KERNELS = ("bwd_prep_kernel", "bwd_finish_kernel", "routing_bwd_sweep_kernel")


def read(ctx):
    ks = ctx.kernels(*KERNELS)
    calls = len(ctx.kernels(KERNELS[0]))
    if not calls:
        return None
    per_call = sum(s for _, s in ks) / calls
    c = ctx.config
    flop, n_bytes = k4_work(ctx.batch, c["routing_nodes"], c["n_classes"],
                            c["n_iter"], c["in_dim"], c["out_dim"])
    return roofline_s(flop, n_bytes) / per_call * 100
