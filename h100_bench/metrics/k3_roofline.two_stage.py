"""k3_roofline.two_stage: K3 (csrc/routing.cu, CapsuleNet's votes and
dynamic routing in one cooperative launch) in the fused two-stage
pipeline, where it routes every frame's ``max_crops`` crops at once,
against its roofline: the least time of one call (work.k3_work at B =
``batch_size`` x ``max_crops``) over its device time, in percent.
Device trace, attributed by kernel name."""

from h100_bench.work import k3_work, roofline_s

KERNELS = ("routing_kernel<",)


def read(ctx):
    ks = ctx.kernels(*KERNELS)
    if not ks:
        return None
    per_call = sum(s for _, s in ks) / len(ks)
    c = ctx.config
    flop, n_bytes = k3_work(c["batch_size"] * c["max_crops"],
                            c["routing_nodes"], c["n_classes"], c["n_iter"],
                            c["in_dim"], c["out_dim"])
    return roofline_s(flop, n_bytes) / per_call * 100
