"""tail_ms.two_stage: host milliseconds a batch spent in the fused
two-stage tail after the detector (the port's ``cyt.tail`` span,
`export._two_stage_tail`: the top-k decode, the crop, the centring and
the classifier's call, their enqueue on the card): the mean over the
traced window's ``cyt.tail`` spans (one a batch).  Program span.  The
program records serving spans only under a profiler and keeps them for
the whole process; `h100_bench/run.py` runs one cell a process, so these
are the traced window's.  None where the program records no such
span."""


def read(ctx):
    try:
        from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.profiling \
            import spans
    except ImportError:
        return None
    tails = [s.seconds for s in spans("cyt.tail") if s.name == "cyt.tail"]
    if not tails:
        return None
    return sum(tails) / len(tails) * 1e3
