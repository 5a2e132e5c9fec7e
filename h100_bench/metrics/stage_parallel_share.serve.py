"""stage_parallel_share.serve: the share of staged images whose rows the
gather threads wrote, in %: Σ ``images`` of the window's ``cyt.stage``
spans whose ``workers`` count is above 1, over Σ ``images`` of them all
(`ops/preprocess.py:stage`).  Program counter.  The program records
serving spans only under a profiler and keeps them for the whole
process; `h100_bench/run.py` runs one cell a process, so these are the
traced window's.  None where the program records no such span, or
counts no ``workers``."""


def read(ctx):
    try:
        from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.profiling \
            import spans
    except ImportError:
        return None
    stages = [s for s in spans("cyt.stage") if s.name == "cyt.stage"]
    images = sum(s.args.get("images", 0) for s in stages)
    if not images or not any("workers" in s.args for s in stages):
        return None
    return 100.0 * sum(s.args.get("images", 0) for s in stages
                       if s.args.get("workers", 1) > 1) / images
