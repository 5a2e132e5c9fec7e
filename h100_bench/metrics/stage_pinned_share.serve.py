"""stage_pinned_share.serve: the share of staged images that went to the
card through pinned host memory, in %: the ``pinned`` counts of the
port's ``cyt.stage`` spans (`ops/preprocess.py:preprocess_images`) over
their ``images``, in the traced window.  Program span.  The program
records serving spans only under a profiler and keeps them for the
whole process; `h100_bench/run.py` runs one cell a process, so these
are the traced window's.  None where the program records no such span,
or counts no ``pinned``."""


def read(ctx):
    try:
        from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.profiling \
            import spans
    except ImportError:
        return None
    stages = [s for s in spans("cyt.stage") if s.name == "cyt.stage"]
    images = sum(s.args.get("images", 0) for s in stages)
    if not images or not any("pinned" in s.args for s in stages):
        return None
    return 100.0 * sum(s.args.get("pinned", 0) for s in stages) / images
