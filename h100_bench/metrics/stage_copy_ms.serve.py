"""stage_copy_ms.serve: host milliseconds a batch spent copying its host
frames to the card (the port's ``cyt.stage.copy`` spans, each
``.to(device)`` inside `ops/preprocess.py:preprocess_images`): their sum
over the traced window, over the window's ``cyt.stage`` spans (one a
batch).  Program span.  The program records serving spans only under a
profiler and keeps them for the whole process; `h100_bench/run.py`
runs one cell a process, so these are the traced window's.  None where
the program records no such span."""


def read(ctx):
    try:
        from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.profiling \
            import spans
    except ImportError:
        return None
    batches = sum(s.name == "cyt.stage" for s in spans("cyt.stage"))
    parts = [s.seconds for s in spans("cyt.stage.copy")]
    if not batches or not parts:
        return None
    return sum(parts) / batches * 1e3
