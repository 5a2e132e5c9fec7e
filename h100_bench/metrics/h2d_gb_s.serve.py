"""h2d_gb_s.serve: the rate of the host frames' copies to the card, in
GB/s: the ``bytes`` counted on the port's ``cyt.stage.copy`` spans
(`ops/preprocess.py:preprocess_images`) over those spans' seconds, in
the traced window.  Program span.  The program records serving spans
only under a profiler and keeps them for the whole process;
`h100_bench/run.py` runs one cell a process, so these are the traced
window's.  None where the program records no such span or no byte
crossed to a card."""


def read(ctx):
    try:
        from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.profiling \
            import spans
    except ImportError:
        return None
    copies = spans("cyt.stage.copy")
    moved = sum(s.args.get("bytes", 0) for s in copies)
    seconds = sum(s.seconds for s in copies)
    if not moved or not seconds:
        return None
    return moved / seconds / 1e9
