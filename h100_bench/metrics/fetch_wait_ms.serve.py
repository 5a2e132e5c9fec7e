"""fetch_wait_ms.serve: host milliseconds a batch waited for its outputs'
copies to the host, which wait for the card (the port's
``cyt.fetch.wait`` span, the ``.cpu()`` calls inside
`ops/decode.py:to_flat_host_with_extras`): their sum over the traced
window, over the window's ``cyt.fetch`` spans (one a batch).  Program
span.  The program records serving spans only under a profiler and
keeps them for the whole process; `h100_bench/run.py` runs one cell a
process, so these are the traced window's.  None where the program
records no such span."""


def read(ctx):
    try:
        from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.profiling \
            import spans
    except ImportError:
        return None
    batches = sum(s.name == "cyt.fetch" for s in spans("cyt.fetch"))
    parts = [s.seconds for s in spans("cyt.fetch.wait")]
    if not batches or not parts:
        return None
    return sum(parts) / batches * 1e3
