"""setup_first_call_s: seconds of set-up spent in the first call of each
of the program's serving fns (`export.make_detector_fn`,
`make_classifier_fn`) and train epochs (`train.steps.Epoch`: its eager
batch and the capture): the sum of the port's
``cyt.setup.first_call`` spans.  The spans are kept for the whole
process, and `h100_bench/run.py` runs one cell a process, so this is
the cell's set-up alone.  Program span; None where the program records
no such span."""


def read(ctx):
    try:
        from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.profiling \
            import spans
    except ImportError:
        return None
    first = [s.seconds for s in spans("cyt.setup.first_call")]
    if not first:
        return None
    return sum(first)
