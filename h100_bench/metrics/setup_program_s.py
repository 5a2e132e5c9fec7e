"""setup_program_s: seconds of set-up spent in the program's own set-up
spans (``cyt.setup.*``: the kernels' build and load, the seeded
initialisers, building the serving fns, the first call of each serving
fn and train epoch, the CUDA graphs' capture), each counted once: the
sum of those with no ``cyt.setup`` span around them.  The spans are
kept for the whole process, and `h100_bench/run.py` runs one cell a
process, so this is the cell's set-up alone.  Program span; None where
the program records no such span."""


def read(ctx):
    try:
        from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.profiling \
            import spans
    except ImportError:
        return None
    setup = spans("cyt.setup.")
    if not setup:
        return None
    return sum(s.seconds for s in setup if not _inside_setup(s))


def _inside_setup(s):
    p = s.parent
    while p is not None:
        if p.name.startswith("cyt.setup."):
            return True
        p = p.parent
    return False
