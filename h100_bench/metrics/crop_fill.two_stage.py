"""crop_fill.two_stage: the share of the classifier's batch that holds a
detected sign, in %: the ``boxes`` the port's ``cyt.fetch`` spans
unpacked (`ops/decode.py:to_flat_host_with_extras`, the boxes over
conf_th among each frame's top ``max_crops``) over the ``crops`` of its
``cyt.tail`` spans (`export._two_stage_tail`, batch x max_crops), in the
traced window.  Program counter.  The program records serving spans
only under a profiler and keeps them for the whole process;
`h100_bench/run.py` runs one cell a process, so these are the traced
window's.  None where the program records no such span or count."""


def read(ctx):
    try:
        from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.profiling \
            import spans
    except ImportError:
        return None
    fetches = [s for s in spans("cyt.fetch") if s.name == "cyt.fetch"]
    crops = sum(s.args.get("crops", 0) for s in spans("cyt.tail")
                if s.name == "cyt.tail")
    if not crops or not any("boxes" in s.args for s in fetches):
        return None
    return 100.0 * sum(s.args.get("boxes", 0) for s in fetches) / crops
