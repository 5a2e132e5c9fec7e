"""The traced window: `torch.profiler` over the device and the host,
reduced to the device's operations (kernels, copies, fills), the
device's busy seconds, the window's length and the idle gaps by what the
host was doing (the benchmark's own ``bench.*`` spans)."""

import bisect

import torch

WINDOW = "bench.window"


def traced(fn, device):
    """``fn()`` under the profiler, inside a ``bench.window`` range;
    returns (its result, the profile)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            out = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    return out, prof


def _annotation(ev):
    is_ann = getattr(ev, "is_user_annotation", None)
    name = ev.name()
    return (bool(is_ann()) if callable(is_ann) else False) or \
        name.startswith(("bench.", "Optimizer.", "ProfilerStep"))


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The reduced trace: ``kernels`` [(name, seconds)] of every device
    operation in the window, ``busy_s`` (the union of their intervals),
    ``window_s``, and the idle gaps [(host span, seconds)]."""

    def __init__(self, window, device_ops, host_spans):
        w0, w1 = window
        self.window_s = (w1 - w0) / 1e9
        ops = [(n, max(a, w0), min(b, w1)) for n, a, b in device_ops
               if b > w0 and a < w1]
        self.kernels = [(n, (b - a) / 1e9) for n, a, b in ops]
        busy = _union([(a, b) for _, a, b in ops])
        self.busy_s = sum(b - a for a, b in busy) / 1e9
        gaps, t = [], w0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < w1:
            gaps.append((t, w1))
        spans = sorted(host_spans, key=lambda s: s[1])
        starts = [a for _, a, _ in spans]
        self.gaps = [(_span_at(spans, starts, a), (b - a) / 1e9)
                     for a, b in gaps]

    def breakdown(self, top=10):
        """The device operations that took most time and the idle time
        by the host span the gaps began in, each at most ``top``."""
        by_op, by_span = {}, {}
        for n, s in self.kernels:
            by_op[n] = by_op.get(n, 0.0) + s
        for n, s in self.gaps:
            by_span[n] = by_span.get(n, 0.0) + s
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}


def _span_at(spans, starts, t):
    """The host span (they do not nest inside the window) that holds
    ``t``, by name; the window itself between them."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][1] <= t < spans[i][2]:
        return spans[i][0]
    return WINDOW


def reduce(prof, device):
    """The profile as a `Trace`."""
    events = prof.profiler.kineto_results.events()
    window, device_ops, host_spans = None, [], []
    for ev in events:
        name = ev.name()
        a, b = ev.start_ns(), ev.end_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not _annotation(ev):
                device_ops.append((name, a, b))
        elif name == WINDOW:
            window = (a, b)
        elif name.startswith("bench."):
            host_spans.append((name, a, b))
    if window is None:
        raise RuntimeError("the trace holds no bench.window range")
    if torch.device(device).type == "cuda" and not device_ops:
        raise RuntimeError("the trace holds no device operation: the "
                           "profiler saw nothing on the card")
    return Trace(window, device_ops, host_spans)
