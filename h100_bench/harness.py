"""The benchmark's runner: it finds a cell's configuration, traffic mix,
system, limits and metrics by the names in ``BENCHMARK.json``, runs the
set-up, the measured window (or, with ``trace``, a traced window), the
comparison with the reference, and assembles the result line.

Everything a cell needs is found by name, so a later change adds a
configuration, a mix, a system, a metric or a cell as new files and
entries:

  configs/<config>.json     the sizes as run, ``system`` naming
  systems/<system>.py       the adapter to the port (``Serve``, ``Train``)
  traffic/<mix>.json        the mix (``task``: serve | train)
  limits/<cell>.json        the limit of each number compared
  metrics/<metric>.py       ``read(ctx)``: the metric, or None
"""

import contextlib
import importlib.util
import json
import os
import sys
import time

import torch

from . import check, traffic, tracing

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
JAX_NAMES = frozenset({"jax", "jaxlib", "flax",
                       "cs231_capsule_yolo_traffic_sign_detection_tpu"})
# the traced window: whole batches or epochs until this many seconds
TRACE_SECONDS = 3.0
WARMUP_BATCHES = 3


def load_spec(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name):
    """``metrics/<name>.py``'s ``read``."""
    mod = _load_module(os.path.join(HERE, "metrics", name + ".py"),
                       "h100_bench_metric_" + name.replace(".", "_"))
    return mod.read


def system(name):
    return importlib.import_module(f"h100_bench.systems.{name}")


class Cell:
    """One entry of ``workloads`` with everything it names resolved."""

    def __init__(self, spec, name):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                           f"{' | '.join(cells)}")
        self.entry = cells[name]
        self.name, self.chips = name, self.entry["chips"]
        self.config = _load_json("configs", self.entry["config"] + ".json")
        self.traffic = traffic.load(self.entry["traffic"])
        self.limits = check.load_limits(name)
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name])
                          and ("workloads" in m or m["moves"] in reported)]


class Spans:
    """Host spans around the benchmark's calls into the port: each
    span's durations (s) by name, and under a trace a ``bench.<name>``
    range for the profiler."""

    def __init__(self, traced=False):
        self.traced, self.durations = traced, {}

    @contextlib.contextmanager
    def __call__(self, name):
        rng = (torch.profiler.record_function("bench." + name)
               if self.traced else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rng:
            yield
        self.durations.setdefault(name, []).append(time.perf_counter() - t0)


class Window:
    """What a measured window did: its seconds, the batches (requests or
    train steps) and images, and each serving batch's latency."""

    def __init__(self):
        self.seconds, self.batches, self.images = 0.0, 0, 0
        self.latencies = []


def serve_window(job, seconds, spans):
    """The closed loop: one batch after another, each timed from taking
    its host input to its outputs on the host, until a batch ends past
    ``seconds``; every batch's outputs kept for the comparison."""
    w = Window()
    t0 = time.perf_counter()
    while True:
        batch = job.next_batch()
        ta = time.perf_counter()
        out = job.serve(batch, spans)
        tb = time.perf_counter()
        job.keep(batch, out)
        w.latencies.append(tb - ta)
        w.batches += 1
        w.images += job.bs
        if tb - t0 >= seconds:
            w.seconds = tb - t0
            return w


def train_window(job, seconds, spans):
    """Whole epochs back to back until one ends past ``seconds``."""
    w = Window()
    t0 = time.perf_counter()
    while True:
        n = job.epoch(spans)
        tb = time.perf_counter()
        w.batches += n
        w.images += n * job.bs
        if tb - t0 >= seconds:
            w.seconds = tb - t0
            return w


def warm_up(job, task):
    """Every shape the window uses, once or more, as set-up: serving
    batches (not kept); a training cell's set-up epoch already ran."""
    if task == "serve":
        spans = Spans()
        for _ in range(WARMUP_BATCHES):
            job.serve(job.next_batch(), spans)
    if torch.device(job.device).type == "cuda":
        torch.cuda.synchronize()


def device_info(device):
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_reserved(dev))}


class Context:
    """What a metric's reader gets: the cell, the window's counts and
    spans and, in a traced run, the device's kernels."""

    def __init__(self, cell, job, window, spans, setup_s, trace=None):
        self.config, self.traffic = cell.config, cell.traffic
        self.window, self.spans, self.setup_s = window, spans, setup_s
        self.flop_per_image = job.flop_per_image
        self.batch = job.bs
        self.trace = trace

    def kernels(self, *parts):
        """The traced kernels whose names hold any of ``parts``:
        [(name, seconds)]."""
        return [(n, d) for n, d in self.trace.kernels
                if any(p in n for p in parts)]


def run_cell(cell, seed, seconds, trace, device, t_start):
    """Set-up, window, comparison; returns the result dict (the line's
    keys, ``checks`` last)."""
    sysmod = system(cell.config["system"])
    task = cell.traffic["task"]
    phases = [("imports", time.time() - t_start)]
    job = (sysmod.Serve if task == "serve" else sysmod.Train)(
        cell.config, cell.traffic, seed, device)
    phases.append(("inputs, weights, program, first epoch",
                   time.time() - t_start))
    warm_up(job, task)
    phases.append(("warm-up", time.time() - t_start))
    # the reference's seconds in set-up (a serving calibration) are the
    # yardstick's, not the program's: setup_s leaves them out
    reference_s = getattr(job, "reference_s", 0.0)
    for name, t in phases:
        print(f"setup: {name} done at {t:.3f} s", file=sys.stderr)
    print(f"setup: of which the reference {reference_s:.3f} s",
          file=sys.stderr)
    loop = serve_window if task == "serve" else train_window
    if trace:
        spans = Spans(traced=True)
        window, prof = tracing.traced(
            lambda: loop(job, min(seconds, TRACE_SECONDS), spans), device)
        setup_s = None
    else:
        setup_s = time.time() - t_start - reference_s
        spans = Spans()
        window = loop(job, seconds, spans)
    info = device_info(device)
    print(f"peak device memory reserved: {info['memory_peak_bytes']} bytes",
          file=sys.stderr)
    result_trace = tracing.reduce(prof, device) if trace else None
    ctx = Context(cell, job, window, spans.durations, setup_s, result_trace)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    job.release()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    correct, checks = check.judge(job.check(), cell.limits)
    result = {"correct": bool(correct), "attempted": window.batches,
              "failed": 0, "metrics": metrics, "device": info}
    if trace:
        info["busy_s"] = result_trace.busy_s
        info["window_s"] = result_trace.window_s
        result["breakdown"] = result_trace.breakdown()
    result["checks"] = checks
    return result


def jax_modules():
    """Top-level names in sys.modules that are JAX's or the JAX
    package's, compared whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & JAX_NAMES)
