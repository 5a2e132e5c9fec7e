"""The port's spans (`profiling.span`) on the CPU: the profiler's clock,
parents and counts, what is recorded with and without a profiler, the
bounded store, outputs unchanged by tracing, and the benchmark's span
metrics read from a traced small cell."""

import math
import threading
import time

import numpy as np
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import profiling
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import (
    decode, preprocess)
from h100_bench import harness
from h100_bench.tests.small import SEED, small_cell

CPU = [torch.profiler.ProfilerActivity.CPU]
SERVE_SPAN_METRICS = ("stage_gather_ms.serve", "stage_copy_ms.serve",
                      "fetch_wait_ms.serve", "fetch_unpack_ms.serve")
SETUP_METRICS = ("setup_program_s", "setup_first_call_s")


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


def _names(records):
    return [s.name for s in records]


def test_a_span_lies_on_the_profiler_s_clock():
    with torch.profiler.profile(activities=CPU):   # its first use is slow
        with torch.profiler.record_function("cyt.test.warm"):
            pass
    with torch.profiler.profile(activities=CPU) as prof:
        with profiling.span("cyt.test.clock"):
            time.sleep(0.01)
    s, = profiling.spans("cyt.test.clock")
    ev, = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "cyt.test.clock"]
    # a different clock would be off by seconds or more
    assert abs(s.start_ns - ev.start_ns()) < 5e6
    assert abs(s.end_ns - ev.end_ns()) < 5e6
    assert s.seconds >= 0.01


def test_parents_args_and_order_are_recorded():
    with torch.profiler.profile(activities=CPU):
        with profiling.span("cyt.outer", images=3) as outer:
            with profiling.span("cyt.outer.inner", bytes=7) as inner:
                pass
            with profiling.span("cyt.setup.nested") as nested:
                pass
        other = []

        def elsewhere():
            with profiling.span("cyt.thread") as s:
                other.append(s)

        with profiling.span("cyt.outer2"):
            t = threading.Thread(target=elsewhere)
            t.start()
            t.join(timeout=10)
        assert not t.is_alive()
    assert outer.parent is None
    assert inner.parent is outer and nested.parent is outer
    assert other[0].parent is None       # a thread's own stack
    assert outer.args == {"images": 3} and inner.args == {"bytes": 7}
    assert outer.seq < inner.seq < nested.seq
    # stored as they close
    assert _names(profiling.spans("cyt.outer")) == [
        "cyt.outer.inner", "cyt.outer", "cyt.outer2"]
    assert profiling.spans("cyt.setup.") == [nested]


def test_without_a_profiler_only_set_up_spans_record():
    with profiling.span(profiling.STAGE, images=2) as stage:
        with profiling.span(profiling.SETUP_INIT) as init:
            pass
    assert stage is None
    assert profiling.spans() == [init]
    assert init.parent is None           # the serving span was not opened
    profiling.clear()
    assert profiling.spans() == []
    fn = profiling.first_call(lambda x: x + 1)
    assert [fn(1), fn(2)] == [2, 3]
    assert _names(profiling.spans()) == [profiling.SETUP_FIRST_CALL]


def test_the_store_keeps_the_newest_spans():
    for _ in range(profiling.STORE_SIZE + 5):
        with profiling.span("cyt.setup.test"):
            pass
    kept = profiling.spans()
    assert len(kept) == profiling.STORE_SIZE
    assert kept[-1].seq - kept[0].seq == profiling.STORE_SIZE - 1


def test_staging_and_fetch_give_the_same_outputs_traced():
    rng = np.random.RandomState(0)
    same = [rng.randint(0, 256, (40, 56, 3), dtype=np.uint8)
            for _ in range(3)]
    mixed = same[:2] + [rng.randint(0, 256, (24, 32, 3), dtype=np.uint8)]
    decoded = decode.decode_grid(
        torch.from_numpy(rng.rand(3, 2, 2, 9).astype(np.float32)),
        n_classes=4, n_boxes=1, img_size=64, conf_th=0.3)
    extras = {"score": torch.from_numpy(rng.rand(3, 4).astype(np.float32))}
    hw = np.array([[40, 56]] * 3)

    def run():
        xs = [preprocess.preprocess_images(f, 32, "cpu") for f in (same,
                                                                   mixed)]
        return xs, decode.to_flat_host_with_extras(
            decoded, extras, image_hw=hw, img_size=64)

    xs_off, (out_off, ex_off) = run()
    assert profiling.spans() == []
    with torch.profiler.profile(activities=CPU):
        xs_on, (out_on, ex_on) = run()
    for a, b in zip(xs_off, xs_on):
        assert torch.equal(a, b)
    assert len(out_off[0]) > 0
    for a, b in zip(out_off, out_on):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ex_off["score"], ex_on["score"])
    names = _names(profiling.spans())
    assert names.count(profiling.STAGE) == 2
    assert names.count(profiling.STAGE_GATHER) == 1
    copies = profiling.spans(profiling.STAGE_COPY)
    assert len(copies) == 1 + 3          # a batch, then an image each
    assert all(s.args == {"bytes": 0} for s in copies)
    for name in (profiling.FETCH, profiling.FETCH_WAIT,
                 profiling.FETCH_UNPACK):
        assert names.count(name) == 1
    fetch, = [s for s in profiling.spans() if s.name == profiling.FETCH]
    assert fetch.args == {"images": 3, "boxes": len(out_on[0])}


def test_a_traced_serving_window_reads_the_program_s_spans():
    r = harness.run_cell(small_cell("darknet_r.serve"), SEED, 0.2, True,
                         "cpu", time.time())
    m = r["metrics"]
    for name in SERVE_SPAN_METRICS + SETUP_METRICS:
        assert math.isfinite(m[name]["value"]) and m[name]["value"] >= 0
    assert "h2d_gb_s.serve" not in m     # no byte crossed to a card
    assert m["stage_gather_ms.serve"]["value"] + \
        m["stage_copy_ms.serve"]["value"] <= m["staging_ms.serve"]["value"]
    assert m["setup_first_call_s"]["value"] <= m["setup_program_s"]["value"]
    names = _names(profiling.spans())
    assert names.count(profiling.STAGE) == r["attempted"]
    assert names.count(profiling.FETCH) == r["attempted"]
    assert not any(n.startswith("cyt.")
                   for n, _ in r["breakdown"]["device_ops"])
    assert r["correct"] is True


def test_a_traced_training_window_reports_the_set_up_spans():
    r = harness.run_cell(small_cell("capsule.train"), SEED, 0.2, True,
                         "cpu", time.time())
    for name in SETUP_METRICS:
        assert r["metrics"][name]["value"] > 0
    names = _names(profiling.spans(profiling.SETUP))
    assert profiling.SETUP_INIT in names
    assert profiling.SETUP_FIRST_CALL in names
