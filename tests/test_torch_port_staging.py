"""The port's staging of host arrays (`ops/preprocess.py:stage`): its
chunked write-and-copy loop against ``np.stack`` and `preprocess_images`
on the CPU, its spans and counts, the gather threads' rows against
``np.stack`` (any worker count, bad rows, concurrent callers) and when
a call uses them, `predict.class_pred`'s crops staged through it,
`predict.dark_detect`'s grid against the shared detector forward
(`export.detector_forward`), and on the card the pinned path against
the pageable one, two calls in flight at once (on the calling thread
and on the gather threads), and the ``pinned`` count of the
``cyt.stage`` span.

The card's tests skip without one.  This file imports nothing of JAX,
so it also runs on a machine without it:

    python -m pytest tests/test_torch_port_staging.py --noconftest -q
"""

import math
import sys
import threading

import numpy as np
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import (
    export, predict, profiling)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.device import (
    compute_dtype)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
    ConvNet, DarkNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import preprocess
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    checkpoint as ckpt)

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


def _frames(n, hw=(12, 20), seed=0):
    """``n`` uint8 frames of ``hw``; the second (where there is one) a
    strided view, the last a reversed one (negative strides)."""
    rng = np.random.RandomState(seed)
    frames = [rng.randint(0, 256, hw + (3,), dtype=np.uint8)
              for _ in range(n)]
    if n > 1:
        wide = rng.randint(0, 256, (hw[0], 2 * hw[1], 3), dtype=np.uint8)
        frames[1] = wide[:, ::2]
    big = rng.randint(0, 256, hw + (3,), dtype=np.uint8)
    frames[-1] = big[::-1, :, ::-1]
    return frames


@pytest.mark.parametrize("chunk", [1, 3, preprocess.CHUNK_FRAMES, 64])
@pytest.mark.parametrize("n", [1, 5, 33])
def test_stage_chunks_writes_and_copies_every_frame(monkeypatch, n, chunk):
    monkeypatch.setattr(preprocess, "CHUNK_FRAMES", chunk)
    frames = _frames(n)
    assert not frames[-1].flags.c_contiguous
    want = np.stack(frames)
    got = preprocess.stage(frames, "cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # an array's rows stage as the list of them does
    assert torch.equal(preprocess.stage(want, "cpu"), got)
    assert torch.equal(preprocess.preprocess_batch(got, 16),
                       preprocess.preprocess_images(frames, 16, "cpu"))


@pytest.mark.parametrize("n", [5, 33])
def test_stage_chunks_records_a_gather_and_a_copy_a_chunk(n):
    frames = _frames(n)
    with torch.profiler.profile(activities=CPU):
        preprocess.stage(frames, "cpu")
    chunks = math.ceil(n / preprocess.CHUNK_FRAMES)
    stages = [s for s in profiling.spans(profiling.STAGE)
              if s.name == profiling.STAGE]
    assert [s.args for s in stages] == [{"images": n, "pinned": 0,
                                         "workers": 1}]
    assert len(profiling.spans(profiling.STAGE_GATHER)) == chunks
    copies = profiling.spans(profiling.STAGE_COPY)
    assert len(copies) == chunks
    assert all(s.args == {"bytes": 0} for s in copies)   # to the host
    assert all(s.parent is stages[0] for s in copies)


def test_the_host_stages_through_no_pinned_memory():
    same, mixed = _frames(3), _frames(2) + _frames(1, hw=(8, 8))
    with torch.profiler.profile(activities=CPU):
        for frames in (same, mixed):
            preprocess.preprocess_images(frames, 16, "cpu")
    stages = [s for s in profiling.spans(profiling.STAGE)
              if s.name == profiling.STAGE]
    assert [s.args for s in stages] == [
        {"images": 3, "pinned": 0, "workers": 1},
        {"images": 3, "pinned": 0, "workers": 1}]


def _parallel(monkeypatch, cores=8):
    """`stage` as on a host of ``cores`` cores with no byte threshold:
    every call goes to the gather threads."""
    monkeypatch.setattr(preprocess, "PARALLEL_BYTES", 0)
    monkeypatch.setattr(preprocess, "_cores", lambda: cores)


def _gather_threads():
    return sum(t.name.startswith("cyt-gather-")
               for t in threading.enumerate())


@pytest.mark.parametrize("workers", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 5, 33])
def test_parallel_gather_equals_np_stack(n, workers):
    frames = _frames(n)
    if n > 2:   # a window of a wider frame: neither C- nor F-ordered
        wide = np.random.RandomState(9).randint(0, 256, (12, 40, 3),
                                                dtype=np.uint8)
        frames[2] = wide[:, 7:27]
    want = np.stack(frames)
    out = np.zeros_like(want)
    chunks = []

    def on_chunk(i, j):   # a chunk's rows are written before its call
        np.testing.assert_array_equal(out[i:j], want[i:j])
        chunks.append((i, j))

    preprocess._gather(frames, out, workers, on_chunk)
    np.testing.assert_array_equal(out, want)
    c = preprocess.GATHER_CHUNK
    assert chunks == [(i, min(i + c, n)) for i in range(0, n, c)]
    # an array's rows gather as the list of them does
    again = np.zeros_like(want)
    preprocess._gather(want[::-1][::-1], again, workers)
    np.testing.assert_array_equal(again, want)


@pytest.mark.parametrize("n", [5, 33])
def test_parallel_stage_waits_a_chunk_at_a_time_on_the_calling_thread(
        monkeypatch, n):
    _parallel(monkeypatch)
    frames = _frames(n)
    with torch.profiler.profile(activities=CPU):
        got = preprocess.stage(frames, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.stack(frames))
    workers = min(preprocess.GATHER_WORKERS, n, 7)
    assert workers > 1
    stages = [s for s in profiling.spans(profiling.STAGE)
              if s.name == profiling.STAGE]
    assert [s.args for s in stages] == [{"images": n, "pinned": 0,
                                         "workers": workers}]
    chunks = math.ceil(n / preprocess.GATHER_CHUNK)
    gathers = profiling.spans(profiling.STAGE_GATHER)
    copies = profiling.spans(profiling.STAGE_COPY)
    assert len(gathers) == len(copies) == chunks
    # each opened on the calling thread, inside its stage span; the
    # gather threads record none
    assert all(s.parent is stages[0] for s in gathers + copies)
    assert len(profiling.spans()) == 1 + 2 * chunks
    # each chunk's wait, then its copy
    order = sorted(gathers + copies, key=lambda s: s.seq)
    assert [s.name for s in order] == \
        [profiling.STAGE_GATHER, profiling.STAGE_COPY] * chunks


def test_small_calls_write_on_the_calling_thread_alone(monkeypatch):
    monkeypatch.setattr(preprocess, "_POOL", None)
    threads = _gather_threads()
    frames = _frames(5)
    nbytes = 5 * 12 * 20 * 3
    assert nbytes < preprocess.PARALLEL_BYTES
    with torch.profiler.profile(activities=CPU):
        preprocess.stage(frames, "cpu")
        # large enough, on hosts with no core to spare for a second
        # writer
        _parallel(monkeypatch, cores=1)
        preprocess.stage(frames, "cpu")
        _parallel(monkeypatch, cores=2)
        preprocess.stage(frames, "cpu")
    assert preprocess._POOL is None and _gather_threads() == threads
    stages = [s for s in profiling.spans(profiling.STAGE)
              if s.name == profiling.STAGE]
    assert [s.args["workers"] for s in stages] == [1, 1, 1]


def test_the_bytes_the_rows_and_the_cores_set_the_workers(monkeypatch):
    big, cap = 1 << 30, preprocess.GATHER_WORKERS
    monkeypatch.setattr(preprocess, "_cores", lambda: 64)
    assert preprocess._workers(preprocess.PARALLEL_BYTES - 1, 32) == 1
    assert preprocess._workers(preprocess.PARALLEL_BYTES, 32) == cap
    assert preprocess._workers(big, 1) == 1
    assert preprocess._workers(big, 2) == min(2, cap)
    for cores, want in ((1, 1), (2, 1), (3, min(2, cap)),
                        (cap + 1, cap)):
        monkeypatch.setattr(preprocess, "_cores", lambda: cores)
        assert preprocess._workers(big, 32) == want


@pytest.mark.parametrize("bad", [0, 6, 32])
@pytest.mark.parametrize("fault", ["shape", "dtype"])
def test_a_bad_row_raises_in_the_caller(monkeypatch, fault, bad):
    frames = _frames(33)
    if fault == "shape":   # one line short
        frames[bad], error = frames[bad][:-1], ValueError
    else:                  # float64 does not cast to uint8 as same_kind
        frames[bad], error = frames[bad].astype(np.float64), TypeError
    out = np.empty((33, 12, 20, 3), np.uint8)
    with pytest.raises(error):
        np.stack(frames, out=out)
    with pytest.raises(error):
        preprocess._gather(frames, out, 3)
    _parallel(monkeypatch)
    if bad:   # row 0 sets the shape and dtype
        with pytest.raises(error):
            preprocess.stage(frames, "cpu")
    # and the pool goes on
    good = _frames(33, seed=1)
    np.testing.assert_array_equal(preprocess.stage(good, "cpu").numpy(),
                                  np.stack(good))


def test_concurrent_calls_keep_their_own_rows(monkeypatch):
    """Four callers at once, twelve gather threads (more than a small
    host's cores) and a switch between threads every microsecond: each
    call's rows are its own, whole."""
    _parallel(monkeypatch, cores=64)
    monkeypatch.setattr(preprocess, "GATHER_WORKERS", 12)
    monkeypatch.setattr(preprocess, "GATHER_CHUNK", 3)
    errors = []

    def caller(seed):
        try:
            for k in range(10):
                frames = _frames(17, hw=(6, 10), seed=100 * seed + k)
                got = preprocess.stage(frames, "cpu").numpy()
                if not np.array_equal(got, np.stack(frames)):
                    errors.append((seed, k))
        except Exception as e:
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        callers = [threading.Thread(target=caller, args=(s,))
                   for s in range(4)]
        for t in callers:
            t.start()
        for t in callers:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in callers)
    assert errors == []


def _checkpoint(model_dir, model):
    ckpt.save_checkpoint({"epoch": 0, "optim_dict": {},
                          "state_dict": model.state_dict()}, False,
                         str(model_dir))


def test_class_pred_stages_each_batch_of_crops(tmp_path):
    """class_pred's crops reach the device through `stage`, one
    ``cyt.stage`` span a batch of ``batch_size`` crops, and score as
    `export.make_classifier_fn` does on the same batches."""
    params = Params(model="cnn", n_classes=43, batch_size=8)
    model = ConvNet(43, seed=1)
    _checkpoint(tmp_path, model)
    x = np.random.RandomState(0).uniform(-1, 1, (20, 32, 32, 3)).astype(
        np.float32)
    with torch.profiler.profile(activities=CPU):
        y_hat, classes = predict.class_pred(x, str(tmp_path), params, "last",
                                            device="cpu")
    stages = [s for s in profiling.spans(profiling.STAGE)
              if s.name == profiling.STAGE]
    assert [s.args for s in stages] == [{"images": n, "pinned": 0,
                                         "workers": 1} for n in (8, 8, 4)]
    fn = export.make_classifier_fn(model)
    with torch.inference_mode():
        want = torch.cat([fn(torch.from_numpy(x[i:i + 8]))[0]
                          for i in range(0, 20, 8)])
    np.testing.assert_array_equal(y_hat, want.numpy())
    np.testing.assert_array_equal(classes, np.argmax(y_hat, axis=1))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_dark_detect_serves_the_shared_detector_forward(tmp_path, dtype):
    """dark_detect's grid is `export.detector_forward`'s on the same
    batch, int8 calibrated on that batch."""
    params = Params(model="darknet_r", n_classes=43, n_boxes=1, n_grid=2,
                    darknet_input=64, batch_size=4, compute_dtype=dtype)
    model = DarkNet(1, 43, seed=1).eval()
    _checkpoint(tmp_path, model)
    frames = list(np.random.RandomState(2).randint(0, 256, (4, 64, 64, 3),
                                                   dtype=np.uint8))
    y_hat, _ = predict.dark_detect(frames, str(tmp_path), params, "last",
                                   device="cpu")
    x = preprocess.preprocess_images(frames, 64, "cpu")
    with torch.inference_mode():
        want = export.detector_forward(model, compute_dtype(dtype),
                                       n_boxes=1, n_classes=43, x_cal=x)(x)
    assert y_hat.shape == (4, 2, 2, 48)
    np.testing.assert_array_equal(y_hat, want.numpy())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pinned memory and the copy engine")
    return "cuda"


def _pageable(frames, size):
    """Staging as it was before pinned memory: one ``np.stack`` and one
    copy from pageable memory."""
    return preprocess.preprocess_batch(
        torch.from_numpy(np.stack(frames)).to("cuda"), size)


@pytest.mark.cuda
def test_pinned_staging_equals_pageable_on_the_card(card):
    frames = _frames(32, hw=(800, 1360), seed=1)
    got = preprocess.preprocess_images(frames, 448, card)
    assert torch.equal(got, _pageable(frames, 448))


@pytest.mark.cuda
def test_two_calls_in_flight_keep_their_own_frames(card):
    a = _frames(32, hw=(800, 1360), seed=2)
    b = _frames(32, hw=(800, 1360), seed=3)
    preprocess.preprocess_images(a, 448, card)   # the pinned block, cached
    torch.cuda.synchronize()
    # a busy stream: the first call's copies wait while the second call
    # writes its frames
    torch.cuda._sleep(200_000_000)
    xa = preprocess.preprocess_images(a, 448, card)
    xb = preprocess.preprocess_images(b, 448, card)
    torch.cuda.synchronize()
    assert torch.equal(xa, _pageable(a, 448))
    assert torch.equal(xb, _pageable(b, 448))


@pytest.mark.cuda
def test_two_parallel_calls_in_flight_keep_their_own_frames(card,
                                                            monkeypatch):
    """As above, with the rows written by the gather threads whatever
    the host's cores."""
    monkeypatch.setattr(preprocess, "_cores", lambda: 8)
    a = _frames(32, hw=(800, 1360), seed=4)
    b = _frames(32, hw=(800, 1360), seed=5)
    preprocess.preprocess_images(a, 448, card)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    with torch.profiler.profile(activities=CPU):
        xa = preprocess.preprocess_images(a, 448, card)
        xb = preprocess.preprocess_images(b, 448, card)
    torch.cuda.synchronize()
    stages = [s for s in profiling.spans(profiling.STAGE)
              if s.name == profiling.STAGE]
    assert [s.args["workers"] for s in stages] == \
        [min(preprocess.GATHER_WORKERS, 7)] * 2
    assert min(preprocess.GATHER_WORKERS, 7) > 1
    assert torch.equal(xa, _pageable(a, 448))
    assert torch.equal(xb, _pageable(b, 448))


@pytest.mark.cuda
def test_the_card_counts_every_image_pinned(card):
    frames = _frames(6, hw=(40, 56))
    with torch.profiler.profile(activities=CPU):
        preprocess.preprocess_images(frames, 32, card)
        preprocess.preprocess_images(frames[:2] + _frames(1, hw=(8, 8)), 32,
                                     card)
    stages = [s for s in profiling.spans(profiling.STAGE)
              if s.name == profiling.STAGE]
    assert [s.args for s in stages] == [
        {"images": 6, "pinned": 6, "workers": 1},
        {"images": 3, "pinned": 0, "workers": 1}]
    copies = profiling.spans(profiling.STAGE_COPY)
    chunks = math.ceil(6 / preprocess.CHUNK_FRAMES)
    assert sum(s.args["bytes"] for s in copies[:chunks]) == 6 * 40 * 56 * 3
