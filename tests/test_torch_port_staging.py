"""The port's staging of host frames (`ops/preprocess.py`): the chunked
write-and-copy loop (`stage_chunks`) against ``np.stack`` and
`preprocess_images` on the CPU, its spans and counts, and on the card
the pinned path against the pageable one, two calls in flight at once,
and the ``pinned`` count of the ``cyt.stage`` span.

The card's tests skip without one.  This file imports nothing of JAX,
so it also runs on a machine without it:

    python -m pytest tests/test_torch_port_staging.py --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import profiling
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import preprocess

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
    host = torch.empty(want.shape, dtype=torch.uint8)
    dest = torch.empty(want.shape, dtype=torch.uint8)
    assert preprocess.stage_chunks(frames, host, dest) is dest
    np.testing.assert_array_equal(host.numpy(), want)
    np.testing.assert_array_equal(dest.numpy(), want)
    assert torch.equal(preprocess.preprocess_batch(dest, 16),
                       preprocess.preprocess_images(frames, 16, "cpu"))


@pytest.mark.parametrize("n", [5, 33])
def test_stage_chunks_records_a_gather_and_a_copy_a_chunk(n):
    frames = _frames(n)
    host = torch.empty((n, 12, 20, 3), dtype=torch.uint8)
    dest = torch.empty_like(host)
    with torch.profiler.profile(activities=CPU):
        preprocess.stage_chunks(frames, host, dest)
    chunks = math.ceil(n / preprocess.CHUNK_FRAMES)
    assert len(profiling.spans(profiling.STAGE_GATHER)) == chunks
    copies = profiling.spans(profiling.STAGE_COPY)
    assert len(copies) == chunks
    assert all(s.args == {"bytes": 0} for s in copies)   # to the host


def test_the_host_stages_through_no_pinned_memory():
    same, mixed = _frames(3), _frames(2) + _frames(1, hw=(8, 8))
    with torch.profiler.profile(activities=CPU):
        for frames in (same, mixed):
            preprocess.preprocess_images(frames, 16, "cpu")
    stages = [s for s in profiling.spans(profiling.STAGE)
              if s.name == profiling.STAGE]
    assert [s.args for s in stages] == [{"images": 3, "pinned": 0},
                                        {"images": 3, "pinned": 0}]


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
def test_the_card_counts_every_image_pinned(card):
    frames = _frames(6, hw=(40, 56))
    with torch.profiler.profile(activities=CPU):
        preprocess.preprocess_images(frames, 32, card)
        preprocess.preprocess_images(frames[:2] + _frames(1, hw=(8, 8)), 32,
                                     card)
    stages = [s for s in profiling.spans(profiling.STAGE)
              if s.name == profiling.STAGE]
    assert [s.args for s in stages] == [{"images": 6, "pinned": 6},
                                        {"images": 3, "pinned": 0}]
    copies = profiling.spans(profiling.STAGE_COPY)
    chunks = math.ceil(6 / preprocess.CHUNK_FRAMES)
    assert sum(s.args["bytes"] for s in copies[:chunks]) == 6 * 40 * 56 * 3
