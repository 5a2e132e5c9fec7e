"""PyTorch port, --stream (CPU): data/stream.py's batches against
np.array_split and the JAX package's iterators, the native prefetcher
against its numpy path, uint8 rows, memmaps, a failed build; the
--stream trajectory against the resident one; and two processes joined
through --coordinator/--num_processes/--process_id with --stream, each
loading only its rows (tiny models: 64 px / n_grid 2, batch 8)."""

import json
import os
import pathlib
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu.data import (
    stream as jax_stream)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import native
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import (
    loader, stream)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    checkpoint as ckpt, driver)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _two_threads(monkeypatch):
    """Two CPU threads a process for this file's runs and the ranks they
    spawn: the suite's workers share the machine's cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _data(n, dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randint(0, 256, (n, 6, 5, 3)).astype(np.uint8)
         if dtype == np.uint8 else rng.randn(n, 6, 5, 3).astype(dtype))
    return x, rng.rand(n, 2, 2, 7).astype(np.float32), rng.permutation(n)


@pytest.mark.parametrize("n,n_batch,dtype", [
    (37, 5, np.float32), (32, 4, np.float32), (3, 5, np.float32),
    (64, 1, np.uint8), (37, 5, np.uint8)])
def test_batches_equal_array_split_and_jax(n, n_batch, dtype):
    """Native batches bit-equal np.array_split of the permuted rows (uint8
    rows centered as the loader's center_rgb, in float32), the numpy path
    and the JAX package's iterator; the labels' dtype kept."""
    x, y, perm = _data(n, dtype)
    native_b = list(stream.iter_batches(x, y, perm, n_batch))
    numpy_b = list(stream.iter_batches(x, y, perm, n_batch,
                                       use_native=False))
    jax_b = list(jax_stream.iter_batches(x, y, perm, n_batch))
    want_x = np.array_split(np.asarray(loader.center_rgb(x[perm])
                                       if dtype == np.uint8 else x[perm],
                                       np.float32), n_batch)
    want_y = np.array_split(y[perm], n_batch)
    assert len(native_b) == len(numpy_b) == len(jax_b) == n_batch
    for (xa, ya), (xb, yb), (xc, yc), wx, wy in zip(
            native_b, numpy_b, jax_b, want_x, want_y):
        assert xa.dtype == np.float32 and ya.dtype == y.dtype
        for got in (xa, xb, xc):
            assert np.array_equal(got, wx)
        for got in (ya, yb, yc):
            assert np.array_equal(got, wy)
    assert list(stream.iter_batches(x, y, np.zeros(0, np.int64), 3)) == []


def test_memmap_views_and_center_rgb(tmp_path):
    """Memmapped .npy artifacts (open_memmap_dataset) stream like arrays;
    copy=False yields views of the ring slot; center_rgb is the
    prefetcher's f32 arithmetic."""
    x, y, perm = _data(20, np.uint8)
    np.save(tmp_path / "train_X.npy", x)
    np.save(tmp_path / "train_Y.npy", y)
    xm, ym = stream.open_memmap_dataset(str(tmp_path), "train")
    assert isinstance(xm, np.memmap)
    want = list(stream.iter_batches(x, y, perm, 3))
    for copy in (True, False):
        for (xa, ya), (xb, yb) in zip(
                stream.iter_batches(xm, ym, perm, 3, copy=copy), want):
            assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
    v = np.arange(256, dtype=np.uint8)
    assert np.array_equal(stream.center_rgb(v),
                          np.asarray((v - 128.0) / 128, np.float32))
    with pytest.raises(ValueError, match="float32 or uint8"):
        next(stream.iter_batches(x.astype(np.float64), y, perm, 3))


@pytest.mark.parametrize("n,n_batch,shard_rows", [
    (32, 4, 2), (37, 5, 2), (40, 5, 4), (37, 5, None)])
def test_process_local_slices_equal_jax(n, n_batch, shard_rows):
    """Each process's rows of each batch equal the JAX package's
    iter_batches_process_local for the same permutation (its equal
    split, or rows a mesh names; a batch the data axis does not divide
    whole), and the processes' rows partition each split batch."""
    x, y, perm = _data(n)
    pc = 2 if shard_rows in (None, 2) else 4
    seen = []
    for pi in range(pc):
        got = list(stream.iter_batches_process_local(
            x, y, perm, n_batch, process_index=pi, process_count=pc,
            shard_rows=shard_rows))
        want = list(jax_stream.iter_batches_process_local(
            x, y, perm, n_batch, process_index=pi, process_count=pc,
            shard_rows=shard_rows))
        assert len(got) == len(want) == n_batch
        for (xa, ya, na), (xb, yb, nb) in zip(got, want):
            assert na == nb and np.array_equal(xa, xb) \
                and np.array_equal(ya, yb)
        seen.append(got)
    for b, n_glob in enumerate(len(p) for p in np.array_split(perm,
                                                              n_batch)):
        rows = np.concatenate([seen[pi][b][0] for pi in range(pc)])
        whole = shard_rows is not None and n_glob % shard_rows
        assert len(rows) == (pc * n_glob if whole else n_glob)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A prefetcher that does not compile raises; nothing falls back."""
    (tmp_path / "prefetch.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CSRC", str(tmp_path))
    monkeypatch.setattr(native, "build_dir", lambda: str(tmp_path / "out"))
    stream.library.cache_clear()
    try:
        x, y, perm = _data(8)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            next(stream.iter_batches(x, y, perm, 2))
    finally:
        stream.library.cache_clear()


CNN = dict(model="cnn", n_classes=43, batch_size=8, dropout=0.5,
           lr_runtime=1e-3, lr_decay=0.5, n_epochs=2, eval_every=1,
           train_frac=1, summary=False, npy=True)


def test_stream_trajectory_bit_equals_resident(tmp_path):
    """cnn (BN, dropout 0.5), 2 epochs through train_and_evaluate with
    --npy: --stream over memmapped uint8 crops (the fused centering)
    gives the resident run's losses, metrics and checkpoint to the bit,
    the resident run reading the same crops centered in float32."""
    x_tr, y_tr, x_ev, y_ev = loader.synthetic_dataset(
        "cnn", Params(**CNN), 36, 12)
    runs = {}
    for tag, stream_on in (("resident", False), ("stream", True)):
        data = tmp_path / f"data_{tag}"
        data.mkdir()
        for split, x, y in (("train", x_tr, y_tr), ("eval", x_ev, y_ev)):
            u8 = np.clip(x * 128.0 + 128, 0, 255).astype(np.uint8)
            np.save(data / f"{split}_X.npy",
                    u8 if stream_on else np.asarray(loader.center_rgb(u8),
                                                    np.float32))
            np.save(data / f"{split}_Y.npy", y)
        model_dir = tmp_path / tag
        model_dir.mkdir()
        np.random.seed(0)
        driver.train_and_evaluate(Params(**CNN, stream=stream_on),
                                  str(data), str(model_dir), seed=0,
                                  device="cpu", progress=False)
        runs[tag] = [np.load(model_dir / f"{h}.npy") for h in (
            "losses_tr", "losses_ev", "metrics_tr", "metrics_ev")] + [
            ckpt.load_checkpoint(str(model_dir) + "1/last.ckpt")]
        shutil.rmtree(str(model_dir) + "1")  # 51 MB a checkpoint
    for a, b in zip(runs["stream"][:4], runs["resident"][:4]):
        assert a.shape == (2,) and np.array_equal(a, b)
    sa, sb = runs["stream"][4]["state_dict"], runs["resident"][4]["state_dict"]
    assert all(torch.equal(sa[k], sb[k]) for k in sb)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# records the rows each prefetcher loads, then runs the CLI
_WRAPPER = """
import json, sys
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import __main__ as cli
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import stream
loaded, inner = [], stream._iter_offsets
def spy(x, y, perm, *a):
    loaded.append(sorted(int(i) for i in perm))
    return inner(x, y, perm, *a)
stream._iter_offsets = spy
cli.main(sys.argv[1:])
print('[rows]', json.dumps(loaded))
"""


def test_two_processes_with_coordinator_and_stream(tmp_path):
    """Two CLI processes, --mesh data=2 --stream joined through
    --coordinator/--num_processes/--process_id (one gloo rank each), cnn
    on 64 synthetic crops for 2 epochs: process 0 alone prints the epochs
    and writes the checkpoint and histories; the two prefetchers load
    disjoint rows that together are every row of every epoch; the losses
    are the single-process run's at JAX's rtol 1e-3 for the same pair
    (tests/test_multiprocess.py:159: f32 sums in another order, and
    Adam's first steps follow each gradient's sign)."""
    params = {"batch_size": 8, "n_classes": 43, "lr": 1e-3, "n_epochs": 2,
              "dropout": 0.5, "lr_decay": 0.1}
    common = ["--model", "cnn", "--mode", "train", "--device", "cpu",
              "--no_metric", "--train_frac", "0.125", "--stream"]
    # two threads a process: three CLI processes share the test's cores
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    dirs = {}
    for tag in ("single", "pair"):
        d = tmp_path / tag
        d.mkdir()
        (d / "params.json").write_text(json.dumps(params))
        dirs[tag] = d
    single = subprocess.run(
        [sys.executable, "-c", _WRAPPER, *common, "--model_dir",
         str(dirs["single"]), "--mesh", "off"], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=600)
    assert single.returncode == 0, single.stderr[-3000:]
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WRAPPER, *common, "--model_dir",
         str(dirs["pair"]), "--mesh", "data=2", "--coordinator",
         f"127.0.0.1:{port}", "--num_processes", "2", "--process_id",
         str(pid)], cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert "epoch 2 | train loss" in outs[0][0]
    assert "epoch" not in outs[1][0].replace("[rows]", "")
    assert "[mesh] data=2 model=1 (routing sharded: False)" in outs[0][0]
    assert os.path.exists(str(dirs["pair"]) + "0.125/last.ckpt")

    def rows(out):
        line = [ln for ln in out.splitlines() if ln.startswith("[rows]")]
        return json.loads(line[0][len("[rows] "):])

    r0, r1, r_single = rows(outs[0][0]), rows(outs[1][0]), rows(single.stdout)
    assert len(r0) == len(r1) == len(r_single) == 4  # train, eval x 2
    for a, b, whole in zip(r0, r1, r_single):
        assert not set(a) & set(b)
        assert sorted(a + b) == whole
    for name in ("losses_tr.npy", "losses_ev.npy"):
        np.testing.assert_allclose(np.load(dirs["pair"] / name),
                                   np.load(dirs["single"] / name),
                                   rtol=1e-3)
    for d in dirs.values():
        shutil.rmtree(str(d) + "0.125")
