"""PyTorch port, the CLI against the JAX CLI (main.py) on the CPU: the
parser's defaults, an unknown --mode, and --mode overfit --npy, which
writes the small set from the ``*_X.npy``/``*_Y.npy`` files as JAX
`make_small_data(..., npy=True)` does."""

import pickle
import shutil

import numpy as np
import pytest

import main as jax_cli
from cs231_capsule_yolo_traffic_sign_detection_tpu.data import (
    loader as jax_loader)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import (
    __main__ as cli)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params

CNN = dict(batch_size=4, n_classes=43, lr=1e-3, n_epochs=1, dropout=0.0,
           lr_decay=0.1)


def test_parser_defaults_are_the_jax_clis():
    ours, theirs = cli.parser.parse_args([]), jax_cli.parser.parse_args([])
    assert (ours.model, ours.mode) == (theirs.model, theirs.mode) \
        == ("cnn", "train")


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def test_unknown_mode_runs_nothing_as_the_jax_cli(tmp_path, monkeypatch,
                                                  capsys):
    """Both CLIs read params.json, return normally and print nothing for
    --mode bogus: no checkpoint, no metric file, no data written (the JAX
    CLI also opens its scalar log under runs/, which the port opens only
    when it trains)."""
    for side in ("port", "jax"):
        d = tmp_path / side / "experiments" / "cnn"
        d.mkdir(parents=True)
        Params(**CNN).save(str(d / "params.json"))
    monkeypatch.setenv("CYT_COMPILE_CACHE", "0")
    monkeypatch.chdir(tmp_path / "port")
    assert cli.main(["--model", "cnn", "--mode", "bogus", "--device",
                     "cpu"]) is None
    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr("sys.argv", ["main.py", "--model", "cnn", "--mode",
                                     "bogus"])
    assert jax_cli.main() is None
    assert capsys.readouterr().out == ""
    assert _tree(tmp_path / "port") == ["experiments", "experiments/cnn",
                                        "experiments/cnn/params.json"]
    assert [p for p in _tree(tmp_path / "jax")
            if not p.startswith("runs")] == _tree(tmp_path / "port")
    # without params.json both raise alike
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        cli.main(["--model", "cnn", "--mode", "bogus", "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        jax_cli.main()


def _npy_set(d, seed):
    """train/eval X and Y as build_data_npy writes them for a classifier:
    centered crops and int labels, 6 and 5 samples."""
    rng = np.random.RandomState(seed)
    d.mkdir(parents=True)
    for name, n in (("train", 6), ("eval", 5)):
        np.save(d / f"{name}_X.npy",
                rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32))
        np.save(d / f"{name}_Y.npy", rng.randint(0, 43, n))


def test_overfit_npy_writes_the_small_set_of_the_npy_files(tmp_path,
                                                            monkeypatch,
                                                            capsys):
    """--mode overfit --npy in a dir holding only the npy files overfits
    their first 3 samples (before, the port looked for train.p, found
    none and overfit the synthetic set): the pickles it writes equal
    JAX make_small_data(npy=True)'s."""
    data = tmp_path / "data" / "GTSRB"
    _npy_set(data, seed=3)
    ref = tmp_path / "ref"
    shutil.copytree(data, ref)
    jax_loader.make_small_data(str(ref), 3, npy=True)
    d = tmp_path / "experiments" / "cnn"
    d.mkdir(parents=True)
    Params(**CNN).save(str(d / "params.json"))
    monkeypatch.chdir(tmp_path)
    cli.main(["--model", "cnn", "--mode", "overfit", "--npy", "--device",
              "cpu", "--no_metric"])
    out = capsys.readouterr().out
    assert "dataset absent" not in out and "synthetic" not in out
    assert out.count("epoch ") == 1
    assert (tmp_path / "experiments" / "cnn1" / "last.ckpt").exists()
    for name in ("train_small.p", "eval_small.p"):
        with open(data / name, "rb") as f:
            ours = pickle.load(f)
        with open(ref / name, "rb") as f:
            theirs = pickle.load(f)
        assert len(ours) == len(theirs) == 2
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype and a.shape == b.shape \
                and a.shape[0] == 3
            np.testing.assert_array_equal(a, b)
