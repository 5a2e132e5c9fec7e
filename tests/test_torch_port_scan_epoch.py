"""PyTorch port, --scan_epoch (CPU): the epoch objects of train/steps.py
(`make_train_epoch`, `make_eval_epoch`) and the driver's scan branch
against the per-batch loop, bit for bit, for the five trained models;
the epoch objects against the JAX package's whole-epoch programs
(train/steps.py:188-264) from the same weights and permutation; the
setting's resolution, the CLI flag, and the messages where the loop
runs instead; the port's profiling.py against the JAX package's.  On the CPU the epoch body runs eagerly: it is the plain
version of the CUDA graphs a card replays (tests/test_torch_port_cuda.py
holds the graphs against it).  Small: 64 px detectors, 32 px crops,
ragged sizes (two groups of batches), two epochs."""

import contextlib
import io
import json
import os
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu import (
    losses as jax_losses, profiling as jax_profiling)
from cs231_capsule_yolo_traffic_sign_detection_tpu.models import (
    ConvNet as JaxConvNet, DarkNet as JaxDarkNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu.params import (
    Params as JaxParams)
from cs231_capsule_yolo_traffic_sign_detection_tpu.train import (
    steps as jax_steps)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import (
    __main__ as cli, losses, profiling)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import loader
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
    ConvNet, DarkNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.parallel import (
    mesh as par)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    checkpoint as ckpt, driver, steps)

from test_torch_port_cnn import _port_layout64 as cnn_layout
from test_torch_port_darknet_train import _port_layout as darknet_layout
from torch_port_helpers import jax_variables_from_port

# each model at 64 px (detectors) or 32 px (crops), dropout 0.5 where the
# model has it; 10 train rows at batch 4 are batches of 4, 3, 3
BASE = dict(n_classes=43, batch_size=4, lr_runtime=1e-3, lr_decay=0.1,
            n_epochs=2, eval_every=1, train_frac=1, recon=True,
            recon_coef=5e-4, dropout=0.5, l_coord=5.0, l_noobj=0.5,
            n_boxes=1, n_grid=2, darknet_input=64, summary=False)
MODELS = {"cnn": {}, "capsule": {}, "darknet_r": {},
          "darknet_d": dict(n_boxes=2, n_classes=0),
          "darkcapsule": dict(n_grid=2)}


def _params(model, scan, **over):
    return Params(**dict(BASE, model=model, scan_epoch=scan,
                         **MODELS[model], **over))


def _run(model, scan, data):
    """2 train and eval epochs from seed 0 (metric on); returns the
    epochs' results, per-batch losses and outputs, the state after and
    the trainer."""
    x, y, xe, ye = data
    t = driver.Trainer(_params(model, scan), seed=0, device="cpu",
                       verbose=False)
    assert t.scan_epoch == (scan == "on")
    np.random.seed(0)
    out = []
    with contextlib.redirect_stdout(io.StringIO()):
        for _ in range(2):
            out.append(t.train_epoch(x, y, 1e-3, metric_on=True))
            out.append((t.last_losses.clone(), torch.cat(t.last_outputs)))
            out.append(t.eval_epoch(xe, ye, metric_on=True))
            out.append((t.last_losses.clone(), torch.cat(t.last_outputs)))
    state = {k: v.clone() for k, v in t.model.state_dict().items()}
    return out, state, t


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(u, v) for u, v in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("model", list(MODELS))
def test_scan_epoch_equals_the_loop(model):
    """--scan_epoch on --device cpu (the epoch objects, eagerly) against
    the per-batch loop: every batch's loss and outputs, the epochs'
    metrics, the weights, BN buffers, Adam's state and the dropout
    generator's state, bit for bit, over 2 epochs of 10 train rows
    (batches of 4, 3, 3: two groups) and 7 eval rows (4, 3)."""
    p = _params(model, "off")
    data = loader.synthetic_dataset(model, p, 10, 7)
    a, sa, ta = _run(model, "off", data)
    b, sb, tb = _run(model, "on", data)
    assert [len(e[0]) for e in b[1:4:2]] == [3, 2]
    assert _equal(a, b)
    assert _equal(sa, sb)
    assert _equal(steps.optimizer_state(ta.opt),
                  steps.optimizer_state(tb.opt))
    if ta.generator is not None:
        assert torch.equal(ta.generator.get_state(),
                           tb.generator.get_state())
    assert set(tb._epochs) == {(True, 4, 1), (True, 3, 2), (False, 4, 1),
                               (False, 3, 1)}


@pytest.mark.parametrize("setting,want", [
    ("auto", False), ("on", True), ("off", False), ("ON", True),
    (True, True), (False, False), (None, False)])
def test_resolve_scan_on_the_cpu(setting, want):
    assert driver.Trainer._resolve_scan(setting, "cpu") is want


def test_resolve_scan_auto_on_a_card():
    want = driver.SCAN_EPOCH_AUTO_ON_CARD
    assert driver.Trainer._resolve_scan("auto", "cuda") is want
    assert driver.Trainer._resolve_scan("off", "cuda") is False


def test_group_splits_as_jax():
    """At most two groups, the larger batches first, in int64."""
    from cs231_capsule_yolo_traffic_sign_detection_tpu.train.driver import (
        Trainer as JaxTrainer)
    for n, n_batch in ((10, 3), (2000, 32), (8, 2), (7, 7)):
        perm = np.random.RandomState(n).permutation(n)
        splits = np.array_split(perm, n_batch)
        got = driver._group_splits(splits)
        want = JaxTrainer._group_splits(splits)
        assert len(got) == len(want) <= 2
        for g, w in zip(got, want):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------- JAX

def _jax_state(variables):
    params = variables["params"]
    return jax_steps.TrainState(
        params=params, batch_stats=variables["batch_stats"],
        opt_state=jax_steps.make_optimizer().init(params),
        rng=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.mark.parametrize("model", ["cnn", "darknet_r"])
def test_epochs_match_jax(model):
    """`make_train_epoch` then `make_eval_epoch` against JAX's
    whole-epoch programs, both frameworks in f64 from the same weights
    (the port's, through JAX's converter) over the same permutation,
    dropout 0, 8 train rows in 2 batches of 4 and 4 eval rows: every
    batch's loss (rtol 1e-10) and outputs, the weights and BN statistics
    after (rtol 1e-9, atol 1e-8), the bands of the port's Adam-step
    parity tests.  On noise: the synthetic set's flat signs tie in the
    max-pools, where each framework's rounding picks another maximum."""
    p = Params(**dict(BASE, model=model, dropout=0.0))
    x, y, xe, ye = loader.synthetic_dataset(model, p, 8, 4)
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, x.shape).astype(np.float32)
    xe = rng.uniform(-1, 1, xe.shape).astype(np.float32)
    if model == "darknet_r":
        tmodel = DarkNet(1, 43, dropout=0.0, seed=0)
        jmodel = JaxDarkNet(n_boxes=1, n_classes=43, dropout=0.0)
        shape = (64, 64, 3)
    else:
        tmodel = ConvNet(43, dropout=0.0, seed=0)
        jmodel = JaxConvNet(n_classes=43, dropout=0.0)
        shape = (32, 32, 3)
    variables = _f64(jax_variables_from_port(tmodel, model, jmodel, shape))
    tmodel.double()
    tmodel.dtype = torch.float64
    yt = np.float64 if model == "darknet_r" else np.int64
    perm = np.random.RandomState(0).permutation(8)
    (idx,) = driver._group_splits(np.array_split(perm, 2))

    jcfg = jax_losses.LossConfig.from_params(JaxParams(**dict(
        BASE, model=model, dropout=0.0)))
    state, losses_w, _, yh_w = jax_steps.make_train_epoch(
        jmodel, model, jcfg, donate=False)(
        _jax_state(variables), jnp.asarray(x, jnp.float64),
        jnp.asarray(y.astype(yt)), jnp.asarray(idx, jnp.int32), 1e-3)
    ev_w, _, ev_yh_w = jax_steps.make_eval_epoch(jmodel, model, jcfg)(
        state, jnp.asarray(xe, jnp.float64), jnp.asarray(ye.astype(yt)),
        jnp.arange(4, dtype=jnp.int32)[None])

    cfg = losses.LossConfig.from_params(p)
    opt = steps.make_optimizer(tmodel.train())
    tr, _, yh = steps.make_train_epoch(tmodel, opt, cfg, model)(
        torch.from_numpy(x).double(), torch.from_numpy(y.astype(yt)),
        torch.from_numpy(idx), 1e-3)
    tmodel.eval()
    ev, _, ev_yh = steps.make_eval_epoch(tmodel, cfg, model)(
        torch.from_numpy(xe).double(), torch.from_numpy(ye.astype(yt)),
        torch.arange(4)[None])
    for got, want in ((tr, losses_w), (ev, ev_w)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-10)
    for got, want in ((yh, yh_w), (ev_yh, ev_yh_w)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-9, atol=1e-10)
    for name, t in tmodel.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        running = "running" in name
        tree = state.batch_stats if running else state.params
        want = (cnn_layout(tree, name, "batch_stats" if running else
                           "params") if model == "cnn"
                else darknet_layout(tree, name))
        np.testing.assert_allclose(t.numpy(), want, rtol=1e-9, atol=1e-8,
                                   err_msg=name)


# ---------------------------------------------------------------- CLI

def test_cli_flag():
    parse = cli.parser.parse_args
    assert parse([]).scan_epoch == "auto"
    assert parse(["--scan_epoch"]).scan_epoch == "on"
    assert parse(["--scan_epoch", "off"]).scan_epoch == "off"
    with pytest.raises(SystemExit), contextlib.redirect_stderr(
            io.StringIO()):
        parse(["--scan_epoch", "sometimes"])


def test_cli_cnn_train_scan_equals_off(tmp_path, monkeypatch):
    """``--model cnn --mode train --device cpu --scan_epoch`` writes the
    checkpoint and histories that ``--scan_epoch off`` writes, to the
    bit (2 epochs over the synthetic 512 / 128 crops at batch 64: the
    eval epoch's 2 batches in one group)."""
    monkeypatch.chdir(tmp_path)
    out = {}
    for flag in (["--scan_epoch"], ["--scan_epoch", "off"]):
        model_dir = tmp_path / flag[-1] / "cnn"
        model_dir.mkdir(parents=True)
        Params(**dict(batch_size=64, n_classes=43, lr=1e-3, n_epochs=2,
                      dropout=0.5, lr_decay=0.1)).save(
            str(model_dir / "params.json"))
        with contextlib.redirect_stdout(io.StringIO()) as text:
            cli.main(["--model", "cnn", "--mode", "train", "--device",
                      "cpu", "--model_dir", str(model_dir)] + flag)
        assert text.getvalue().count("epoch ") == 2
        raw = ckpt.load_checkpoint(os.path.join(str(model_dir) + "1",
                                                "last.ckpt"))
        out[flag[-1]] = (raw, np.load(model_dir / "losses_tr.npy"),
                         np.load(model_dir / "metrics_ev.npy"))
    (a, la, ma), (b, lb, mb) = out["off"], out["--scan_epoch"]
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(ma, mb)
    assert _equal(a["state_dict"], b["state_dict"])
    assert _equal(a["optim_dict"], b["optim_dict"])
    assert isinstance(b["optim_dict"]["param_groups"][0]["lr"], float)


def test_stream_on_prints_ignored_and_loops(capsys):
    """An explicit on with --stream says the loop runs; auto is silent."""
    t = driver.Trainer(_params("cnn", "on", stream=True), device="cpu",
                       verbose=True)
    assert not t.scan_epoch
    assert ("[scan_epoch] ignored: --stream keeps the dataset "
            "host-resident, the per-batch streamed loop runs"
            in capsys.readouterr().out)
    driver.Trainer(_params("cnn", "auto", stream=True), device="cpu",
                   verbose=True)
    assert "[scan_epoch]" not in capsys.readouterr().out


def test_gloo_mesh_prints_ignored_and_loops(capsys):
    """A gloo mesh (one rank here) cannot be captured: an explicit on
    says so and the loop runs; off is silent."""
    par.initialize_distributed(f"127.0.0.1:{par._free_port()}", 1, 0,
                               "gloo")
    try:
        mesh = par.make_mesh(n_data=1)
        t = driver.Trainer(_params("cnn", "on"), device="cpu",
                           verbose=True, mesh=mesh)
        assert not t.scan_epoch
        assert ("[scan_epoch] ignored: gloo collectives cannot be captured"
                in capsys.readouterr().out)
        driver.Trainer(_params("cnn", "off"), device="cpu", verbose=True,
                       mesh=mesh)
        assert "[scan_epoch]" not in capsys.readouterr().out
    finally:
        torch.distributed.destroy_process_group()


def test_restore_and_new_data_drop_the_epochs(tmp_path):
    """What the epoch objects read is replaced: Trainer.restore and a
    new split drop them; the restored optimizer state round-trips in the
    reference format."""
    p = _params("cnn", "on")
    data = loader.synthetic_dataset("cnn", p, 10, 7)
    _, _, t = _run("cnn", "on", data)
    assert t._epochs
    ckpt.save_checkpoint(t.state_dict(2, None), False, str(tmp_path))
    before = steps.optimizer_state(t.opt)
    t.restore(str(tmp_path / "last.ckpt"))
    assert not t._epochs
    assert _equal(steps.optimizer_state(t.opt), before)
    x, y, _, _ = data
    t.train_epoch(x, y, 1e-3, metric_on=False)
    assert t._epochs
    t.train_epoch(x[:9], y[:9], 1e-3, metric_on=False)
    assert set(t._epochs) == {(True, 3, 3)}


# ---------------------------------------------------------------- profiling

def test_step_timer_matches_jax(monkeypatch):
    """`StepTimer` as JAX's: warm-up steps discarded, the mean of the
    rest, items a second at it (nan before any step)."""
    timers = [profiling.StepTimer(warmup=2), jax_profiling.StepTimer(
        warmup=2)]
    assert all(np.isnan(t.mean) for t in timers)
    for timer in timers:
        clock = iter([0.0, 5.0, 5.0, 9.0, 10.0, 10.5, 11.0, 11.25,
                      12.0, 12.75])
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        for _ in range(5):
            with timer:
                pass
    got, want = timers
    assert got.times == want.times == [0.5, 0.25, 0.75]
    assert got.mean == want.mean == 0.5
    assert got.throughput(64) == want.throughput(64) == 128.0


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "profile")
    with profiling.trace(logdir) as where:
        torch.ones((8, 8)).matmul(torch.ones((8, 8))).sum()
    assert where == logdir
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any("matmul" in e.key
               for e in profiling.trace.last.key_averages())
