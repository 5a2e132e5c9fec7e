"""PyTorch port, the mesh (CPU, gloo): parallel/mesh.py's helpers against
the JAX ones, one data=2 step of cnn, capsule and darknet_r and one
data=1,model=2 capsule step against the single-process step in f64, and
the CLI's --mesh data=2 trajectory against --mesh off and the JAX
package's --mesh data=2 (tiny models: 64 px / n_grid 2, batch 8)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu import (
    parallel as jax_par)
from cs231_capsule_yolo_traffic_sign_detection_tpu.params import (
    Params as JaxParams)
from cs231_capsule_yolo_traffic_sign_detection_tpu.train import (
    driver as jax_driver, steps as jax_steps)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import (
    __main__ as cli)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.parallel import (
    mesh as par)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    driver)

import torch_port_mesh_ranks as ranks
from torch_port_helpers import jax_variables_from_port

# the f64 parity bands (JAX tests/test_parallel.py:40)
LOSS_RTOL, GRAD_TOL = 1e-12, dict(rtol=1e-8, atol=1e-12)
SPECS = ["off", "none", "1", "", "auto", " Data=2 ", "data=2", "data=8",
         "data=2,model=2", "data=4,model=2", "data=1,model=2", "data=1",
         "data=3", "model=2", "data=9", "data=2,bogus=1"]


@pytest.fixture(autouse=True)
def _two_threads(monkeypatch):
    """Two CPU threads a process for this file's runs and the ranks they
    spawn: the suite's workers share the machine's cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("case", (
    [("spec", s, n) for s in SPECS for n in (8, 1)]
    + [("batch_slice", n, pc) for n in (0, 1, 5, 8, 17) for pc in (1, 2, 3, 5)]
    + [("row_slices", n, shape) for n in (8, 16, 24)
       for shape in ((2, 1), (4, 2), (1, 2), (8, 1), (2, 4))]))
def test_mesh_helpers_match_jax(case):
    """parse_mesh_spec (results and errors), process_batch_slice and
    process_row_slices against the JAX functions: each rank's rows are
    the JAX batch sharding's slice for the device at its mesh position,
    and together they are JAX's process_row_slices."""
    kind, a, b = case
    if kind == "spec":
        assert _outcome(par.parse_mesh_spec, a, b) == \
            _outcome(jax_par.parse_mesh_spec, a, b)
    elif kind == "batch_slice":
        for pi in range(b):
            assert par.process_batch_slice(a, pi, b) == \
                jax_par.process_batch_slice(a, pi, b)
    else:
        n_data, n_model = b
        jmesh = jax_par.make_mesh(n_data=n_data, n_model=n_model)
        index = jax_par.batch_sharding(jmesh).devices_indices_map((a,))
        got = set()
        for d in range(n_data):
            for m in range(n_model):
                mesh = par.Mesh(n_data, n_model, rank=d * n_model + m)
                s = index[jmesh.devices[d, m]][0]
                assert par.process_row_slices(a, mesh) == [
                    (s.start or 0, a if s.stop is None else s.stop)]
                got.update(par.process_row_slices(a, mesh))
        assert sorted(got) == jax_par.process_row_slices(a, jmesh)


def test_ragged_batch_is_replicated():
    mesh = par.Mesh(2, 1, rank=1)
    x = torch.arange(7)
    assert par.process_row_slices(7, mesh) == [(0, 7)]
    assert torch.equal(par.place_batch((x,), mesh)[0], x)
    assert torch.equal(par.place_batch((x[:6],), mesh)[0], x[3:6])
    assert par.routing_param_spec("traffic_sign_capsules.route_weights") \
        == ("model", None, None, None)
    assert par.routing_param_spec("conv1.weight") == ()


def test_dp_and_tp_steps_match_single_process(tmp_path):
    """Two gloo ranks.  data=2: one f64 step of cnn and darknet_r (dropout
    0.5, BN over the global batch) and capsule (K3/K4's plain versions)
    equals the single-process step: the loss to rtol 1e-12, every
    gradient to rtol 1e-8 / atol 1e-12 (the same on both ranks), the BN
    buffers, the outputs and the dropout generator's state; a darknet_r
    train and eval epoch with a replicated ragged batch has the same
    losses, avg_iou and metric.  data=1,model=2: the capsule step with
    the route weights split over the nodes (the plain routing, with
    JAX's [mesh] lines) equals the single-process plain-routing step at
    the same bands, the gathered route-weight gradient included; in f32
    its loss is within JAX's rtol 1e-5 (tests/test_parallel.py:80).
    Each rank compares against the single-process step it runs itself
    and writes the assertion messages."""
    par.launch(ranks.steps_ranks, (str(tmp_path), GRAD_TOL, LOSS_RTOL), 2,
               1, device="cpu")
    got = [torch.load(tmp_path / f"steps_{r}.pt", weights_only=False)
           for r in range(2)]
    for r, g in enumerate(got):
        for name in ranks.STEP_CASES:
            assert g["dp_" + name] == [], (r, name, g["dp_" + name])
            assert g["dp_same_" + name], (r, name)
        for a, b in zip(g["epochs"], g["epochs_single"]):
            np.testing.assert_allclose(a, b, rtol=1e-12)
            assert a[1] == b[1] and b[2] > 0
        assert g["tp_capsule"] == [], (r, g["tp_capsule"])
        assert g["tp_shard"] == (1, 1296 // 2, 43, 8, 16)
        assert g["tp_impl"] == "xla"
        np.testing.assert_allclose(*g["tp_loss_f32"], rtol=1e-5)
    assert "[mesh] routing weights sharded over 'model': forcing " \
        "--routing xla" in got[0]["tp_lines"]
    assert "[mesh] data=1 model=2 (routing sharded: True)" in \
        got[0]["tp_lines"]
    assert got[1]["tp_lines"] == ""


CNN = {"batch_size": 8, "n_classes": 43, "lr": 1e-3, "n_epochs": 3,
       "dropout": 0.0, "lr_decay": 0.1}


def test_cli_mesh_trajectory_matches_single_and_jax(tmp_path, monkeypatch,
                                                    capfd):
    """--device cpu --mesh data=2 (two spawned gloo ranks), cnn, 3 epochs
    on the first 64 synthetic crops: the loss histories equal --mesh
    off's and the JAX package's --mesh data=2 run's (the same Trainer
    on two of the virtual CPU devices) at JAX's rtol 1e-2
    (tests/test_mesh_cli.py:59), the JAX run from the port's seed-0
    weights; rank 0 alone prints the epochs and writes the checkpoint and
    histories."""
    monkeypatch.chdir(tmp_path)
    runs = {}
    for tag, mesh in (("off", "off"), ("mesh", "data=2")):
        d = tmp_path / f"cnn_{tag}"
        d.mkdir()
        (d / "params.json").write_text(json.dumps(CNN))
        cli.main(["--model", "cnn", "--mode", "train", "--device", "cpu",
                  "--no_metric", "--train_frac", "0.125", "--model_dir",
                  str(d), "--mesh", mesh])
        out = capfd.readouterr().out
        runs[tag] = [np.load(d / f"losses_{s}.npy") for s in ("tr", "ev")]
        assert os.path.exists(str(d) + "0.125/last.ckpt")
        shutil.rmtree(str(d) + "0.125")  # 51 MB a checkpoint
        assert out.count("epoch 3 | train loss") == 1
    assert "[mesh] data=2 model=1 (routing sharded: False)" in out
    assert out.count("Trainable params") == 1

    jp = JaxParams(model="cnn", mesh="data=2", summary=False,
                   lr_runtime=1e-3, recon=True, recon_coef=5e-4,
                   eval_every=1, train_frac=0.125, **CNN)
    port_init = driver.build_model(Params(model="cnn", n_classes=43,
                                          dropout=0.0), 0, "cpu")

    class FromPortWeights(jax_driver.Trainer):
        def __init__(self, params, seed=0, verbose=True):
            super().__init__(params, seed=seed, verbose=verbose)
            v = jax_variables_from_port(port_init, "cnn", self.model,
                                        (32, 32, 3))
            self.state = jax_par.shard_state(self.state.replace(
                params=v["params"], batch_stats=v["batch_stats"],
                opt_state=jax_steps.make_optimizer().init(v["params"])),
                self.mesh)

    monkeypatch.setattr(jax_driver, "Trainer", FromPortWeights)
    d = tmp_path / "cnn_jax"
    d.mkdir()
    np.random.seed(0)
    jax_driver.train_and_evaluate(jp, "data/GTSRB", str(d), no_metric=True,
                                  seed=0, progress=False)
    jax_runs = [np.load(d / f"losses_{s}.npy") for s in ("tr", "ev")]
    for a, b, c in zip(runs["mesh"], runs["off"], jax_runs):
        assert a.shape == (3,)
        np.testing.assert_allclose(a, b, rtol=1e-2)
        np.testing.assert_allclose(a, c, rtol=1e-2)
