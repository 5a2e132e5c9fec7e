"""Rank bodies for the PyTorch port's mesh tests (tests/test_torch_port_
mesh.py, _stream.py, _ckpt.py).

`parallel.mesh.launch` spawns fresh interpreters that import these
functions by name, so this module imports no jax: a rank loads torch and
the port only.  Each rank writes what the test compares to
``out_dir/<tag>_<rank>.pt``.
"""

import contextlib
import io
import os

import numpy as np
import torch
import torch.distributed as dist

from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import loader
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.parallel import (
    mesh as par)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    driver, steps)

BATCH = 8
# cnn and darknet_r with dropout 0.5 and BN; capsule through the fused
# routing's plain versions (K3/K4 on the CPU) with the reconstruction
STEP_CASES = {
    "cnn": dict(model="cnn", n_classes=43, dropout=0.5),
    "capsule": dict(model="capsule", n_classes=43, routing_impl="pallas",
                    recon=True, recon_coef=5e-4),
    "darknet_r": dict(model="darknet_r", n_boxes=1, n_classes=43, n_grid=2,
                      darknet_input=64, l_coord=5.0, l_noobj=0.5,
                      dropout=0.5),
}


def step_params(name, **over):
    kw = dict(batch_size=BATCH, lr_runtime=1e-3, lr_decay=0.1, n_epochs=1,
              eval_every=1, train_frac=1, summary=False, **STEP_CASES[name])
    kw.update(over)
    return Params(**kw)


def step_batch(name, n=BATCH, seed=0):
    """A seeded numpy batch (x NHWC f64, labels or grids)."""
    rng = np.random.RandomState(seed)
    if name in ("cnn", "capsule"):
        return rng.rand(n, 32, 32, 3) * 2 - 1, rng.randint(0, 43, n)
    x = rng.rand(n, 64, 64, 3) * 2 - 1
    y = np.zeros((n, 2, 2, 48))
    for i in range(n):
        r, c = rng.randint(0, 2, 2)
        y[i, r, c, :5] = [1, *rng.uniform(0.2, 0.8, 2),
                          *rng.uniform(0.1, 0.4, 2)]
        y[i, r, c, 5 + rng.randint(43)] = 1
    return x, y


def step_trainer(name, mesh=None, dtype=torch.float64, verbose=False,
                 **over):
    """A Trainer of ``name`` from seed 0 whose model computes in
    ``dtype`` (f64: the parity band of a reduction reordered)."""
    t = driver.Trainer(step_params(name, **over), seed=0, device="cpu",
                       verbose=verbose, mesh=mesh)
    if dtype == torch.float64:
        t.model.double()
        t.model.dtype = torch.float64
        t.opt = steps.make_optimizer(t.model)
    return t


def one_step(trainer, x, y):
    """One train step on the global batch (x, y): the global loss, every
    gradient, the BN buffers, the generator's state and the outputs in
    row order.  Under a mesh the rank's rows go through the step; the
    node-sharded route weights' gradient is this rank's shard."""
    mesh = trainer.mesh
    xb = torch.from_numpy(x).to(trainer.model.dtype)
    yb = torch.from_numpy(np.asarray(y, np.float64 if y.ndim > 1
                                     else np.int64))
    if mesh is not None:
        xb, yb = par.place_batch((xb, yb), mesh)
    shard, group = trainer._shard(x.shape[0])
    trainer.model.train()
    loss, y_hat, _ = steps.train_step(
        trainer.model, trainer.opt, xb, yb, 1e-3, trainer.loss_cfg,
        trainer.model_name, trainer.generator, shard=shard,
        grad_group=group)
    if mesh is not None:
        loss = par.all_reduce_rows(loss[None], mesh)[0] / mesh.n_data
        y_hat = par.gather_batches([y_hat], [x.shape[0]], mesh)
    return {"loss": loss.item(), "y_hat": y_hat,
            "grads": {k: p.grad.clone() for k, p in
                      trainer.model.named_parameters() if p.grad is not None},
            "buffers": {k: b.clone() for k, b in
                        trainer.model.named_buffers()},
            "rng": (None if trainer.generator is None
                    else trainer.generator.get_state())}


def epochs(trainer):
    """One darknet_r train and eval epoch over 20 + 6 synthetic scenes in
    batches of 7, 7, 6 (train: the 7s replicated over two data ranks, the
    6 split) and 6: (loss, metric, avg_iou) of each."""
    x_tr, y_tr, x_ev, y_ev = loader.synthetic_dataset(
        "darknet_r", trainer.params, 20, 6)
    np.random.seed(0)
    tr = trainer.train_epoch(x_tr, y_tr, 1e-3) + (trainer.last_avg_iou,)
    ev = trainer.eval_epoch(x_ev, y_ev) + (trainer.last_avg_iou,)
    return tr, ev


def compare(got, want, grad_tol, loss_rtol, skip=()):
    """The assertion messages of ``got`` (a mesh step's `one_step`)
    against ``want`` (the single-process step's), or an empty list: the
    loss, every gradient but ``skip``, the BN buffers, the outputs and
    the generator's state."""
    errs = []

    def check(label, a, b, **tol):
        try:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol,
                                       err_msg=label)
        except AssertionError as e:
            errs.append(str(e))

    check("loss", got["loss"], want["loss"], rtol=loss_rtol)
    if set(got["grads"]) != set(want["grads"]):
        errs.append(f"gradients of {sorted(got['grads'])} against "
                    f"{sorted(want['grads'])}")
    for k in want["grads"]:
        if k not in skip:
            check(k, got["grads"][k], want["grads"][k], **grad_tol)
    for k in want["buffers"]:
        check(k, got["buffers"][k], want["buffers"][k], rtol=1e-12,
              atol=1e-15)
    check("y_hat", got["y_hat"], want["y_hat"], rtol=1e-12, atol=1e-15)
    if want["rng"] is not None and not torch.equal(got["rng"], want["rng"]):
        errs.append("the dropout generator's state differs")
    return errs


def same_on_ranks(tensors):
    """Whether every rank holds rank 0's ``tensors`` to the bit."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    return bool(torch.equal(flat, ref))


def steps_ranks(out_dir, grad_tol, loss_rtol, mesh=None):
    """data=2: one f64 step of each STEP_CASES model and darknet_r's
    `epochs`, each against the same on one process (every rank runs the
    reference itself); then, on the same two ranks as data=1,model=2,
    one capsule step with the route weights split over the nodes (f64
    against the plain routing, the route weights' gradient gathered
    whole; f32 for JAX's loss band), with the Trainer's printed lines
    (verbose on rank 0, as train_and_evaluate sets it).  Writes the
    assertion messages and what the test reads to steps_<rank>.pt."""
    rank = dist.get_rank()
    out = {}
    for name in STEP_CASES:
        x, y = step_batch(name)
        got = one_step(step_trainer(name, mesh), x, y)
        out["dp_" + name] = compare(got, one_step(step_trainer(name), x, y),
                                    grad_tol, loss_rtol)
        out["dp_same_" + name] = same_on_ranks(list(got["grads"].values()))
    out["epochs"] = epochs(step_trainer("darknet_r", mesh))
    out["epochs_single"] = epochs(step_trainer("darknet_r"))
    tp = par.make_mesh(n_data=1, n_model=2)
    x, y = step_batch("capsule")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        t = step_trainer("capsule", tp, verbose=rank == 0)
    out["tp_lines"] = text.getvalue()
    out["tp_impl"] = t.model.traffic_sign_capsules.impl
    got = one_step(t, x, y)
    key = "traffic_sign_capsules.route_weights"
    out["tp_shard"] = tuple(got["grads"][key].shape)
    got["grads"][key] = par.gather_nodes(got["grads"][key], tp)
    want = one_step(step_trainer("capsule", routing_impl="xla"), x, y)
    out["tp_capsule"] = compare(got, want, grad_tol, loss_rtol)
    x32 = x.astype(np.float32)
    out["tp_loss_f32"] = (
        one_step(step_trainer("capsule", tp, dtype=torch.float32), x32,
                 y)["loss"],
        one_step(step_trainer("capsule", dtype=torch.float32,
                              routing_impl="xla"), x32, y)["loss"])
    torch.save(out, os.path.join(out_dir, f"steps_{rank}.pt"))
