#!/usr/bin/env python3
"""The port's mesh across the cards of one host: train steps under data
and model parallelism against the same step on one card.

    python3 mesh_scaling.py [--ranks N] [--iters 10] [--device cuda|cpu]

Run from the repository root.  Spawns N ranks through
`parallel.mesh.launch` (default: every card; rank r on cuda:r over
NCCL; ``--device cpu``: N gloo processes at 64 px and batch 8, a
rehearsal of the same code).  Rank 0 first runs each step on one device
(the plain Trainer, the other ranks waiting); then every rank runs it on
the mesh:

  1. darknet_r (448 px, global batch 32, dropout 0.5, f32) on data=N:
     BatchNorm over the global batch, the gradients averaged;
  2. CapsuleNet (global batch 64, f32) on data=N (K3/K4 on each rank's
     64/N rows), on data=N/2,model=2 and on data=1,model=N (the route
     weights split over the nodes, the plain routing; one device's
     reference then runs the plain routing too).

For each: the loss's relative error and the gradients' least cosine
against one device (the route weights' gradient gathered whole), and
the ms of a step (CUDA events on rank 0, or the host clock on the CPU)
beside one device's; on cards, rank 0's kernel time by group for the
darknet_r step, one device's and the mesh's (`chip_smoke.profile_ms`,
NCCL's kernels a group of their own).  Prints the card's name and power
limit, then one line per measurement.
"""

import argparse
import contextlib
import io
import os
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import loader
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import _build
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.parallel import (
    mesh as par)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    driver, steps)

import chip_smoke

HERE = os.path.dirname(os.path.abspath(__file__))
ROUTE = "traffic_sign_capsules.route_weights"
# chip_smoke's darknet step groups, NCCL's collectives first
GROUPS = (("NCCL collectives", ("nccl",)),) + chip_smoke.DARK_GROUPS


def case(name, small):
    """(params, x, y) of a step: the model's params.json (cut to 64 px /
    n_grid 2 and batch 8 with ``small``) and a synthetic global batch."""
    p = Params(os.path.join(HERE, "experiments", name, "params.json"),
               model=name, n_epochs=1, lr_runtime=1e-3, recon=True,
               recon_coef=5e-4, eval_every=1, train_frac=1, summary=False)
    if small:
        p.batch_size = 8
        if name == "darknet_r":
            p.darknet_input, p.n_grid = 64, 2
    x, y, _, _ = loader.synthetic_dataset(name, p, p.batch_size, 0)
    return p, torch.from_numpy(np.asarray(x, np.float32)), \
        torch.from_numpy(np.asarray(y, np.float32 if name == "darknet_r"
                                    else np.int64))


def step_fn(trainer, x, y):
    """A closure running one train step of ``trainer`` on this rank's
    rows of the global batch (x, y)."""
    n = x.shape[0]
    if trainer.mesh is None:
        xb, yb = x.to(trainer.device), y.to(trainer.device)
    else:
        xb, yb = par.place_batch((x, y), trainer.mesh)
    shard, group = trainer._shard(n)
    trainer.model.train()
    return lambda: steps.train_step(
        trainer.model, trainer.opt, xb, yb, 1e-3, trainer.loss_cfg,
        trainer.model_name, trainer.generator, shard=shard,
        grad_group=group)[0]


def first_step(trainer, x, y):
    """The loss (global under a mesh) and every gradient (the route
    weights gathered whole) of one step, and the step's closure."""
    step = step_fn(trainer, x, y)
    loss = step()
    if trainer.mesh is not None:
        loss = par.all_reduce_rows(loss[None], trainer.mesh)[0] \
            / trainer.mesh.n_data
    grads = {k: p.grad.clone() for k, p in trainer.model.named_parameters()}
    if trainer._shard_routing:
        grads[ROUTE] = par.gather_nodes(grads[ROUTE], trainer.mesh)
    return loss.item(), grads, step


def ms_per_step(step, device, iters):
    for _ in range(3):
        step()
    if device.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(iters):
        step()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile(step, ms, label):
    """Rank 0 prints the kernel time of three steps by group; the other
    ranks run the same steps (their collectives pair with rank 0's)."""
    if dist.get_rank() == 0:
        print(f"[scaling] profile, {label}:", flush=True)
        chip_smoke.profile_ms(step, ms, iters=3, groups=GROUPS, top=6)
    else:
        with contextlib.redirect_stdout(io.StringIO()):
            chip_smoke.profile_ms(step, ms, iters=3, groups=GROUPS)


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()))


def scaling_rank(iters, small, smi, mesh=None):
    rank, world = dist.get_rank(), dist.get_world_size()
    shapes = {"darknet_r": [(world, 1)],
              "capsule": [(world, 1), (world // 2, 2), (1, world)]}
    for name, meshes in shapes.items():
        for n_data, n_model in meshes:
            m = par.make_mesh(n_data, n_model, device=mesh.device)
            p, x, y = case(name, small)
            routing = "xla" if n_model > 1 else "pallas"
            ref = None
            if rank == 0:
                p.routing_impl = routing
                t = driver.Trainer(p, seed=0, device=mesh.device,
                                   verbose=False)
                loss, grads, step = first_step(t, x, y)
                ref = (loss, grads, ms_per_step(step, mesh.device, iters))
                if name == "darknet_r" and not small:
                    chip_smoke.profile_ms(step, ref[2], iters=3,
                                          groups=GROUPS, top=6)
                del t, step
            dist.barrier()
            p.routing_impl = routing
            t = driver.Trainer(p, seed=0, device=mesh.device, verbose=False,
                               mesh=m)
            loss, grads, step = first_step(t, x, y)
            ms = ms_per_step(step, mesh.device, iters)
            if name == "darknet_r" and not small:
                profile(step, ms, f"darknet_r data={n_data} (one device's "
                        "above)")
            if rank == 0:
                cos = min(cosine(grads[k], ref[1][k]) for k in grads)
                how = ("" if name != "capsule" else
                       f" ({routing} routing"
                       f"{', sharded' if t._shard_routing else ''})")
                print(f"[scaling] {name} step, global batch {x.shape[0]}, "
                      f"data={n_data} model={n_model}{how}: loss "
                      f"rel err {abs(loss - ref[0]) / abs(ref[0]):.3e}, "
                      f"gradients' least cosine {cos:.8f}; {ms:.3f} ms a "
                      f"step against {ref[2]:.3f} ms on one device "
                      f"({ref[2] / ms:.3f}x) ({smi})", flush=True)
            del t, step
            dist.barrier()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("mesh_scaling: no card (--device cpu rehearses)")
    ranks = args.ranks or (torch.cuda.device_count() if cuda else 4)
    if ranks < 2 or ranks % 2:
        raise SystemExit(f"mesh_scaling: needs an even count of ranks, "
                         f"got {ranks}")
    smi = "CPU (gloo)"
    if cuda:
        smi = "; ".join(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines())
        print(smi)
        _build.build()  # once, before the ranks load it
    par.launch(scaling_rank, (args.iters, not cuda, smi), ranks, 1,
               device=args.device)


if __name__ == "__main__":
    main()
