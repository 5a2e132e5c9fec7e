"""CLI of the PyTorch port: predict, train and overfit of the five
models (darknet_r, darknet_d, darkcapsule, capsule, cnn), and the
two-stage darknet_r|darknet_d --combine capsule|cnn.

    python -m cs231_capsule_yolo_traffic_sign_detection_tpu_torch \\
        --model darknet_r|darknet_d|darkcapsule|capsule|cnn \\
        --mode predict --restore last [--nms] \\
        [--dtype float32|bfloat16|int8] [--device cuda|cpu] \\
        [--model_dir DIR]
    python -m cs231_capsule_yolo_traffic_sign_detection_tpu_torch \\
        --model darknet_r|darknet_d --mode predict --restore last \\
        --combine capsule|cnn [--device_crop] [--max_crops 16] \\
        [--dtype float32|bfloat16|int8] [--device cuda|cpu]
    python -m cs231_capsule_yolo_traffic_sign_detection_tpu_torch \\
        --model darknet_r|darknet_d|darkcapsule|capsule|cnn \\
        --mode train|overfit \\
        [--dtype float32|bfloat16] [--seed N] [--lr LR] [--dropout P] \\
        [--fine_tune N] [--npy] [--recon] [--recon_coef C] \\
        [--eval_every N] [--train_frac F] [--no_metric] \\
        [--restore last|best] [--device cuda|cpu] [--model_dir DIR] \\
        [--routing auto|xla|pallas] [--remat] [--stream] \\
        [--async_ckpt] [--ckpt_every N] [--scan_epoch [auto|on|off]]
    ... [--mesh auto|off|data=N[,model=M]] \\
        [--coordinator HOST:PORT --num_processes P --process_id I]

Reads ``<model_dir>/params.json``.  predict reads
``<model_dir>/<restore>.ckpt`` (the reference's torch format; else the
same file under ``<model_dir><train_frac>``, where training writes),
predicts over the test set (GTSDB frames for a detector, read from
their ``.ppm`` files without cv2 when ``test_names.npy`` lists them;
GTSRB crops for a classifier) or, when it is absent, the synthetic test
set, and writes ``<model_dir>/metric_output.txt`` as the JAX CLI does,
with its plots: ``r_pr.png`` and ``r_auc.png`` (classifiers),
``detect_ap/d_AP.png`` (detectors), ``combine-<m>_mAP/d&r_mAP_class_<c>
.png`` (--combine), and each annotated frame as
``<model_dir>/output/<i>.png`` (detectors and --combine; the JAX CLI
writes ``.jpg`` through cv2).  ``--nms`` applies the greedy NMS to the
detector's boxes; ``--dtype int8`` serves the calibrated int8 detector
(and, fused, the int8 ConvNet; CapsuleNet and the host path's
classifier stay f32).  ``--show`` is parsed and never read, and
``--summary`` is always true, as in the JAX CLI.
darkcapsule has no predict function in the reference: its predict
loads the test set and writes an empty metric file, restoring nothing.
With ``--combine capsule|cnn`` the detector's frames go through the two-stage
pipeline (`predict.dark_class_pred`; ``--device_crop`` fuses it into one
device pass per batch, classifying the top ``--max_crops`` boxes of a
frame): the classifier's params and checkpoint come from its own model
dir (``experiments/<capsule|cnn>``, the same ``--restore``, ``--dtype``
and ``--train_frac``), and ``detect_and_recog_mAP`` and
``detect_and_recog_acc`` go to
``<model_dir>/combine-<capsule|cnn>_metric_output.txt``.  train and
overfit train from ``--seed`` (or resume from ``--restore``) on the
stored set, the first 3 samples of it for overfit, or the synthetic set
when it is absent, and write ``last.ckpt``/``best.ckpt`` into
``<model_dir><train_frac>``.  The reference's quirks are kept: the
optimizer LR comes from ``--lr`` only, ``--recon`` turns the
reconstruction loss OFF, and ``--fine_tune N`` with N > 0 only turns
fine-tuning on (the darknet19 npz ``params.pretrained_weights``, default
``./darknet19_weights.npz``, when present): the count of frozen blocks
is ``fine_tune`` in params.json (18 for darknet_r and darknet_d).
``--dropout P`` (P >= 0) overrides the json's dropout.  ``--device``
alone picks the device (darkcapsule's params.json ``device`` key is not
read).  ``--routing`` picks the capsule models' routing (pallas: the K3/K4
kernels; xla: the plain composition; auto: pallas for capsule on the
card, xla for darkcapsule and on the CPU), in predict and training;
``--remat`` rematerializes the detectors' conv blocks in training.
``--stream`` feeds training from the native prefetcher (the dataset
stays on the host, memmapped with ``--npy``), ``--async_ckpt`` writes
checkpoints on a worker thread and ``--ckpt_every N`` writes ``last``
every Nth epoch (and on the last; ``best`` whenever it improves).
``--scan_epoch`` (bare: on) runs each train and eval epoch as replays of
captured CUDA graphs, one a distinct batch size (`train.steps.
make_train_epoch`): the per-batch loop's batches and numbers, one
``replay()`` a batch; with ``--device cpu`` the same epoch body runs
eagerly.  ``auto``, the default, is off on the CPU and
``driver.SCAN_EPOCH_AUTO_ON_CARD`` on the card; ``--stream`` and a gloo
mesh run the loop.
``--mesh data=N[,model=M]`` runs N*M ranks (parallel/mesh.py; rank r on
``cuda:r`` over NCCL, or on the CPU over gloo with ``--device cpu``):
data parallel with global-batch BatchNorm, the capsule route weights
split over the model axis; ``auto``, the default, is every card when
there are more than one, off otherwise (and on the CPU).  With
``--coordinator HOST:PORT --num_processes P --process_id I`` this process
runs its N*M/P of the ranks (one such process per host).  Rank 0 alone
prints the summary and the epochs and writes the checkpoints,
histories, metrics and frames.
Training refuses ``--dtype int8`` (serving only), and any other
mode exits with a "not ported yet" message.
"""

import argparse
import os
import pickle
import sys

import numpy as np
import torch.distributed as dist

from . import config
from .data import loader
from .data.ppm import read_ppm
from .imageio import write_png
from .metrics.classification import recog_acc, recog_auc, recog_pr
from .device import compute_dtype, resolve_device
from .metrics.detection import (detect_AP, detect_acc, detect_and_recog_acc,
                                detect_and_recog_mAP)
from .models.registry import ROUTING_IMPLS
from .parallel import mesh as par
from .params import Params
from .predict import CLASSIFIERS, class_pred, dark_class_pred, dark_pred
from .train.driver import train_and_evaluate
from .train.logging_utils import ScalarWriter

PORTED = {(m, mode) for m in config.model_names
          for mode in ("predict", "train", "overfit")}
# the detectors --combine takes (JAX main.py's combine_model)
DETECTORS = ("darknet_d", "darknet_r")

parser = argparse.ArgumentParser(
    prog="python -m cs231_capsule_yolo_traffic_sign_detection_tpu_torch")
parser.add_argument("--model", default="darknet_r",
                    help=" | ".join(config.model_names))
parser.add_argument("--mode", default="predict",
                    help="train | predict | overfit")
parser.add_argument("--restore", default=None, help="last | best")
parser.add_argument("--model_dir", default=None, help="model dir")
parser.add_argument("--dtype", default="float32",
                    help="compute dtype: float32 | bfloat16 (training keeps "
                    "f32 master params and Adam moments) | int8 (serving "
                    "only)")
parser.add_argument("--device", default="cuda", help="cuda | cpu")
parser.add_argument("--seed", type=int, default=0, help="random seed")
parser.add_argument("--lr", type=float, default=1e-3, help="learning rate")
parser.add_argument("--dropout", type=float, default=-1, help="dropout rate")
parser.add_argument("--train_frac", type=float, default=1,
                    help="fraction of train data")
parser.add_argument("--recon", action="store_false",
                    help="if use reconstruction loss")
parser.add_argument("--recon_coef", default=5e-4,
                    help="reconstruction coefficient")
parser.add_argument("--eval_every", default=1, type=int,
                    help="evaluate metric every # epochs")
parser.add_argument("--fine_tune", default=-1, type=int,
                    help="number of fixed layer in fine tuning")
parser.add_argument("--no_metric", action="store_true",
                    help="do not compute metric")
parser.add_argument("--npy", default=False, action="store_true",
                    help="data is npy file")
parser.add_argument("--combine", default=None,
                    help="predict a detector's frames through a classifier: "
                    "cnn | capsule")
parser.add_argument("--device_crop", default=False, action="store_true",
                    help="--combine only: detect -> crop -> classify in one "
                    "device pass per batch, crops from the detector input")
parser.add_argument("--max_crops", default=16, type=int,
                    help="--device_crop only: boxes classified per frame, "
                    "the top by confidence")
parser.add_argument("--routing", default="auto",
                    help="capsule routing: auto | xla | pallas (pallas = the "
                    "K3/K4 kernels; auto = pallas for capsule on the card, "
                    "xla for darkcapsule and on the CPU)")
parser.add_argument("--remat", default=False, action="store_true",
                    help="rematerialize the detectors' conv blocks in the "
                    "backward (torch.utils.checkpoint): less activation "
                    "memory for one more forward of each block; the same "
                    "loss, gradients, BN buffers and dropout masks")
parser.add_argument("--nms", default=False, action="store_true",
                    help="greedy NMS over the detector's boxes in predict "
                    "(the reference has none)")
parser.add_argument("--mesh", default="auto",
                    help="device mesh: auto | off | data=N[,model=M] "
                    "(auto = all local cards data-parallel when >1; the "
                    "reference is single-device, main.py:231)")
parser.add_argument("--coordinator", default=None,
                    help="multi-host: rendezvous address host:port. Launch "
                    "one process per host with the same --coordinator/"
                    "--num_processes and a distinct --process_id; --mesh "
                    "then spans every host's ranks and rank 0 writes "
                    "artifacts")
parser.add_argument("--num_processes", default=None, type=int,
                    help="multi-host: total process count (with "
                    "--coordinator)")
parser.add_argument("--process_id", default=None, type=int,
                    help="multi-host: this process's id (with "
                    "--coordinator)")
parser.add_argument("--stream", default=False, action="store_true",
                    help="host-streaming data path for datasets larger than "
                    "device memory: batches assembled ahead of the device by "
                    "the native threaded prefetcher (memmap-friendly; "
                    "identical batches to the default path)")
parser.add_argument("--async_ckpt", default=False, action="store_true",
                    help="write checkpoints on a background thread (same "
                    "last/best semantics, flushed at exit)")
parser.add_argument("--scan_epoch", nargs="?", const="on", default="auto",
                    choices=["auto", "on", "off"],
                    help="run each train/eval epoch as replays of captured "
                    "CUDA graphs, one per distinct batch size (identical "
                    "batches and numbers to the per-batch loop); auto "
                    "(default) = off on the CPU, on the card as "
                    "train/driver.py's SCAN_EPOCH_AUTO_ON_CARD; bare "
                    "--scan_epoch = on")
parser.add_argument("--ckpt_every", default=1, type=int,
                    help="save the last checkpoint every N epochs "
                    "(best-on-improvement always saved; default 1 = "
                    "reference behavior)")
# the JAX CLI's: --summary's default makes it always true; --show is
# parsed and never read
parser.add_argument("--summary", default=True, action="store_true",
                    help="if summarize model")
parser.add_argument("--show", default=False, action="store_true",
                    help="save result")


def load_test_set(data_dir, model_name, params):
    """The test set as stored (``test.p``); the synthetic set if absent."""
    try:
        with open(data_dir + "/test.p", "rb") as f:
            return pickle.load(f)
    except (FileNotFoundError, OSError):
        print("[predict] dataset absent; using synthetic test data")
        _, _, x, y = loader.synthetic_dataset(model_name, params,
                                              n_train=4, n_eval=16)
        return x, y


def load_test_frames(data_dir, model_name, params):
    """GTSDB test frames (uint8 BGR, read from ``raw_GTSDB/<name>.ppm``
    when ``test_names.npy`` lists them) and grids; the synthetic set if
    absent."""
    x, y = load_test_set(data_dir, model_name, params)
    names_path = data_dir + "/test_names.npy"
    if os.path.exists(names_path):
        return [read_ppm(os.path.join(data_dir + "/raw_GTSDB", name))
                for name in np.load(names_path)], y
    # uint8 frames rebuilt from the stored centered tensors
    return [np.clip(im * 128.0 + 128, 0, 255).astype(np.uint8)
            for im in np.asarray(x)], y


def main(argv=None):
    args = parser.parse_args(argv)
    if args.model not in config.model_names:
        sys.exit("Did not recognize model, choose from: "
                 + " ".join(config.model_names))
    if (args.model, args.mode) not in PORTED:
        ported = ", ".join(f"--model {m} --mode {d}"
                           for m, d in sorted(PORTED))
        sys.exit(f"--model {args.model} --mode {args.mode} is not ported "
                 f"yet; ported: {ported}")
    if args.mode == "predict" and args.restore is None:
        sys.exit("Must give restore file last/best")
    try:
        compute_dtype(args.dtype)
    except ValueError as e:
        sys.exit(f"--dtype {args.dtype}: {e}")
    if args.routing not in ROUTING_IMPLS:
        sys.exit(f"--routing {args.routing}: choose from "
                 + " | ".join(ROUTING_IMPLS))
    if is_combine(args) and args.combine not in CLASSIFIERS:
        sys.exit(f"--combine {args.combine}: choose from "
                 + " | ".join(CLASSIFIERS))
    if (args.coordinator is None) != (args.num_processes is None) \
            or (args.coordinator is None) != (args.process_id is None):
        sys.exit("--coordinator, --num_processes and --process_id go "
                 "together")
    try:
        shape = par.mesh_shape(args.mesh, args.device,
                               args.num_processes or 1)
    except ValueError as e:
        sys.exit(str(e))
    if shape is None:
        if args.coordinator is not None:
            sys.exit("--coordinator needs a --mesh of more than one rank")
        run(args)
        return
    par.launch(run, (args,), *shape, device=args.device,
               coordinator=args.coordinator,
               num_processes=args.num_processes or 1,
               process_id=args.process_id or 0)


def run(args, mesh=None):
    """The checked CLI's work on one rank (``mesh``) or alone; under a
    mesh every rank runs the forwards and steps, rank 0 writes."""
    primary = mesh is None or mesh.is_primary
    data_dir = config.data_dir[args.model]
    model_dir = args.model_dir or config.model_dir[args.model]
    params = load_params(model_dir, args, args.model)
    np.random.seed(args.seed)
    if args.mode in ("train", "overfit"):
        train(args, params, data_dir, model_dir, mesh)
        return

    combine = is_combine(args)
    save_path = model_dir + "/metric_output.txt"
    output = None
    if args.model in CLASSIFIERS:
        # classifier crops are used as loaded
        x, y = load_test_set(data_dir, args.model, params)
        y_hat, _ = class_pred(x, model_dir, params, args.restore,
                              device=args.device, mesh=mesh)
        if not primary:
            return
        metric_out = {
            "recog_pr": recog_pr(y, y_hat, params, save=True,
                                 save_dir=model_dir),
            "recog_acc": recog_acc(y, y_hat, params),
            "recog_auc": recog_auc(y, y_hat, params, save=True,
                                   save_dir=model_dir)}
    elif combine:
        x, y = load_test_frames(data_dir, args.model, params)
        class_model_dir = config.model_dir[args.combine]
        class_params = load_params(class_model_dir, args, args.combine)
        y_hat, output = dark_class_pred(
            x, model_dir, params, class_model_dir, class_params,
            args.restore, device=args.device, device_crop=args.device_crop,
            max_crops=args.max_crops, mesh=mesh)
        if not primary:
            return
        plot_dir = model_dir + f"/combine-{args.combine}_mAP"
        os.makedirs(plot_dir, exist_ok=True)
        metric_out = {
            "detect_and_recog_mAP": detect_and_recog_mAP(
                y, y_hat, params, save=True, save_dir=plot_dir),
            "detect_and_recog_acc": detect_and_recog_acc(y, y_hat, params)}
        save_path = model_dir + f"/combine-{args.combine}_metric_output.txt"
    elif args.model == "darkcapsule":
        # no predict function (JAX main.py:241-318): the test set is
        # loaded, nothing is restored and no metric computed
        resolve_device(args.device)
        load_test_frames(data_dir, args.model, params)
        metric_out = {}
        if not primary:
            return
    else:
        x, y = load_test_frames(data_dir, args.model, params)
        y_hat, output = dark_pred(x, model_dir, params, args.restore, y=y,
                                  use_nms=args.nms, device=args.device,
                                  mesh=mesh)
        if not primary:
            return
        plot_dir = model_dir + "/detect_ap"
        os.makedirs(plot_dir, exist_ok=True)
        metric_out = {"detect_AP": detect_AP(y, y_hat, params, save=True,
                                             save_dir=plot_dir),
                      "detect_acc": detect_acc(y, y_hat, params)}
    with open(save_path, "w") as text_file:
        for k, v in metric_out.items():
            text_file.write("{}:{}, ".format(k, v))
            print("{}:{}, ".format(k, v))
    if output is not None:
        out_dir = os.path.join(model_dir, "output")
        os.makedirs(out_dir, exist_ok=True)
        for i, image in enumerate(output):
            write_png(os.path.join(out_dir, f"{i}.png"), image)


def is_combine(args):
    """Whether the CLI runs the two-stage pipeline (a detector's predict
    with --combine)."""
    return (args.mode == "predict" and args.model in DETECTORS
            and args.combine is not None)


def load_params(model_dir, args, model):
    """``<model_dir>/params.json`` with the CLI's overrides for ``model``
    (JAX main.py:131-163)."""
    params = Params(os.path.join(model_dir, "params.json"))
    params.model = model
    params.compute_dtype = args.dtype
    params.train_frac = args.train_frac
    params.npy = args.npy
    params.summary = bool(args.summary)
    params.routing_impl = args.routing
    params.remat = args.remat
    params.stream = args.stream
    params.async_ckpt = args.async_ckpt
    params.ckpt_every = args.ckpt_every
    params.scan_epoch = args.scan_epoch
    if args.dropout >= 0:
        params.dropout = args.dropout
    return params


def train(args, params, data_dir, model_dir, mesh=None):
    """--mode train | overfit, with the JAX CLI's params (main.py:131-163)
    and data (main.py:215-235); rank 0 alone writes the scalars."""
    params.seed = args.seed
    params.recon = args.recon
    params.recon_coef = float(args.recon_coef)
    params.eval_every = args.eval_every
    params.lr_runtime = args.lr
    params.do_fine_tune = args.fine_tune > 0
    is_small = args.mode == "overfit"
    primary = mesh is None or mesh.is_primary
    if is_small and primary:
        try:
            loader.make_small_data(data_dir, 3)
        except (FileNotFoundError, OSError):
            print("[overfit] dataset absent; synthetic small set will be "
                  "used")
    if is_small and mesh is not None:
        dist.barrier()  # the small set is written before any rank reads it
    train_and_evaluate(params, data_dir, model_dir, is_small=is_small,
                       restore_file=args.restore,
                       writer=ScalarWriter() if primary else None,
                       no_metric=args.no_metric, seed=args.seed,
                       device=args.device, mesh=mesh)


if __name__ == "__main__":
    main()
