"""Training and evaluation (counterpart of the JAX train/driver.py), for
the five models: the cnn and capsule classifiers, the darknet_r and
darknet_d detectors and darkcapsule.

Per epoch, as the reference's main.py:42-217 and the JAX driver: a
shuffle from the global ``np.random`` stream, ``np.array_split``
batching, a train epoch, an eval epoch, the plateau LR step on the
TRAIN loss, the scalars (train_loss / eval_loss / train_metric /
eval_metric), last/best checkpoints into ``model_dir + str(train_frac)``,
the ``.npy`` loss and metric histories, and the metric on at most 1000
subsampled rows (`METRICS`: recog_acc for cnn and capsule,
detect_and_recog_acc for darknet_r, detect_acc for darknet_d,
darkcapsule_cell_f1 for darkcapsule).  The darknet detectors'
``avg_iou`` (the loss's aux) is kept per epoch as ``last_avg_iou`` and,
for darknet_d, printed as the reference does.  darkcapsule trains at
32 * n_grid px (loader.synthetic_dataset); the ``device`` key of its
params.json is not read: the ``device`` argument alone picks the
device.

The dataset stays resident on the device (in bf16 under bf16, whose
first op casts to it, but for the capsule reconstruction loss, which
reads the crops): a shuffle is one permuted
gather per batch on the device, with the same ``np.random.permutation``
and ``np.array_split`` use as the JAX driver's device-data path, so the
same ``np.random.seed`` gives both frameworks the same batches.  The
losses stay on the device until one fetch per epoch; nothing syncs the
host per batch.  The dropout masks (darknet_r, darknet_d, cnn) come
from a ``torch.Generator`` on the device that the Trainer owns, seeded
from ``seed``.  With ``params.do_fine_tune`` the darknet19 npz is
loaded (when present) and the blocks up to ``params.fine_tune`` are
frozen, as the JAX Trainer does for every model: for darkcapsule an npz
that is present raises (its blocks are not darknet19's) and, its
params.json having no ``fine_tune``, nothing is frozen.
``--routing`` picks the capsule models' routing
(`models.registry.resolve_routing_impl`) and ``--remat`` rematerializes
the detectors' blocks in the backward (`models.layers.remat_block`).
Not ported: --mesh, --stream, --scan_epoch, --async_ckpt,
--ckpt_every.
"""

import os

import numpy as np
import torch

from .. import config
from ..data import loader as data_loader
from ..device import compute_dtype, resolve_device
from ..losses import LossConfig
from ..metrics.classification import recog_acc
from ..metrics.detection import (darkcapsule_cell_f1, detect_acc,
                                 detect_and_recog_acc)
from ..models import CapsuleNet, ConvNet, DarkCapsuleNet, DarkNet
from ..models.darknet import freeze_darknet, load_darknet19_npz
from ..models.registry import resolve_routing_impl
from . import checkpoint as ckpt
from .plateau import ReduceLROnPlateau
from .steps import eval_step, make_optimizer, train_step
from .summary import summarize

# each trained model's epoch metric (JAX metrics/__init__.py:15-25)
METRICS = {"cnn": recog_acc, "capsule": recog_acc,
           "darknet_d": detect_acc, "darknet_r": detect_and_recog_acc,
           "darkcapsule": darkcapsule_cell_f1}
TRAINED_MODELS = tuple(METRICS)


def _bounds(n, n_batch):
    """(lo, hi) of each of np.array_split's n_batch parts of range(n)."""
    ends = np.cumsum([len(p) for p in np.array_split(np.arange(n),
                                                     n_batch)])
    return list(zip(np.concatenate([[0], ends[:-1]]).tolist(), ends.tolist()))


def build_model(params, seed, device):
    """The model of ``params.model`` in ``params.compute_dtype``, its
    weights from ``seed``, on ``device``; the capsule models with the
    routing ``params.routing_impl`` resolves to (``--routing``, default
    auto), the detectors with ``params.remat`` (``--remat``)."""
    dtype = compute_dtype(params.get("compute_dtype", "float32"))
    dropout = float(params.get("dropout", 0.0))
    impl = resolve_routing_impl(params.get("routing_impl", "auto"),
                                params.model, device)
    remat = bool(params.get("remat", False))
    if params.model == "capsule":
        model = CapsuleNet(n_classes=int(params.n_classes), dtype=dtype,
                           seed=seed, routing_impl=impl)
    elif params.model == "cnn":
        model = ConvNet(n_classes=int(params.n_classes), dropout=dropout,
                        dtype=dtype, seed=seed)
    elif params.model == "darkcapsule":
        model = DarkCapsuleNet(n_grid=int(params.n_grid), dtype=dtype,
                               seed=seed, routing_impl=impl, remat=remat)
    else:
        model = DarkNet(n_boxes=int(params.n_boxes),
                        n_classes=int(params.n_classes),
                        dropout=dropout, dtype=dtype, seed=seed,
                        remat=remat)
    return model.to(device)


class Trainer:
    """Owns the model, the optimizer, the dropout generator and the
    device-resident data of one experiment."""

    def __init__(self, params, seed=0, device="cuda", verbose=True):
        if compute_dtype(params.get("compute_dtype")) == torch.int8:
            raise ValueError(
                "--dtype int8 is a serving-only extension (predict / "
                "bench, ops/quant.py); train with float32 or bfloat16")
        if params.model not in TRAINED_MODELS:
            raise ValueError(f"training --model {params.model} is not ported "
                             f"yet: {' | '.join(TRAINED_MODELS)}")
        self.device = resolve_device(device)
        self.params = params
        self.loss_cfg = LossConfig.from_params(params)
        self.model_name = params.model
        self.metric = METRICS[self.model_name]
        self.model = build_model(params, seed, self.device)
        self.generator = None
        if isinstance(self.model, (DarkNet, ConvNet)):
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(int(seed))
        if params.get("do_fine_tune", False):
            self._fine_tune(int(params.get("fine_tune", -1) or -1))
        if verbose:
            summarize(self.model, title=self.model_name)
        self.opt = make_optimizer(self.model)
        # under bf16 the images stay on the device in bf16: the model's
        # first op casts to it, so the values are the same, rounded once
        # (not for the capsule reconstruction loss, which reads x in f32)
        reads_x = self.model_name == "capsule" and self.loss_cfg.recon
        self._x_dtype = (torch.bfloat16 if self.model.dtype == torch.bfloat16
                         and not reads_x else torch.float32)
        self.last_avg_iou = 0.0
        self._data = {}

    def _fine_tune(self, fine_tune):
        """The JAX driver's fine-tune branch (driver.py:98-114): the
        pretrained npz when present, then the freeze."""
        npz = self.params.get("pretrained_weights", "./darknet19_weights.npz")
        if os.path.exists(npz):
            load_darknet19_npz(self.model, npz, n_load_layer=18)
            print(f"Load weights from {npz}")
        else:
            print(f"[fine_tune] pretrained weights {npz!r} not found; "
                  "training from scratch")
        if fine_tune > 0:
            freeze_darknet(self.model, fine_tune)

    def _resident(self, tag, x, y):
        """(x, y) of a split on the device, uploaded once: x in the
        dataset's dtype, y int64 labels or f32 grids."""
        key = (tag, x.shape, y.shape)
        if key not in self._data:
            for stale in [k for k in self._data if k[0] == tag]:
                del self._data[stale]
            y = np.asarray(y)
            y = y.astype(np.float32 if y.dtype.kind == "f" else np.int64)
            self._data[key] = (
                torch.from_numpy(np.asarray(x, np.float32)).to(
                    self.device, self._x_dtype),
                torch.from_numpy(y).to(self.device))
        return self._data[key]

    def _epoch_metric(self, losses, ious, y_hats, y, metric_on, tag):
        """Mean batch loss and avg_iou (one fetch) and the model's metric
        on <= 1000 rows, with the reference's np.random use (a choice only
        when the metric is on and there are more rows); darknet_d prints
        ``<tag> avg iou``."""
        means = [torch.stack(losses).mean()]
        if ious:
            means.append(torch.stack(ious).mean())
        means = torch.stack(means).tolist()
        avg_loss = means[0]
        self.last_avg_iou = means[1] if ious else 0.0
        metric_score = -1
        if metric_on:
            y_hat = torch.cat(y_hats).float().cpu().numpy()
            n = y.shape[0]
            if n > config.max_metric_samples:
                i = np.random.choice(n, config.max_metric_samples).astype(int)
                y, y_hat = y[i], y_hat[i]
            metric_score = self.metric(y, y_hat, self.params)
        if self.model_name == "darknet_d":
            print("{} avg iou: {:05.3f}".format(tag, self.last_avg_iou))
        return avg_loss, metric_score

    def train_epoch(self, x, y, lr, metric_on=True):
        """One training epoch over (x, y) at learning rate ``lr``;
        returns (mean batch loss, metric or -1)."""
        n = y.shape[0]
        n_batch = (n + self.params.batch_size - 1) // self.params.batch_size
        x_dev, y_dev = self._resident("train", x, y)
        perm = np.random.permutation(n)
        perm_dev = torch.from_numpy(perm).to(self.device)
        self.model.train()
        losses, ious, y_hats = [], [], []
        for lo, hi in _bounds(n, n_batch):
            idx = perm_dev[lo:hi]
            loss, y_hat, aux = train_step(
                self.model, self.opt, x_dev[idx], y_dev[idx], lr,
                self.loss_cfg, self.model_name, self.generator)
            losses.append(loss)
            y_hats.append(y_hat)
            if "avg_iou" in aux:
                ious.append(aux["avg_iou"])
        return self._epoch_metric(losses, ious, y_hats, np.asarray(y)[perm],
                                  metric_on, "train")

    def eval_epoch(self, x, y, metric_on=True):
        """One evaluation epoch; returns (mean batch loss, metric or -1)."""
        n = y.shape[0]
        n_batch = (n + self.params.batch_size - 1) // self.params.batch_size
        x_dev, y_dev = self._resident("eval", x, y)
        self.model.eval()
        losses, ious, y_hats = [], [], []
        for lo, hi in _bounds(n, n_batch):
            loss, y_hat, aux = eval_step(self.model, x_dev[lo:hi],
                                         y_dev[lo:hi], self.loss_cfg,
                                         self.model_name)
            losses.append(loss)
            y_hats.append(y_hat)
            if "avg_iou" in aux:
                ious.append(aux["avg_iou"])
        return self._epoch_metric(losses, ious, y_hats, np.asarray(y),
                                  metric_on, "test")

    # -- checkpoint glue ---------------------------------------------------

    def state_dict(self, epoch, plateau):
        return {"epoch": epoch, "state_dict": self.model.state_dict(),
                "optim_dict": self.opt.state_dict(),
                "plateau": plateau.state_dict() if plateau else {}}

    def restore(self, path, model_dir=None, train_frac=None):
        """Weights and Adam state from ``path`` (or the same file under
        ``model_dir + str(train_frac)``); returns the checkpoint dict."""
        fallbacks = []
        if model_dir is not None and train_frac is not None:
            fallbacks.append(model_dir + str(train_frac))
        raw = ckpt.load_checkpoint(path, fallback_dirs=fallbacks)
        self.model.load_state_dict(raw["state_dict"], strict=True)
        if raw.get("optim_dict"):
            self.opt.load_state_dict(raw["optim_dict"])
        return raw


def train_and_evaluate(params, data_dir, model_dir, is_small=False,
                       restore_file=None, writer=None, no_metric=False,
                       seed=0, device="cuda"):
    """Full training run (reference main.py:146-217); returns the best
    eval metric."""
    trainer = Trainer(params, seed=seed, device=device,
                      verbose=bool(params.get("summary", True)))
    plateau = ReduceLROnPlateau(lr=params.lr_runtime, factor=params.lr_decay)

    if restore_file is not None:
        restore_path = ckpt.checkpoint_path(model_dir, restore_file)
        print("Restoring parameters from {}".format(restore_path))
        raw = trainer.restore(restore_path, model_dir, params.train_frac)
        if raw.get("plateau"):
            plateau.load_state_dict(raw["plateau"])

    x_tr, y_tr, x_ev, y_ev = data_loader.load_or_synthesize(
        data_dir, params, is_small=is_small, npy=params.get("npy", False))
    to_frac = int(y_tr.shape[0] * params.train_frac)
    x_tr, y_tr = x_tr[:to_frac], y_tr[:to_frac]

    losses_tr, losses_ev, metrics_tr, metrics_ev = [], [], [], []
    best_metric_ev = float("-inf")
    best_loss_ev = float("inf")
    for epoch in range(params.n_epochs):
        if_eval = (epoch + 1) % params.eval_every == 0
        metric_on = if_eval and not no_metric

        loss_tr, metric_tr = trainer.train_epoch(x_tr, y_tr, plateau.lr,
                                                 metric_on=metric_on)
        loss_ev, metric_ev = trainer.eval_epoch(x_ev, y_ev,
                                                metric_on=metric_on)
        plateau.step(loss_tr)

        if writer is not None:
            writer.add_scalar("train_loss", loss_tr, epoch)
            writer.add_scalar("eval_loss", loss_ev, epoch)

        is_best = metric_ev > best_metric_ev
        ckpt.save_checkpoint(trainer.state_dict(epoch + 1, plateau),
                             is_best=is_best,
                             checkpoint_dir=model_dir + str(params.train_frac))
        if is_best:
            best_metric_ev = metric_ev
        if loss_ev < best_loss_ev:
            best_loss_ev = loss_ev

        if if_eval:
            if writer is not None:
                writer.add_scalar("train_metric", metric_tr, epoch)
                writer.add_scalar("eval_metric", metric_ev, epoch)
            print("epoch {} | train loss: {:05.3f} | eval loss: {:05.3f} |"
                  " best eval loss: {:05.3f} | train metric: {:05.3f} | "
                  "eval metric: {:05.3f} | best eval metric {:05.3f}".format(
                      epoch + 1, loss_tr, loss_ev, best_loss_ev, metric_tr,
                      metric_ev, best_metric_ev))
            metrics_tr.append(metric_tr)
            metrics_ev.append(metric_ev)
            np.save(os.path.join(model_dir, "metrics_tr"), metrics_tr)
            np.save(os.path.join(model_dir, "metrics_ev"), metrics_ev)

        losses_tr.append(loss_tr)
        losses_ev.append(loss_ev)
        np.save(os.path.join(model_dir, "losses_tr"), losses_tr)
        np.save(os.path.join(model_dir, "losses_ev"), losses_ev)
    if writer is not None:
        writer.close()
    return best_metric_ev
