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

Scale-out (JAX train/driver.py:116-130, 229-272, 433-575): with a
``mesh`` (parallel/, one rank per device) every rank draws the same
permutation and runs its rows of each batch (`parallel.mesh.
place_batch`'s rule: a batch the data axis does not divide is run whole
on every rank), with global-batch BatchNorm and dropout and the
gradients averaged over the data group; under a model axis the capsule
models' route weights are split over their nodes and the routing runs
the plain composition (JAX's ``[mesh] ... forcing --routing xla``).  The
epoch's losses, avg_iou sums and outputs are combined in one collective
each, the outputs in row order, so the metric sees the single-device
rows; rank 0 alone prints, writes the checkpoints (the route weights
gathered whole: they restore on any mesh) and the histories.
``--stream`` (``params.stream``) keeps the dataset on the host (memmapped
with ``--npy``) and feeds each batch from the native prefetcher
(data/stream.py) through pinned memory; under a mesh each rank loads
only its rows.  ``--async_ckpt`` writes checkpoints on a worker thread
(`checkpoint.AsyncCheckpointer`), ``--ckpt_every N`` writes ``last``
every Nth epoch and on the last (``best`` whenever the metric improves),
and rank 0 counts each train epoch's batches on stderr
(`logging_utils.BatchCounter`).

``--scan_epoch`` (``params.scan_epoch``: a bool or auto | on | off; JAX
driver.py:174-211, 332-389) runs each epoch as groups of equal-size
batches (`_group_splits`: np.array_split's, at most two), each through
a `steps.make_train_epoch` / `make_eval_epoch` object: on a card one
captured CUDA graph a group, replayed a batch; on the CPU the same body
eagerly.  The batches, their order, the dropout stream and the numbers
are the per-batch loop's.  It needs the resident dataset: with
``--stream`` and under a gloo mesh (its collectives cannot be captured)
the loop runs, and an explicit ``on`` says so.  An NCCL mesh is
captured, its all-reduces inside the graphs.  ``auto`` is off on the CPU
and `SCAN_EPOCH_AUTO_ON_CARD` on a card.  The graphs are dropped when
what they read moves: on `Trainer.restore` (the optimizer's state is
replaced) and when `_resident` replaces a split.
"""

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import config
from ..data import loader as data_loader
from ..data import stream as data_stream
from ..device import compute_dtype, resolve_device
from ..losses import LossConfig
from ..metrics.classification import recog_acc
from ..metrics.detection import (darkcapsule_cell_f1, detect_acc,
                                 detect_and_recog_acc)
from ..models import CapsuleNet, ConvNet, DarkCapsuleNet, DarkNet
from ..models.capsule_net import CapsuleRouting
from ..models.darknet import freeze_darknet, load_darknet19_npz
from ..models.registry import resolve_routing_impl
from ..parallel import mesh as par
from ..parallel.collectives import BatchShard
from . import checkpoint as ckpt, steps
from .logging_utils import BatchCounter
from .plateau import ReduceLROnPlateau
from .steps import eval_step, make_optimizer, train_step
from .summary import summarize

# each trained model's epoch metric (JAX metrics/__init__.py:15-25)
METRICS = {"cnn": recog_acc, "capsule": recog_acc,
           "darknet_d": detect_acc, "darknet_r": detect_and_recog_acc,
           "darkcapsule": darkcapsule_cell_f1}
TRAINED_MODELS = tuple(METRICS)
ROUTE_KEY = "traffic_sign_capsules.route_weights"
# what --scan_epoch auto is on a card: on where the captured epochs are
# no slower than the loop for every model and dtype (chip_smoke.py
# phase 32; PERF.md)
SCAN_EPOCH_AUTO_ON_CARD = True


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


class _PinnedStager:
    """The streamed loop's host-to-device copies: each batch is copied
    into one of two pinned buffers per tensor and sent with a
    non-blocking copy; a buffer is reused once the copy that read it has
    finished (its event)."""

    def __init__(self, device):
        self.device = device
        self.bufs, self.events, self.turn = {}, [None, None], 0

    def __call__(self, arrays):
        slot, self.turn = self.turn, 1 - self.turn
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        out = []
        for k, a in enumerate(arrays):
            src = torch.from_numpy(a)
            buf = self.bufs.get((slot, k))
            if buf is None or buf.numel() < src.numel() \
                    or buf.dtype != src.dtype:
                buf = torch.empty(src.numel(), dtype=src.dtype,
                                  pin_memory=True)
                self.bufs[(slot, k)] = buf
            staged = buf[:src.numel()].view(src.shape)
            staged.copy_(src)
            out.append(staged.to(self.device, non_blocking=True))
        self.events[slot] = torch.cuda.Event()
        self.events[slot].record()
        return out


class Trainer:
    """Owns the model, the optimizer, the dropout generator and the
    device-resident data of one experiment; with ``mesh``, one rank's
    share of it."""

    def __init__(self, params, seed=0, device="cuda", verbose=True,
                 mesh=None):
        if compute_dtype(params.get("compute_dtype")) == torch.int8:
            raise ValueError(
                "--dtype int8 is a serving-only extension (predict / "
                "bench, ops/quant.py); train with float32 or bfloat16")
        if params.model not in TRAINED_MODELS:
            raise ValueError(f"training --model {params.model} is not ported "
                             f"yet: {' | '.join(TRAINED_MODELS)}")
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh else device)
        self.primary = mesh is None or mesh.is_primary
        self.params = params
        self.loss_cfg = LossConfig.from_params(params)
        self.model_name = params.model
        self.metric = METRICS[self.model_name]
        # decided before the model is built: route weights split over
        # 'model' run the plain routing (JAX driver.py:65-85)
        self._shard_routing = (mesh is not None and mesh.n_model > 1
                               and self.model_name in ("capsule",
                                                       "darkcapsule"))
        if self._shard_routing and params.get("routing_impl",
                                              "auto") != "xla":
            if params.get("routing_impl") == "pallas" and self.primary:
                print("[mesh] routing weights sharded over 'model': "
                      "forcing --routing xla (the Pallas kernel cannot "
                      "consume a sharded operand)")
            params.routing_impl = "xla"
        self.model = build_model(params, seed, self.device)
        self.generator = None
        if isinstance(self.model, (DarkNet, ConvNet)):
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(int(seed))
        if params.get("do_fine_tune", False):
            self._fine_tune(int(params.get("fine_tune", -1) or -1))
        if self._shard_routing:
            for name, m in self.model.named_modules():
                if (isinstance(m, CapsuleRouting) and "model" in
                        par.routing_param_spec(name + ".route_weights")):
                    m.shard_nodes(mesh.model_group, mesh.model_rank,
                                  mesh.n_model)
        if verbose:
            summarize(self.model, title=self.model_name)
            if mesh is not None:
                print("[mesh] data={} model={} (routing sharded: {})".format(
                    mesh.n_data, mesh.n_model, self._shard_routing))
        self.opt = make_optimizer(self.model)
        # under bf16 the images stay on the device in bf16: the model's
        # first op casts to it, so the values are the same, rounded once
        # (not for the capsule reconstruction loss, which reads x in f32)
        reads_x = self.model_name == "capsule" and self.loss_cfg.recon
        self._x_dtype = (torch.bfloat16 if self.model.dtype == torch.bfloat16
                         and not reads_x else torch.float32)
        self.stream = bool(params.get("stream", False))
        self._stager = (_PinnedStager(self.device)
                        if self.stream and self.device.type == "cuda"
                        else None)
        self.prefetch_wait_s = 0.0  # the last epoch's, --stream only
        self.last_avg_iou = 0.0
        self._data = {}
        setting = params.get("scan_epoch", False)
        wanted = self._resolve_scan(setting, self.device)
        gloo = mesh is not None and dist.get_backend(
            mesh.data_group) == "gloo"
        self.scan_epoch = wanted and not self.stream and not gloo
        if wanted and not self.scan_epoch and verbose and \
                str(setting).lower() != "auto":
            print("[scan_epoch] ignored: --stream keeps the dataset "
                  "host-resident, the per-batch streamed loop runs"
                  if self.stream else
                  "[scan_epoch] ignored: gloo collectives cannot be "
                  "captured in a CUDA graph, the per-batch loop runs")
        self.last_losses = self.last_outputs = None
        self._epochs = {}      # (train, batch size, batches): steps.Epoch
        self._capture = None   # their steps.GraphCapture, on a card

    @staticmethod
    def _resolve_scan(setting, device="cpu"):
        """A --scan_epoch setting (bool | 'auto' | 'on' | 'off') as a
        bool: 'auto' is off on the CPU, `SCAN_EPOCH_AUTO_ON_CARD` on a
        card."""
        if isinstance(setting, str):
            s = setting.lower()
            if s == "auto":
                return (torch.device(device).type == "cuda"
                        and SCAN_EPOCH_AUTO_ON_CARD)
            return s in ("on", "true", "1")
        return bool(setting)

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
                self.drop_graphs()
            self._data[key] = (
                torch.from_numpy(np.asarray(x, np.float32)).to(
                    self.device, self._x_dtype),
                torch.from_numpy(_labels(y)).to(self.device))
        return self._data[key]

    def _batches(self, tag, x, y, order, n_batch):
        """This rank's rows of each batch of ``order`` (a permutation, or
        None for the stored order) split n_batch ways: (x, y, global
        batch size) on the device.  Resident: gathers from the dataset
        on the device.  ``--stream``: the prefetcher's batches, copied in
        through pinned memory; the time spent waiting on it is
        ``prefetch_wait_s``."""
        n = y.shape[0]
        if self.stream:
            yield from self._streamed(x, y, np.arange(n) if order is None
                                      else order, n_batch)
            return
        x_dev, y_dev = self._resident(tag, x, y)
        order_dev = (None if order is None
                     else torch.from_numpy(order).to(self.device))
        for lo, hi in _bounds(n, n_batch):
            a, b = (0, hi - lo) if self.mesh is None \
                else par.batch_rows(hi - lo, self.mesh)
            if order_dev is None:
                yield x_dev[lo + a:lo + b], y_dev[lo + a:lo + b], hi - lo
            else:
                idx = order_dev[lo + a:lo + b]
                yield x_dev[idx], y_dev[idx], hi - lo

    def _streamed(self, x, y, order, n_batch):
        self.prefetch_wait_s = 0.0
        cuda = self._stager is not None
        if self.mesh is None:
            it = ((xb, yb, xb.shape[0]) for xb, yb in data_stream.iter_batches(
                x, y, order, n_batch, copy=not cuda))
        else:
            it = data_stream.iter_batches_process_local(
                x, y, order, n_batch, copy=not cuda,
                shard_rows=self.mesh.n_data,
                row_slices=lambda m: par.process_row_slices(m, self.mesh))
        while True:
            t0 = time.perf_counter()
            try:
                xb, yb, n_glob = next(it)
            except StopIteration:
                return
            self.prefetch_wait_s += time.perf_counter() - t0
            yb = _labels(yb)
            if cuda:
                xt, yt = self._stager([xb, yb])
            else:
                xt, yt = torch.from_numpy(xb), torch.from_numpy(yb)
            yield xt.to(self._x_dtype), yt, n_glob

    def _shard(self, n_global):
        """(BatchShard or None, gradient group or None) of a train batch
        of ``n_global`` rows: a batch the data axis divides is split, and
        its gradients are averaged over the data group; with one data
        rank no statistic needs the group; a ragged batch is replicated
        and needs neither."""
        if self.mesh is None or n_global % self.mesh.n_data:
            return None, None
        mesh = self.mesh
        shard = None
        if mesh.n_data > 1:
            lo, hi = par.batch_rows(n_global, mesh)
            shard = BatchShard(mesh.data_group, n_global, lo, hi)
        return shard, mesh.data_group

    def _aux(self, aux, y):
        """A step's aux; under a mesh with the count of object cells of
        its rows beside avg_iou, so the epoch sums avg_iou's numerator and
        denominator over the data ranks."""
        if self.mesh is None or "avg_iou" not in aux:
            return aux
        return dict(aux, n_obj=(y[..., 0] == 1.0).sum(
            dtype=aux["avg_iou"].dtype))

    def _epoch_metric(self, losses, auxes, y_hats, n_globals, y, metric_on,
                      tag):
        """Mean batch loss and avg_iou (one fetch; under a mesh one
        all-reduce of the losses and avg_iou sums before it) and the
        model's metric on <= 1000 rows, with the reference's np.random
        use (a choice only when the metric is on and there are more
        rows); darknet_d prints ``<tag> avg iou``.  ``losses`` (n_batch,)
        and ``auxes`` {key: (n_batch,)} are the batches' in order; the
        losses and the per-batch outputs stay as ``last_losses`` and
        ``last_outputs`` (under ``--scan_epoch`` until the group's next
        epoch)."""
        self.last_losses, self.last_outputs = losses, y_hats
        has_iou = "avg_iou" in auxes
        if self.mesh is None:
            means = [losses.mean()]
            if has_iou:
                means.append(auxes["avg_iou"].mean())
        else:
            rows = [losses]
            if has_iou:
                n_obj = auxes["n_obj"]
                rows += [auxes["avg_iou"] * n_obj, n_obj]
            sums = par.all_reduce_rows(torch.stack(rows), self.mesh)
            means = [(sums[0] / self.mesh.n_data).mean()]
            if has_iou:
                n_obj = sums[2]
                means.append(torch.where(
                    n_obj > 0, sums[1] / n_obj.clamp_min(1.0), 0.0).mean())
        means = torch.stack(means).tolist()
        avg_loss = means[0]
        self.last_avg_iou = means[1] if has_iou else 0.0
        metric_score = -1
        if metric_on:
            y_hat = par.gather_batches(y_hats, n_globals,
                                       self.mesh).float()
            y_hat = y_hat.cpu().numpy()
            n = y.shape[0]
            if n > config.max_metric_samples:
                i = np.random.choice(n, config.max_metric_samples).astype(int)
                y, y_hat = y[i], y_hat[i]
            metric_score = self.metric(y, y_hat, self.params)
        if self.model_name == "darknet_d" and self.primary:
            print("{} avg iou: {:05.3f}".format(tag, self.last_avg_iou))
        return avg_loss, metric_score

    def train_epoch(self, x, y, lr, metric_on=True, progress=None):
        """One training epoch over (x, y) at learning rate ``lr``;
        returns (mean batch loss, metric or -1).  ``progress`` (a
        `BatchCounter`) counts the batches."""
        n = y.shape[0]
        n_batch = (n + self.params.batch_size - 1) // self.params.batch_size
        perm = np.random.permutation(n)
        self.model.train()
        if self.scan_epoch:
            out = self._scan_epoch_run(True, x, y, perm, lr, progress)
            return self._epoch_metric(*out, np.asarray(y)[perm], metric_on,
                                      "train")
        losses, auxes, y_hats, n_globals = [], [], [], []
        for xb, yb, n_glob in self._batches("train", x, y, perm, n_batch):
            shard, grad_group = self._shard(n_glob)
            loss, y_hat, aux = train_step(
                self.model, self.opt, xb, yb, lr, self.loss_cfg,
                self.model_name, self.generator, shard=shard,
                grad_group=grad_group)
            losses.append(loss)
            y_hats.append(y_hat)
            auxes.append(self._aux(aux, yb))
            n_globals.append(n_glob)
            if progress is not None:
                progress.update()
        return self._epoch_metric(*_stacked(losses, auxes), y_hats,
                                  n_globals, np.asarray(y)[perm], metric_on,
                                  "train")

    def eval_epoch(self, x, y, metric_on=True):
        """One evaluation epoch; returns (mean batch loss, metric or -1)."""
        n = y.shape[0]
        n_batch = (n + self.params.batch_size - 1) // self.params.batch_size
        self.model.eval()
        if self.scan_epoch:
            out = self._scan_epoch_run(False, x, y, np.arange(n))
            return self._epoch_metric(*out, np.asarray(y), metric_on, "test")
        losses, auxes, y_hats, n_globals = [], [], [], []
        for xb, yb, n_glob in self._batches("eval", x, y, None, n_batch):
            loss, y_hat, aux = eval_step(self.model, xb, yb, self.loss_cfg,
                                         self.model_name)
            losses.append(loss)
            y_hats.append(y_hat)
            auxes.append(self._aux(aux, yb))
            n_globals.append(n_glob)
        return self._epoch_metric(*_stacked(losses, auxes), y_hats,
                                  n_globals, np.asarray(y), metric_on, "test")

    # -- --scan_epoch ------------------------------------------------------

    def _epoch(self, train, size, n_batch):
        """The `steps.Epoch` of a group of ``n_batch`` batches of
        ``size`` rows, made once and kept (with its graph on a card)."""
        key = (train, size, n_batch)
        if key not in self._epochs:
            if self.device.type == "cuda" and self._capture is None:
                self._capture = steps.GraphCapture(self.device,
                                                   [self.generator])
            if train:
                shard, group = self._shard(size)
                self._epochs[key] = steps.make_train_epoch(
                    self.model, self.opt, self.loss_cfg, self.model_name,
                    self.generator, shard, group, self._aux, self._capture)
            else:
                self._epochs[key] = steps.make_eval_epoch(
                    self.model, self.loss_cfg, self.model_name, self._aux,
                    self._capture)
        return self._epochs[key]

    def _scan_epoch_run(self, train, x, y, order, lr=None, progress=None):
        """One epoch through the group objects (JAX _scan_epoch_run):
        the batches of np.array_split(order, n_batch), this rank's rows
        of each under a mesh, as index tables on the device.  Returns
        the batches' losses, aux and outputs and their global sizes, in
        order, for `_epoch_metric`."""
        n = len(order)
        n_batch = (n + self.params.batch_size - 1) // self.params.batch_size
        x_dev, y_dev = self._resident("train" if train else "eval", x, y)
        losses, auxes, y_hats, n_globals = [], [], [], []
        for idx in _group_splits(np.array_split(order, n_batch)):
            size = idx.shape[1]
            lo, hi = (0, size) if self.mesh is None \
                else par.batch_rows(size, self.mesh)
            table = torch.from_numpy(np.ascontiguousarray(
                idx[:, lo:hi])).to(self.device)
            out = self._epoch(train, size, len(idx))(
                x_dev, y_dev, table, lr,
                None if progress is None else progress.update)
            losses.append(out[0])
            auxes.append(out[1])
            y_hats += list(out[2].unbind(0))
            n_globals += [size] * len(idx)
        if train:  # the replays moved the weights behind their versions
            for m in self.model.modules():
                if isinstance(m, CapsuleRouting):
                    m.drop_bf16_copy()
        return (torch.cat(losses),
                {k: torch.cat([a[k] for a in auxes]) for k in auxes[0]},
                y_hats, n_globals)

    def drop_graphs(self):
        """Forget the epochs' objects and their CUDA graphs (after the
        device finished what they queued): what they read was replaced."""
        if self._epochs and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._epochs.clear()
        self._capture = None

    # -- checkpoint glue ---------------------------------------------------

    def _route_index(self):
        """The route weights' index in the optimizer's state."""
        trained = [p for p in self.model.parameters() if p.requires_grad]
        route = self.model.traffic_sign_capsules.route_weights
        return next(i for i, p in enumerate(trained) if p is route)

    def state_dict(self, epoch, plateau):
        """The checkpoint dict (every rank calls it: under a model axis
        the route weights and their Adam moments are gathered whole)."""
        sd, optim = self.model.state_dict(), steps.optimizer_state(self.opt)
        if self._shard_routing:
            sd = dict(sd, **{ROUTE_KEY: par.gather_nodes(sd[ROUTE_KEY],
                                                         self.mesh)})
            optim = _map_route_state(optim, self._route_index(),
                                     lambda t: par.gather_nodes(t, self.mesh))
        return {"epoch": epoch, "state_dict": sd, "optim_dict": optim,
                "plateau": plateau.state_dict() if plateau else {}}

    def restore(self, path, model_dir=None, train_frac=None):
        """Weights and Adam state from ``path`` (or the same file under
        ``model_dir + str(train_frac)``); returns the checkpoint dict.
        Under a model axis the whole route weights and moments are cut
        to this rank's nodes (a checkpoint restores on any mesh)."""
        fallbacks = []
        if model_dir is not None and train_frac is not None:
            fallbacks.append(model_dir + str(train_frac))
        raw = ckpt.load_checkpoint(path, fallback_dirs=fallbacks)
        sd, optim = raw["state_dict"], raw.get("optim_dict")
        if self._shard_routing:
            shard = self.model.traffic_sign_capsules.node_shard

            def cut(t):
                return t[:, shard.lo:shard.hi].contiguous()

            sd = dict(sd, **{ROUTE_KEY: cut(sd[ROUTE_KEY])})
            if optim:
                optim = _map_route_state(optim, self._route_index(), cut)
        self.drop_graphs()
        self.model.load_state_dict(sd, strict=True)
        if optim:
            steps.load_optimizer_state(self.opt, optim)
        return raw


def _stacked(losses, auxes):
    """The loop's per-batch losses and aux dicts as (n_batch,) tensors."""
    return torch.stack(losses), {k: torch.stack([a[k] for a in auxes])
                                 for k in (auxes[0] if auxes else {})}


def _group_splits(splits):
    """np.array_split's parts stacked into index tables, one per
    distinct batch size (the larger parts come first, so at most two
    groups); int64, as the device gathers take them."""
    groups, start = [], 0
    while start < len(splits):
        end = start
        while end < len(splits) and len(splits[end]) == len(splits[start]):
            end += 1
        groups.append(np.stack(splits[start:end]).astype(np.int64))
        start = end
    return groups


def _labels(y):
    """Labels as the steps take them: int64 classes or f32 grids."""
    y = np.asarray(y)
    return y.astype(np.float32 if y.dtype.kind == "f" else np.int64)


def _map_route_state(optim, index, fn):
    """An optimizer state dict with ``fn`` applied to the route weights'
    Adam moments (their shape is the weights')."""
    state = dict(optim["state"])
    if index in state:
        state[index] = {k: fn(v) if k in ("exp_avg", "exp_avg_sq") else v
                        for k, v in state[index].items()}
    return dict(optim, state=state)


def train_and_evaluate(params, data_dir, model_dir, is_small=False,
                       restore_file=None, writer=None, no_metric=False,
                       seed=0, device="cuda", mesh=None, progress=True):
    """Full training run (reference main.py:146-217); returns the best
    eval metric.  With ``mesh``, this rank's part of it (rank 0 prints
    and writes).  ``progress``: rank 0's per-epoch batch counter on
    stderr."""
    primary = mesh is None or mesh.is_primary
    trainer = Trainer(params, seed=seed, device=device,
                      verbose=bool(params.get("summary", True)) and primary,
                      mesh=mesh)
    plateau = ReduceLROnPlateau(lr=params.lr_runtime, factor=params.lr_decay)

    if restore_file is not None:
        restore_path = ckpt.checkpoint_path(model_dir, restore_file)
        if primary:
            print("Restoring parameters from {}".format(restore_path))
        raw = trainer.restore(restore_path, model_dir, params.train_frac)
        if raw.get("plateau"):
            plateau.load_state_dict(raw["plateau"])

    if trainer.stream and params.get("npy", False) and not is_small:
        # --stream --npy: X memmapped, on disk until the prefetcher's
        # threads fault it in
        try:
            x_tr, y_tr = data_stream.open_memmap_dataset(data_dir, "train")
            x_ev, y_ev = data_stream.open_memmap_dataset(data_dir, "eval")
        except (FileNotFoundError, OSError):
            x_tr, y_tr, x_ev, y_ev = data_loader.load_or_synthesize(
                data_dir, params, is_small=is_small, npy=True)
    else:
        x_tr, y_tr, x_ev, y_ev = data_loader.load_or_synthesize(
            data_dir, params, is_small=is_small,
            npy=params.get("npy", False))
    if trainer.stream:  # the prefetcher reads float32 or uint8 rows
        x_tr, x_ev = (x if x.dtype in (np.float32, np.uint8)
                      else np.asarray(x, np.float32) for x in (x_tr, x_ev))
    to_frac = int(y_tr.shape[0] * params.train_frac)
    x_tr, y_tr = x_tr[:to_frac], y_tr[:to_frac]

    losses_tr, losses_ev, metrics_tr, metrics_ev = [], [], [], []
    best_metric_ev = float("-inf")
    best_loss_ev = float("inf")
    # --async_ckpt: the copy to the host, serialization and write on a
    # worker thread, flushed in the finally (an exception still lands
    # every queued checkpoint); --ckpt_every N: last every Nth epoch and
    # on the final one, best whenever the eval metric improves
    async_ckpt = (ckpt.AsyncCheckpointer()
                  if params.get("async_ckpt", False) and primary else None)
    save_ckpt = async_ckpt.save if async_ckpt else ckpt.save_checkpoint
    ckpt_every = max(1, int(params.get("ckpt_every", 1) or 1))
    n_batch = (len(y_tr) + params.batch_size - 1) // params.batch_size
    try:
        for epoch in range(params.n_epochs):
            if_eval = (epoch + 1) % params.eval_every == 0
            metric_on = if_eval and not no_metric

            bar = (BatchCounter(n_batch, f"epoch {epoch + 1}")
                   if progress and primary else None)
            loss_tr, metric_tr = trainer.train_epoch(
                x_tr, y_tr, plateau.lr, metric_on=metric_on, progress=bar)
            loss_ev, metric_ev = trainer.eval_epoch(x_ev, y_ev,
                                                    metric_on=metric_on)
            if bar is not None:
                bar.close()
            plateau.step(loss_tr)

            if writer is not None:
                writer.add_scalar("train_loss", loss_tr, epoch)
                writer.add_scalar("eval_loss", loss_ev, epoch)

            is_best = metric_ev > best_metric_ev
            if (is_best or (epoch + 1) % ckpt_every == 0
                    or epoch + 1 == params.n_epochs):
                state = trainer.state_dict(epoch + 1, plateau)
                if primary:
                    save_ckpt(state, is_best=is_best,
                              checkpoint_dir=model_dir
                              + str(params.train_frac))
            if is_best:
                best_metric_ev = metric_ev
            if loss_ev < best_loss_ev:
                best_loss_ev = loss_ev

            if if_eval:
                if writer is not None:
                    writer.add_scalar("train_metric", metric_tr, epoch)
                    writer.add_scalar("eval_metric", metric_ev, epoch)
                metrics_tr.append(metric_tr)
                metrics_ev.append(metric_ev)
                if primary:
                    print("epoch {} | train loss: {:05.3f} | eval loss: "
                          "{:05.3f} | best eval loss: {:05.3f} | train "
                          "metric: {:05.3f} | eval metric: {:05.3f} | best "
                          "eval metric {:05.3f}".format(
                              epoch + 1, loss_tr, loss_ev, best_loss_ev,
                              metric_tr, metric_ev, best_metric_ev))
                    np.save(os.path.join(model_dir, "metrics_tr"), metrics_tr)
                    np.save(os.path.join(model_dir, "metrics_ev"), metrics_ev)

            losses_tr.append(loss_tr)
            losses_ev.append(loss_ev)
            if primary:
                np.save(os.path.join(model_dir, "losses_tr"), losses_tr)
                np.save(os.path.join(model_dir, "losses_ev"), losses_ev)
    finally:
        if async_ckpt is not None:
            async_ckpt.flush()
    if writer is not None:
        writer.close()
    return best_metric_ev
