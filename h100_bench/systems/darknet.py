"""The port's DarkNet detector (darknet_r; any n_boxes and n_classes) as
the benchmark drives it: the seeded weights, the serving closed loop
over host frames and the captured training epochs, and the comparison
of what they produced with the plain reference.

Serving (`Serve`): each batch is the port's `preprocess_images` of the
host frames (np.stack, the copy to the card, the resize there), the
detector fn `export.make_detector_fn` builds (BN folded, K2, cuDNN, K1,
the grid decode) and `decode.to_flat_host` with each frame's size: the
boxes and classes on the host.  Every batch of the window is kept and
compared, box for box, with the reference's decode of the same frames.

Training (`Train`): `steps.make_train_epoch` with a `GraphCapture`, as
``--scan_epoch auto`` runs it on the card, over scenes resident on the
card, one seeded index table an epoch.  The set-up epoch is the first
of the same object; its first three steps are compared with three
reference steps from the same weights, rows and dropout seed.
"""

import time

import numpy as np
import torch

from .. import traffic as tr
from ..reference import darknet as ref
from ..reference.common import control_tf32, precision, resize_bilinear
from ..work import DARKNET_LAYERS, darknet_flop
from .common import (TAG_DATA, TAG_DROPOUT, TAG_ORDER, TAG_STATS,
                     EpochTrain, dtypes, fresh_peak, honour, load)

# a candidate this close to conf_th may go either way, and a class this
# close to the runner-up may flip: ten and five times the largest
# confidence and class-probability errors of the port against the
# reference on the card (5.1e-4 and 3.6e-4, 3 seeds; PERF.md)
CONF_MARGIN = 5e-3
CLASS_MARGIN = 2e-3
# training: the last block's BN starts at this share of the others'
# scale and bias, so that Adam's first steps at the published lr do not
# drive a box width's sigmoid to exactly 0 in f32 (PERF.md)
LAST_BN_SHARE = 0.1
# the configuration's keys that a run reads, and the published keys that
# a window of whole epochs at a held learning rate cannot change
READ = ("learning_rate", "batch_size", "l_coord", "l_noobj", "n_boxes",
        "n_classes", "darknet_input", "n_grid", "dropout", "dtype",
        "conf_th")
RECORDED = {
    "layers": "describes work.DARKNET_LAYERS, held to the port's module",
    "n_epochs": "a window runs whole epochs back to back",
    "lr_decay": "the learning rate is held (assumed.lr_schedule)",
    "fine_tune": "only read with do_fine_tune, which is off",
    "add_signs": "the reference loader's augmentation; scenes are drawn",
    "capsule_input": "the two-stage classifier's crops; none run here",
}
MODELS = ("darknet_r", "darknet_d")


def honoured(cfg):
    """The configuration, checked: every key run as it says, DarkNet-19
    (work.DARKNET_LAYERS, held to the port's module by the strict load)
    with its five pools to ``n_grid``."""
    honour(cfg, READ, RECORDED)
    if cfg["model"] not in MODELS:
        raise ValueError(f"system darknet runs {MODELS}, not "
                         f"{cfg['model']!r}")
    pools = sum(after == "mp" for _, _, after in DARKNET_LAYERS)
    if cfg["darknet_input"] != cfg["n_grid"] * 2 ** pools:
        raise ValueError(f"n_grid {cfg['n_grid']} is not darknet_input "
                         f"{cfg['darknet_input']} over 2**{pools}")
    return cfg


def _port():
    from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import export
    from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.device import \
        resolve_device
    from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.losses import \
        LossConfig
    from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import \
        DarkNet
    from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import \
        decode
    from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops.preprocess \
        import preprocess_images
    from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import \
        steps
    return (export, resolve_device, LossConfig, DarkNet, decode,
            preprocess_images, steps)


def make_state(cfg, seed, device):
    """The seeded state_dict in the reference's keys, drawn on the card
    in two calls: He-normal conv weights (the head at std
    2/sqrt(fan_in)), BN scale 1 + 0.1 N and bias 0.1 N, BN statistics
    at 0 and 1."""
    g = tr.generator(seed, 0, device)
    n_out = 5 * cfg["n_boxes"] + cfg["n_classes"]
    shapes, in_c = [], 3
    for out_c, k, _ in DARKNET_LAYERS:
        shapes.append((out_c, in_c, k, k))
        in_c = out_c
    shapes.append((n_out, in_c, 1, 1))
    flat = torch.randn(sum(int(np.prod(s)) for s in shapes), generator=g,
                       device=device)
    sd, at = {}, 0
    for i, s in enumerate(shapes, start=1):
        n = int(np.prod(s))
        fan_in = n // s[0]
        std = (2.0 / fan_in ** 0.5 if i == len(shapes)
               else (2.0 / fan_in) ** 0.5)
        sd[f"model.conv_{i}.weight"] = (flat[at:at + n] * std).view(s)
        at += n
    widths = [c for c, _, _ in DARKNET_LAYERS]
    bn = torch.randn(2 * sum(widths), generator=g, device=device) * 0.1
    at = 0
    for i, c in enumerate(widths, start=1):
        p = f"model.bn_{i}."
        sd[p + "weight"] = 1.0 + bn[at:at + c]
        sd[p + "bias"] = bn[at + c:at + 2 * c].clone()
        sd[p + "running_mean"] = torch.zeros(c, device=device)
        sd[p + "running_var"] = torch.ones(c, device=device)
        sd[p + "num_batches_tracked"] = torch.zeros(
            (), dtype=torch.int64, device=device)
        at += 2 * c
    return {k: v.contiguous() for k, v in sd.items()}


def calibrate(sd, x, cfg, boxes_per_frame, seed):
    """Serving's statistics and confidence bias, set by the reference on
    the images ``x`` (NHWC, the detector's input size): each BN's running
    statistics are its batch statistics, perturbed; then channel 0 of
    the last block is held at 1 and its head weight on each confidence
    set so that ``boxes_per_frame`` of the candidates clear conf_th."""
    n_layers = len(DARKNET_LAYERS)
    g = tr.generator(seed, TAG_STATS, x.device)
    with torch.no_grad(), precision(tf32=False):
        stats = []
        ref.features(sd, x, train=True, stats=stats)
        for i, (mean, var) in enumerate(stats, start=1):
            p = f"model.bn_{i}."
            sd[p + "running_var"] = var * (1 + 0.1 * torch.rand(
                var.shape, generator=g, device=x.device))
            sd[p + "running_mean"] = mean + 0.05 * torch.randn(
                mean.shape, generator=g, device=x.device) * mean.abs().mean()
        last = f"model.bn_{n_layers}."
        sd[last + "weight"][0] = 0.0
        sd[last + "bias"][0] = 1.0
        head_w = sd[f"model.conv_{n_layers + 1}.weight"]
        confs = [5 * b for b in range(cfg["n_boxes"])]
        head_w[confs, 0] = 0.0
        h = ref.features(sd, x)
        logits = torch.nn.functional.conv2d(h, head_w)[:, confs]
        share = boxes_per_frame / logits[0].numel()
        cut = torch.quantile(logits.flatten().double(), 1.0 - share)
        head_w[confs, 0] = -cut.float() + torch.logit(
            torch.tensor(cfg.get("conf_th", 0.5))).to(x.device)
    return sd


def reference_candidates(sd, frames_u8, cfg, frame_hw, device, tf32=False,
                         block=32):
    """The reference's decode of every frame (host uint8 array): conf,
    corners in the frame's pixels, class and class gap of every
    candidate, as host arrays (n_frames, n, ...)."""
    size = cfg["darknet_input"]
    out = [[], [], [], []]
    with torch.no_grad(), precision(tf32=tf32):
        for i in range(0, len(frames_u8), block):
            x = resize_bilinear(torch.from_numpy(
                frames_u8[i:i + block]).to(device), size)
            y = ref.forward(sd, x, cfg["n_boxes"], cfg["n_classes"])
            for acc, t in zip(out, ref.decode(y, cfg["n_boxes"], size,
                                              frame_hw)):
                acc.append(t.double().cpu().numpy())
    return [np.concatenate(a) for a in out]


def compare_boxes(kept, cand, conf_th):
    """Every kept batch (frame indices, (image_indices, boxes, classes))
    against the reference's candidates of those frames.  Each served box
    is matched to the reference candidate of its frame with the nearest
    centre.  Returns box_px (the largest corner error in frame pixels
    over matched boxes), box_miss (served boxes whose candidate lies
    below conf_th - CONF_MARGIN, plus candidates above conf_th +
    CONF_MARGIN that no served box matched), class_flip (matched boxes
    whose class differs where the reference's top two classes are more
    than CLASS_MARGIN apart), the count of boxes compared and of those
    whose class was."""
    conf, xy, cls, gap = cand
    centre = (xy[..., :2] + xy[..., 2:]) / 2
    box_px, miss, flip, n_box, n_cls = 0.0, 0, 0, 0, 0
    for frames, (img_idx, boxes, classes) in kept:
        f = np.asarray(frames)
        must = conf[f] > conf_th + CONF_MARGIN
        matched = np.zeros_like(must)
        if len(img_idx):
            c = (boxes[:, :2] + boxes[:, 2:]) / 2
            d = np.abs(centre[f][img_idx] - c[:, None, :]).sum(-1)
            j = d.argmin(1)
            fr = f[img_idx]
            matched[img_idx, j] = True
            err = np.abs(xy[fr, j] - boxes).max(1)
            box_px = max(box_px, float(err.max()))
            miss += int((conf[fr, j] < conf_th - CONF_MARGIN).sum())
            if classes is not None:
                sure = gap[fr, j] > CLASS_MARGIN
                flip += int(((cls[fr, j] != classes) & sure).sum())
                n_cls += int(sure.sum())
            n_box += len(img_idx)
        miss += int((must & ~matched).sum())
    return {"box_px": box_px, "box_miss": miss, "class_flip": flip,
            "boxes": n_box, "classes_sure": n_cls}


def serve_inputs(cfg, traffic, seed, device):
    """The seed's host frame pool (uint8), the serving state_dict,
    calibrated by the reference on the pool's first frames, and the
    seconds the calibration took (the reference's, not the set-up's)."""
    g = tr.generator(seed, TAG_DATA, device)
    frames, *_ = tr.scenes(traffic["pool"], tuple(traffic["frame_hw"]),
                           traffic["signs"], traffic["sign_frac"],
                           cfg["n_classes"], g, device)
    sd = make_state(cfg, seed, device)
    t0 = time.perf_counter()
    calib = resize_bilinear(frames[:traffic["calibration_frames"]],
                            cfg["darknet_input"])
    sd = calibrate(sd, calib, cfg, traffic["boxes_per_frame"], seed)
    del calib
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    calib_s = time.perf_counter() - t0
    pool = frames.cpu().numpy()
    del frames
    return pool, sd, calib_s


class Serve:
    """The serving closed loop's state: the host frame pool, the
    detector fn and every batch's outputs.  ``reference_s``: the
    set-up's seconds in the reference (the calibration), which
    ``setup_s`` leaves out."""

    def __init__(self, cfg, traffic, seed, device):
        export, resolve_device, _, DarkNet, decode, preprocess_images, _ = \
            _port()
        cfg = honoured(cfg)
        device = resolve_device(device)   # the port's f32 policy: no TF32
        self.cfg, self.device = cfg, device
        self.size, self.bs = cfg["darknet_input"], cfg["batch_size"]
        self.frame_hw = tuple(traffic["frame_hw"])
        self.pool, sd, self.reference_s = serve_inputs(cfg, traffic, seed,
                                                       device)
        fresh_peak(device)
        compute, module = dtypes(cfg)
        model = load(DarkNet(n_boxes=cfg["n_boxes"],
                              n_classes=cfg["n_classes"], dtype=module),
                     sd, device).eval()
        self.fn = export.make_detector_fn(
            model, n_boxes=cfg["n_boxes"], n_classes=cfg["n_classes"],
            img_size=self.size, conf_th=cfg["conf_th"], dtype=compute)
        del model
        self.sd = {k: v.cpu() for k, v in sd.items()}
        del sd
        self._preprocess, self._to_host = (preprocess_images,
                                           decode.to_flat_host)
        self.image_hw = np.array([self.frame_hw] * self.bs)
        self.order = tr.batches(traffic["pool"], self.bs, seed, TAG_ORDER)
        self.kept = []
        self.flop_per_image = darknet_flop(self.size, cfg["n_boxes"],
                                           cfg["n_classes"])

    def next_batch(self):
        return next(self.order)

    def serve(self, frames, spans):
        """One batch: host frames in, boxes and classes on the host out."""
        with torch.inference_mode():
            with spans("stage"):
                x = self._preprocess([self.pool[j] for j in frames],
                                     self.size, self.device)
            with spans("forward"):
                d = self.fn(x)
            with spans("fetch"):
                return self._to_host(d, image_hw=self.image_hw,
                                     img_size=self.size,
                                     with_classes=self.cfg["n_classes"] != 0)

    def keep(self, frames, out):
        self.kept.append((frames, out))

    def release(self):
        self.fn = None

    def check(self):
        sd = {k: v.to(self.device) for k, v in self.sd.items()}
        cand = reference_candidates(sd, self.pool, self.cfg, self.frame_hw,
                                    self.device)
        return compare_boxes(self.kept, cand, self.cfg["conf_th"])


def serve_control(cfg, traffic, seed, device):
    """The control's numbers: the reference in TF32 put in the program's
    place, its boxes above conf_th served for the pool's frames in
    batches, compared with the f32 reference as the program's are."""
    pool, sd, _ = serve_inputs(honoured(cfg), traffic, seed, device)
    frame_hw = tuple(traffic["frame_hw"])
    conf, xy, cls, _ = reference_candidates(sd, pool, cfg, frame_hw, device,
                                            tf32=control_tf32(cfg))
    kept, bs = [], cfg["batch_size"]
    for i in range(0, len(pool) - bs + 1, bs):
        f = np.arange(i, i + bs)
        img, j = np.nonzero(conf[f] > cfg["conf_th"])
        kept.append((f, (img, xy[f][img, j],
                         cls[f][img, j] if cfg["n_classes"] else None)))
    cand = reference_candidates(sd, pool, cfg, frame_hw, device)
    return compare_boxes(kept, cand, cfg["conf_th"])


class Train(EpochTrain):
    """The captured training epochs over resident scenes: the port's
    DarkNet with dropout, Adam and the dropout generator."""

    def __init__(self, cfg, traffic, seed, device):
        _, resolve_device, LossConfig, DarkNet, _, _, steps = _port()
        cfg = honoured(cfg)
        device = resolve_device(device)   # the port's f32 policy: no TF32
        self.cfg, self.lr = cfg, cfg["learning_rate"]
        size, c = cfg["darknet_input"], cfg["n_classes"]
        self.bs = cfg["batch_size"]
        g = tr.generator(seed, TAG_DATA, device)
        img, box, cls, valid = tr.scenes(traffic["n"], (size, size),
                                         traffic["signs"],
                                         traffic["sign_frac"], c, g, device)
        self.x = tr.center(img.float())
        self.y = tr.yolo_grid(box, cls, valid, size, cfg["n_grid"], c)
        del img, box, cls, valid
        sd = make_state(cfg, seed, device)
        last = f"model.bn_{len(DARKNET_LAYERS)}."
        for k in ("weight", "bias"):
            sd[last + k] = sd[last + k] * LAST_BN_SHARE
        self.sd0 = {k: v.cpu() for k, v in sd.items()}
        fresh_peak(device)
        self.model = load(DarkNet(n_boxes=cfg["n_boxes"], n_classes=c,
                                  dropout=cfg["dropout"],
                                  dtype=dtypes(cfg)[1]), sd, device)
        del sd
        self.model.train()
        self.opt = steps.make_optimizer(self.model, cfg["learning_rate"])
        gen = tr.generator(seed, TAG_DROPOUT, device)
        capture = (steps.GraphCapture(device, [gen])
                   if torch.device(device).type == "cuda" else None)
        loss_cfg = LossConfig(n_classes=c, n_boxes=cfg["n_boxes"],
                              n_grid=cfg["n_grid"], darknet_input=size,
                              l_coord=float(cfg["l_coord"]),
                              l_noobj=float(cfg["l_noobj"]))
        self.epoch_fn = steps.make_train_epoch(
            self.model, self.opt, loss_cfg, cfg["model"], generator=gen,
            capture=capture)
        self.flop_per_image = darknet_flop(size, cfg["n_boxes"], c,
                                           train=True)
        self.start(seed, device)

    def ref_loss(self, params, idx, generator):
        cfg = self.cfg
        y = ref.forward(params, self.x[idx], cfg["n_boxes"], cfg["n_classes"],
                        train=True, dropout=cfg["dropout"],
                        generator=generator)
        return ref.yolo_loss(y, self.y[idx], cfg["n_boxes"], cfg["n_classes"],
                             cfg["darknet_input"], cfg["l_coord"],
                             cfg["l_noobj"])
