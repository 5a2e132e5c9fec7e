"""The port's fused two-stage pipeline as the benchmark drives it:
DarkNet-19 (darknet_r) detects, CapsuleNet classifies the top
``max_crops`` boxes of every frame, in one pass on the card a batch.

Serving (`Serve` only): each batch is the port's `preprocess_images` of
the host frames, the fn `export.make_two_stage_fn` builds (the BN-folded
detector with K2 and K1, the top-k decode, the crop, the centring and
CapsuleNet with K3 on batch x max_crops crops) and
`decode.to_flat_host_with_extras` with the class scores as an extra:
each served box in the detector input's pixels, its detector class and
its CapsuleNet scores on the host.  The weights are each system's own
(`systems/darknet.py`, the detector calibrated as in `darknet_r.serve`;
`systems/capsule.py`, from a sub-stream of the seed).

Every batch of the window is kept.  Its boxes are compared as
`darknet_r.serve`'s (`darknet.compare_boxes`) with the reference's
candidates, those outside a frame's ``max_crops`` most confident taken
out; each served box's scores with the reference's scores of the crop
the reference cuts at that same box from its own detector input, so a
box that moved across an integer pixel edge is held by ``box_px`` alone.
The reference classifies each distinct (frame, served box) once.
"""

import numpy as np
import torch

from .. import traffic as tr
from ..reference import two_stage as ref
from ..reference.common import control_tf32, precision, resize_bilinear
from ..work import capsule_flop, darknet_flop
from . import capsule as scap
from . import darknet as sdark
from .common import TAG_ORDER, dtypes, fresh_peak, honour, load

# the classifier's weights come from this sub-stream of the seed (the
# detector's from the seed's own, as in darknet_r.serve)
TAG_CLASSIFIER = 6
# a crop's class may flip where the reference's two best scores lie
# closer than this share of the best: twice the score_err limit (1e-4),
# so that scores within that limit cannot flip a class held here; the
# port's largest score error on the card is 2.45e-5 (15 runs; PERF.md)
CLASS_MARGIN = 2e-4
DETECTOR = ("darknet_input", "n_grid", "n_boxes", "n_classes",
            "batch_size", "conf_th", "dtype")
CLASSIFIER = scap.WIDTHS + ("n_classes", "routing", "dtype")
READ = DETECTOR + CLASSIFIER + ("max_crops",)
FRAMES_A_BLOCK = 32     # the reference's frames in one call


def parts(cfg, device):
    """The configuration as the two systems take it: the detector's
    (`darknet.honoured`: DarkNet-19's pools to ``n_grid``) and the
    classifier's (`capsule.honoured`: the nodes from the conv widths),
    each checked by its own system."""
    det = sdark.honoured({"system": "darknet", "model": "darknet_r",
                          **{k: cfg[k] for k in DETECTOR}})
    cls = scap.honoured({"system": "capsule", "model": "capsule",
                         "device": torch.device(device).type,
                         **{k: cfg[k] for k in CLASSIFIER}}, device)
    return det, cls


def honoured(cfg, device):
    """The configuration, checked: every key read (none recorded), and
    each model's part as its own system checks it; returns the parts
    (`parts`)."""
    honour(cfg, READ, {})
    if cfg["model"] != "two_stage":
        raise ValueError(f"system two_stage runs 'two_stage', not "
                         f"{cfg['model']!r}")
    return parts(cfg, device)


def inputs(det_cfg, cls_cfg, traffic, seed, device):
    """The seed's host frame pool, the calibrated detector's and the
    classifier's state_dicts, and the calibration's seconds."""
    pool, det_sd, calib_s = sdark.serve_inputs(det_cfg, traffic, seed, device)
    cls_sd = scap.make_state(cls_cfg, tr.stream_seed(seed, TAG_CLASSIFIER),
                             device)
    return pool, det_sd, cls_sd, calib_s


def reference_inputs(pool, size, device):
    """The reference's detector input (the frame resized, 0-255) of every
    pool frame, on ``device``."""
    return torch.cat([resize_bilinear(torch.from_numpy(
        pool[i:i + FRAMES_A_BLOCK]).to(device), size)
        for i in range(0, len(pool), FRAMES_A_BLOCK)])


def reference_candidates(sd, x, cfg):
    """The reference's candidates of every frame of ``x`` as host arrays
    (`darknet.compare_boxes`' ``cand``), in the input's pixels, with the
    confidence of those a fused pass does not serve changed: below a
    frame's ``max_crops`` cut (midway between its k-th and k+1-th
    confidences) by more than `darknet.CONF_MARGIN`, -1 (never served);
    within the margin of it, at most ``conf_th`` (either way)."""
    out = [[], [], [], []]
    with torch.no_grad(), precision(tf32=False):
        for i in range(0, len(x), FRAMES_A_BLOCK):
            for acc, t in zip(out, ref.candidates(
                    sd, x[i:i + FRAMES_A_BLOCK], cfg["n_boxes"],
                    cfg["n_classes"])):
                acc.append(t.double().cpu().numpy())
    conf, xy, cls, gap = (np.concatenate(a) for a in out)
    k = cfg["max_crops"]
    if k < conf.shape[1]:
        ranked = -np.sort(-conf, axis=1)
        cut = (ranked[:, k - 1:k] + ranked[:, k:k + 1]) / 2
        either = np.abs(conf - cut) <= sdark.CONF_MARGIN
        conf = np.where(conf < cut - sdark.CONF_MARGIN, -1.0,
                        np.where(either, np.minimum(conf, cfg["conf_th"]),
                                 conf))
    return conf, xy, cls, gap


def compare_scores(kept, x, sd, cfg):
    """Every served box's scores against the reference's scores of the
    crop it cuts at that box from its detector input ``x``, computed
    once per distinct (frame, box).  score_err: the largest error of a
    box's scores over its largest reference score; crop_class_flip:
    boxes whose best class differs from the reference's where its two
    best scores lie more than CLASS_MARGIN of the best apart; with the
    counts of boxes scored, distinct and sure."""
    index, frames, boxes, rows = {}, [], [], []
    for f, ((img, xy, _), extras) in kept:
        for fr, b in zip(np.asarray(f)[img], xy.astype(np.float32)):
            key = (int(fr), b.tobytes())
            if key not in index:
                index[key] = len(frames)
                frames.append(int(fr))
                boxes.append(b)
            rows.append(index[key])
    if not rows:
        return {"score_err": float("nan"), "crop_class_flip": 0,
                "crops_scored": 0, "crops_distinct": 0, "crops_sure": 0}
    with torch.no_grad(), precision(tf32=False):
        want = ref.crop_scores(
            sd, x, torch.tensor(frames, device=x.device),
            torch.from_numpy(np.stack(boxes)).to(x.device),
            cfg["capsule_input"], cfg["n_iter"]).double().cpu().numpy()
    want = want[np.asarray(rows)]
    got = np.concatenate([e["scores"] for _, (_, e) in kept]).astype(
        np.float64)
    top2 = np.sort(want, 1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > CLASS_MARGIN * top2[:, 1]
    err = np.abs(got - want).max(1) / np.abs(want).max(1)
    flip = (got.argmax(1) != want.argmax(1)) & sure
    return {"score_err": float(err.max()), "crop_class_flip": int(flip.sum()),
            "crops_scored": len(rows), "crops_distinct": len(frames),
            "crops_sure": int(sure.sum())}


def compare(kept, pool, det_sd, cls_sd, cfg, device):
    """The cell's numbers: `darknet.compare_boxes` on the served boxes
    (in the detector input's pixels) and `compare_scores`."""
    x = reference_inputs(pool, cfg["darknet_input"], device)
    cand = reference_candidates(det_sd, x, cfg)
    numbers = sdark.compare_boxes([(f, out) for f, (out, _) in kept], cand,
                                  cfg["conf_th"])
    numbers.update(compare_scores(kept, x, cls_sd, cfg))
    return numbers


class Serve:
    """The serving closed loop's state: the host frame pool, the fused
    two-stage fn and every batch's outputs.  ``reference_s``: the
    set-up's seconds in the reference (the detector's calibration),
    which ``setup_s`` leaves out."""

    def __init__(self, cfg, traffic, seed, device):
        export, resolve_device, _, DarkNet, decode, preprocess_images, _ = \
            sdark._port()
        det_cfg, cls_cfg = honoured(cfg, device)
        device = resolve_device(device)   # the port's f32 policy: no TF32
        self.cfg, self.device = cfg, device
        self.size, self.bs = cfg["darknet_input"], cfg["batch_size"]
        self.pool, det_sd, cls_sd, self.reference_s = inputs(
            det_cfg, cls_cfg, traffic, seed, device)
        fresh_peak(device)
        compute, module = dtypes(cfg)
        det = load(DarkNet(n_boxes=cfg["n_boxes"],
                           n_classes=cfg["n_classes"], dtype=module),
                   det_sd, device).eval()
        cls = scap.build_model(cls_cfg, cls_sd, device)
        self.fn = export.make_two_stage_fn(
            det, cls, n_boxes=cfg["n_boxes"], n_classes=cfg["n_classes"],
            img_size=self.size, cap_input=cfg["capsule_input"],
            max_crops=cfg["max_crops"], conf_th=cfg["conf_th"],
            dtype=compute)
        del det, cls
        self.det_sd = {k: v.cpu() for k, v in det_sd.items()}
        self.cls_sd = {k: v.cpu() for k, v in cls_sd.items()}
        del det_sd, cls_sd
        self._preprocess, self._fetch = (preprocess_images,
                                         decode.to_flat_host_with_extras)
        self.order = tr.batches(traffic["pool"], self.bs, seed, TAG_ORDER)
        self.kept = []
        self.flop_per_image = (
            darknet_flop(self.size, cfg["n_boxes"], cfg["n_classes"])
            + cfg["max_crops"] * capsule_flop(cls_cfg, recon=False))

    def next_batch(self):
        return next(self.order)

    def serve(self, frames, spans):
        """One batch: host frames in; boxes in the detector input's
        pixels, their classes and CapsuleNet scores on the host out."""
        with torch.inference_mode():
            with spans("stage"):
                x = self._preprocess([self.pool[j] for j in frames],
                                     self.size, self.device)
            with spans("forward"):
                d = self.fn(x)
            with spans("fetch"):
                return self._fetch(d, {"scores": d["class_scores"]},
                                   img_size=self.size)

    def keep(self, frames, out):
        self.kept.append((frames, out))

    def release(self):
        self.fn = None

    def check(self):
        dev = self.device
        return compare(self.kept, self.pool,
                       {k: v.to(dev) for k, v in self.det_sd.items()},
                       {k: v.to(dev) for k, v in self.cls_sd.items()},
                       self.cfg, dev)


def serve_control(cfg, traffic, seed, device, fault=None):
    """The control's numbers: the reference in TF32 put in the program's
    place, the pool's frames served in batches and compared as the
    program's are.  With ``fault="half"`` the f32 reference is put there
    instead, with the crops of the second half of each batch's frames cut
    from the next frame's image."""
    pool, det_sd, cls_sd, _ = inputs(*honoured(cfg, device), traffic, seed,
                                     device)
    x = reference_inputs(pool, cfg["darknet_input"], device)
    bs, kept = cfg["batch_size"], []
    tf32 = control_tf32(cfg) if fault is None else False
    with torch.no_grad(), precision(tf32=tf32):
        for i in range(0, len(pool) - bs + 1, bs):
            xb = x[i:i + bs]
            src = xb
            if fault == "half":
                src = torch.cat([xb[:bs // 2], xb.roll(-1, 0)[bs // 2:]])
            frame, boxes, cls, scores = ref.pipeline(det_sd, cls_sd, xb, cfg,
                                                     crop_x=src)
            kept.append((np.arange(i, i + bs),
                         ((frame, boxes.astype(np.float32), cls),
                          {"scores": scores})))
    return compare(kept, pool, det_sd, cls_sd, cfg, device)
