"""The port's CapsuleNet classifier as the benchmark drives it: the
seeded weights, the serving closed loop over host crops and the captured
training epochs, and the comparison with the plain reference.

Serving (`Serve`): each batch is a slice of the host pool of centred
crops, copied to the card as `predict.class_pred` copies it, run
through `export.make_classifier_fn` (conv1, the primary capsules, K3's
routing under the resolved ``--routing``, the lengths and the argmax)
and its class ids brought to the host.  Every batch's ids are compared
with the reference's, and the scores of a seeded share of the batches
(kept on the card as the fn returned them) with the reference's scores.

Training (`Train`): `steps.make_train_epoch` with a `GraphCapture` over
crops resident on the card (the margin and reconstruction loss, K4 in
the backward, Adam), compared over its first three steps.
"""

import numpy as np
import torch

from .. import traffic as tr
from ..reference import capsule as ref
from ..reference.common import control_tf32, precision
from ..work import capsule_flop
from .common import (TAG_DATA, TAG_ORDER, EpochTrain, dtypes, fresh_peak,
                     honour, load)

# a class whose two best scores lie closer than this share of its best
# score may flip: 200 times the largest relative score error of the port
# against the reference on the card (4.9e-7, 12 seeds; PERF.md)
CLASS_MARGIN = 1e-4
SCORE_SHARE = 8       # the first batch and one in this many keep scores
# the configuration's keys that a run reads (the widths are held to the
# port's module), and the published keys a window cannot change
WIDTHS = ("capsule_input", "conv1_channels", "conv1_kernel", "primary_caps",
          "primary_channels", "primary_kernel", "primary_stride",
          "routing_nodes", "in_dim", "out_dim", "n_iter")
READ = ("batch_size", "n_classes", "lr", "dtype", "routing", "device",
        "recon", "recon_coef") + WIDTHS
RECORDED = {
    "n_epochs": "a window runs whole epochs back to back",
    "lr_decay": "the learning rate is held (assumed.lr_schedule)",
}


def _port():
    from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import export
    from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.device import \
        resolve_device
    from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.losses import \
        LossConfig
    from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import \
        CapsuleNet
    from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models.registry \
        import resolve_routing_impl
    from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import \
        steps
    return (export, resolve_device, LossConfig, CapsuleNet,
            resolve_routing_impl, steps)


def shapes(cfg):
    """Each leaf's shape, in the reference's keys and the port's
    parameter order."""
    k, c, d = cfg["n_classes"], cfg["in_dim"], cfg["out_dim"]
    ch, ker = cfg["conv1_channels"], cfg["conv1_kernel"]
    pc, pk = cfg["primary_channels"], cfg["primary_kernel"]
    out = {"conv1.weight": (ch, 3, ker, ker), "conv1.bias": (ch,)}
    for j in range(cfg["primary_caps"]):
        p = f"primary_capsules.capsules.{j}."
        out[p + "weight"] = (pc, ch, pk, pk)
        out[p + "bias"] = (pc,)
    out["traffic_sign_capsules.route_weights"] = (
        1, cfg["routing_nodes"], k, c, d)
    for i, (o, n_in, kk) in zip((0, 4, 7, 10, 12), (
            (256, d, None), (4, 16, 3), (8, 4, 3), (16, 8, 3), (3, 16, 3))):
        out[f"decoder.{i}.weight"] = (o, n_in) if kk is None \
            else (o, n_in, kk, kk)
        out[f"decoder.{i}.bias"] = (o,)
    return out


def make_state(cfg, seed, device):
    """The seeded state_dict, drawn on the card in two calls: conv and
    dense layers U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as torch's defaults
    (a bias takes its layer's bound), route weights 0.1 N(0, 1)."""
    g = tr.generator(seed, 0, device)
    shp = shapes(cfg)
    route = "traffic_sign_capsules.route_weights"
    sizes = {k: int(np.prod(s)) for k, s in shp.items() if k != route}
    flat = torch.rand(sum(sizes.values()), generator=g, device=device) * 2 - 1
    sd, at, bound = {}, 0, 1.0
    for k, n in sizes.items():
        if k.endswith("weight"):
            bound = 1.0 / (n // shp[k][0]) ** 0.5
        sd[k] = (flat[at:at + n] * bound).view(shp[k])
        at += n
    sd[route] = 0.1 * torch.randn(shp[route], generator=g, device=device)
    return {k: sd[k].contiguous() for k in shp}


def honoured(cfg, device):
    """The configuration, checked: every key run as it says, on the
    configuration's ``device`` kind, and the primary capsules' nodes
    those that conv1 and the primary convs make of ``capsule_input``."""
    honour(cfg, READ, RECORDED)
    if torch.device(device).type != cfg["device"]:
        raise ValueError(f"configuration device {cfg['device']!r}, run on "
                         f"{torch.device(device).type!r}")
    side = ((cfg["capsule_input"] - cfg["conv1_kernel"] + 1
             - cfg["primary_kernel"]) // cfg["primary_stride"] + 1)
    if cfg["routing_nodes"] != cfg["primary_channels"] * side ** 2 \
            or cfg["in_dim"] != cfg["primary_caps"]:
        raise ValueError("routing_nodes and in_dim do not follow from the "
                         "conv widths and capsule_input")
    return cfg


def check_widths(cfg, model):
    """Raise where the port's module is not the configuration's: each
    width, the stride and the routing's iterations.  The leaves' shapes
    are held besides by the strict load of `make_state`'s state_dict."""
    prim = model.primary_capsules
    have = {
        "conv1_channels": model.conv1.out_channels,
        "conv1_kernel": model.conv1.kernel_size[0],
        "primary_caps": len(prim.capsules),
        "primary_channels": prim.capsules[0].out_channels,
        "primary_kernel": prim.capsules[0].kernel_size[0],
        "primary_stride": prim.stride,
        "routing_nodes": model.traffic_sign_capsules.route_weights.shape[1],
        "in_dim": model.traffic_sign_capsules.route_weights.shape[3],
        "out_dim": model.traffic_sign_capsules.route_weights.shape[4],
        "n_iter": model.traffic_sign_capsules.n_iter,
    }
    wrong = {k: (cfg[k], v) for k, v in have.items() if cfg[k] != v}
    if wrong:
        raise ValueError(f"the port's CapsuleNet is not the configuration's "
                         f"(key: (configured, built)): {wrong}")


def build_model(cfg, sd, device):
    _, _, _, CapsuleNet, resolve_routing_impl, _ = _port()
    model = CapsuleNet(
        n_classes=cfg["n_classes"], dtype=dtypes(cfg)[1],
        routing_impl=resolve_routing_impl(cfg["routing"], "capsule", device))
    check_widths(cfg, model)
    return load(model, sd, device)


def reference_scores(sd, pool, device, n_iter, tf32=False, block=64):
    """The reference's scores (n, K) of every centred host crop."""
    out = []
    with torch.no_grad(), precision(tf32=tf32):
        for i in range(0, len(pool), block):
            x = torch.from_numpy(pool[i:i + block]).to(device)
            out.append(ref.scores(ref.capsules(sd, x, n_iter)).double()
                       .cpu().numpy())
    return np.concatenate(out)


def compare_scores(kept_ids, kept_scores, ref_s, bs):
    """class_flip: served ids that differ from the reference's argmax
    where its top two scores are more than CLASS_MARGIN of the best
    apart;
    score_err: the largest score error over the batches that kept their
    scores, each over the batch's largest reference score; with the
    counts compared."""
    top2 = np.sort(ref_s, 1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > CLASS_MARGIN * top2[:, 1]
    want = ref_s.argmax(1)
    flip = n = n_sure = 0
    for start, ids in kept_ids:
        r = slice(start, start + bs)
        flip += int(((ids != want[r]) & sure[r]).sum())
        n += len(ids)
        n_sure += int(sure[r].sum())
    err = max((float(np.abs(s - ref_s[start:start + bs]).max()
                     / np.abs(ref_s[start:start + bs]).max())
               for start, s in kept_scores), default=float("nan"))
    return {"score_err": err, "class_flip": flip, "crops": n,
            "crops_sure": n_sure, "crops_scored": len(kept_scores) * bs}


class Serve:
    """The serving closed loop's state: the host pool of centred crops,
    the classifier fn and what each batch returned."""

    def __init__(self, cfg, traffic, seed, device):
        export, resolve_device = _port()[:2]
        cfg = honoured(cfg, device)
        device = resolve_device(device)   # the port's f32 policy: no TF32
        self.cfg, self.device, self.bs = cfg, device, cfg["batch_size"]
        self.pool, sd = serve_inputs(cfg, traffic, seed, device)
        fresh_peak(device)
        self.fn = export.make_classifier_fn(build_model(cfg, sd, device))
        self.sd = {k: v.cpu() for k, v in sd.items()}
        del sd
        self.n_batches = len(self.pool) // self.bs
        self.count = 0
        self.phase = int(tr.stream_seed(seed, TAG_ORDER)) % SCORE_SHARE
        self.kept_ids, self.kept_scores = [], []
        self.flop_per_image = capsule_flop(cfg, recon=False)

    def next_batch(self):
        """The next slice of the pool, in order, as class_pred takes
        them: its first row."""
        start = (self.count % self.n_batches) * self.bs
        self.count += 1
        return start

    def serve(self, start, spans):
        with torch.inference_mode():
            with spans("stage"):
                x = torch.from_numpy(self.pool[start:start + self.bs]).to(
                    self.device)
            with spans("forward"):
                scores, ids = self.fn(x)
            with spans("fetch"):
                return ids.cpu().numpy(), scores

    def keep(self, start, out):
        ids, scores = out
        self.kept_ids.append((start, ids))
        if not self.kept_scores or \
                len(self.kept_ids) % SCORE_SHARE == self.phase:
            self.kept_scores.append((start, scores))

    def release(self):
        self.fn = None
        self.kept_scores = [(s, t.double().cpu().numpy())
                            for s, t in self.kept_scores]

    def check(self):
        sd = {k: v.to(self.device) for k, v in self.sd.items()}
        ref_s = reference_scores(sd, self.pool, self.device,
                                 self.cfg["n_iter"])
        return compare_scores(self.kept_ids, self.kept_scores, ref_s,
                              self.bs)


def serve_inputs(cfg, traffic, seed, device):
    """The seed's host pool of centred crops (f32) and the state_dict."""
    g = tr.generator(seed, TAG_DATA, device)
    crops, _ = tr.crops(traffic["pool"], traffic["crop"], cfg["n_classes"],
                        g, device)
    pool = tr.center(crops.cpu().numpy().astype(np.float32))
    return pool, make_state(cfg, seed, device)


def serve_control(cfg, traffic, seed, device):
    """The control's numbers: the reference in TF32 put in the program's
    place, every pool batch served, its ids and scores compared."""
    pool, sd = serve_inputs(honoured(cfg, device), traffic, seed, device)
    bs = cfg["batch_size"]
    low = reference_scores(sd, pool, device, cfg["n_iter"],
                           tf32=control_tf32(cfg))
    starts = range(0, len(pool) - bs + 1, bs)
    ref_s = reference_scores(sd, pool, device, cfg["n_iter"])
    return compare_scores([(s, low[s:s + bs].argmax(1)) for s in starts],
                          [(s, low[s:s + bs]) for s in starts], ref_s, bs)


class Train(EpochTrain):
    """The captured training epochs over resident crops: the port's
    CapsuleNet (K3 forward, K4 backward on a card) with its
    reconstruction loss and Adam."""

    def __init__(self, cfg, traffic, seed, device):
        _, resolve_device, LossConfig, _, _, steps = _port()
        cfg = honoured(cfg, device)
        device = resolve_device(device)   # the port's f32 policy: no TF32
        self.cfg, self.bs, self.lr = cfg, cfg["batch_size"], cfg["lr"]
        g = tr.generator(seed, TAG_DATA, device)
        crops, self.y = tr.crops(traffic["n"], traffic["crop"],
                                 cfg["n_classes"], g, device)
        self.x = tr.center(crops.float())
        del crops
        sd = make_state(cfg, seed, device)
        self.sd0 = {k: v.cpu() for k, v in sd.items()}
        fresh_peak(device)
        self.model = build_model(cfg, sd, device).train()
        del sd
        self.opt = steps.make_optimizer(self.model, cfg["lr"])
        capture = (steps.GraphCapture(device, [])
                   if torch.device(device).type == "cuda" else None)
        loss_cfg = LossConfig(n_classes=cfg["n_classes"],
                              recon=cfg["recon"],
                              recon_coef=cfg["recon_coef"])
        self.epoch_fn = steps.make_train_epoch(
            self.model, self.opt, loss_cfg, cfg["model"], capture=capture)
        self.flop_per_image = capsule_flop(cfg, recon=cfg["recon"],
                                           train=True)
        self.start(seed, device)

    def ref_loss(self, params, idx, generator):
        cfg = self.cfg
        return ref.loss(params, self.x[idx], self.y[idx], cfg["n_classes"],
                        cfg["recon_coef"] if cfg["recon"] else 0.0,
                        cfg["n_iter"])
