"""Inference (counterpart of the JAX predict.py: dark_pred, class_pred,
dark_class_pred).

`dark_pred`: restore the reference-format checkpoint of a darknet
detector (darknet_r, B=1 C=43, or darknet_d, B=2 C=0), fold BN, resize
on the device, run the serving forward (ops/input_stage.
darknet_serving_apply: the input-stage and pool+leaky kernels on a
card) batch by batch, decode the full grid on the device and flatten
the boxes in grid-scan order; with ``crops``, also each box's crop from
its full-resolution frame.  Box drawing is not ported.

`class_pred`: restore the classifier ``params.model`` names (CapsuleNet,
with the fused routing kernel on a card, or ConvNet) and score crops
batch by batch.

`dark_class_pred`: the two-stage detect-then-classify pipeline, on
either darknet detector (on darknet_d the combine metrics come out
nan / 0.0, as in the JAX package: metrics/detection.py).  By
default the reference's composition through the host (dark_pred's
crops, centered, through class_pred, then `combine_y_hat`); with
``device_crop`` one pass on the device per detector batch
(`_dark_class_pred_fused`).

darkcapsule has no predict function, as in the reference (JAX
predict.py's registry): the CLI loads its test set and writes an empty
metric file.
"""

import numpy as np
import torch

from .data.loader import center_rgb
from .device import compute_dtype, resolve_device
from .models import CapsuleNet, ConvNet, DarkNet
from .ops import decode as decode_ops
from .ops.boxes import combine_y_hat
from .ops.crop import crop_resize_bilinear, frame_crops
from .ops.input_stage import darknet_serving_apply, prepare_serving
from .ops.preprocess import preprocess_images
from .train import checkpoint as ckpt


def _restore(model, params, model_dir, restore_file):
    """``model`` with weights from ``<model_dir>/<restore_file>.ckpt``, or
    the same file under ``model_dir + str(train_frac)`` where training
    writes it (strict load), in eval mode on the CPU."""
    path = ckpt.checkpoint_path(model_dir, restore_file)
    print("Restoring parameters from {}".format(path))
    raw = ckpt.load_checkpoint(
        path, fallback_dirs=[model_dir + str(params.get("train_frac", 1))])
    model.load_state_dict(raw["state_dict"], strict=True)
    return model.eval()


def restore_darknet(params, model_dir, restore_file):
    """DarkNet with ``params.n_boxes`` boxes and ``params.n_classes``
    classes (darknet_r, darknet_d) from its checkpoint (see
    `_restore`)."""
    return _restore(DarkNet(n_boxes=int(params.n_boxes),
                            n_classes=int(params.n_classes)),
                    params, model_dir, restore_file)


def restore_capsule(params, model_dir, restore_file):
    """CapsuleNet from its checkpoint (see `_restore`), computing in
    ``params.compute_dtype``."""
    return _restore(CapsuleNet(
        n_classes=int(params.n_classes),
        dtype=compute_dtype(params.get("compute_dtype", "float32"))),
        params, model_dir, restore_file)


def restore_convnet(params, model_dir, restore_file):
    """ConvNet from its checkpoint (see `_restore`), computing in
    ``params.compute_dtype``."""
    return _restore(ConvNet(
        n_classes=int(params.n_classes),
        dtype=compute_dtype(params.get("compute_dtype", "float32"))),
        params, model_dir, restore_file)


CLASSIFIERS = {"capsule": restore_capsule, "cnn": restore_convnet}


def restore_classifier(params, model_dir, restore_file):
    """The classifier ``params.model`` names, restored."""
    if params.model not in CLASSIFIERS:
        raise ValueError(f"classifier {params.model!r} is not ported yet: "
                         f"{' | '.join(CLASSIFIERS)}")
    return CLASSIFIERS[params.model](params, model_dir, restore_file)


def dark_pred(images, model_dir, params, restore_file, device="cuda",
              conf_th=0.5, crops=False):
    """Darknet detection inference.

    images: uint8 (H, W, 3) frames, fed uncentered (0-255) as the
    reference's predict path does.  ``params.compute_dtype`` selects
    float32 or bfloat16 serving (heads stay f32).  Returns the y_hat grid
    (numpy, f32) and (image_indices, boxes_xy, classes_or_None) with
    boxes in each image's own frame; with ``crops``, returns (y_hat,
    crops, image_indices, boxes_xy) instead, the crops uint8
    (n_boxes, capsule_input, capsule_input, 3) cut from the frames
    (`ops.crop.frame_crops`).
    """
    dev = resolve_device(device)
    dtype = compute_dtype(params.get("compute_dtype", "float32"))
    model = restore_darknet(params, model_dir, restore_file).to(dev)
    nb, nc = int(params.n_boxes), int(params.n_classes)
    size = int(params.darknet_input)
    bs = int(params.batch_size)
    image_hw = np.array([im.shape[0:2] for im in images])

    with torch.inference_mode():
        p = prepare_serving(model.state_dict(), dtype)
        outs = []
        for i in range(0, len(images), bs):
            xb = preprocess_images(images[i:i + bs], size, dev)
            outs.append(darknet_serving_apply(
                p, xb, n_boxes=nb, n_classes=nc, dtype=dtype))
        y_hat = torch.cat(outs)
        decoded = decode_ops.decode_grid(
            y_hat, n_classes=nc, n_boxes=nb, img_size=size, conf_th=conf_th)
        boxes = decode_ops.to_flat_host(
            decoded, image_hw=image_hw, img_size=size, with_classes=nc != 0)
        y_hat = y_hat.cpu().numpy()
        if not crops:
            return y_hat, boxes
        image_indices, boxes_xy, _ = boxes
        return (y_hat, frame_crops(images, image_indices, boxes_xy,
                                   int(params.capsule_input), dev),
                image_indices, boxes_xy)


def class_pred(x, model_dir, params, restore_file, device="cuda"):
    """Classifier inference: scores (N, n_classes) f32 and argmax classes.

    x: centered crops (N, 32, 32, 3), run in batches of
    ``params.batch_size`` through the classifier ``params.model`` names.
    Zero crops give empty arrays without a restore.
    """
    x = np.asarray(x, np.float32)
    if x.shape[0] == 0:  # zero crops from an upstream empty detection
        y_hat = np.zeros((0, params.n_classes), np.float32)
        return y_hat, np.zeros((0,), np.int64)
    dev = resolve_device(device)
    model = restore_classifier(params, model_dir, restore_file).to(dev)
    bs = int(params.batch_size)
    with torch.inference_mode():
        y_hat = torch.cat([model(torch.from_numpy(x[i:i + bs]).to(dev))
                           for i in range(0, x.shape[0], bs)])
    y_hat = y_hat.cpu().numpy()
    return y_hat, np.argmax(y_hat, axis=1)


def dark_class_pred(images, dark_model_dir, dark_params, class_model_dir,
                    class_params, restore_file, device="cuda",
                    device_crop=False, max_crops=16):
    """Two-stage detect-then-classify pipeline.

    The detector's checkpoint comes from ``dark_model_dir``, the
    classifier's (``class_params.model``: capsule or cnn) from
    ``class_model_dir``, both ``restore_file``.  By default the
    reference's composition: `dark_pred`'s crops from the
    full-resolution frames, centered, through `class_pred`.  With
    ``device_crop`` one device pass per detector batch
    (`_dark_class_pred_fused`, its deviations there).  Returns the
    combined grid (`combine_y_hat`, float64) and the detections
    (image_indices, boxes_xy in each frame's pixels, the classifier's
    argmax classes); box drawing is not ported.
    """
    if device_crop:
        return _dark_class_pred_fused(
            images, dark_model_dir, dark_params, class_model_dir,
            class_params, restore_file, device=device, max_crops=max_crops)
    dark_y_hat, crops, image_indices, boxes_xy = dark_pred(
        images, dark_model_dir, dark_params, restore_file, device=device,
        crops=True)
    class_y_hat, classes = class_pred(center_rgb(crops), class_model_dir,
                                      class_params, restore_file,
                                      device=device)
    y_hat = combine_y_hat(images, dark_y_hat, class_y_hat, image_indices,
                          boxes_xy, dark_params)
    return y_hat, (image_indices, boxes_xy, classes)


def two_stage_tail(x, y, classify, *, n_boxes, n_classes, img_size,
                   cap_input, max_crops, conf_th):
    """Decode -> crop -> center -> classify on the device: the fused
    pipeline after the detector (JAX export._two_stage_tail).

    x (B, S, S, 3) the detector's input, y (B, g, g, D) its grid; the top
    ``max_crops`` boxes of each image by confidence are cropped from x,
    those at or under ``conf_th`` as zeros, and ``classify`` scores all
    B * max_crops centered crops at once.  Returns the decode dict (see
    `decode_ops.decode_grid`) with ``class_scores`` (B, max_crops,
    n_classes) f32."""
    d = decode_ops.decode_grid(y, n_classes=n_classes, n_boxes=n_boxes,
                               img_size=img_size, max_boxes=max_crops,
                               conf_th=conf_th)
    crops = crop_resize_bilinear(x, d["xy"], cap_input, valid=d["valid"])
    b, m = crops.shape[:2]
    scores = classify(center_rgb(crops.reshape(b * m, cap_input, cap_input,
                                               -1)))
    return dict(d, class_scores=scores.float().reshape(b, m, -1))


def _dark_class_pred_fused(images, dark_model_dir, dark_params,
                           class_model_dir, class_params, restore_file,
                           device="cuda", max_crops=16, conf_th=0.5):
    """Fused two-stage pipeline (JAX COMPAT #33): per detector batch, on
    the device, the serving forward (K2, K1), `two_stage_tail` with the
    classifier (K3 once for CapsuleNet, at B = batch * max_crops), then
    one fetch.  ``dark_params.compute_dtype`` runs the detector in f32
    or bf16, ``class_params.compute_dtype`` the classifier (the CLI sets
    both from --dtype).

    Deviations from the host composition (as in the JAX package): crops
    are sampled from the darknet_input-sized detector input, not the
    full-resolution frame, and only the top ``max_crops`` boxes of an
    image are classified; a message counts the above-threshold boxes
    that cap left out.  Same return contract as `dark_class_pred`.
    """
    dev = resolve_device(device)
    dtype = compute_dtype(dark_params.get("compute_dtype", "float32"))
    det = restore_darknet(dark_params, dark_model_dir, restore_file).to(dev)
    cls = restore_classifier(class_params, class_model_dir,
                             restore_file).to(dev)
    nb, nc = int(dark_params.n_boxes), int(dark_params.n_classes)
    size = int(dark_params.darknet_input)
    bs = int(dark_params.batch_size)
    image_hw = np.array([im.shape[:2] for im in images])
    tail = dict(n_boxes=nb, n_classes=nc, img_size=size,
                cap_input=int(class_params.get("capsule_input", 32)),
                max_crops=max_crops, conf_th=conf_th)

    with torch.inference_mode():
        p = prepare_serving(det.state_dict(), dtype)
        outs = []
        for i in range(0, len(images), bs):
            xb = preprocess_images(images[i:i + bs], size, dev)
            yb = darknet_serving_apply(p, xb, n_boxes=nb, n_classes=nc,
                                       dtype=dtype)
            outs.append(dict(two_stage_tail(xb, yb, cls, **tail), grid=yb))
        out = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        y_hat = out.pop("grid").cpu().numpy()
        scores = out.pop("class_scores")

    n_above = int((y_hat[..., :5 * nb].reshape(len(images), -1, 5)[..., 0]
                   > conf_th).sum())
    n_kept = int(out["valid"].sum())
    if n_above > n_kept:
        print("[device_crop] {} above-threshold detections exceed the "
              "static cap (max_crops={}, kept {}); pass a larger "
              "--max_crops to classify them all".format(
                  n_above - n_kept, max_crops, n_kept))
    (image_indices, boxes_xy, _), extras = \
        decode_ops.to_flat_host_with_extras(
            out, {"scores": scores}, image_hw=image_hw, img_size=size,
            with_classes=True)
    class_y_hat = extras["scores"]  # to_flat_host's box order
    classes = (np.argmax(class_y_hat, axis=1) if class_y_hat.shape[0]
               else np.zeros(0, np.int64))
    y_hat = combine_y_hat(images, y_hat, class_y_hat, image_indices,
                          boxes_xy, dark_params)
    return y_hat, (image_indices, boxes_xy, classes)
