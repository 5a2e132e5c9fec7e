"""Inference (counterpart of the JAX predict.py: dark_pred, class_pred,
dark_class_pred).

`dark_detect`: restore the reference-format checkpoint of a darknet
detector (darknet_r, B=1 C=43, or darknet_d, B=2 C=0), fold BN, resize
on the device, run the serving forward batch by batch (f32 / bf16:
ops/input_stage.darknet_serving_apply, the input-stage and pool+leaky
kernels on a card; int8: the calibrated int8-resident chain of
ops/quant.py), decode the full grid on the device, optionally NMS, and
flatten the boxes in grid-scan order; with ``crops``, also each box's
crop from its full-resolution frame.  `dark_pred` is the JAX function's
contract on top: the frames annotated (viz.py), the ground truth too.

`class_pred`: restore the classifier ``params.model`` names (CapsuleNet,
with the fused routing kernel on a card, or ConvNet) and score crops
batch by batch.

`dark_class_detect`: the two-stage detect-then-classify pipeline, on
either darknet detector (on darknet_d the combine metrics come out
nan / 0.0, as in the JAX package: metrics/detection.py).  By
default the reference's composition through the host (dark_detect's
crops, centered, through class_pred, then `combine_y_hat`); with
``device_crop`` one pass on the device per detector batch
(`_dark_class_pred_fused`).  `dark_class_pred` adds the annotated
frames, the JAX function's contract.

darkcapsule has no predict function, as in the reference (JAX
predict.py's registry): the CLI loads its test set and writes an empty
metric file.

Under a mesh (``mesh=``, parallel/; JAX predict.py:72-111) each data
rank serves its rows of every batch (the detector's K2 and K1, the
classifier's K3) on its device, and the outputs are all-gathered in row
order, so every rank holds the single-device result; a batch the data
axis does not divide is served whole on every rank.  The fused
``device_crop`` path is not split: every rank runs all of it.
"""

import itertools

import numpy as np
import torch

from . import export, viz
from .data.loader import center_rgb
from .device import compute_dtype, module_dtype, resolve_device
from .models import CapsuleNet, ConvNet, DarkCapsuleNet, DarkNet
from .models.registry import resolve_routing_impl
from .ops import decode as decode_ops, quant
from .ops.boxes import combine_y_hat, y_to_boxes_vec
from .ops.crop import frame_crops
from .ops.input_stage import darknet_serving_apply, prepare_serving
from .ops.preprocess import preprocess_images
from .parallel import mesh as par
from .train import checkpoint as ckpt


def _restore(model, params, model_dir, restore_file):
    """``model`` with weights from ``<model_dir>/<restore_file>.ckpt``, or
    the same file under ``model_dir + str(train_frac)`` where training
    writes it (strict load), in eval mode on the CPU."""
    path = ckpt.checkpoint_path(model_dir, restore_file)
    if par.is_primary():
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


def restore_capsule(params, model_dir, restore_file, device="cuda"):
    """CapsuleNet from its checkpoint (see `_restore`), computing in
    ``params.compute_dtype`` (f32 under int8: no quantized routing), with
    the routing ``params.routing_impl`` resolves to on ``device``."""
    return _restore(CapsuleNet(
        n_classes=int(params.n_classes),
        dtype=module_dtype(params.get("compute_dtype", "float32")),
        routing_impl=resolve_routing_impl(
            params.get("routing_impl", "auto"), "capsule", device)),
        params, model_dir, restore_file)


def restore_convnet(params, model_dir, restore_file, device="cuda"):
    """ConvNet from its checkpoint (see `_restore`), computing in
    ``params.compute_dtype`` (built f32 under int8: the fused path
    quantizes it, the host path serves it f32); ``device`` is unused (no
    routing to resolve), as in `CLASSIFIERS`' other entry."""
    return _restore(ConvNet(
        n_classes=int(params.n_classes),
        dtype=module_dtype(params.get("compute_dtype", "float32"))),
        params, model_dir, restore_file)


CLASSIFIERS = {"capsule": restore_capsule, "cnn": restore_convnet}


def restore_model(params, model_dir, restore_file, device="cuda"):
    """The eval-mode model of ``params.model`` (any of the five) from its
    checkpoint, in ``params.compute_dtype`` (f32 modules under int8), on
    ``device`` (JAX predict.restore_variables)."""
    if params.model in CLASSIFIERS:
        model = restore_classifier(params, model_dir, restore_file, device)
    elif params.model == "darkcapsule":
        model = _restore(DarkCapsuleNet(
            n_grid=int(params.n_grid),
            dtype=module_dtype(params.get("compute_dtype", "float32")),
            routing_impl=resolve_routing_impl(
                params.get("routing_impl", "auto"), "darkcapsule", device)),
            params, model_dir, restore_file)
    else:
        model = restore_darknet(params, model_dir, restore_file)
    return model.to(device)


def restore_classifier(params, model_dir, restore_file, device="cuda"):
    """The classifier ``params.model`` names, restored for ``device``."""
    if params.model not in CLASSIFIERS:
        raise ValueError(f"classifier {params.model!r} is not ported yet: "
                         f"{' | '.join(CLASSIFIERS)}")
    return CLASSIFIERS[params.model](params, model_dir, restore_file, device)


def _serve_batches(det, images, params, dev, mesh=None):
    """The detector over ``images`` in batches of ``params.batch_size``:
    yields each batch's input on the device (the port's resize, 0-255
    uncentered) and its f32 grid; under ``mesh``, of this rank's rows of
    the batch (`parallel.mesh.batch_rows`).

    ``params.compute_dtype`` float32 / bfloat16: the BN-folded serving
    forward (K2 for block 1, K1 at the other four pools on a card).
    int8 (JAX predict.py:153-171): BN folded, weights quantized and the
    18 activation scales calibrated on the FIRST batch, then the
    int8-resident chain (ops/quant.py: im2col and s8 x s8 -> s32
    products, int8 pools; neither K1 nor K2 runs); under a mesh every
    rank calibrates on the whole first batch."""
    dtype = compute_dtype(params.get("compute_dtype", "float32"))
    nb, nc = int(params.n_boxes), int(params.n_classes)
    size, bs = int(params.darknet_input), int(params.batch_size)
    sd = det.state_dict()
    p = None if dtype == torch.int8 else prepare_serving(sd, dtype)
    q = None
    for i in range(0, len(images), bs):
        n = len(images[i:i + bs])
        a, b = (0, n) if mesh is None else par.batch_rows(n, mesh)
        xb = preprocess_images(images[i + a:i + b], size, dev)
        if p is not None:
            yb = darknet_serving_apply(p, xb, n_boxes=nb, n_classes=nc,
                                       dtype=dtype)
        else:
            if q is None:   # static int8: calibrated once, on the whole batch
                x_cal = xb if (a, b) == (0, n) else preprocess_images(
                    images[i:i + bs], size, dev)
                q = quant.quantize_darknet(sd, x_cal=x_cal)
            yb = quant.darknet_int8_resident_apply(q, xb, n_boxes=nb,
                                                   n_classes=nc)
        yield xb, yb


def dark_detect(images, model_dir, params, restore_file, device="cuda",
                conf_th=0.5, use_nms=False, crops=False, mesh=None):
    """Darknet detection without drawing: the y_hat grid and the boxes.

    images: uint8 (H, W, 3) BGR frames, fed uncentered (0-255) as the
    reference's predict path does.  ``params.compute_dtype`` selects
    float32, bfloat16 or int8 serving (`_serve_batches`; heads f32).
    ``use_nms`` applies `decode_ops.nms_mask` after the decode (JAX
    predict.py:186-189; off by default, COMPAT #17).  Returns the y_hat
    grid (numpy, f32) and (image_indices, boxes_xy, classes_or_None)
    with boxes in each image's own frame; with ``crops``, returns
    (y_hat, crops, image_indices, boxes_xy) instead, the crops uint8
    (n_boxes, capsule_input, capsule_input, 3) cut from the frames
    (`ops.crop.frame_crops`).  Under ``mesh`` each rank serves its rows
    and the grid is gathered (module docstring).
    """
    dev = resolve_device(mesh.device if mesh else device)
    model = restore_darknet(params, model_dir, restore_file).to(dev)
    nb, nc = int(params.n_boxes), int(params.n_classes)
    size, bs = int(params.darknet_input), int(params.batch_size)
    image_hw = np.array([im.shape[0:2] for im in images])

    with torch.inference_mode():
        y_hat = par.gather_batches(
            [yb for _, yb in _serve_batches(model, images, params, dev,
                                            mesh)],
            [len(images[i:i + bs]) for i in range(0, len(images), bs)],
            mesh)
        decoded = decode_ops.decode_grid(
            y_hat, n_classes=nc, n_boxes=nb, img_size=size, conf_th=conf_th)
        if use_nms:
            decoded = dict(decoded, valid=decode_ops.nms_mask(
                decoded["xy"], decoded["conf"], decoded["valid"]))
        boxes = decode_ops.to_flat_host(
            decoded, image_hw=image_hw, img_size=size, with_classes=nc != 0)
        y_hat = y_hat.cpu().numpy()
        if not crops:
            return y_hat, boxes
        image_indices, boxes_xy, _ = boxes
        return (y_hat, frame_crops(images, image_indices, boxes_xy,
                                   int(params.capsule_input), dev),
                image_indices, boxes_xy)


def dark_pred(images, model_dir, params, restore_file, is_end=True,
              conf_th=0.5, y=None, use_nms=False, device="cuda", mesh=None):
    """Darknet detection inference, the JAX ``dark_pred`` contract
    (predict.py:114-222): `dark_detect`, then with ``is_end`` the frames
    annotated (`viz.draw_boxes_vec`: predictions green with their class
    names, and with ``y`` the ground truth's boxes red).  Returns
      is_end:  (y_hat grid, annotated frames)
      else:    (y_hat grid, crops, image_indices, boxes_xy).
    ``mesh``: see `dark_detect`.
    """
    out = dark_detect(images, model_dir, params, restore_file,
                      device=device, conf_th=conf_th, use_nms=use_nms,
                      crops=not is_end, mesh=mesh)
    if not is_end:
        return out
    y_hat, (image_indices, boxes_xy, classes) = out
    output_images, _ = viz.draw_boxes_vec(images, image_indices, boxes_xy,
                                          classes)
    if y is not None:
        t_idx, t_xy, t_cls = y_to_boxes_vec(
            y, params, image_hw=np.array([im.shape[:2] for im in images]),
            conf_th=conf_th)
        output_images, _ = viz.draw_boxes_vec(output_images, t_idx, t_xy,
                                              t_cls, color=(0, 0, 255))
    return y_hat, output_images


def class_pred(x, model_dir, params, restore_file, device="cuda",
               mesh=None):
    """Classifier inference: scores (N, n_classes) f32 and argmax classes.

    x: centered crops (N, 32, 32, 3), run in batches of
    ``params.batch_size`` through the classifier ``params.model`` names
    (under ``mesh``, each rank its rows of each batch, gathered).  Zero
    crops give empty arrays without a restore.
    """
    x = np.asarray(x, np.float32)
    if x.shape[0] == 0:  # zero crops from an upstream empty detection
        y_hat = np.zeros((0, params.n_classes), np.float32)
        return y_hat, np.zeros((0,), np.int64)
    dev = resolve_device(mesh.device if mesh else device)
    model = restore_classifier(params, model_dir, restore_file, dev).to(dev)
    bs = int(params.batch_size)
    batches = [torch.from_numpy(x[i:i + bs]) for i in range(0, x.shape[0], bs)]
    with torch.inference_mode():
        y_hat = par.gather_batches(
            [model(xb.to(dev) if mesh is None
                   else par.place_batch((xb,), mesh)[0]) for xb in batches],
            [xb.shape[0] for xb in batches], mesh)
    y_hat = y_hat.cpu().numpy()
    return y_hat, np.argmax(y_hat, axis=1)


def dark_class_detect(images, dark_model_dir, dark_params,
                      class_model_dir, class_params, restore_file,
                      device="cuda", device_crop=False, max_crops=16,
                      mesh=None):
    """Two-stage detect-then-classify pipeline, without drawing.

    The detector's checkpoint comes from ``dark_model_dir``, the
    classifier's (``class_params.model``: capsule or cnn) from
    ``class_model_dir``, both ``restore_file``.  By default the
    reference's composition: `dark_detect`'s crops from the
    full-resolution frames, centered, through `class_pred` (under
    --dtype int8 the int8 detector, then the classifier in f32, as the
    JAX package).  With ``device_crop`` one device pass per detector
    batch (`_dark_class_pred_fused`, its deviations there).  Returns the
    combined grid (`combine_y_hat`, float64) and the detections
    (image_indices, boxes_xy in each frame's pixels, the classifier's
    argmax classes).  ``mesh`` splits the host path's detector and
    classifier batches (`dark_detect`, `class_pred`); the fused path runs
    whole on the rank's device.
    """
    if device_crop:
        return _dark_class_pred_fused(
            images, dark_model_dir, dark_params, class_model_dir,
            class_params, restore_file,
            device=mesh.device if mesh else device, max_crops=max_crops)
    dark_y_hat, crops, image_indices, boxes_xy = dark_detect(
        images, dark_model_dir, dark_params, restore_file, device=device,
        crops=True, mesh=mesh)
    class_y_hat, classes = class_pred(center_rgb(crops), class_model_dir,
                                      class_params, restore_file,
                                      device=device, mesh=mesh)
    y_hat = combine_y_hat(images, dark_y_hat, class_y_hat, image_indices,
                          boxes_xy, dark_params)
    return y_hat, (image_indices, boxes_xy, classes)


def dark_class_pred(images, dark_model_dir, dark_params, class_model_dir,
                    class_params, restore_file, device="cuda",
                    device_crop=False, max_crops=16, mesh=None):
    """The two-stage pipeline with the JAX ``dark_class_pred`` contract
    (predict.py:225-272): `dark_class_detect`, then the frames annotated
    with the boxes and the classifier's class names, on both the host and
    the fused path.  Returns (combined grid, annotated frames)."""
    y_hat, (image_indices, boxes_xy, classes) = dark_class_detect(
        images, dark_model_dir, dark_params, class_model_dir, class_params,
        restore_file, device=device, device_crop=device_crop,
        max_crops=max_crops, mesh=mesh)
    output_images, _ = viz.draw_boxes_vec(images, image_indices, boxes_xy,
                                          classes)
    return y_hat, output_images


def _dark_class_pred_fused(images, dark_model_dir, dark_params,
                           class_model_dir, class_params, restore_file,
                           device="cuda", max_crops=16, conf_th=0.5):
    """Fused two-stage pipeline (JAX COMPAT #33): per detector batch, one
    pass on the device through the program the two-stage artifact holds
    (`export.make_serving_two_stage_fn`, as JAX predict.py builds it from
    export.make_two_stage_fn), then one fetch.  ``dark_params.
    compute_dtype`` runs the detector in f32 or bf16 (K2, K1) or int8,
    ``class_params``'s the classifier (the CLI sets both from --dtype).
    Under int8 the detector is calibrated on the first batch and the
    ConvNet runs as `quant.convnet_int8_apply`, calibrated on the crops
    `export.make_crops_fn` cuts from that batch with the f32 detector
    module (cuDNN, no kernel of the port); CapsuleNet stays f32 with K3
    (COMPAT #35).

    Deviations from the host composition (as in the JAX package): crops
    are sampled from the darknet_input-sized detector input, not the
    full-resolution frame, and only the top ``max_crops`` boxes of an
    image are classified; a message counts the above-threshold boxes
    that cap left out.  Same return contract as `dark_class_detect`.
    """
    dev = resolve_device(device)
    det = restore_darknet(dark_params, dark_model_dir, restore_file).to(dev)
    cls = restore_classifier(class_params, class_model_dir, restore_file,
                             dev).to(dev)
    nb = int(dark_params.n_boxes)
    size, bs = int(dark_params.darknet_input), int(dark_params.batch_size)
    image_hw = np.array([im.shape[:2] for im in images])
    common = dict(n_boxes=nb, n_classes=int(dark_params.n_classes),
                  img_size=size,
                  cap_input=int(class_params.get("capsule_input", 32)),
                  max_crops=max_crops, conf_th=conf_th, with_grid=True)

    with torch.inference_mode():
        batches = (preprocess_images(images[i:i + bs], size, dev)
                   for i in range(0, len(images), bs))
        first = next(batches)
        fn = export.make_serving_two_stage_fn(
            det, cls, dtype=compute_dtype(dark_params.get("compute_dtype",
                                                          "float32")),
            x_cal=first, **common)
        outs = [fn(xb) for xb in itertools.chain([first], batches)]
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
