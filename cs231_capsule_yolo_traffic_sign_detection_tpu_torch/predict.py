"""Inference (counterpart of the JAX predict.py: dark_pred, class_pred).

`dark_pred`: restore the reference-format checkpoint, fold BN, resize
on the device, run the serving forward (ops/input_stage.
darknet_serving_apply: the input-stage and pool+leaky kernels on a
card) batch by batch, decode the full grid on the device and flatten
the boxes in grid-scan order.  Box drawing is not ported.

`class_pred`: restore CapsuleNet and score crops batch by batch (the
fused routing kernel on a card).
"""

import numpy as np
import torch

from .device import compute_dtype, resolve_device
from .models import CapsuleNet, DarkNet
from .ops import decode as decode_ops
from .ops.input_stage import darknet_serving_apply, prepare_serving
from .ops.preprocess import preprocess_images
from .train import checkpoint as ckpt


def restore_darknet(params, model_dir, restore_file):
    """DarkNet with weights from ``<model_dir>/<restore_file>.ckpt``, or
    the same file under ``model_dir + str(train_frac)`` where training
    writes it (strict load), on the CPU."""
    path = ckpt.checkpoint_path(model_dir, restore_file)
    print("Restoring parameters from {}".format(path))
    raw = ckpt.load_checkpoint(
        path, fallback_dirs=[model_dir + str(params.get("train_frac", 1))])
    model = DarkNet(n_boxes=int(params.n_boxes),
                    n_classes=int(params.n_classes))
    model.load_state_dict(raw["state_dict"], strict=True)
    return model.eval()


def dark_pred(images, model_dir, params, restore_file, device="cuda",
              conf_th=0.5):
    """Darknet detection inference.

    images: uint8 (H, W, 3) frames, fed uncentered (0-255) as the
    reference's predict path does.  ``params.compute_dtype`` selects
    float32 or bfloat16 serving (heads stay f32).  Returns the y_hat grid
    (numpy, f32) and (image_indices, boxes_xy, classes_or_None) with
    boxes in each image's own frame.
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
    return y_hat.cpu().numpy(), boxes


def restore_capsule(params, model_dir, restore_file):
    """CapsuleNet with weights from ``<model_dir>/<restore_file>.ckpt``,
    or the same file under ``model_dir + str(train_frac)`` where training
    writes it (strict load), on the CPU, computing in
    ``params.compute_dtype``."""
    path = ckpt.checkpoint_path(model_dir, restore_file)
    print("Restoring parameters from {}".format(path))
    raw = ckpt.load_checkpoint(
        path, fallback_dirs=[model_dir + str(params.get("train_frac", 1))])
    model = CapsuleNet(
        n_classes=int(params.n_classes),
        dtype=compute_dtype(params.get("compute_dtype", "float32")))
    model.load_state_dict(raw["state_dict"], strict=True)
    return model.eval()


def class_pred(x, model_dir, params, restore_file, device="cuda"):
    """Classifier inference: scores (N, n_classes) f32 and argmax classes.

    x: centered crops (N, 32, 32, 3), run in batches of
    ``params.batch_size``.  Zero crops give empty arrays without a
    restore.
    """
    x = np.asarray(x, np.float32)
    if x.shape[0] == 0:  # zero crops from an upstream empty detection
        y_hat = np.zeros((0, params.n_classes), np.float32)
        return y_hat, np.zeros((0,), np.int64)
    dev = resolve_device(device)
    model = restore_capsule(params, model_dir, restore_file).to(dev)
    bs = int(params.batch_size)
    with torch.inference_mode():
        y_hat = torch.cat([model(torch.from_numpy(x[i:i + bs]).to(dev))
                           for i in range(0, x.shape[0], bs)])
    y_hat = y_hat.cpu().numpy()
    return y_hat, np.argmax(y_hat, axis=1)
