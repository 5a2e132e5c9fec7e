"""Host data utilities (numpy): the synthetic sets and `center_rgb` of
the JAX data/loader.py.

`synthetic_dataset` draws from the same private ``RandomState(0)``
stream as the JAX package, so its crops, scenes and labels are
byte-equal.
"""

import numpy as np

from ..ops import boxes as box_ops

DETECTION_MODELS = ("darknet_d", "darknet_r")
CLASSIFIER_MODELS = ("cnn", "capsule")


def center_rgb(x):
    """uint8-range pixels -> centered floats in [-1, 1]."""
    return (x - 128.0) / 128


def _synthetic_classification(templates, n, rng):
    # one prototype per class, shared by the train and eval draws
    n_classes = templates.shape[0]
    y = (np.arange(n) % n_classes).astype(np.int64)
    x = templates[y] + 0.1 * rng.randn(n, *templates.shape[1:])
    return np.clip(x, -1.0, 1.0).astype(np.float32), y


def _synthetic_detection(params, n, rng, size):
    g = int(params.n_grid)
    n_classes = int(params.get("n_classes", 0) or 0)
    x = rng.uniform(-1.0, -0.8, (n, size, size, 3)).astype(np.float32)
    y = np.zeros((n, g, g, 5 + n_classes), np.float32)
    lo, hi = max(size // 8, 2), max(size // 3, 3)
    for i in range(n):
        w = int(rng.randint(lo, hi))
        h = int(rng.randint(lo, hi))
        x1 = int(rng.randint(0, size - w))
        y1 = int(rng.randint(0, size - h))
        c = i % n_classes if n_classes else 0
        # a flat, bright, class-tinted rectangle = the "sign"
        tint = 0.4 + 0.6 * ((c % 7) / 6.0)
        x[i, y1:y1 + h, x1:x1 + w, :] = [tint, 1.0 - tint, 0.8]
        cwh = box_ops.xy_to_cwh([x1, y1, x1 + w, y1 + h])
        (xc, yc, bw, bh), (row, col) = box_ops.normalize_box_cwh(
            (size, size), g, cwh)
        y[i, row, col, 0:5] = [1.0, xc, yc, bw, bh]
        if n_classes:
            y[i, row, col, 5 + c] = 1.0
    return x, y


def synthetic_dataset(model_name, params, n_train, n_eval):
    """Deterministic synthetic (x_tr, y_tr, x_ev, y_ev): class-separable
    centered crops (``capsule_input`` px, default 32) with int labels for
    a classifier; one synthetic sign per centered scene with its YOLO
    grid label for a detector."""
    rng = np.random.RandomState(0)
    if model_name in CLASSIFIER_MODELS:
        n_classes = int(params.get("n_classes", 43) or 43)
        size = int(params.get("capsule_input", 32) or 32)
        templates = rng.uniform(-1.0, 1.0, (n_classes, size, size, 3))
        x_tr, y_tr = _synthetic_classification(templates, n_train, rng)
        x_ev, y_ev = _synthetic_classification(templates, n_eval, rng)
        return x_tr, y_tr, x_ev, y_ev
    if model_name not in DETECTION_MODELS:
        ported = " | ".join(CLASSIFIER_MODELS + DETECTION_MODELS)
        raise ValueError(f"synthetic data for {model_name!r} is not ported "
                         f"yet: {ported}")
    size = int(params.darknet_input)
    x_tr, y_tr = _synthetic_detection(params, n_train, rng, size)
    x_ev, y_ev = _synthetic_detection(params, n_eval, rng, size)
    return x_tr, y_tr, x_ev, y_ev
