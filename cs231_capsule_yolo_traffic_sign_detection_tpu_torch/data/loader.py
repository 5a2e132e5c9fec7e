"""Host data utilities (numpy), from the JAX data/loader.py: the stored
sets (`load_data`, `make_small_data`), `shuffle`, `center_rgb`, the
synthetic sets and `load_or_synthesize`.

`synthetic_dataset` draws from the same private ``RandomState(0)``
stream as the JAX package, so its crops, scenes and labels are
byte-equal; `load_or_synthesize` falls back to it with the same sizes.
"""

import pickle

import numpy as np

from .. import config
from ..ops import boxes as box_ops

DETECTION_MODELS = ("darknet_d", "darknet_r", "darkcapsule")
CLASSIFIER_MODELS = ("cnn", "capsule")
# synthetic fallback sizes (train, eval): classification sets are cheap
# (32x32); detection scenes at 448^2 are ~2.4 MB each; 3/3 for overfit
_SYNTH_FULL = {"classification": (512, 128), "detection": (64, 16)}
_SYNTH_SMALL = (3, 3)


def _strip_pickle_suffix(path):
    return path[:-2] if path.endswith(".p") else path


def load_data(data_dir, is_small=False, npy=False):
    """Load (x_tr, y_tr, x_ev, y_ev) from the build artifacts: pickles,
    or ``*_X.npy``/``*_Y.npy`` with ``npy``; small sets are pickles."""
    if is_small:
        train_path = data_dir + config.tr_sm_d
        eval_path = data_dir + config.ev_sm_d
        npy = False
    else:
        train_path = data_dir + config.tr_d
        eval_path = data_dir + config.ev_d
    if not npy:
        with open(train_path, "rb") as f:
            x_tr, y_tr = pickle.load(f)
        with open(eval_path, "rb") as f:
            x_ev, y_ev = pickle.load(f)
        return x_tr, y_tr, x_ev, y_ev
    train_stem = _strip_pickle_suffix(train_path)
    eval_stem = _strip_pickle_suffix(eval_path)
    return (np.load(train_stem + "_X.npy"), np.load(train_stem + "_Y.npy"),
            np.load(eval_stem + "_X.npy"), np.load(eval_stem + "_Y.npy"))


def make_small_data(data_dir, n=128, npy=False):
    """Write the first n train/eval samples as *_small.p pickles (the
    overfit mode's set)."""
    x_tr, y_tr, x_ev, y_ev = load_data(data_dir, npy=npy)
    with open(data_dir + config.tr_sm_d, "wb") as f:
        pickle.dump((x_tr[:n], y_tr[:n]), f)
    with open(data_dir + config.ev_sm_d, "wb") as f:
        pickle.dump((x_ev[:n], y_ev[:n]), f)


def shuffle(x, y):
    """Joint random permutation from the global np.random stream."""
    i = np.random.permutation(len(y))
    return x[i], y[i]


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
    grid label for a detector (5 + n_classes channels: 5 for darknet_d),
    at darknet_input px, or 32 * n_grid for darkcapsule, whose capsule
    grid needs that size."""
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
    if model_name == "darkcapsule":
        size = 32 * int(params.n_grid)
    x_tr, y_tr = _synthetic_detection(params, n_train, rng, size)
    x_ev, y_ev = _synthetic_detection(params, n_eval, rng, size)
    return x_tr, y_tr, x_ev, y_ev


def load_or_synthesize(data_dir, params, is_small=False, npy=False):
    """`load_data`, or the deterministic synthetic set sized for the mode
    (3/3 for overfit) when the artifacts are absent."""
    try:
        return load_data(data_dir, is_small=is_small, npy=npy)
    except (FileNotFoundError, OSError):
        pass
    model = params.get("model", "cnn")
    kind = ("classification" if model in CLASSIFIER_MODELS
            else "detection")
    n_train, n_eval = _SYNTH_SMALL if is_small else _SYNTH_FULL[kind]
    print("[data] artifacts missing under {!r}; using deterministic "
          "synthetic data ({} train / {} eval)".format(
              data_dir, n_train, n_eval))
    return synthetic_dataset(model, params, n_train, n_eval)
