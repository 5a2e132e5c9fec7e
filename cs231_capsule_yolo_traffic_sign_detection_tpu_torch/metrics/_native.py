"""ctypes binding of the native confusion sweep (csrc/confusion.cpp),
the counterpart of the JAX metrics/_native.py and native_util.py.

The port's own copy of the JAX package's ``native/confusion.cpp`` is
compiled with g++ at its first use (`native.build`: into
``build/native/``, a failed build raises; `confusion_sweep(use_native=
False)` is the numpy path, asked for by name).
"""

import ctypes
import functools

import numpy as np

from .. import native


def build():
    """Compile csrc/confusion.cpp if needed; returns the library path."""
    return native.build("confusion.cpp", "libconfusion")


@functools.lru_cache(maxsize=None)
def library():
    """The loaded library, built on first use, with argtypes set."""
    lib = ctypes.CDLL(build())
    dp = ctypes.POINTER(ctypes.c_double)
    lp = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    lib.confusion_sweep_image.argtypes = [dp, dp, i64, dp, dp, i64,
                                          dp, i64, dp, i64, lp, lp, lp]
    lib.confusion_sweep_image.restype = None
    return lib


def _ptr(a, ctype=ctypes.c_double):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def confusion_sweep_native(gt, pred, iou_ths, conf_ths, cls_filter=None):
    """metrics.detection.confusion_sweep in C++: (TP, FP, FN) int64
    arrays of shape (n_iou, n_conf)."""
    lib = library()
    iou_ths = np.ascontiguousarray(iou_ths, np.float64).ravel()
    conf_ths = np.ascontiguousarray(conf_ths, np.float64).ravel()
    n_i, n_c = iou_ths.size, conf_ths.size
    counts = [np.zeros(n_i * n_c, np.int64) for _ in range(3)]
    for gt_i, pr_i in zip(gt, pred):
        g_keep = (slice(None) if cls_filter is None
                  else gt_i["cls"] == cls_filter)
        p_keep = (slice(None) if cls_filter is None
                  else pr_i["cls"] == cls_filter)
        g_xy, g_conf, p_xy, p_conf = (
            np.ascontiguousarray(a, np.float64) for a in (
                gt_i["xy"][g_keep], gt_i["conf"][g_keep],
                pr_i["xy"][p_keep], pr_i["conf"][p_keep]))
        lib.confusion_sweep_image(
            _ptr(g_xy), _ptr(g_conf), g_conf.size,
            _ptr(p_xy), _ptr(p_conf), p_conf.size,
            _ptr(iou_ths), n_i, _ptr(conf_ths), n_c,
            *(_ptr(c, ctypes.c_int64) for c in counts))
    return tuple(c.reshape(n_i, n_c) for c in counts)
