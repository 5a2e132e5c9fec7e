"""Classification metrics: top-1 accuracy, micro ROC-AUC, micro AP.

Counterpart of the JAX metrics/classification.py, in numpy only (the
card's machine has no sklearn).  `recog_auc` and `recog_pr` return the
micro averages the JAX functions return, computed as sklearn's
``roc_curve`` + ``auc`` and ``average_precision_score(average="micro")``
compute them: the one-hot labels and the scores are flattened, tied
scores form one threshold, and ROC points collinear with their
neighbours are dropped before the trapezoid sum.  The per-class curves
are not computed (the JAX functions draw only the micro ones).  With
``save`` the micro curves are written as the JAX package's
``r_auc.png`` and ``r_pr.png``, drawn by metrics/plots.py (no text,
no fill under the step).
"""

import os

import numpy as np

from .. import config
from . import plots


def recog_acc(y, y_hat, params=None):
    """Top-1 accuracy."""
    y = np.asarray(y)
    return np.sum(y == np.argmax(y_hat, axis=1)) / y.shape[0]


def _micro(y, y_hat, n_classes):
    """Flattened one-hot labels and scores."""
    y1 = np.eye(n_classes)[np.asarray(y)]
    return y1.ravel(), np.asarray(y_hat).ravel()


def _threshold_counts(y_true, y_score):
    """False and true positives (f64) at each distinct score, from the
    highest score down; a tie counts once, at its end."""
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    idx = np.r_[np.nonzero(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true.astype(np.float64), dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps


def _plot_path(params, save_dir, name):
    return os.path.join(save_dir if save_dir is not None
                        else config.model_dir[params.model], name)


def recog_auc(y, y_hat, params, save=False, save_dir=None):
    """Micro-averaged ROC-AUC; ``save`` writes the micro ROC step curve
    (dark orange) and the diagonal (navy) to ``<save_dir>/r_auc.png``."""
    fps, tps = _threshold_counts(*_micro(y, y_hat, int(params.n_classes)))
    if fps.shape[0] > 2:  # drop points collinear with their neighbours
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                     True]
        fps, tps = fps[keep], tps[keep]
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    # the trapezoid rule as sklearn's auc evaluates it
    if save:
        plots.save_plot(_plot_path(params, save_dir, "r_auc.png"),
                        [(*plots.step_post(fpr, tpr), "#ff8c00"),
                         ([0, 1], [0, 1], "#000080")],
                        (0.0, 1.0), (0.0, 1.05))
    d = fpr[1:] - fpr[:-1]
    return float(np.sum(d * (tpr[1:] + tpr[:-1]) / 2.0, dtype=np.float64))


def recog_pr(y, y_hat, params, save=False, save_dir=None):
    """Micro-averaged average precision (the step integral of the
    precision-recall curve); ``save`` writes the micro PR step curve
    (blue) to ``<save_dir>/r_pr.png``."""
    fps, tps = _threshold_counts(*_micro(y, y_hat, int(params.n_classes)))
    ps = tps + fps
    precision = np.where(ps != 0, tps / ps, 0.0)
    recall = tps / tps[-1]
    precision = np.concatenate((precision[::-1], [1.0]))
    recall = np.concatenate((recall[::-1], [0.0]))
    if save:
        plots.save_plot(_plot_path(params, save_dir, "r_pr.png"),
                        [(*plots.step_post(recall, precision), "#0000ff")],
                        (0.0, 1.0), (0.0, 1.05))
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))
