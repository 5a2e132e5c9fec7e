"""Losses (PyTorch port of the JAX losses.py): the capsule classifier's.

`LossConfig.from_params` reads the same keys with the same defaults as
the JAX one.  `capsule_loss` is the reference's (loss_fns.py:11-23):
the margin loss T relu(0.9 - s)^2 + 0.5 (1 - T) relu(s - 0.1)^2 summed
over every entry, plus ``recon_coef * sum((x - recon)^2)`` when the
reconstruction is on, all divided by the batch size.  Both return
``(loss, aux)`` as the JAX losses do.  The detector losses are not
ported yet.
"""

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Static loss hyperparameters extracted from Params."""

    n_classes: int = 43
    n_boxes: int = 2
    n_grid: int = 14
    darknet_input: int = 448
    l_coord: float = 5.0
    l_noobj: float = 0.5
    recon: bool = True
    recon_coef: float = 5e-4

    @classmethod
    def from_params(cls, params):
        return cls(
            n_classes=int(params.get("n_classes", 43)),
            n_boxes=int(params.get("n_boxes", 2)),
            n_grid=int(params.get("n_grid", 14)),
            darknet_input=int(params.get("darknet_input", 448)),
            l_coord=float(params.get("l_coord", 5.0)),
            l_noobj=float(params.get("l_noobj", 0.5)),
            recon=bool(params.get("recon", True)),
            recon_coef=float(params.get("recon_coef", 5e-4)),
        )


def capsule_loss(scores, y, cfg, x=None, recon=None):
    """Margin loss + optional reconstruction squared error, / batch.

    scores (B, n_classes) f32, y (B,) int labels, x and recon (B, 32, 32,
    3) f32 crops and their reconstruction."""
    left = F.relu(0.9 - scores) ** 2
    right = F.relu(scores - 0.1) ** 2
    # one-hot by comparison: F.one_hot checks the labels' range on the
    # host, which waits for the card once per step
    labels = (y.long()[:, None] == torch.arange(
        cfg.n_classes, device=scores.device)).to(scores.dtype)
    loss = (labels * left + 0.5 * (1.0 - labels) * right).sum()
    if cfg.recon and recon is not None:
        loss = loss + cfg.recon_coef * ((x - recon) ** 2).sum()
    return loss / y.shape[0], {}
