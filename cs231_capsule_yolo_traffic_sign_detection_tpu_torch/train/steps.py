"""Train and eval steps (counterpart of the JAX train/steps.py).

`train_step` is one forward with the reconstruction, the loss, the
backward (K4 on a card) and one Adam update.  optax's ``scale_by_adam``
with ``-lr`` applied, as the JAX step does it, is torch's Adam with
betas (0.9, 0.999) and eps 1e-8.  The learning rate is set on the
optimizer before each step, from the plateau schedule.  Master
parameters and Adam moments stay f32 whatever the compute dtype: under
bf16 only the convs and the decoder compute in bf16, and K3/K4 run in
their bf16-storage mode.  Nothing here syncs the host with the card.
"""

import torch

from ..losses import capsule_loss


def make_optimizer(model, lr=1e-3):
    """Adam with torch defaults (the reference's, main.py:280)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def loss_and_scores(model, x, y, loss_cfg):
    """Forward (with the reconstruction when the loss wants it) and the
    loss; returns (loss, scores)."""
    if loss_cfg.recon:
        scores, recon = model(x, y, recon=True)
        loss, _ = capsule_loss(scores, y, loss_cfg, x, recon)
    else:
        scores = model(x)
        loss, _ = capsule_loss(scores, y, loss_cfg)
    return loss, scores


def train_step(model, opt, x, y, lr, loss_cfg):
    """One Adam step on the batch (x NHWC f32, y int labels); returns the
    loss (a 0-d tensor) and the scores, both detached, on x's device."""
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    loss, scores = loss_and_scores(model, x, y, loss_cfg)
    loss.backward()
    opt.step()
    return loss.detach(), scores.detach()


def eval_step(model, x, y, loss_cfg):
    """Loss and scores on the batch, with the reconstruction as in
    training (the JAX eval does the same), no gradient."""
    with torch.no_grad():
        return loss_and_scores(model, x, y, loss_cfg)
