"""Train and eval steps (counterpart of the JAX train/steps.py).

`train_step` is one forward (with the reconstruction for the capsule
classifier, with dropout from the trainer's generator for the darknet
detectors and the cnn classifier), the model's loss from `LOSS_REGISTRY`, the
backward (K4 on a card for the capsule classifier) and one Adam update.  optax's
``scale_by_adam`` with ``-lr`` applied, as the JAX step does it, is
torch's Adam with betas (0.9, 0.999) and eps 1e-8.  The learning rate
is set on the optimizer before each step, from the plateau schedule.
Master parameters and Adam moments stay f32 whatever the compute dtype.
Frozen parameters (``requires_grad=False``, fine-tuning) stay out of
Adam, as in the reference.  The loss, the outputs and the loss's aux
(``avg_iou`` for the darknet detectors) come back as tensors on the
device: nothing here syncs the host with the card.

Under a mesh (parallel/) a step runs one data rank's rows: ``shard`` (a
`parallel.collectives.BatchShard`) makes BatchNorm and dropout the
global batch's, and after the backward the gradients are averaged over
``grad_group`` (the data group) in one all-reduce, the node-sharded
route weights' too.  Every loss divides by its local batch, so equal
shards give the global mean.
"""

import torch

from ..losses import capsule_loss, cnn_loss, dark_loss, darkcapsule_loss
from ..parallel.collectives import all_reduce_grads

LOSS_REGISTRY = {"cnn": cnn_loss, "capsule": capsule_loss,
                 "darknet_d": dark_loss, "darknet_r": dark_loss,
                 "darkcapsule": darkcapsule_loss}


def make_optimizer(model, lr=1e-3):
    """Adam with torch defaults (the reference's, main.py:280) over the
    parameters that train."""
    return torch.optim.Adam([p for p in model.parameters()
                             if p.requires_grad], lr=lr,
                            betas=(0.9, 0.999), eps=1e-8)


def loss_and_scores(model, x, y, loss_cfg, model_name, generator=None,
                    shard=None):
    """Forward (with the reconstruction when the loss wants it; dropout
    masks from ``generator``; BN and dropout over the global batch of
    ``shard``) and the model's loss; returns (loss, outputs, aux)."""
    loss_fn = LOSS_REGISTRY[model_name]
    if model_name == "capsule" and loss_cfg.recon:
        scores, recon = model(x, y, recon=True)
        loss, aux = loss_fn(scores, y, loss_cfg, x, recon)
    else:
        kw = {} if generator is None else {"generator": generator}
        if shard is not None:
            kw["shard"] = shard
        scores = model(x, **kw)
        loss, aux = loss_fn(scores, y, loss_cfg)
    return loss, scores, aux


def train_step(model, opt, x, y, lr, loss_cfg, model_name, generator=None,
               shard=None, grad_group=None):
    """One Adam step on the batch (x NHWC, y labels or grids); returns the
    loss (a 0-d tensor) and the outputs, detached, and the aux (no
    gradient flows into it), on x's device.  Under a mesh: ``shard``
    for BN and dropout, and the gradients averaged over ``grad_group``
    before the update (a replicated batch passes neither: every rank
    already holds the whole batch's gradient)."""
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    loss, scores, aux = loss_and_scores(model, x, y, loss_cfg, model_name,
                                        generator, shard)
    loss.backward()
    if grad_group is not None:
        all_reduce_grads(model.parameters(), grad_group)
    opt.step()
    return loss.detach(), scores.detach(), aux


def eval_step(model, x, y, loss_cfg, model_name):
    """Loss, outputs and aux on the batch, with the reconstruction as in
    training (the JAX eval does the same), no gradient."""
    with torch.no_grad():
        return loss_and_scores(model, x, y, loss_cfg, model_name)
