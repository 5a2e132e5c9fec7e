"""Parameter initialisation from an explicit seed (counterpart of the
JAX models/init.py).

The reference relies on torch's default inits: U(-1/sqrt(fan_in),
+1/sqrt(fan_in)) for conv and linear weights and biases (kaiming-uniform
with a = sqrt(5)), and 0.1 * N(0, 1) for the capsule route weights
(reference models.py:57-58).  `init_capsulenet`, `init_darknet`,
`init_convnet` and `init_darkcapsule` draw all of them from one
``torch.Generator`` seeded from ``seed``, so a model's initial weights
depend on ``--seed`` and on nothing else; BatchNorm starts at scale 1,
bias 0, mean 0 and variance 1.  The JAX package's draws (jax.random)
differ from torch's; the tests carry weights across instead of
comparing inits.
"""

import math

import torch
import torch.nn as nn


def torch_default_(module, generator):
    """Re-draw a conv's or linear layer's weight and bias in place."""
    fan_in = module.weight[0].numel()
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        module.weight.uniform_(-bound, bound, generator=generator)
        if module.bias is not None:
            module.bias.uniform_(-bound, bound, generator=generator)


def route_weights_(param, generator):
    """0.1 * N(0, 1), in place."""
    with torch.no_grad():
        param.normal_(0.0, 1.0, generator=generator).mul_(0.1)


def _init_layers(model, seed):
    """Every conv and dense layer and every capsule layer's route weights
    from ``torch.Generator(seed)``, in registration order; BatchNorm reset
    to its defaults."""
    g = torch.Generator().manual_seed(int(seed))
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            torch_default_(module, g)
        elif isinstance(module, nn.BatchNorm2d):
            module.reset_parameters()
        elif isinstance(getattr(module, "route_weights", None), nn.Parameter):
            route_weights_(module.route_weights, g)
    return model


def init_capsulenet(model, seed=0):
    """Every parameter of a CapsuleNet from ``seed``: conv1, the primary
    capsules, the route weights, the decoder."""
    return _init_layers(model, seed)


def init_darknet(model, seed=0):
    """A DarkNet's conv weights (conv_1 .. conv_19) from ``seed``."""
    return _init_layers(model, seed)


def init_convnet(model, seed=0):
    """A ConvNet's convs and dense layers (cnn.0, 4, 10, 12) from
    ``seed``."""
    return _init_layers(model, seed)


def init_darkcapsule(model, seed=0):
    """A DarkCapsuleNet from ``seed``: conv_1 .. conv_5 (weights and
    biases), the route weights, the unused decoder; BN at 1/0/0/1."""
    return _init_layers(model, seed)
