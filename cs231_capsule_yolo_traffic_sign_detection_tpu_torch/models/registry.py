"""``--routing``: which routing the capsule models run (counterpart of
the JAX models/registry.py:resolve_routing_impl)."""

import torch

ROUTING_IMPLS = ("auto", "xla", "pallas")


def resolve_routing_impl(impl, model=None, device="cuda"):
    """"auto" -> the fused kernels K3/K4 where they win, the plain
    composition elsewhere; "xla" and "pallas" are kept as given.

    "pallas" is K3 (and K4 in training) on a card and their plain
    versions on the CPU, as the JAX package runs Pallas in interpret
    mode off the TPU; "xla" is the plain torch composition of
    ops/capsule.py, differentiated by autograd, on any device.  "auto"
    picks "pallas" for the capsule classifier on a card (K3 at batch 64
    takes a ninth of the plain composition's time on an H100,
    chip_smoke.py phase 27 measures both), and "xla" for darkcapsule and
    on the CPU, as the JAX rule keeps XLA off the TPU.  darkcapsule's one
    output capsule takes the closed form whatever the choice
    (models/capsule_net.py:CapsuleRouting)."""
    if impl not in ROUTING_IMPLS:
        raise ValueError(f"--routing {impl!r}: {' | '.join(ROUTING_IMPLS)}")
    if impl != "auto":
        return impl
    if model == "darkcapsule" or torch.device(device).type != "cuda":
        return "xla"
    return "pallas"
