"""Capsule primitives: squash, votes and dynamic routing (plain PyTorch).

Counterpart of the JAX ops/capsule.py, as plain tensor functions:

  * `squash` — the capsule nonlinearity, with the JAX package's 1e-12
    guard against 0/0 at a zero-norm capsule;
  * `compute_priors` — the votes ``x @ W`` per (node, capsule);
  * `dynamic_routing` — routing by agreement: softmax over the capsule
    axis, node sum, squash, and n_iter - 1 agreement updates;
  * `routed_single_capsule` — the closed form for one output capsule;
  * `capsule_norm` — the class score.

The fused CUDA kernel of ops/routing.py computes compute_priors +
dynamic_routing in one op; these functions are its plain version.
`node_sharded_routing` is the plain routing over a rank's share of the
nodes under a mesh's model axis.
"""

import torch

from ..parallel.collectives import enter_shard, leave_shard

SQUASH_EPS = 1e-12


def squash(v, dim=-1):
    """(|v|^2 / (1 + |v|^2)) * v / |v| along ``dim``."""
    squared_norm = (v * v).sum(dim=dim, keepdim=True)
    scale = squared_norm / (1.0 + squared_norm)
    return scale * v * torch.rsqrt(squared_norm + SQUASH_EPS)


def compute_priors(x, route_weights):
    """Votes: x (B, N, in_C), route_weights (N, K, in_C, D) -> (B, N, K, D)."""
    return torch.einsum("bni,nkio->bnko", x, route_weights)


def dynamic_routing(priors, n_iter=3):
    """Routing by agreement over votes (B, N, K, D) -> (B, 1, K, D).

    The softmax normalises the logits over the capsule axis (dim 2), the
    weighted sum contracts the nodes, and the agreement ``sum_d priors *
    v`` is added to the logits on every iteration but the last.  The
    logits are kept as (B, N, K, 1): the JAX package broadcasts them over
    D, where every column holds the same values.
    """
    return routing_iterations(priors, n_iter)[0]


def routing_iterations(priors, n_iter=3):
    """`dynamic_routing` that also returns the node sums s_t of every
    iteration, (n_iter, B, K, D): the state the routing backward (K4)
    rebuilds the iterations from."""
    logits = priors.new_zeros(priors.shape[:3] + (1,))
    s_all = []
    for it in range(n_iter):
        probs = torch.softmax(logits, dim=2)
        s = (probs * priors).sum(dim=1, keepdim=True)
        s_all.append(s[:, 0])
        outputs = squash(s)
        if it < n_iter - 1:
            logits = logits + (priors * outputs).sum(dim=-1, keepdim=True)
    return outputs, torch.stack(s_all)


def routed_single_capsule(x, route_weights):
    """Closed form of routing for one output capsule (K = 1): the softmax
    over a single capsule is 1, so every iteration gives squash(sum_n
    priors).  x (B, N, in_C), route_weights (N, 1, in_C, D) -> (B, 1, D).
    """
    return squash(torch.einsum("bni,nkio->bko", x, route_weights))


def capsule_norm(caps, dim=-1):
    """Capsule length |v|_2, the class score."""
    return torch.sqrt((caps * caps).sum(dim=dim))


def node_sharded_routing(x, w_shard, shard, n_iter=3):
    """`dynamic_routing` of `compute_priors` (or, for one output capsule,
    `routed_single_capsule`) with the nodes split over a mesh's model
    axis (JAX `_shard_routing`: the route weights sharded on axis 0).

    x (B, N, in_C), replicated over ``shard.group``; w_shard (N_s, K,
    in_C, D), this rank's nodes [shard.lo, shard.hi).  Each rank takes
    the votes of its nodes; the weighted node sum s of every iteration is
    all-reduced over the group (`leave_shard`), while the logits stay
    local, their softmax running over the capsules.  x and each
    iteration's v enter the sharded region through `enter_shard`, so
    their gradients are the sums of the ranks' parts.  Returns (B, K, D),
    replicated."""
    x = enter_shard(x, shard.group)[:, shard.lo:shard.hi]
    if w_shard.shape[1] == 1:
        return squash(leave_shard(
            torch.einsum("bni,nkio->bko", x, w_shard), shard.group))
    priors = compute_priors(x, w_shard)
    logits = priors.new_zeros(priors.shape[:3] + (1,))
    for it in range(n_iter):
        probs = torch.softmax(logits, dim=2)
        s = leave_shard((probs * priors).sum(dim=1, keepdim=True),
                        shard.group)
        outputs = squash(s)
        if it < n_iter - 1:
            logits = logits + (priors * enter_shard(
                outputs, shard.group)).sum(dim=-1, keepdim=True)
    return outputs[:, 0]
