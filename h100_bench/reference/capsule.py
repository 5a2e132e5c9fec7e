"""Plain CapsuleNet (the reference repo's models.py:46-123 and
loss_fns.py:11-23) over a state_dict in the reference's keys:
``conv1.{weight,bias}`` (9x9, 3 -> 256), ``primary_capsules.capsules.
{0..7}.{weight,bias}`` (8x8 stride 2, 256 -> 16 each),
``traffic_sign_capsules.route_weights`` (1, N, K, 8, 16) and the
decoder ``decoder.{0,4,7,10,12}.{weight,bias}``.  Plain PyTorch in
float32; nothing of the program.

Departures: the crops come NHWC and the reconstruction goes out NHWC
(the reference's tensors are NCHW); the routing runs in blocks of
capsules' votes exactly as written, three iterations.
"""

import torch
import torch.nn.functional as F


def squash(v):
    """|v|^2 / (1 + |v|^2) * v / |v| over the last axis."""
    n2 = (v * v).sum(-1, keepdim=True)
    return n2 / (1 + n2) * v / torch.sqrt(n2)


def primary(sd, x):
    """NHWC crops -> squashed primary capsules (B, 16 h w, 8): conv j's
    channel c at position p is vector element j of node c h w + p."""
    h = F.relu(F.conv2d(x.permute(0, 3, 1, 2), sd["conv1.weight"],
                        sd["conv1.bias"]))
    caps = [F.conv2d(h, sd[f"primary_capsules.capsules.{j}.weight"],
                     sd[f"primary_capsules.capsules.{j}.bias"], stride=2)
            .reshape(h.shape[0], -1, 1) for j in range(8)]
    return squash(torch.cat(caps, -1))


def route(u, w, n_iter=3):
    """Dynamic routing: u (B, N, 8), w (N, K, 8, 16) -> (B, K, 16).
    Votes u W per node and capsule; each iteration a softmax over the K
    capsules, the vote sum over the nodes, the squash, and (but the
    last) the agreement added to the logits."""
    priors = torch.einsum("bni,nkio->bnko", u, w)
    logits = torch.zeros(priors.shape[:3] + (1,), device=u.device)
    for it in range(n_iter):
        probs = torch.softmax(logits, dim=2)
        v = squash((probs * priors).sum(dim=1, keepdim=True))
        if it < n_iter - 1:
            logits = logits + (priors * v).sum(-1, keepdim=True)
    return v[:, 0]


def capsules(sd, x, n_iter=3):
    return route(primary(sd, x), sd["traffic_sign_capsules.route_weights"][0],
                 n_iter)


def scores(caps):
    return torch.sqrt((caps * caps).sum(-1))


def decoder(sd, t):
    """(B, 16) capsule -> (B, 32, 32, 3) NHWC reconstruction: dense to
    16x4x4, three times a nearest 2x upsample, 3x3 conv and relu, then a
    3x3 conv to 3 channels and tanh."""
    h = F.relu(F.linear(t, sd["decoder.0.weight"], sd["decoder.0.bias"]))
    h = h.reshape(-1, 16, 4, 4)
    for i in (4, 7, 10):
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = F.relu(F.conv2d(h, sd[f"decoder.{i}.weight"],
                            sd[f"decoder.{i}.bias"], padding=1))
    h = F.conv2d(h, sd["decoder.12.weight"], sd["decoder.12.bias"], padding=1)
    return torch.tanh(h).permute(0, 2, 3, 1)


def loss(sd, x, y, n_classes, recon_coef, n_iter=3):
    """The margin loss T relu(0.9 - s)^2 + 0.5 (1 - T) relu(s - 0.1)^2
    over every class plus ``recon_coef`` times the squared error of the
    reconstruction from the true class's capsule, divided by the
    batch."""
    caps = capsules(sd, x, n_iter)
    s = scores(caps)
    t = F.one_hot(y, n_classes).float()
    margin = (t * F.relu(0.9 - s) ** 2
              + 0.5 * (1 - t) * F.relu(s - 0.1) ** 2).sum()
    total = margin
    if recon_coef:
        rec = decoder(sd, caps[torch.arange(x.shape[0], device=x.device), y])
        total = total + recon_coef * ((x - rec) ** 2).sum()
    return total / x.shape[0]
