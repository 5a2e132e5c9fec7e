"""Hyperspherical (polar) transform for the darkcapsule loss (PyTorch
port of the JAX ops/polar.py).

Maps a YOLO target vector (r, x, y, w, h) to a presence scalar r and a
5-d unit direction built from hyperspherical angles, so a capsule's
orientation can encode the box and its length the objectness.  The
angles are x * pi, y * pi, h * pi and w * 2 pi, h before w, and the
first component is sin(x * pi), as in the reference.
"""

import math

import torch


def polar_transform(x):
    """x: (..., 5) [r, x, y, w, h] -> (r (...), direction (..., 5))."""
    if x.shape[-1] != 5:
        raise ValueError("polar transform failed, dimension mismatched: "
                         f"{tuple(x.shape)}")
    r = x[..., 0]
    f1 = x[..., 1] * math.pi
    f2 = x[..., 2] * math.pi
    f3 = x[..., 4] * math.pi        # h
    f4 = x[..., 3] * math.pi * 2    # w
    s1 = torch.sin(f1)
    s2, c2 = torch.sin(f2), torch.cos(f2)
    s3, c3 = torch.sin(f3), torch.cos(f3)
    s4, c4 = torch.sin(f4), torch.cos(f4)
    return r, torch.stack([s1, s1 * c2, s1 * s2 * c3, s1 * s2 * s3 * c4,
                           s1 * s2 * s3 * s4], dim=-1)
