"""On-device image preprocessing (counterpart of the JAX ops/preprocess.py).

Frames go to the device as uint8 and are resized there with plain
bilinear sampling (``align_corners=False, antialias=False``, the
sampling of cv2.INTER_LINEAR up to rounding details).  The port needs
no cv2.  A frame already at the network's input size passes through
unchanged.  Detector inputs are not centered: the reference's predict
path feeds raw 0-255 values, and the port keeps that quirk.
"""

import numpy as np
import torch
import torch.nn.functional as F


def preprocess_batch(images_u8, size):
    """(B, H, W, 3) uint8 tensor -> (B, size, size, 3) float32, NHWC."""
    x = images_u8.float()
    if x.shape[1:3] != (size, size):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                          mode="bilinear", align_corners=False,
                          antialias=False).permute(0, 2, 3, 1).contiguous()
    return x


def preprocess_images(images, size, device):
    """List of host uint8 frames (any sizes) -> device batch, NHWC f32."""
    if len({im.shape for im in images}) == 1:
        return preprocess_batch(
            torch.from_numpy(np.stack(images)).to(device), size)
    return torch.cat([
        preprocess_batch(torch.from_numpy(np.ascontiguousarray(im))[None]
                         .to(device), size)
        for im in images])
