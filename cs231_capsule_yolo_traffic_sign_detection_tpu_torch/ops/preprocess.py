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

from .. import profiling


def preprocess_batch(images_u8, size):
    """(B, H, W, 3) uint8 tensor -> (B, size, size, 3) float32, NHWC."""
    x = images_u8.float()
    if x.shape[1:3] != (size, size):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                          mode="bilinear", align_corners=False,
                          antialias=False).permute(0, 2, 3, 1).contiguous()
    return x


def preprocess_images(images, size, device):
    """List of host uint8 frames (any sizes) -> device batch, NHWC f32.

    Recorded as a ``cyt.stage`` span, its ``np.stack`` as
    ``cyt.stage.gather`` and each copy to ``device`` as
    ``cyt.stage.copy`` (`profiling`)."""
    with profiling.span(profiling.STAGE, images=len(images)):
        if len({im.shape for im in images}) == 1:
            with profiling.span(profiling.STAGE_GATHER):
                host = torch.from_numpy(np.stack(images))
            return preprocess_batch(_copy(host, device), size)
        return torch.cat([
            preprocess_batch(_copy(torch.from_numpy(
                np.ascontiguousarray(im))[None], device), size)
            for im in images])


def _copy(host, device):
    """``host.to(device)`` as a ``cyt.stage.copy`` span of the bytes it
    moves (0 when ``device`` is the host)."""
    moved = 0 if torch.device(device).type == "cpu" else host.nbytes
    with profiling.span(profiling.STAGE_COPY, bytes=moved):
        return host.to(device)
