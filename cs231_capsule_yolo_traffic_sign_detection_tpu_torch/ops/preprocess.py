"""On-device image preprocessing (counterpart of the JAX ops/preprocess.py).

Frames go to the device as uint8 and are resized there with plain
bilinear sampling (``align_corners=False, antialias=False``, the
sampling of cv2.INTER_LINEAR up to rounding details).  The port needs
no cv2.  A frame already at the network's input size passes through
unchanged.  Detector inputs are not centered: the reference's predict
path feeds raw 0-255 values, and the port keeps that quirk.

Frames of one shape bound for a CUDA device are written into pinned
host memory a chunk at a time, each chunk copied to the card without
blocking as soon as it is written, so the copy engine moves one chunk
while the host writes the next (`stage_chunks`).  The pinned memory
comes from torch's caching host allocator: allocated once, reused by
later calls, and not handed out again until the copies that read it
have run on the card.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import profiling

# frames written between two copies to the card: on an H100's host 4
# stages 32 frames of 1360x800 sooner than 1, 2, 8 or 32 (PERF.md).  The
# write is ``np.stack``'s one thread: torch's threaded copy has the lower
# median there but the far longer tail
CHUNK_FRAMES = 4


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

    Frames of one shape on a CUDA device go through pinned memory in
    chunks (`stage_chunks`); elsewhere frames of one shape are
    ``np.stack``-ed and copied at once, and frames of mixed shapes one
    by one.  Recorded as a ``cyt.stage`` span (``images``; ``pinned``,
    the images staged through pinned memory), each gather into one host
    array as ``cyt.stage.gather`` and each copy to ``device`` as
    ``cyt.stage.copy`` (`profiling`)."""
    uniform = len({im.shape for im in images}) == 1
    pinned = uniform and torch.device(device).type == "cuda"
    with profiling.span(profiling.STAGE, images=len(images),
                        pinned=len(images) if pinned else 0):
        if pinned:
            shape = (len(images),) + images[0].shape
            host = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
            x = torch.empty(shape, dtype=torch.uint8, device=device)
            return preprocess_batch(stage_chunks(images, host, x), size)
        if uniform:
            with profiling.span(profiling.STAGE_GATHER):
                host = torch.from_numpy(np.stack(images))
            return preprocess_batch(_copy(host, device), size)
        return torch.cat([
            preprocess_batch(_copy(torch.from_numpy(
                np.ascontiguousarray(im))[None], device), size)
            for im in images])


def stage_chunks(images, host, dest):
    """Write the frames ``images`` into ``host``, a host tensor of their
    stacked shape, `CHUNK_FRAMES` at a time, and after each chunk copy
    its rows into the same rows of ``dest`` without blocking; returns
    ``dest``.  From pinned memory to a card the copy runs on the copy
    engine while the next chunk is written.  Each chunk's write is a
    ``cyt.stage.gather`` span, each copy's enqueue a ``cyt.stage.copy``
    span of its bytes (0 when ``dest`` is on the host).  ``host`` must
    not be written again until those copies have run."""
    rows = host.numpy()
    to_card = dest.device.type != "cpu"
    for i in range(0, len(images), CHUNK_FRAMES):
        j = min(i + CHUNK_FRAMES, len(images))
        with profiling.span(profiling.STAGE_GATHER):
            np.stack(images[i:j], out=rows[i:j])
        with profiling.span(profiling.STAGE_COPY,
                            bytes=host[i:j].nbytes if to_card else 0):
            dest[i:j].copy_(host[i:j], non_blocking=True)
    return dest


def _copy(host, device):
    """``host.to(device)`` as a ``cyt.stage.copy`` span of the bytes it
    moves (0 when ``device`` is the host)."""
    moved = 0 if torch.device(device).type == "cpu" else host.nbytes
    with profiling.span(profiling.STAGE_COPY, bytes=moved):
        return host.to(device)
