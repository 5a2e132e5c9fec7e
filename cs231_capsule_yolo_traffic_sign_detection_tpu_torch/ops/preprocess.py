"""On-device image preprocessing (counterpart of the JAX ops/preprocess.py).

Frames go to the device as uint8 and are resized there with plain
bilinear sampling (``align_corners=False, antialias=False``, the
sampling of cv2.INTER_LINEAR up to rounding details).  The port needs
no cv2.  A frame already at the network's input size passes through
unchanged.  Detector inputs are not centered: the reference's predict
path feeds raw 0-255 values, and the port keeps that quirk.

`stage` is the port's one way from host arrays to a device tensor:
frames here, the classifier's crops in `predict.class_pred` and the
streamed training batches in `train.driver.Trainer`.  Bound for a card,
the rows are written into pinned host memory a chunk at a time, each
chunk copied to the card without blocking as soon as it is written, so
the copy engine moves one chunk while the host writes the next.  The
pinned memory comes from torch's caching host allocator: allocated
once, reused by later calls, and not handed out again until the copies
that read it have run on the card.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import profiling

# rows (frames) written between two copies to the card: on an H100's
# host 4 stages 32 frames of 1360x800 sooner than 1, 2, 8 or 32
# (PERF.md).  The write is ``np.stack``'s one thread: torch's threaded
# copy has the lower median there but the far longer tail
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

    Frames of one shape are staged together (`stage`), frames of mixed
    shapes one by one, each with a ``.to(device)`` recorded as a
    ``cyt.stage.copy`` span of its bytes (0 when ``device`` is the host)
    in a ``cyt.stage`` span (``images``, ``pinned`` 0; `profiling`)."""
    if len({im.shape for im in images}) == 1:
        return preprocess_batch(stage(images, device), size)
    with profiling.span(profiling.STAGE, images=len(images), pinned=0):
        return torch.cat([
            preprocess_batch(_copy(torch.from_numpy(
                np.ascontiguousarray(im))[None], device), size)
            for im in images])


def stage(arrays, device):
    """Host arrays of one shape and dtype (a list, or an array's rows)
    -> their stack, a tensor on ``device``.

    The rows are written `CHUNK_FRAMES` at a time into a host tensor,
    pinned when ``device`` is a card, and after each chunk its rows are
    copied into the same rows of the result without blocking.  Recorded
    as a ``cyt.stage`` span (``images``, the rows; ``pinned``, those
    staged through pinned memory), each chunk's write as a
    ``cyt.stage.gather`` span and each copy's enqueue as a
    ``cyt.stage.copy`` span of its bytes (0 when ``device`` is the host;
    `profiling`)."""
    card = torch.device(device).type == "cuda"
    shape = (len(arrays),) + np.shape(arrays[0])
    dtype = torch.from_numpy(np.empty(0, np.asarray(arrays[0]).dtype)).dtype
    with profiling.span(profiling.STAGE, images=len(arrays),
                        pinned=len(arrays) if card else 0):
        host = torch.empty(shape, dtype=dtype, pin_memory=card)
        dest = torch.empty(shape, dtype=dtype, device=device)
        rows = host.numpy()
        for i in range(0, len(arrays), CHUNK_FRAMES):
            j = min(i + CHUNK_FRAMES, len(arrays))
            with profiling.span(profiling.STAGE_GATHER):
                np.stack(arrays[i:j], out=rows[i:j])
            with profiling.span(profiling.STAGE_COPY,
                                bytes=host[i:j].nbytes if card else 0):
                dest[i:j].copy_(host[i:j], non_blocking=True)
        return dest


def _copy(host, device):
    """``host.to(device)`` as a ``cyt.stage.copy`` span of the bytes it
    moves (0 when ``device`` is the host)."""
    moved = 0 if torch.device(device).type == "cpu" else host.nbytes
    with profiling.span(profiling.STAGE_COPY, bytes=moved):
        return host.to(device)
