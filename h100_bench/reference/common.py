"""Plain pieces both references share: the float32 precision switch,
bilinear resizing and Adam.  Plain PyTorch; nothing of the program."""

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32=False):
    """Float32 products and convolutions in full f32 (``tf32`` False,
    the references) or in TF32 (True: the control, the precision one
    step below the configurations' float32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def control_tf32(cfg):
    """Whether the control computes in TF32: the precision one step
    below the configuration's ``dtype``.  Only float32 has its control
    written; a configuration in another dtype brings its own (bfloat16's
    is int8 or fp8) before its cell can be proven."""
    if cfg.get("dtype", "float32") != "float32":
        raise NotImplementedError(
            f"no control for dtype {cfg['dtype']!r}: only float32's "
            "(TF32) is written")
    return True


def _taps(n_in, n_out, device):
    """Source rows of a half-pixel-centred bilinear resize: the lower
    index, the upper index and the upper weight of each output row."""
    scale = n_in / n_out
    src = ((torch.arange(n_out, device=device, dtype=torch.float64) + 0.5)
           * scale - 0.5).clamp_min(0.0)
    lo = src.floor().long().clamp_max(n_in - 1)
    hi = (lo + 1).clamp_max(n_in - 1)
    return lo, hi, (src - lo).float()


def resize_bilinear(frames_u8, size):
    """(B, H, W, 3) uint8 -> (B, size, size, 3) float32 by bilinear
    sampling at half-pixel centres, edges clamped, no antialiasing: the
    sampling of cv2.INTER_LINEAR, written out as gathers and weights."""
    x = frames_u8.float()
    b, h, w, c = x.shape
    if (h, w) == (size, size):
        return x
    r0, r1, wy = _taps(h, size, x.device)
    c0, c1, wx = _taps(w, size, x.device)
    top = x[:, r0] * (1 - wy)[None, :, None, None] \
        + x[:, r1] * wy[None, :, None, None]
    return top[:, :, c0] * (1 - wx)[None, None, :, None] \
        + top[:, :, c1] * wx[None, None, :, None]


class Adam:
    """Adam (Kingma and Ba), betas (0.9, 0.999), eps 1e-8, as the
    reference trains: m and v, bias-corrected, p -= lr m^ / (sqrt(v^) +
    eps)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))

