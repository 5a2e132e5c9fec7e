"""K5: CapsuleNet's primary capsules in serving, one CUDA kernel.

The primary capsules are eight 8x8 stride-2 convs of 16 channels over
conv1's relu'd map (B, 256, 24, 24), stacked as one conv of 128
channels, whose output channel j * 16 + c at position p is dim j of
node c * 81 + p, squashed over its 8 dims: (B, 1296, 8), the routing's
input (K3).  `primary_caps_plain` is that composition (conv2d, reshape,
transpose, copy, squash), the plain version.  The CUDA kernel
(csrc/primary_caps.cu) computes the conv as a 3xTF32 implicit GEMM
straight from the channels-last map and squashes in its epilogue.  The
two are the implementations of one operator, ``torch.ops.cyt.primary_caps``
(`primary_caps` calls it): the kernel for a CUDA tensor, the plain
version only for a CPU tensor.  The kernel reads the weights as
`prepare_weights` lays them out.  `models.capsule_net.PrimaryCapsules`
takes the operator for f32 calls that need no gradient at CapsuleNet's
geometry (`takes`), and the plain version for every other call.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .capsule import squash

# the geometry csrc/primary_caps.cu takes: CapsuleNet's
IN_CHANNELS, N_CAPS, OUT_CHANNELS, KERNEL, STRIDE, IN_SIZE = (
    256, 8, 16, 8, 2, 24)
OUT_SIZE = (IN_SIZE - KERNEL) // STRIDE + 1
NODES = OUT_CHANNELS * OUT_SIZE * OUT_SIZE
CHUNK = 32   # input channels of one of the kernel's k-chunks


def primary_caps_plain(x, w, b, n_caps, stride, dtype=torch.float32):
    """Conv -> squashed capsules: x (B, C, H, W), w (n_caps * out_c, C,
    k, k) and b (n_caps * out_c,), the n_caps convs stacked, -> (B,
    out_c * h * w, n_caps), f32 (f64 kept): output channel j * out_c + c
    at position p is dim j of node c * h * w + p."""
    y = F.conv2d(x.to(dtype), w.to(dtype), b.to(dtype), stride=stride).to(
        torch.promote_types(dtype, torch.float32))
    # (B, j*16 + c, p) -> (B, c*81 + p, j): vector j per node (c, p)
    y = y.reshape(y.shape[0], n_caps, -1).transpose(1, 2)
    return squash(y.contiguous())


def prepare_weights(w):
    """The stacked weights (128, 256, 8, 8) as K5 reads them: (8, 64,
    128, 32), [input-channel chunk][tap r * 8 + s][output channel]
    [channel in the chunk], each k-chunk's 16 KB tile contiguous."""
    n, c, kh, kw = w.shape
    return w.reshape(n, c // CHUNK, CHUNK, kh * kw).permute(
        1, 3, 0, 2).contiguous()


def unprepare_weights(wp):
    """`prepare_weights` undone: (n, C, k, k), contiguous."""
    chunks, taps, n, chunk = wp.shape
    k = round(taps ** 0.5)
    return wp.permute(2, 0, 3, 1).reshape(n, chunks * chunk, k, k).contiguous()


def takes(convs, x, dtype):
    """Whether a primary-capsule call goes through the operator: the
    compute dtype and x float32, ``convs`` (the stacked nn.Conv2d) at
    CapsuleNet's geometry with x (B, 256, 24, 24), and no gradient
    needed (grad mode off, or neither x nor a weight requires one)."""
    if dtype != torch.float32 or x.dtype != torch.float32:
        return False
    if len(convs) != N_CAPS or x.dim() != 4 or \
            tuple(x.shape[1:]) != (IN_CHANNELS, IN_SIZE, IN_SIZE):
        return False
    for m in convs:
        if (m.in_channels, m.out_channels, m.kernel_size, m.stride,
                m.padding, m.dilation, m.groups, m.bias is None) != (
                IN_CHANNELS, OUT_CHANNELS, (KERNEL, KERNEL),
                (STRIDE, STRIDE), (0, 0), (1, 1), 1, False):
            return False
    if not torch.is_grad_enabled():
        return True
    return not (x.requires_grad or any(
        p.requires_grad for m in convs for p in m.parameters()))


def primary_caps(x, wp, b):
    """K5: squashed primary capsules (B, 1296, 8) f32 from conv1's map x
    (B, 256, 24, 24) f32, wp = `prepare_weights` of the stacked weights
    and b (128,) f32.  On a card x must be channels-last (as cuDNN
    leaves conv1's output); the kernel takes nothing else and raises.
    Calls the operator ``torch.ops.cyt.primary_caps``, which a traced
    program (export.py) keeps as one node.  The count of kernel launches
    is ``primary_caps.launches``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"primary_caps: unsupported device {x.device}")
    return torch.ops.cyt.primary_caps(x, wp, b)


primary_caps.launches = 0


@torch.library.custom_op("cyt::primary_caps", mutates_args=(),
                         device_types="cpu")
def primary_caps_op(x: torch.Tensor, wp: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """The operator's CPU implementation: the plain version."""
    return primary_caps_plain(x, unprepare_weights(wp), b, N_CAPS, STRIDE)


@primary_caps_op.register_fake
def _(x, wp, b):
    h = (x.shape[2] - KERNEL) // STRIDE + 1
    w = (x.shape[3] - KERNEL) // STRIDE + 1
    return x.new_empty((x.shape[0], OUT_CHANNELS * h * w, N_CAPS))


@primary_caps_op.register_kernel("cuda")
def _(x, wp, b):
    """The CUDA implementation: launches csrc/primary_caps.cu, counted."""
    if x.dim() != 4 or tuple(x.shape[1:]) != (IN_CHANNELS, IN_SIZE,
                                              IN_SIZE):
        raise ValueError(f"primary_caps: need x (B, {IN_CHANNELS}, "
                         f"{IN_SIZE}, {IN_SIZE}), got {tuple(x.shape)}")
    if tuple(wp.shape) != (IN_CHANNELS // CHUNK, KERNEL * KERNEL,
                           N_CAPS * OUT_CHANNELS, CHUNK) or \
            tuple(b.shape) != (N_CAPS * OUT_CHANNELS,):
        raise ValueError(f"primary_caps: need wp (8, 64, 128, 32) and b "
                         f"(128,), got {tuple(wp.shape)}, {tuple(b.shape)}")
    for name, t in (("x", x), ("wp", wp), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"primary_caps: {name} must be f32, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"primary_caps: {name} must be on {x.device}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("primary_caps: x must be channels-last contiguous")
    if not (wp.is_contiguous() and b.is_contiguous()):
        raise ValueError("primary_caps: wp and b must be contiguous")
    bsz = x.shape[0]
    out = torch.empty((bsz, NODES, N_CAPS), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        tiles, splits, ws_floats = plan(bsz, torch.cuda.current_device())
        ws = torch.empty((max(ws_floats, 1),), dtype=torch.float32,
                         device=x.device)
        err = _build.library().cyt_primary_caps(
            x.data_ptr(), wp.data_ptr(), b.data_ptr(), out.data_ptr(),
            ws.data_ptr(), bsz, splits,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "primary_caps")
    primary_caps.launches += 1
    return out


@functools.lru_cache(maxsize=64)
def plan(bsz, device_index):
    """K5's launch for ``bsz`` crops on the current device
    (csrc/primary_caps.cu: cyt_primary_caps_plan), cached per batch and
    device: (row tiles, K split, workspace floats)."""
    out = (ctypes.c_int64 * 3)()
    err = _build.library().cyt_primary_caps_plan(bsz, out)
    if err != 0:
        raise RuntimeError(f"primary_caps: no launch plan for B {bsz} on "
                           f"this device (cudaError {err})")
    return tuple(out)
