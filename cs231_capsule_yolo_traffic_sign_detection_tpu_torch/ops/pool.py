"""K1: fused 2x2 max-pool + LeakyReLU over NHWC.

Counterpart of the JAX ops/pool_pallas.py:maxpool2_leaky.  The CUDA
kernel is csrc/pool_leaky.cu; `maxpool2_leaky_plain` is the plain
PyTorch version of the same function.  Both are the implementations
of one operator, ``torch.ops.cyt.pool_leaky``: the kernel for a CUDA
tensor, the plain version only for a CPU tensor.  The operator's fake
implementation gives the output's shape, type and (NHWC-contiguous)
strides to a trace.
"""

import torch
import torch.nn.functional as F

from . import _build


def maxpool2_leaky_plain(x, negative_slope=0.1):
    """leaky(max_pool_2x2(x)) on NHWC x through the NCHW view."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
    return F.leaky_relu(y, negative_slope).permute(0, 2, 3, 1)


def maxpool2_leaky(x, negative_slope=0.1):
    """leaky(max_pool_2x2(x)) == max_pool_2x2(leaky(x)), one pass.

    x: [B, H, W, C] with H, W even, f32 or bf16, NHWC-contiguous (a
    channels_last conv output permuted to NHWC is).  Returns
    [B, H/2, W/2, C] in x.dtype, NHWC-contiguous.  Calls the operator
    ``torch.ops.cyt.pool_leaky``, which a traced program (export.py)
    keeps as one node.  The count of kernel launches is
    ``maxpool2_leaky.launches``.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"maxpool2_leaky: unsupported device {x.device}")
    return torch.ops.cyt.pool_leaky(x, float(negative_slope))


maxpool2_leaky.launches = 0


@torch.library.custom_op("cyt::pool_leaky", mutates_args=(),
                         device_types="cpu")
def pool_leaky_op(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """The operator's CPU implementation: the plain version."""
    return maxpool2_leaky_plain(x, negative_slope).contiguous()


@pool_leaky_op.register_fake
def _(x, negative_slope):
    b, h, w, c = x.shape
    return x.new_empty((b, h // 2, w // 2, c))


@pool_leaky_op.register_kernel("cuda")
def _(x, negative_slope):
    """The CUDA implementation: launches csrc/pool_leaky.cu, counted."""
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"maxpool2_leaky: need [B, H, W, C] with H, W "
                         f"even, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"maxpool2_leaky: f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        # NHWC order is required; copying here would hide a layout loss
        raise ValueError(f"maxpool2_leaky: x must be NHWC-contiguous, got "
                         f"strides {x.stride()}")
    b, h, w, c = x.shape
    out = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.cyt_pool_leaky(
            x.data_ptr(), out.data_ptr(), b, h, w, c, float(negative_slope),
            _build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "pool_leaky")
    maxpool2_leaky.launches += 1
    return out
