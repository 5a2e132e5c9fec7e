"""K2: DarkNet's fused input stage, and the BN-folded serving forward.

Counterpart of the JAX ops/input_stage.py.  The input stage is
DarkNet's first block with its pool:

    pool2x2(leaky(conv3x3(x, w) + b)) = leaky(max_phases(conv_s2d(x) + b))

The plain PyTorch version (`input_stage_apply`) computes the right-hand
side as the JAX package does: a space-to-depth image convolved with the
phase-stacked kernel of `phase_kernel`, then a max over the four pool
phases.  The CUDA kernel (csrc/input_stage.cu) computes the left-hand
side directly, from the folded conv1 ``w (3,3,3,32)``/``b (32,)``,
without the phase kernel's zero taps.  The two are the implementations
of one operator, ``torch.ops.cyt.input_stage`` (`input_stage` calls
it): the kernel for a CUDA tensor, the plain version only for a CPU
tensor.

`darknet_serving_apply` is the serving forward: K2 for block 1, cuDNN
convolutions (BN folded) for blocks 2..18, K1 (ops/pool.py) at the four
remaining pools.  Activations stay NHWC-contiguous; the NCHW tensors
cuDNN sees are channels_last views of them, so no layout copy is made.
"""

import torch
import torch.nn.functional as F

from ..models.darknet import DARKNET_LAYERS, head
from . import _build, quant
from .pool import maxpool2_leaky


def space_to_depth(x):
    """[B, 2H, 2W, C] -> [B, H, W, 4C]; channel order (a, b, c) =
    (row phase, col phase, original channel)."""
    b, h2, w2, c = x.shape
    h, w = h2 // 2, w2 // 2
    x = x.reshape(b, h, 2, w, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, 4 * c)


def _tap_split(t):
    """Full-resolution tap offset t = d + u - 1 (d: pool phase, u:
    kernel tap) -> (s2d spatial offset r in 0..2, pixel phase a in 0..1)
    with t = 2*(r - 1) + a."""
    r = (t + 2) // 2
    return r, t - 2 * (r - 1)


def phase_kernel(w, bias):
    """[3,3,Cin,Cout] kernel -> phase-stacked [3,3,4*Cin,4*Cout] kernel
    and bias [4*Cout].  Output channel m = phase*Cout + cout with phase
    = 2*di + dj the pool-window position; s2d input channel =
    (2*a + b)*Cin + c."""
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"phase_kernel: need a 3x3 kernel, got {w.shape}")
    wp = w.new_zeros((3, 3, 4 * cin, 4 * cout))
    for di in range(2):
        for dj in range(2):
            phase = 2 * di + dj
            for u in range(3):
                r, a = _tap_split(di + u - 1)
                for v in range(3):
                    s, b = _tap_split(dj + v - 1)
                    wp[r, s, (2 * a + b) * cin:(2 * a + b + 1) * cin,
                       phase * cout:(phase + 1) * cout] += w[u, v]
    return wp, bias.repeat(4)


def input_stage_apply(x, wp, bp, n_out, negative_slope=0.1):
    """Plain K2: leaky(max over phases of conv_s2d(x) + bp).

    x: [B, 2H, 2W, C] NHWC; wp/bp from `phase_kernel`.  Returns
    [B, H, W, n_out] NHWC, pool2x2(leaky(conv(x) + bias)).
    """
    xs = space_to_depth(x).permute(0, 3, 1, 2)
    y = F.conv2d(xs, wp.permute(3, 2, 0, 1).to(xs.dtype), padding=1)
    y = y + bp.to(y.dtype)[None, :, None, None]
    b, _, h, w = y.shape
    y = y.reshape(b, 4, n_out, h, w).amax(dim=1)
    return F.leaky_relu(y, negative_slope).permute(0, 2, 3, 1)


def input_stage(x, w, b, negative_slope=0.1):
    """K2: pool2x2(leaky(conv3x3(x, w) + b)), only the pooled map written.

    x: [B, 2H, 2W, 3] NHWC-contiguous, f32 or bf16.  w: folded conv1
    kernel [3, 3, 3, n_out] (HWIO) and b: [n_out], both f32 (the kernel
    accumulates in f32; round w through bf16 first to serve bf16
    operands); the CUDA kernel takes n_out = 32.  Returns
    [B, H, W, n_out] in x.dtype, NHWC-contiguous.  On bf16 the CUDA
    kernel runs on the tensor cores and rounds once, to the output; the
    plain bf16 version also rounds the conv before the bias.  Calls the
    operator ``torch.ops.cyt.input_stage``, which a traced program
    (export.py) keeps as one node.  The count of kernel launches is
    ``input_stage.launches``.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"input_stage: unsupported device {x.device}")
    return torch.ops.cyt.input_stage(x, w, b, float(negative_slope))


input_stage.launches = 0


@torch.library.custom_op("cyt::input_stage", mutates_args=(),
                         device_types="cpu")
def input_stage_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   negative_slope: float) -> torch.Tensor:
    """The operator's CPU implementation: the plain version."""
    wp, bp = phase_kernel(w, b)
    return input_stage_apply(x, wp, bp, w.shape[-1],
                             negative_slope).contiguous()


@input_stage_op.register_fake
def _(x, w, b, negative_slope):
    bsz, h2, w2, _ = x.shape
    return x.new_empty((bsz, h2 // 2, w2 // 2, w.shape[-1]))


@input_stage_op.register_kernel("cuda")
def _(x, w, b, negative_slope):
    """The CUDA implementation: launches csrc/input_stage.cu, counted."""
    if (x.dim() != 4 or x.shape[3] != 3 or x.shape[1] % 2
            or x.shape[2] % 2):
        raise ValueError(f"input_stage: need [B, 2H, 2W, 3], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"input_stage: x must be f32 or bf16, got {x.dtype}")
    if tuple(w.shape) != (3, 3, 3, 32) or tuple(b.shape) != (32,):
        raise ValueError(f"input_stage: the kernel takes w (3,3,3,32) and "
                         f"b (32,), got {tuple(w.shape)}, {tuple(b.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"input_stage: {name} must be contiguous on "
                             f"{x.device}")
    if w.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("input_stage: w and b must be f32")
    bsz, h2, w2, _ = x.shape
    out = torch.empty((bsz, h2 // 2, w2 // 2, 32), dtype=x.dtype,
                      device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.cyt_input_stage(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz,
            h2, w2, float(negative_slope),
            _build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "input_stage")
    input_stage.launches += 1
    return out


def prepare_serving(state_dict, dtype=torch.float32):
    """Fold BN and lay the weights out for `darknet_serving_apply`.

    Returns {"input": {"w", "b"}, "layers": [{"w", "b"}] * 17, "head"}:
    block 1's folded HWIO kernel for K2 (f32, its values rounded
    through ``dtype``) with an f32 bias; blocks 2..18 and the head as
    OIHW channels_last kernels in ``dtype`` for cuDNN.  Everything stays
    on the state_dict's device.
    """
    layers, head_w = quant.fold_darknet(state_dict)

    def oihw(w):
        return w.permute(3, 2, 0, 1).to(
            dtype=dtype, memory_format=torch.channels_last)

    return {
        "input": {"w": layers[0]["w"].to(dtype).float().contiguous(),
                  "b": layers[0]["b"].contiguous()},
        "layers": [{"w": oihw(L["w"]), "b": L["b"].to(dtype)}
                   for L in layers[1:]],
        "head": oihw(head_w),
    }


def darknet_serving_apply(p, x, *, n_boxes, n_classes, dtype=torch.float32):
    """BN-folded serving forward: NHWC x -> NHWC grid (f32 heads).

    ``p`` from `prepare_serving`.  Block 1 and its pool run as K2, the
    other four pools as K1; on a CPU tensor both take their plain
    versions.  Conv outputs are updated in place by the leaky slope.
    """
    x = x.to(dtype)
    y = input_stage(x, p["input"]["w"], p["input"]["b"]).permute(0, 3, 1, 2)
    for (_, k, after), L in zip(DARKNET_LAYERS[1:], p["layers"]):
        y = F.conv2d(y, L["w"].to(dtype), L["b"].to(dtype),
                     padding=1 if k == 3 else 0)
        if after == "mp":
            y = maxpool2_leaky(y.permute(0, 2, 3, 1), 0.1).permute(0, 3, 1, 2)
        else:
            y = F.leaky_relu(y, 0.1, inplace=True)
    out = F.conv2d(y, p["head"].to(dtype)).permute(0, 2, 3, 1).float()
    return head(out, n_boxes, n_classes)
