"""BN folding and int8 serving for the DarkNet detector and the ConvNet
classifier (counterpart of the JAX ops/quant.py).

1. **BN folding** (`fold_darknet`, `fold_convnet`): an inference
   BatchNorm is an affine map, so each conv + BN pair folds into one
   conv with per-channel scaled weights and a bias.
2. **int8 DarkNet** (`quantize_darknet`, `darknet_int8_resident_apply`,
   `darknet_int8_apply`): symmetric per-output-channel int8 weights on
   the folded kernels, static per-layer activation scales calibrated on
   a first batch (`calibrate_activation_scales`) or dynamic ones, s8 x
   s8 -> s32 convolutions, an f32 epilogue
   ``leaky(acc.float() * (sx * ws) + b, 0.1)``, and an f32 head.  The
   resident chain requantizes each layer's output for the next
   (`_requant`) and pools in int8 (`_max_pool_int8`): requantization
   is monotone, so it commutes with the max, and the chain equals the
   static `darknet_int8_apply` bit for bit.  The space-to-depth variant
   (`prepare_s2d_int8`, `darknet_int8_resident_s2d_apply`; the JAX
   bench's) runs layer 1 and its pool as one int8 product on the s2d
   image and a channel-group max, equal to the resident chain bit for
   bit.
3. **int8 ConvNet** (`quantize_convnet`, `convnet_int8_apply`): both
   convs and the 32768 x 128 dense in int8, LeakyReLU 0.01, ReLU and
   the n_classes head in f32, for the fused two-stage path.

The JAX package leaves the int8 products to XLA; the port makes each
conv an im2col (`_im2col`, the reduction ``k * k * Cin`` zero-padded to
a multiple of 8: conv1's 27 to 32; zero is exact in the symmetric
domain) and one ``torch._int_mm`` (cuBLASLt s8 x s8 -> s32 on a card,
at least 17 rows).  The epilogue is separate elementwise ops in JAX's
order, with no FMA.  No TPU kernel is involved (XLA work in JAX), so
neither K1 nor K2 runs here.

Quantized parameters keep the JAX package's layouts (HWIO kernels,
dense (in, out)) but for the ConvNet's dense rows, which follow the
port's CHW flatten (interop.jax_qparams_to_port permutes JAX's).
"""

import torch
import torch.nn.functional as F

from ..models.darknet import DARKNET_LAYERS, head as _head


def _sqrt(v):
    """Correctly rounded f32 sqrt (through f64, which rounds it once):
    PyTorch's vectorised CPU sqrt is off by one ulp on some inputs."""
    return torch.sqrt(v.double()).float()


def fold_darknet(state_dict, eps=1e-5):
    """Fold each BN into its conv.  Returns (layers, head_kernel).

    ``state_dict`` is a DarkNet state_dict (OIHW kernels, reference
    keys).  ``layers`` is a list of {"w": HWIO f32, "b": (O,) f32} and
    ``head_kernel`` the HWIO 1x1 head kernel: the JAX package's layout,
    so the two folds compare directly.

    With y = BN(conv(x, w)) = scale * (conv(x, w) - mean) / sqrt(var +
    eps) + bias, the folded form is conv(x, w * inv) + (bias - mean *
    inv) with inv = scale / sqrt(var + eps) per output channel.
    """
    layers = []
    for i in range(1, len(DARKNET_LAYERS) + 1):
        w = state_dict[f"model.conv_{i}.weight"].float().permute(2, 3, 1, 0)
        inv = state_dict[f"model.bn_{i}.weight"].float() / _sqrt(
            state_dict[f"model.bn_{i}.running_var"].float() + eps)
        layers.append({
            "w": (w * inv).contiguous(),  # broadcasts over O, HWIO's last
            "b": state_dict[f"model.bn_{i}.bias"].float()
            - state_dict[f"model.bn_{i}.running_mean"].float() * inv,
        })
    head = state_dict["model.conv_19.weight"].float().permute(2, 3, 1, 0)
    return layers, head.contiguous()


def _conv_f32(x, w, k):
    """NHWC f32 conv with an HWIO kernel, 'SAME' padding, no bias."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=1 if k == 3 else 0)
    return y.permute(0, 2, 3, 1)


def _max_pool(x):
    """2x2/2 max-pool over NHWC (any dtype: the max is exact)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


# requantization commutes with the max (a monotone map), so int8
# pooling is exact against pooling the f32 activation first
_max_pool_int8 = _max_pool


def _abs_max_scale(x):
    """max|x| / 127, at least 1e-12 (f32)."""
    return torch.clamp_min(x.abs().max() / 127.0, 1e-12)


def _quantize_weight(w, axes):
    """Symmetric per-output-channel int8: (wq int8, ws f32 (O,))."""
    s = torch.clamp_min(w.abs().amax(dim=axes) / 127.0, 1e-12)
    return torch.clamp(torch.round(w / s), -127, 127).to(torch.int8), s


def _requant(a, scale):
    """clip(round(a / scale), -127, 127) as int8 (round half to even)."""
    return torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)


def quantize_darknet(state_dict, eps=1e-5, x_cal=None):
    """Quantize the folded conv kernels to symmetric per-channel int8.

    Returns {"layers": [{"wq" int8 HWIO, "ws" f32 (O,), "b" f32 (O,)}]
    * 18, "head": f32 HWIO kernel} and, with a calibration batch
    ``x_cal`` (NHWC f32, as the detector sees it), "act_scales" (18,)
    f32 from `calibrate_activation_scales`; tensors on the state_dict's
    device."""
    layers, head = fold_darknet(state_dict, eps)
    q = []
    for L in layers:
        wq, ws = _quantize_weight(L["w"], (0, 1, 2))
        q.append({"wq": wq, "ws": ws, "b": L["b"]})
    out = {"layers": q, "head": head}
    if x_cal is not None:
        out["act_scales"] = calibrate_activation_scales(x_cal, layers)
    return out


def calibrate_activation_scales(x_cal, folded_layers):
    """Static per-layer activation scales: the BN-folded f32 forward on
    ``x_cal`` (plain convolutions and pools, no kernel of the port),
    recording max|input| / 127 ahead of each quantized conv.  (18,) f32."""
    scales = []
    x = x_cal.float()
    for (_, k, after), L in zip(DARKNET_LAYERS, folded_layers):
        scales.append(_abs_max_scale(x))
        x = F.leaky_relu(_conv_f32(x, L["w"], k) + L["b"], 0.1)
        if after == "mp":
            x = _max_pool(x)
    return torch.stack(scales)


def _im2col(z, k):
    """NHWC z (B, H, W, C) -> (B*H*W, Kp) columns in the (kh, kw, c)
    order of an HWIO kernel's rows, 'SAME' zero padding for k = 3, the
    reduction zero-padded to Kp, a multiple of 8.  For k = 3 the 3x3
    windows of the padded input are one strided view, copied once."""
    b, h, w, c = z.shape
    kp = -(-k * k * c // 8) * 8
    if k == 1 and kp == c:
        return z.reshape(b * h * w, c)
    if k == 1:
        win = z.reshape(b, h, w, 1, 1, c)
    else:
        zp = z.new_zeros((b, h + 2, w + 2, c))
        zp[:, 1:-1, 1:-1] = z
        s0, s1, s2, s3 = zp.stride()
        win = zp.as_strided((b, h, w, 3, 3, c), (s0, s1, s2, s1, s2, s3))
    if kp == k * k * c:
        return win.reshape(b * h * w, kp)
    cols = z.new_empty((b, h, w, kp))
    cols[..., k * k * c:] = 0
    cols[..., :k * k * c].view(b, h, w, k, k, c).copy_(win)
    return cols.reshape(b * h * w, kp)


def _weight_rows(wq):
    """int8 kernel (k, k, Cin, O) or dense (K, O) -> (O, Kp) rows, the
    reduction zero-padded to a multiple of 8 as `_im2col`'s."""
    m = wq.reshape(-1, wq.shape[-1]).t()
    kp = -(-m.shape[1] // 8) * 8
    out = m.new_zeros((m.shape[0], kp))
    out[:, :m.shape[1]] = m
    return out


def int8_matmul(a, w_rows):
    """(M, K) int8 x (O, K) int8 rows -> (M, O) int32, exact.

    ``torch._int_mm`` (cuBLASLt on a card; K and O multiples of 8 and
    more than 16 rows there, so a short ``a`` is zero-padded to 32 rows
    and the result cut back)."""
    m = a.shape[0]
    if a.device.type == "cuda" and m <= 16:
        a = torch.cat([a, a.new_zeros((32 - m, a.shape[1]))])
    return torch._int_mm(a, w_rows.t())[:m]


def _int8_conv(z, wq, k):
    """int8 NHWC conv with an int8 HWIO kernel: (B, H, W, O) int32."""
    b, h, w, _ = z.shape
    acc = int8_matmul(_im2col(z, k), _weight_rows(wq))
    return acc.reshape(b, h, w, -1)


def _epilogue(acc, sx, ws, b, slope):
    """leaky(acc.float() * (sx * ws) + b, slope) in JAX's order of
    operations, in place after the cast: one rounding per op, no FMA."""
    a = acc.float()
    a.mul_(sx * ws).add_(b)
    return F.leaky_relu_(a, slope) if slope is not None else a.relu_()


def _head_f32(x, head_w, n_boxes, n_classes):
    """The f32 1x1 head conv (HWIO (1, 1, C, O)) and the sigmoid/softmax."""
    return _head(torch.matmul(x, head_w[0, 0]), n_boxes, n_classes)


def _resident_tail(qparams, z, start, *, n_boxes, n_classes):
    """Layers ``start``..17 of the int8-resident chain and the f32 head;
    ``z`` is layer ``start``'s int8 input, at act_scales[start]."""
    act = qparams["act_scales"]
    n = len(DARKNET_LAYERS)
    for i in range(start, n):
        (_, k, after), L = DARKNET_LAYERS[i], qparams["layers"][i]
        a = _epilogue(_int8_conv(z, L["wq"], k), act[i], L["ws"], L["b"],
                      0.1)
        if i + 1 < n:
            z = _requant(a, act[i + 1])
            del a
            if after == "mp":
                z = _max_pool_int8(z)
        else:
            x = _max_pool(a) if after == "mp" else a
    return _head_f32(x, qparams["head"], n_boxes, n_classes)


def darknet_int8_resident_apply(qparams, x, *, n_boxes, n_classes):
    """int8-resident forward: the inter-layer activations stay int8.

    Needs static ``act_scales``.  Each layer's f32 epilogue is
    requantized at the NEXT layer's scale and pooled in int8; the last
    quantized layer stays f32 for the head.  x: NHWC, as the detector
    sees it (0-255).  Bit-identical to `darknet_int8_apply` with the
    same static scales."""
    z = _requant(x.float(), qparams["act_scales"][0])
    return _resident_tail(qparams, z, 0, n_boxes=n_boxes,
                          n_classes=n_classes)


def prepare_s2d_int8(qparams):
    """Phase-stack layer 1's int8 kernel for the space-to-depth input
    stage (JAX ops/quant.py:prepare_s2d_int8): `input_stage.phase_kernel`
    only places kernel entries, so it is exact on int8, and the four
    phases of an output channel share its weight scale and bias.
    Returns qparams with "s2d": {"wq" int8 (3, 3, 12, 128), "ws", "b"
    (128,)}."""
    from .input_stage import phase_kernel

    L0 = qparams["layers"][0]
    wp, _ = phase_kernel(L0["wq"], L0["b"].new_zeros(1))
    return dict(qparams, s2d={"wq": wp, "ws": L0["ws"].repeat(4),
                              "b": L0["b"].repeat(4)})


def darknet_int8_resident_s2d_apply(qparams, x, *, n_boxes, n_classes):
    """The int8-resident chain with the space-to-depth input stage (JAX
    ops/quant.py:darknet_int8_resident_s2d_apply): layer 1 and its pool
    as one depth-108 int8 product on space_to_depth(x) (conv1's four
    pool phases as output channel groups), the epilogue, the
    requantization, then an int8 max over the four groups:

        maxpool2(requant(leaky(conv1))) = groupmax_4(requant(leaky(conv_s2d)))

    Bit-identical to `darknet_int8_resident_apply`: each phase's s32
    accumulator is conv1's at its pooled position, the epilogue applies
    the same scale and bias to every phase, and requantization is
    monotone.  ``qparams`` from `prepare_s2d_int8`."""
    from .input_stage import space_to_depth

    act, s2d = qparams["act_scales"], qparams["s2d"]
    zs = space_to_depth(_requant(x.float(), act[0]))
    a = _epilogue(_int8_conv(zs, s2d["wq"], 3), act[0], s2d["ws"], s2d["b"],
                  0.1)
    z = _requant(a, act[1])
    b, h, w, c4 = z.shape
    z = z.reshape(b, h, w, 4, c4 // 4).amax(dim=3)
    return _resident_tail(qparams, z, 1, n_boxes=n_boxes,
                          n_classes=n_classes)


def darknet_int8_apply(qparams, x, *, n_boxes, n_classes):
    """Layer-wise int8 forward: each conv's input quantized from the f32
    activation, at the static ``act_scales`` when qparams has them, else
    at a dynamic per-tensor max|x| / 127; f32 pools."""
    act = qparams.get("act_scales")
    x = x.float()
    for i, ((_, k, after), L) in enumerate(zip(DARKNET_LAYERS,
                                               qparams["layers"])):
        sx = _abs_max_scale(x) if act is None else act[i]
        x = _epilogue(_int8_conv(_requant(x, sx), L["wq"], k), sx, L["ws"],
                      L["b"], 0.1)
        if after == "mp":
            x = _max_pool(x)
    return _head_f32(x, qparams["head"], n_boxes, n_classes)


def fold_convnet(state_dict, eps=1e-5):
    """Fold BN into the ConvNet's two convs (with their biases: the
    folded bias is bn_bias + (conv_bias - mean) * inv).  Returns
    (convs [{"w" HWIO, "b"}] * 2, dense {"w" (in, out), "b"}, head
    {"w" (128, n), "b"}), f32; dense rows in the port's CHW flatten."""
    convs = []
    for conv, bn in (("cnn.0", "cnn.1"), ("cnn.4", "cnn.5")):
        w = state_dict[f"{conv}.weight"].float().permute(2, 3, 1, 0)
        cb = state_dict[f"{conv}.bias"].float()
        inv = state_dict[f"{bn}.weight"].float() / _sqrt(
            state_dict[f"{bn}.running_var"].float() + eps)
        convs.append({
            "w": (w * inv).contiguous(),
            "b": state_dict[f"{bn}.bias"].float()
            + (cb - state_dict[f"{bn}.running_mean"].float()) * inv})
    dense = {"w": state_dict["cnn.10.weight"].float().t().contiguous(),
             "b": state_dict["cnn.10.bias"].float()}
    head = {"w": state_dict["cnn.12.weight"].float().t().contiguous(),
            "b": state_dict["cnn.12.bias"].float()}
    return convs, dense, head


def _flatten_chw(x):
    """Pooled NHWC (B, H, W, C) -> (B, C*H*W), the port's CHW flatten."""
    return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


def quantize_convnet(state_dict, x_cal, eps=1e-5):
    """Quantize the ConvNet: folded convs and the first dense layer to
    symmetric per-output-channel int8, the head f32, and three static
    activation scales from the folded f32 forward on ``x_cal`` (centered
    crops, as the fused two-stage path feeds the classifier)."""
    convs, dense, head = fold_convnet(state_dict, eps)
    q = []
    for L in convs:
        wq, ws = _quantize_weight(L["w"], (0, 1, 2))
        q.append({"wq": wq, "ws": ws, "b": L["b"]})
    dq, ds = _quantize_weight(dense["w"], 0)
    record = []
    x = x_cal.float()
    for L in convs:
        record.append(_abs_max_scale(x))
        x = F.leaky_relu(_conv_f32(x, L["w"], 3) + L["b"], 0.01)
    x = _flatten_chw(_max_pool(x))
    record.append(_abs_max_scale(x))
    return {"convs": q, "dense": {"wq": dq, "ws": ds, "b": dense["b"]},
            "head": head, "act_scales": torch.stack(record)}


def convnet_int8_apply(qc, x):
    """int8 ConvNet forward on centered NHWC crops -> f32 logits."""
    act = qc["act_scales"]
    x = x.float()
    for i, L in enumerate(qc["convs"]):
        x = _epilogue(_int8_conv(_requant(x, act[i]), L["wq"], 3), act[i],
                      L["ws"], L["b"], 0.01)
    x = _flatten_chw(_max_pool(x))
    d = qc["dense"]
    x = _epilogue(int8_matmul(_requant(x, act[2]), _weight_rows(d["wq"])),
                  act[2], d["ws"], d["b"], None)
    return x @ qc["head"]["w"] + qc["head"]["b"]
