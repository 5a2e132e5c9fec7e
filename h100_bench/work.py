"""The yardstick's arithmetic: the card's peaks, the models' FLOPs and
the kernels' operations and bytes, all from shapes.

Every count is of the work the algorithm needs, independent of how the
program computes it: direct convolutions (an FFT or Winograd
convolution does fewer operations than counted here), each input byte
read once and each output byte written once.

Peaks (NVIDIA's data sheet, H100 SXM, dense): the port computes f32 on
the tensor cores as 3xTF32 (K2's f32 path, K3g/K4g), three TF32
products for one f32 product, so the fastest f32 arithmetic it already
uses runs at 495 / 3 = 165 TFLOP/s.  Against the 67 TFLOP/s of the f32
CUDA cores a 3xTF32 kernel could read above 100% of its roofline, so
165 is the f32 peak for every share.  HBM3: 3.35 TB/s.
"""

F32_PEAK_FLOP_S = 495e12 / 3
HBM_BYTES_S = 3.35e12
F32 = 4

# DarkNet-19's blocks: (out_channels, kernel, what follows: "mp" | "drop")
DARKNET_LAYERS = (
    (32, 3, "mp"), (64, 3, "mp"), (128, 3, "drop"), (64, 1, "drop"),
    (128, 3, "mp"), (256, 3, "drop"), (128, 1, "drop"), (256, 3, "mp"),
    (512, 3, "drop"), (256, 1, "drop"), (512, 3, "drop"), (256, 1, "drop"),
    (512, 3, "mp"), (1024, 3, "drop"), (512, 1, "drop"), (1024, 3, "drop"),
    (512, 1, "drop"), (1024, 3, "drop"))


def roofline_s(flop, n_bytes):
    """The least time for the work on one card: operations at the f32
    peak or bytes at HBM's rate, whichever is longer."""
    return max(flop / F32_PEAK_FLOP_S, n_bytes / HBM_BYTES_S)


def darknet_conv_flop(size, n_out):
    """Each conv's forward FLOP for one image at ``size`` px, the head
    (1x1, ``n_out`` channels) last."""
    flop, hw, in_c = [], size, 3
    for out_c, k, after in DARKNET_LAYERS:
        flop.append(2 * hw * hw * in_c * out_c * k * k)
        in_c = out_c
        if after == "mp":
            hw //= 2
    flop.append(2 * hw * hw * in_c * n_out)
    return flop


def darknet_flop(size, n_boxes, n_classes, train=False):
    """FLOP of one image: the forward's convolutions; a train step is
    three times that less conv_1's input gradient (the image takes
    none)."""
    f = darknet_conv_flop(size, 5 * n_boxes + n_classes)
    return 3 * sum(f) - f[0] if train else sum(f)


def capsule_flop(cfg, recon=True, train=False):
    """FLOP of one crop through CapsuleNet at the configuration's widths:
    conv1, the primary capsules (``primary_caps`` convs of
    ``primary_channels``), the votes (2 N K C D), the routing's
    node-sized products ((2 n_iter - 1) x 2 N K D) and, in training with
    the reconstruction, the decoder (the reference's: a dense layer
    from the D-wide capsule to 16 x 4 x 4, then 3x3 convs of 16 -> 4 at
    8 x 8, 4 -> 8 at 16 x 16, 8 -> 16 and 16 -> 3 at 32 x 32).  A
    train step is three times the forward less conv1's input
    gradient."""
    crop, k1, ch = cfg["capsule_input"], cfg["conv1_kernel"], \
        cfg["conv1_channels"]
    h1 = crop - k1 + 1
    conv1 = 2 * h1 * h1 * ch * 3 * k1 * k1
    pk = cfg["primary_kernel"]
    hp = (h1 - pk) // cfg["primary_stride"] + 1
    primary = (2 * hp * hp * cfg["primary_caps"] * cfg["primary_channels"]
               * ch * pk * pk)
    n, k, c, d = (cfg["routing_nodes"], cfg["n_classes"], cfg["in_dim"],
                  cfg["out_dim"])
    votes = 2 * n * k * c * d
    passes = (2 * cfg["n_iter"] - 1) * 2 * n * k * d
    decoder = 0
    if recon:
        decoder = (2 * d * 256 + 2 * 8 * 8 * 4 * 16 * 9
                   + 2 * 16 * 16 * 8 * 4 * 9 + 2 * 32 * 32 * 16 * 8 * 9
                   + 2 * 32 * 32 * 3 * 16 * 9)
    fwd = conv1 + primary + votes + passes + decoder
    return 3 * fwd - conv1 if train else fwd


def k1_work(batch, size):
    """K1 (2x2 max-pool + leaky, f32) at DarkNet's four pools after
    block 1, summed over one forward: (FLOP, bytes).  Each pool reads
    its input once and writes a quarter of it; about 4 operations an
    output (three maxes and the slope)."""
    flop = n_bytes = 0
    hw, in_c = size // 2, 32
    for out_c, _, after in DARKNET_LAYERS[1:]:
        in_c = out_c
        if after == "mp":
            n = batch * hw * hw * in_c
            n_bytes += F32 * (n + n // 4)
            flop += n
            hw //= 2
    return flop, n_bytes


def k2_work(batch, size):
    """K2 (conv1 3x3 3 -> 32, bias, leaky, 2x2 pool, f32): (FLOP,
    bytes).  The image read once, the pooled map written once, the
    folded weights read once."""
    flop = 2 * batch * size * size * 32 * 27
    n_bytes = F32 * (batch * size * size * 3
                     + batch * (size // 2) ** 2 * 32 + 27 * 32 + 32)
    return flop, n_bytes


def k3_work(b, n=1296, k=43, n_iter=3, c=8, d=16, save_states=False):
    """K3 (votes and routing, f32): (FLOP, bytes).  The votes 2 B N K C D
    and (2 n_iter - 1) node-sized passes of 2 B N K D; x and W read, the
    capsules (and with ``save_states`` the n_iter node sums) written."""
    flop = 2 * b * n * k * c * d + (2 * n_iter - 1) * 2 * b * n * k * d
    out = b * k * d * (1 + (n_iter if save_states else 0))
    return flop, F32 * (b * n * c + n * k * c * d + out)


def k4_work(b, n=1296, k=43, n_iter=3, c=8, d=16):
    """K4 (the routing's backward, f32): (FLOP, bytes).  The votes
    rebuilt, dx and dW, 2 B N K C D each, and 5 n_iter - 4 node-sized
    passes of 2 B N K D; x, W, the saved node sums and the incoming
    gradient read, dx and dW written."""
    flop = 3 * 2 * b * n * k * c * d + (5 * n_iter - 4) * 2 * b * n * k * d
    n_bytes = F32 * (2 * (b * n * c + n * k * c * d)
                     + (n_iter + 1) * b * k * d)
    return flop, n_bytes
