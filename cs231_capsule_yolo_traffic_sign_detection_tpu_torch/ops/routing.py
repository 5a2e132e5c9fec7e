"""K3: capsule votes fused with routing by agreement.

Counterpart of the JAX ops/routing_pallas.py:routed_capsules_pallas
(forward).  The CUDA kernel is csrc/routing.cu; `routed_capsules_plain`
is the plain PyTorch version of the same function (ops/capsule.py's
compute_priors + dynamic_routing).  `routed_capsules` launches the
kernel for a CUDA tensor and takes the plain version only for a CPU
tensor.

bf16 mode follows the JAX kernel's: x and W are stored in bf16, the
votes and every sum accumulate in f32, softmax, logits and squash stay
f32, and the caps come out f32.  (The TPU kernel also rounds the priors
and the routing probabilities to bf16 between its matrix-unit passes;
the port keeps both f32, inside the bf16 band of the JAX tests.)
"""

import functools

import torch

from . import _build
from .capsule import compute_priors, dynamic_routing

# what csrc/routing.cu takes: in_C and D fixed, K up to MAX_CAPS
IN_C, OUT_D, MAX_CAPS = 8, 16, 48


def routed_capsules_plain(x, w, n_iter=3, bf16=False):
    """x (B, N, in_C), w (N, K, in_C, D) -> caps (B, K, D) f32."""
    x, w = x.float(), w.float()
    if bf16:  # bf16 storage of the operands, f32 arithmetic
        x, w = x.bfloat16().float(), w.bfloat16().float()
    return dynamic_routing(compute_priors(x, w), n_iter=n_iter)[:, 0]


def routed_capsules(x, w, n_iter=3, bf16=False):
    """Votes x @ W and ``n_iter`` routing iterations, one op.

    x: (B, N, 8) and w: (N, K, 8, 16), contiguous, f32 or bf16 (cast to
    bf16 when ``bf16``, to f32 otherwise); K <= 48.  Returns caps
    (B, K, 16) f32.  No (B, N, K, D) votes tensor is made.  The count of
    calls that launched the kernel is ``routed_capsules.launches`` (one
    per call; the call issues 2 * n_iter CUDA kernels).
    """
    if x.device.type == "cpu":
        return routed_capsules_plain(x, w, n_iter, bf16)
    if x.device.type != "cuda":
        raise ValueError(f"routed_capsules: unsupported device {x.device}")
    if x.dim() != 3 or w.dim() != 4 or x.shape[1] != w.shape[0] \
            or x.shape[2] != w.shape[2]:
        raise ValueError(f"routed_capsules: need x (B, N, C) and w (N, K, "
                         f"C, D), got {tuple(x.shape)}, {tuple(w.shape)}")
    b, n, c = x.shape
    k, d = w.shape[1], w.shape[3]
    if (c, d) != (IN_C, OUT_D) or not 1 <= k <= MAX_CAPS:
        raise ValueError(f"routed_capsules: the kernel takes in_C {IN_C}, "
                         f"D {OUT_D} and 1 <= K <= {MAX_CAPS}, got in_C {c}, "
                         f"D {d}, K {k}")
    if n_iter < 1:
        raise ValueError(f"routed_capsules: n_iter must be >= 1, got {n_iter}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"routed_capsules: {name} must be f32 or bf16, "
                            f"got {t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"routed_capsules: {name} must be contiguous on "
                             f"{x.device}")
    io = torch.bfloat16 if bf16 else torch.float32
    x, w = x.to(io), w.to(io)
    with torch.cuda.device(x.device):
        tile = _tile_nodes(b, n, k, _build.DTYPE_CODES[io],
                           torch.cuda.current_device())
        # per (element, node tile) node sums: 11.4 MB at CapsuleNet's shape
        partial = torch.empty((b, -(-n // tile), k, d), dtype=torch.float32,
                              device=x.device)
        vsum = torch.empty((b, k, d), dtype=torch.float32, device=x.device)
        out = torch.empty((b, k, d), dtype=torch.float32, device=x.device)
        err = _build.library().cyt_routing(
            x.data_ptr(), w.data_ptr(), partial.data_ptr(), vsum.data_ptr(),
            out.data_ptr(), b, n, k, c, d, int(n_iter), tile,
            _build.DTYPE_CODES[io],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "routing")
    routed_capsules.launches += 1
    return out


routed_capsules.launches = 0


@functools.lru_cache(maxsize=64)
def _tile_nodes(b, n, k, dtype_code, device_index):
    """Nodes per block for the kernel's node tiles on the current device
    (csrc/routing.cu:pick_tile), cached per shape, type and device."""
    tile = _build.library().cyt_routing_tile(b, n, k, dtype_code)
    if tile <= 0:
        raise RuntimeError("routed_capsules: no node tile for "
                           f"B {b}, N {n}, K {k} on this device")
    return tile
