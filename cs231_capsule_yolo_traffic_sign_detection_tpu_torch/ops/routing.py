"""K3 and K4: capsule votes fused with routing by agreement, and its VJP.

Counterpart of the JAX ops/routing_pallas.py:routed_capsules_pallas
(forward, K3, csrc/routing.cu) and its custom VJP `_bwd` (backward, K4,
csrc/routing_bwd.cu).  `routed_capsules_plain` and
`routed_capsules_backward_plain` are the plain PyTorch versions of the
two directions.  `routed_capsules` is one differentiable op: a call
that needs no gradient (serving, under ``torch.inference_mode()`` or
``torch.no_grad()``) runs the forward alone and saves nothing; a call
that does goes through `RoutedCapsules`, whose forward keeps the
per-iteration node sums s_t and whose backward is K4.  Each direction
is one operator, ``torch.ops.cyt.routing`` and ``torch.ops.cyt.routing_bwd``,
whose implementations are the kernel for a CUDA tensor and the plain
version only for a CPU tensor.

bf16 mode follows the JAX kernels': x and W are stored in bf16, the
votes and every sum accumulate in f32, softmax, logits, squash and all
gradient state stay f32, the caps and dW come out f32 and dx in x's
dtype.  (The TPU kernels also round the priors and the routing
probabilities to bf16 between their matrix-unit passes; the port keeps
both f32, inside the bf16 bands of the JAX tests.)
"""

import ctypes
import functools

import torch

from . import _build
from .capsule import (SQUASH_EPS, compute_priors, dynamic_routing,
                      routing_iterations, squash)

# what csrc/routing*.cu take: in_C and D fixed, K up to MAX_CAPS, and
# (backward) n_iter up to MAX_ITER_BWD
IN_C, OUT_D, MAX_CAPS, MAX_ITER_BWD = 8, 16, 48, 5


def _operands(x, w, bf16):
    """x and W as the kernels read them, in f32 arithmetic (f64 kept)."""
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    x, w = x.to(dt), w.to(dt)
    if bf16:  # bf16 storage of the operands, f32 arithmetic
        x, w = x.bfloat16().to(dt), w.bfloat16().to(dt)
    return x, w


def routed_capsules_plain(x, w, n_iter=3, bf16=False):
    """x (B, N, in_C), w (N, K, in_C, D) -> caps (B, K, D) f32."""
    x, w = _operands(x, w, bf16)
    return dynamic_routing(compute_priors(x, w), n_iter=n_iter)[:, 0]


def routing_states_plain(x, w, n_iter=3, bf16=False):
    """`routed_capsules_plain` that also returns the node sums s_t of
    every iteration, (n_iter, B, K, D): the state K4 reads."""
    x, w = _operands(x, w, bf16)
    caps, s_all = routing_iterations(compute_priors(x, w), n_iter)
    return caps[:, 0], s_all


def _squash_parts(s):
    """Squash scale sc(n2) and its derivative d sc / d n2, n2 = |s|^2,
    in the closed form of the JAX kernel (routing_pallas.py:345-352)."""
    n2 = (s * s).sum(dim=-1, keepdim=True)
    u = 1.0 / (1.0 + n2)
    r = 1.0 / torch.sqrt(n2 + SQUASH_EPS)
    return n2 * u * r, u * r - n2 * u * u * r - 0.5 * n2 * u * r ** 3


def _squash_vjp(s, vbar):
    """d(squash)/ds applied to vbar: sc vbar + 2 s scp <s, vbar>."""
    sc, scp = _squash_parts(s)
    return sc * vbar + 2.0 * s * scp * (s * vbar).sum(dim=-1, keepdim=True)


def routed_capsules_backward_plain(x, w, s_saved, g, n_iter=3, bf16=False):
    """The VJP of `routed_capsules_plain`: (dx, dW) for the caps'
    cotangent ``g`` (B, K, D), given the forward's node sums ``s_saved``
    (n_iter, B, K, D).

    The reverse sweep of the JAX kernel (_routing_bwd_kernel): the
    squash VJP in closed form, the node-sum VJP (into the probabilities
    and the votes), the softmax VJP over the capsules, the agreement VJP
    (into the votes and the previous output), then the votes-product VJP
    into dx and dW.  The logits of iteration t are the votes dotted with
    v_0 + ... + v_{t-1}.  Plain: it forms the (B, N, K, D) votes.
    Returns dx and dW in f32 (f64 for f64 operands).
    """
    xf, wf = _operands(x, w, bf16)
    s_saved, g = s_saved.to(xf.dtype), g.to(xf.dtype)
    priors = compute_priors(xf, wf)                       # (B, N, K, D)
    k = priors.shape[2]
    v = [squash(s_saved[t]) for t in range(n_iter - 1)]   # (B, K, D)

    def probs(t):
        if t == 0:
            return priors.new_full(priors.shape[:3], 1.0 / k)
        vsum = sum(v[:t])
        return torch.softmax((priors * vsum[:, None]).sum(-1), dim=2)

    d_priors = torch.zeros_like(priors)
    lbar = torch.zeros_like(priors[..., 0])                # (B, N, K)
    vbar = g
    for t in range(n_iter - 1, -1, -1):
        sbar = _squash_vjp(s_saved[t], vbar)
        p = probs(t)
        d_priors = d_priors + p[..., None] * sbar[:, None]
        if t == 0:
            break
        pbar = (priors * sbar[:, None]).sum(-1)           # (B, N, K)
        lbar = lbar + p * (pbar - (p * pbar).sum(dim=2, keepdim=True))
        vbar = (priors * lbar[..., None]).sum(dim=1)      # (B, K, D)
        d_priors = d_priors + v[t - 1][:, None] * lbar[..., None]
    dx = torch.einsum("bnkd,nkcd->bnc", d_priors, wf)
    dw = torch.einsum("bnkd,bnc->nkcd", d_priors, xf)
    return dx, dw


def _check(name, x, w, n_iter):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 3 or w.dim() != 4 or x.shape[1] != w.shape[0] \
            or x.shape[2] != w.shape[2]:
        raise ValueError(f"{name}: need x (B, N, C) and w (N, K, C, D), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    c, k, d = x.shape[2], w.shape[1], w.shape[3]
    if (c, d) != (IN_C, OUT_D) or not 1 <= k <= MAX_CAPS:
        raise ValueError(f"{name}: the kernel takes in_C {IN_C}, D {OUT_D} "
                         f"and 1 <= K <= {MAX_CAPS}, got in_C {c}, D {d}, "
                         f"K {k}")
    if n_iter < 1:
        raise ValueError(f"{name}: n_iter must be >= 1, got {n_iter}")
    for arg, t in (("x", x), ("w", w)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: {arg} must be f32 or bf16, got "
                            f"{t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous on "
                             f"{x.device}")


def _k3(x, w, n_iter, bf16, s_saved=None):
    """Launch K3 on x and w (already in the kernel's storage type);
    writes s_t into ``s_saved`` (n_iter, B, K, D) f32 when given."""
    b, n, c = x.shape
    k, d = w.shape[1], w.shape[3]
    with torch.cuda.device(x.device):
        plan = _plan(b, n, k, _build.DTYPE_CODES[x.dtype],
                     torch.cuda.current_device())
        # per (element, node tile) node sums: 11.4 MB at CapsuleNet's shape
        partial = torch.empty((b, -(-n // plan["tile"]), k, d),
                              dtype=torch.float32, device=x.device)
        vsum = torch.empty((b, k, d), dtype=torch.float32, device=x.device)
        out = torch.empty((b, k, d), dtype=torch.float32, device=x.device)
        err = _build.library().cyt_routing(
            x.data_ptr(), w.data_ptr(), partial.data_ptr(), vsum.data_ptr(),
            out.data_ptr(), None if s_saved is None else s_saved.data_ptr(),
            b, n, k, c, d, int(n_iter), plan["tile"], plan["blocks"],
            _build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "routing")
    routed_capsules.launches += 1
    return out


def _out_dtype(x):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


@torch.library.custom_op("cyt::routing", mutates_args=(), device_types="cpu")
def routing_op(x: torch.Tensor, w: torch.Tensor, n_iter: int, bf16: bool,
               save_states: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 as an operator: (caps (B, K, D), the node sums s_t (n_iter, B,
    K, D) with ``save_states``, else an empty tensor).  This CPU
    implementation is the plain version."""
    if save_states:
        return routing_states_plain(x, w, n_iter, bf16)
    caps = routed_capsules_plain(x, w, n_iter, bf16)
    return caps, caps.new_empty((0,))


@routing_op.register_fake
def _(x, w, n_iter, bf16, save_states):
    dt = _out_dtype(x)
    shape = (x.shape[0], w.shape[1], w.shape[3])
    return (x.new_empty(shape, dtype=dt),
            x.new_empty((n_iter,) + shape if save_states else (0,),
                        dtype=dt))


@routing_op.register_kernel("cuda")
def _(x, w, n_iter, bf16, save_states):
    """The CUDA implementation: one launch of csrc/routing.cu, counted."""
    _check("routed_capsules", x, w, n_iter)
    io = torch.bfloat16 if bf16 else torch.float32
    shape = (x.shape[0], w.shape[1], w.shape[3])
    s_saved = torch.empty((n_iter,) + shape if save_states else (0,),
                          dtype=torch.float32, device=x.device)
    out = _k3(x.to(io), w.to(io), n_iter, bf16,
              s_saved if save_states else None)
    return out, s_saved


class RoutedCapsules(torch.autograd.Function):
    """K3 forward (saving the node sums s_t, 528 KB at B=64) and K4
    backward as one differentiable op; plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, w, n_iter, bf16):
        out, s_saved = torch.ops.cyt.routing(x, w, n_iter, bf16, True)
        ctx.save_for_backward(x, w, s_saved)
        ctx.n_iter, ctx.bf16 = n_iter, bf16
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, s_saved = ctx.saved_tensors
        dx, dw = routed_capsules_backward(x, w, s_saved, g.contiguous(),
                                          ctx.n_iter, ctx.bf16)
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def routed_capsules(x, w, n_iter=3, bf16=False):
    """Votes x @ W and ``n_iter`` routing iterations, one op.

    x: (B, N, 8) and w: (N, K, 8, 16), contiguous, f32 or bf16 (cast to
    bf16 when ``bf16``, to f32 otherwise); K <= 48.  Returns caps
    (B, K, 16) f32.  No (B, N, K, D) votes tensor is made on a card.
    Differentiable in x and w (K4 on a card).  Calls the operator
    ``torch.ops.cyt.routing``, which a traced program (export.py) keeps
    as one node.  The count of calls that launched the forward kernel
    is ``routed_capsules.launches`` (one per call, which issues one CUDA
    kernel).
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"routed_capsules: unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RoutedCapsules.apply(x, w, n_iter, bf16)
    return torch.ops.cyt.routing(x, w, n_iter, bf16, False)[0]


routed_capsules.launches = 0


def routed_capsules_backward(x, w, s_saved, g, n_iter=3, bf16=False):
    """K4: (dx, dW) of `routed_capsules` for the caps' cotangent ``g``
    (B, K, D), given the forward's node sums ``s_saved`` (n_iter, B, K,
    D) f32.  x and w as the forward read them.  Returns dx (B, N, 8) and
    dW (N, K, 8, 16) in f32 (`RoutedCapsules` casts them to its inputs'
    dtypes).  Calls the operator ``torch.ops.cyt.routing_bwd``.  The
    count of calls that launched the kernel is
    ``routed_capsules_backward.launches`` (one per call; the call issues
    2 * n_iter CUDA kernels)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"routed_capsules_backward: unsupported device "
                         f"{x.device}")
    return torch.ops.cyt.routing_bwd(x, w, s_saved, g, n_iter, bf16)


routed_capsules_backward.launches = 0


@torch.library.custom_op("cyt::routing_bwd", mutates_args=(),
                         device_types="cpu")
def routing_bwd_op(x: torch.Tensor, w: torch.Tensor, s_saved: torch.Tensor,
                   g: torch.Tensor, n_iter: int,
                   bf16: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 as an operator; this CPU implementation is the plain version."""
    return routed_capsules_backward_plain(x, w, s_saved, g, n_iter, bf16)


@routing_bwd_op.register_fake
def _(x, w, s_saved, g, n_iter, bf16):
    dt = _out_dtype(x)
    return x.new_empty(x.shape, dtype=dt), w.new_empty(w.shape, dtype=dt)


@routing_bwd_op.register_kernel("cuda")
def _(x, w, s_saved, g, n_iter, bf16):
    """The CUDA implementation: csrc/routing_bwd.cu, counted."""
    _check("routed_capsules_backward", x, w, n_iter)
    b, n, c = x.shape
    k, d = w.shape[1], w.shape[3]
    if n_iter > MAX_ITER_BWD:
        raise ValueError(f"routed_capsules_backward: the kernel takes n_iter "
                         f"<= {MAX_ITER_BWD}, got {n_iter}")
    for arg, t, shape in (("s_saved", s_saved, (n_iter, b, k, d)),
                          ("g", g, (b, k, d))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"routed_capsules_backward: {arg} must be f32 "
                             f"{shape} contiguous on {x.device}")
    io = torch.bfloat16 if bf16 else torch.float32
    xi, wi = x.to(io), w.to(io)
    with torch.cuda.device(x.device):
        plan = _bwd_plan(b, n, k, int(n_iter), _build.DTYPE_CODES[io],
                         torch.cuda.current_device())
        f32 = dict(dtype=torch.float32, device=x.device)
        # per element: sbar_t, the running sums V_t and v_t (3 n_iter - 2
        # vectors of K x D); per (element, cluster of node tiles) partial
        # sums of vbar
        state = torch.empty((b, 3 * n_iter - 2, k, d), **f32)
        partial = torch.empty((b, plan["partials"], k, d), **f32)
        dx = torch.empty((b, n, c), **f32)
        dw = torch.empty((n, k, c, d), **f32)
        err = _build.library().cyt_routing_bwd(
            xi.data_ptr(), wi.data_ptr(), s_saved.data_ptr(), g.data_ptr(),
            state.data_ptr(), partial.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), b, n, k, c, d, int(n_iter), plan["group"],
            _build.DTYPE_CODES[io],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "routing_bwd")
    routed_capsules_backward.launches += 1
    return dx, dw


def kernel_config(b, n, k, n_iter=3, dtype=torch.float32):
    """What K3 and K4 pick for (B, N, K, n_iter) in ``dtype`` on the
    current card, as a dict: K3's and K4's launch plans."""
    code, dev = _build.DTYPE_CODES[dtype], torch.cuda.current_device()
    return {"k3": _plan(b, n, k, code, dev),
            "k4": _bwd_plan(b, n, k, n_iter, code, dev)}


@functools.lru_cache(maxsize=64)
def _plan(b, n, k, dtype_code, device_index):
    """K3's launch on the current device (csrc/routing.cu:
    cyt_routing_plan), cached per shape, type and device: the node tile
    and the cooperative grid's blocks."""
    out = (ctypes.c_int * 2)()
    err = _build.library().cyt_routing_plan(b, n, k, dtype_code, out)
    if err != 0:
        raise RuntimeError("routed_capsules: no launch plan for "
                           f"B {b}, N {n}, K {k} on this device "
                           f"(cudaError {err})")
    return dict(zip(("tile", "blocks"), out))


@functools.lru_cache(maxsize=64)
def _bwd_plan(b, n, k, n_iter, dtype_code, device_index):
    """K4's launch plan on the current device (csrc/routing_bwd.cu:
    cyt_routing_bwd_plan), cached like `_plan`: elements per state
    copy, CTAs per cluster, nodes per CTA of the pass and final launches,
    partial sums per element, clusters resident at once in the final and
    the pass launches."""
    out = (ctypes.c_int * 7)()
    err = _build.library().cyt_routing_bwd_plan(b, n, k, n_iter, dtype_code,
                                                out)
    if err != 0:
        raise RuntimeError("routed_capsules_backward: no launch plan for "
                           f"B {b}, N {n}, K {k}, n_iter {n_iter} on this "
                           f"device (cudaError {err})")
    return dict(zip(("group", "cluster", "pass_nodes", "final_nodes",
                     "partials", "final_resident", "pass_resident"), out))
