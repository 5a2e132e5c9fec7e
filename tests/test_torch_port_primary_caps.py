"""PyTorch port, K5: CapsuleNet's primary capsules (ops/primary_caps.py).

On the CPU the operator ``cyt::primary_caps`` runs its plain version;
these tests hold that version to the composition it was moved from,
the operator to it, `PrimaryCapsules`' choice of path, and the kernel's
split-precision arithmetic (emulated) to the f32 band.  The CUDA kernel
itself is held against the plain version on the card by
tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
    capsule_net)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models.capsule_net \
    import PrimaryCapsules
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import (
    primary_caps as pc)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops.capsule import (
    squash)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops.routing import (
    einsum_3xtf32, tf32_round)


def _module(seed=0, **kw):
    torch.manual_seed(seed)
    return PrimaryCapsules(**kw)


def _map(b, seed=1, c=256, hw=24, dtype=torch.float32):
    """A relu'd map like conv1's, channels-last as cuDNN leaves it."""
    g = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn((b, hw, hw, c), generator=g, dtype=dtype))
    return x.permute(0, 3, 1, 2)


def _composition(m, x, dtype):
    """PrimaryCapsules.forward as it was before K5, verbatim."""
    w = torch.cat([c.weight for c in m.capsules]).to(dtype)
    b = torch.cat([c.bias for c in m.capsules]).to(dtype)
    y = F.conv2d(x.to(dtype), w, b, stride=m.stride).to(
        torch.promote_types(dtype, torch.float32))
    y = y.reshape(y.shape[0], len(m.capsules), -1).transpose(1, 2)
    return squash(y.contiguous())


def _stacked(m):
    return (torch.cat([c.weight for c in m.capsules]),
            torch.cat([c.bias for c in m.capsules]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("b", [1, 5])
def test_plain_is_the_composition_it_replaces(dtype, b):
    m = _module().to(dtype)
    x = _map(b, dtype=dtype)
    w, bias = _stacked(m)
    with torch.no_grad():
        got = pc.primary_caps_plain(x, w, bias, 8, 2, dtype)
        want = _composition(m, x, dtype)
    assert got.shape == (b, 1296, 8) and got.dtype == dtype
    assert torch.equal(got, want)


def test_operator_cpu_is_plain():
    m = _module()
    x = _map(3)
    w, b = _stacked(m)
    wp = pc.prepare_weights(w)
    assert wp.shape == (8, 64, 128, 32)
    assert torch.equal(pc.unprepare_weights(wp), w)
    # K-chunk (cc, tap r * 8 + s), output channel n, channel i of the chunk
    assert torch.equal(wp[3, 2 * 8 + 5, 17], w[17, 96:128, 2, 5])
    before = pc.primary_caps.launches
    with torch.no_grad():
        got = pc.primary_caps(x, wp, b)
        want = pc.primary_caps_plain(x, w, b, 8, 2)
    assert pc.primary_caps.launches == before  # no kernel on the CPU
    assert torch.equal(got, want)


# (case, module kwargs, map channels and size, dtype, grad on, the
# operator taken): K5's case at CapsuleNet's geometry, then each case
# that keeps the plain composition
DISPATCH = [
    ("k5", {}, (256, 24), torch.float32, False, True),
    ("grad", {}, (256, 24), torch.float32, True, False),
    ("bf16", {}, (256, 24), torch.bfloat16, False, False),
    ("f64", {}, (256, 24), torch.float64, False, False),
    ("darkcapsule2_1x1", dict(in_channels=512, kernel=1, stride=1), (512, 7),
     torch.float32, False, False),
]


@pytest.mark.parametrize("case,kw,shape,dtype,grad,taken", DISPATCH,
                         ids=[c[0] for c in DISPATCH])
def test_dispatch(monkeypatch, case, kw, shape, dtype, grad, taken):
    m = _module(**kw)
    if dtype == torch.float64:
        m = m.double()
    x = _map(2, c=shape[0], hw=shape[1],
             dtype=torch.float64 if dtype == torch.float64 else torch.float32)
    calls = []

    def spy(*args):
        calls.append(args)
        return pc.primary_caps(*args)

    monkeypatch.setattr(capsule_net, "primary_caps", spy)
    with torch.set_grad_enabled(grad):
        got = m(x, dtype)
        assert pc.takes(m.capsules, x, dtype) is taken
    assert len(calls) == int(taken)
    assert got.requires_grad is grad
    with torch.no_grad():
        assert torch.equal(got.detach(), _composition(m, x, dtype))


def test_dispatch_cpu_runs_the_plain_version():
    """A CPU tensor in K5's case takes the operator, whose CPU
    implementation is the plain version: no launch, the same bits; its
    weights are laid out once and kept until a weight changes."""
    m = _module()
    x = _map(2)
    before = pc.primary_caps.launches
    with torch.inference_mode():
        got = m(x)
        kept = m._k5_w
        m(x)
        assert m._k5_w is kept
    assert pc.primary_caps.launches == before
    with torch.no_grad():
        assert torch.equal(got, _composition(m, x, torch.float32))
        m.capsules[0].weight.mul_(2)
        m(x)
    assert m._k5_w is not kept


@pytest.mark.parametrize("case", ["relu", "signed"])
def test_3xtf32_split_keeps_f32_band(case):
    """The kernel's product, emulated: x and W split into hi = tf32(v)
    and lo = tf32(v - hi), a_lo b_hi + a_hi b_lo + a_hi b_hi over K =
    16,384, within rtol/atol 1e-5 of the f64 conv, the card tests' band
    (each product keeps ~2^-22 of |a b|; the sums' order is f32's), where
    one-pass TF32 (~2^-11) fails it."""
    m = _module()
    x = _map(1, seed=4)
    if case == "signed":
        x = x - 0.5
    w, b = (t.detach() for t in _stacked(m))
    a = F.unfold(x, 8, stride=2).transpose(1, 2)[0]        # (81, C*64)
    wf = w.reshape(128, -1).t()                            # (C*64, 128)
    want = (a.double() @ wf.double() + b.double()).t().reshape(1, 128, 81)
    got = (einsum_3xtf32("mk,kn->mn", a, wf) + b).t().reshape(1, 128, 81)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    one = (tf32_round(a) @ tf32_round(wf) + b).t().reshape(1, 128, 81)
    assert not np.allclose(one.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
