"""PyTorch port, the general routing kernels' numerical scheme (CPU): the
votes, dx and dW of K3g/K4g are split-precision ("3xTF32") products on
the tensor cores.  `ops.routing`'s emulation of that product (TF32
rounding as cvt.rna, hi and lo, three products into f32) is held, at
both darkcapsule variants' routing shapes (N, K, C, D) on small batches,
against the JAX Pallas routing in interpret mode and its VJP, in K3's
and K4's f32 bands; one TF32 pass must miss them."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu.ops import (
    routing_pallas as jax_rp)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import routing

# K3's and K4's f32 bands (tests/test_pallas_routing.py), which K3g and
# K4g keep
K3_BAND = dict(rtol=2e-5, atol=2e-6)
K4_BAND = dict(rtol=1e-4, atol=1e-6)
# DarkCapsuleNet3's routing (N 512, K 43, D 21) and DarkCapsuleNet2's
# (N 784, K 49, D 48), in_C 8, at B 3
SHAPES = [(3, 512, 43, 8, 21), (3, 784, 49, 8, 48)]


def _inputs(shape, seed=7):
    b, n, k, c, d = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, c).astype(np.float32),
            (0.1 * rng.randn(n, k, c, d)).astype(np.float32),
            rng.randn(b, k, d).astype(np.float32))


@pytest.mark.parametrize("value, want", [
    (1.0, 1.0), (1 + 2 ** -11, 1 + 2 ** -10), (1 + 2 ** -12, 1.0),
    (-(1 + 2 ** -11), -(1 + 2 ** -10)), (1 + 3 * 2 ** -11, 1 + 2 ** -9),
    (0.0, 0.0)])
def test_tf32_round_is_nearest_ties_away(value, want):
    got = routing.tf32_round(torch.tensor([value], dtype=torch.float32))
    assert got.item() == want


def test_split_product_is_within_2_to_the_minus_21():
    """a b as 3xTF32 against f64, over 8-term sums of the kind the votes
    take; one TF32 pass is some 2^-11 off."""
    rng = np.random.RandomState(3)
    a = torch.from_numpy(rng.randn(64, 8).astype(np.float32))
    b = torch.from_numpy(rng.randn(8, 32).astype(np.float32))
    exact = a.double() @ b.double()
    scale = (a.double().abs() @ b.double().abs())
    split = routing.einsum_3xtf32("ik,kj->ij", a, b).double()
    one = (routing.tf32_round(a) @ routing.tf32_round(b)).double()
    assert ((split - exact).abs() / scale).max() < 2 ** -21
    assert ((one - exact).abs() / scale).max() > 2 ** -13


@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_routing_matches_pallas_forward_and_vjp(shape):
    """K3g's scheme (votes in 3xTF32) against the JAX kernel's caps, and
    K4g's (votes, dx, dW in 3xTF32) against jax.grad through it."""
    x, w, cot = _inputs(shape)
    want = np.asarray(jax_rp.routed_capsules_pallas(
        jnp.asarray(x), jnp.asarray(w), 3))
    want_dx, want_dw = jax.grad(
        lambda xx, ww: jnp.sum(jax_rp.routed_capsules_pallas(xx, ww, 3)
                               * cot), argnums=(0, 1))(jnp.asarray(x),
                                                       jnp.asarray(w))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    caps, s = routing.routing_states_3xtf32(xt, wt, 3)
    np.testing.assert_allclose(caps.numpy(), want, **K3_BAND)
    dx, dw = routing.routed_capsules_backward_3xtf32(
        xt, wt, s, torch.from_numpy(cot), 3)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **K4_BAND)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), **K4_BAND)
    # the same VJP from the plain forward's node sums: the split products
    # stand in for f32 ones
    _, s_plain = routing.routing_states_plain(xt, wt, 3)
    np.testing.assert_allclose(s.numpy(), s_plain.numpy(), **K3_BAND)


@pytest.mark.parametrize("shape", SHAPES[:1])
def test_one_tf32_pass_would_miss_the_bands(shape):
    """Why the split: the votes taken in one TF32 pass leave K3's band."""
    x, w, _ = _inputs(shape)
    want = np.asarray(jax_rp.routed_capsules_pallas(
        jnp.asarray(x), jnp.asarray(w), 3))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    priors = torch.einsum("bni,nkio->bnko", routing.tf32_round(xt),
                          routing.tf32_round(wt))
    caps = routing.dynamic_routing(priors, 3)[:, 0]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(caps.numpy(), want, **K3_BAND)
