"""PyTorch port, kernels K1 (pool+leaky) and K2 (input stage).

On the CPU each wrapper takes its plain PyTorch version; these tests
hold the plain versions against the JAX functions (the Pallas kernels
in interpret mode, or their XLA formulation) on the same numpy inputs.
The CUDA kernels themselves are held against the plain versions on
the card by tests/test_torch_port_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as nn
import pytest
import torch

from cs231_capsule_yolo_traffic_sign_detection_tpu.ops import (
    input_stage as jax_is, pool_pallas)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import (
    input_stage as ist, pool)


def _jax_pool_ref(x, slope=0.1):
    return nn.max_pool(jax.nn.leaky_relu(x, slope), (2, 2), strides=(2, 2))


# ---------------------------------------------------------------- K1

@pytest.mark.parametrize("shape", [
    (2, 8, 8, 16), (1, 28, 28, 64), (3, 4, 6, 5), (2, 224, 16, 32),
])
def test_pool_plain_matches_pallas_f32_exact(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(pool_pallas.maxpool2_leaky(jnp.asarray(x), 0.1))
    got = pool.maxpool2_leaky(torch.from_numpy(x), 0.1)
    # f32: exact (max and the leaky slope reassociate nothing)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        _jax_pool_ref(jnp.asarray(x))))


def test_pool_plain_matches_pallas_bf16():
    x = np.random.RandomState(1).randn(2, 16, 16, 32).astype(np.float32)
    want = pool_pallas.maxpool2_leaky(
        jnp.asarray(x).astype(jnp.bfloat16), 0.1)
    got = pool.maxpool2_leaky(torch.from_numpy(x).bfloat16(), 0.1)
    assert got.dtype == torch.bfloat16
    # bf16 band of tests/test_pool_pallas.py
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_pool_all_negative_uses_slope():
    x = -np.ones((1, 4, 4, 8), np.float32)
    want = np.asarray(pool_pallas.maxpool2_leaky(jnp.asarray(x), 0.1))
    got = pool.maxpool2_leaky(torch.from_numpy(x), 0.1).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, -0.1 * np.ones((1, 2, 2, 8)), rtol=1e-6)


# ---------------------------------------------------------------- K2

def test_space_to_depth_and_phase_kernel_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(
        ist.space_to_depth(torch.from_numpy(x)).numpy(),
        np.asarray(jax_is.space_to_depth(jnp.asarray(x))))
    w = rng.randn(3, 3, 3, 32).astype(np.float32)
    b = rng.randn(32).astype(np.float32)
    wp, bp = ist.phase_kernel(torch.from_numpy(w), torch.from_numpy(b))
    jwp, jbp = jax_is.phase_kernel(w, b)
    np.testing.assert_array_equal(wp.numpy(), np.asarray(jwp))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(jbp))


@pytest.mark.parametrize("hw,cin,cout", [(16, 3, 32), (8, 5, 7), (64, 3, 32)])
def test_input_stage_plain_matches_jax_f32(hw, cin, cout):
    rng = np.random.RandomState(0)
    x = rng.randn(2, hw, hw, cin).astype(np.float32)
    w = (0.3 * rng.randn(3, 3, cin, cout)).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    jwp, jbp = jax_is.phase_kernel(w, b)
    want = np.asarray(jax_is.input_stage_apply(jnp.asarray(x), jwp, jbp,
                                               cout))
    wp, bp = ist.phase_kernel(torch.from_numpy(w), torch.from_numpy(b))
    got = ist.input_stage_apply(torch.from_numpy(x), wp, bp, cout).numpy()
    # f32, 27- or 45-term sums in another order: 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_input_stage_wrapper_cpu_is_plain():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 16, 16, 3))
                         .astype(np.float32))
    w = torch.from_numpy((0.3 * rng.randn(3, 3, 3, 32)).astype(np.float32))
    b = torch.from_numpy(rng.randn(32).astype(np.float32))
    before = ist.input_stage.launches
    got = ist.input_stage(x, w, b)
    wp, bp = ist.phase_kernel(w, b)
    torch.testing.assert_close(got, ist.input_stage_apply(x, wp, bp, 32),
                               rtol=0, atol=0)
    assert ist.input_stage.launches == before  # no kernel on the CPU


def test_input_stage_plain_bf16_matches_pallas_interpret():
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    w = (0.3 * rng.randn(3, 3, 3, 32)).astype(np.float32)
    b = (0.1 * rng.randn(32)).astype(np.float32)
    jwp, jbp = jax_is.phase_kernel(w, b)
    want = np.asarray(jax_is.input_stage_pallas(
        jnp.asarray(x), jwp, jbp, 32, interpret=True), np.float32)
    wt = torch.from_numpy(w).bfloat16().float()  # bf16 operands, as K2
    wp, bp = ist.phase_kernel(wt, torch.from_numpy(b))
    got = ist.input_stage_apply(torch.from_numpy(x).bfloat16(), wp, bp, 32)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    # band of tests/test_input_stage.py (bf16 rounding at other places)
    assert err.mean() < 5e-3, err.mean()
    assert err.max() < 0.1, err.max()


def test_input_stage_one_rounding_bf16_matches_pallas_interpret():
    # the reference the card holds K2's bf16 kernel to: f32 math on bf16
    # operands, rounded once to bf16, as the TPU kernel (bf16 operands,
    # f32 accumulation, one bf16 store)
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    w = (0.3 * rng.randn(3, 3, 3, 32)).astype(np.float32)
    b = (0.1 * rng.randn(32)).astype(np.float32)
    jwp, jbp = jax_is.phase_kernel(w, b)
    want = np.asarray(jax_is.input_stage_pallas(
        jnp.asarray(x), jwp, jbp, 32, interpret=True), np.float32)
    xt = torch.from_numpy(x).bfloat16()
    wt = torch.from_numpy(w).bfloat16().float()
    wp, bp = ist.phase_kernel(wt, torch.from_numpy(b))
    got = ist.input_stage_apply(xt.float(), wp, bp, 32).to(torch.bfloat16)
    # f32 sums in another order, then one rounding: within one bf16 ulp
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7,
                               atol=1e-5)


# K2 f32's arithmetic on the card: each operand a split into hi =
# tf32(a) and lo = tf32(a - hi), and a b taken as a_lo b_hi + a_hi b_lo +
# a_hi b_hi ("3xTF32", csrc/input_stage.cu), emulated here

def _tf32(a):
    """cvt.rna.tf32.f32 on the f32 bit pattern: add half a TF32 ulp
    (0x1000) and clear the low 13 bits."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(
        np.float32)


def _split(a):
    hi = _tf32(a)
    return hi, _tf32(a - hi)  # a - hi is exact in f32


def _input_stage_f64(x, w, b):
    wp, bp = ist.phase_kernel(torch.from_numpy(w.astype(np.float64)),
                              torch.from_numpy(b.astype(np.float64)))
    return ist.input_stage_apply(torch.from_numpy(x.astype(np.float64)),
                                 wp, bp, w.shape[-1]).numpy()


def _input_stage_3xtf32(x, w, b):
    """conv-pool-leaky on the split operands: the three products as one
    conv over 9 input channels (x_lo, x_hi, x_hi against w_hi, w_lo,
    w_hi), summed in f64, where each TF32 product is exact."""
    (xh, xl), (wh, wl) = _split(x), _split(w)
    return _input_stage_f64(np.concatenate([xl, xh, xh], axis=-1),
                            np.concatenate([wh, wl, wh], axis=2), b)


def _pixel_operands(rng, shape):
    """0-255 integer frames and conv1 at the serving slice's scale:
    He-normal weights with BN folded from the frames' own statistics,
    so unit-scale outputs come out of sums that cancel from ~10."""
    x = rng.randint(0, 256, shape).astype(np.float32)
    w0 = rng.randn(3, 3, 3, 32) * (2 / 27) ** 0.5
    y = torch.nn.functional.conv2d(
        torch.from_numpy(x.astype(np.float64)).permute(0, 3, 1, 2),
        torch.from_numpy(w0).permute(3, 2, 0, 1), padding=1)
    scale = 1 / np.sqrt(y.var((0, 2, 3)).numpy() + 1e-5)
    return (x, (w0 * scale).astype(np.float32),
            (-y.mean((0, 2, 3)).numpy() * scale).astype(np.float32))


@pytest.mark.parametrize("case", ["uniform", "pixels"])
def test_input_stage_3xtf32_split_keeps_f32_band(case):
    rng = np.random.RandomState(5)
    if case == "uniform":
        x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
        w = (0.3 * rng.randn(3, 3, 3, 32)).astype(np.float32)
        b = rng.randn(32).astype(np.float32)
    else:
        x, w, b = _pixel_operands(rng, (2, 32, 32, 3))
        # raw pixels are exact in TF32: only the weights' split rounds
        assert not _split(x)[1].any()
    want = _input_stage_f64(x, w, b)
    # the kernel's band: rtol 1e-5 and atol 1e-5, on 0-255 frames 1e-5 of
    # the largest output (the sums cancel from ~10 to ~1 there)
    atol = 1e-5 if case == "uniform" else 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(_input_stage_3xtf32(x, w, b), want,
                               rtol=1e-5, atol=atol)
    # one-pass TF32 (a_hi b_hi alone) keeps ~11 bits: outside the band
    one = _input_stage_f64(_tf32(x), _tf32(w), b)
    assert not np.allclose(one, want, rtol=1e-5, atol=atol)


def test_wrappers_reject_unsupported_devices():
    x = torch.empty((1, 4, 4, 3), device="meta")
    w = torch.empty((3, 3, 3, 32), device="meta")
    with pytest.raises(ValueError):
        pool.maxpool2_leaky(x)
    with pytest.raises(ValueError):
        ist.input_stage(x, w, torch.empty((32,), device="meta"))
