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


def test_wrappers_reject_unsupported_devices():
    x = torch.empty((1, 4, 4, 3), device="meta")
    w = torch.empty((3, 3, 3, 32), device="meta")
    with pytest.raises(ValueError):
        pool.maxpool2_leaky(x)
    with pytest.raises(ValueError):
        ist.input_stage(x, w, torch.empty((32,), device="meta"))
