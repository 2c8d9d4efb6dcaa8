"""The int8 tower's activation quantize and the s8 kernel's weight layout,
on the CPU, against the JAX package's ``embed_examples_int8`` formula.

On the card the next layer's quantize is fused into the conv: under static
scales its epilogue writes round_half_even(clip(y / sx, 0, 127)) itself;
under dynamic ones it folds each example's max of y and ``quantize_s8``
makes sx = max(m, 1e-6) / 127 and round_half_even(y / sx). On a CPU tensor
``conv3x3_relu_int8_quant`` and ``quantize_s8`` run the plain versions
(``quantize_activations``), which these tests hold to JAX bit for bit, with
quotients on .5 (round half to even), and with the pool before and after
the quantize (the kernel may take either order: the quantize is monotone).
Every comparison here is exact. The kernels are held to the plain versions
on the card in tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmqg_tpu_torch.ops import vggish as V
from mmqg_tpu_torch.ops.vggish import pack_weights_kmajor

torch.set_num_threads(1)


def _jax_quantize(x, scale):
    """``embed_examples_int8``'s activation quantize (:147-156)."""
    if scale is not None:
        return (jnp.round(jnp.clip(x.astype(jnp.float32) / scale, 0.0,
                                   127.0)).astype(jnp.int8),
                jnp.full((x.shape[0],), scale, jnp.float32))
    sx = jnp.maximum(jnp.max(x, axis=(1, 2, 3), keepdims=True).astype(
        jnp.float32), 1e-6) / 127.0
    return (jnp.round(x.astype(jnp.float32) / sx).astype(jnp.int8),
            sx.reshape(-1))


def _jax_conv(xq, sx, w, b, pool):
    """``embed_examples_int8``'s conv and epilogue for one layer, f32."""
    sw = jnp.max(jnp.abs(w), axis=(0, 1, 2)) / 127.0
    wq = jnp.round(w / jnp.maximum(sw, 1e-12)).astype(jnp.int8)
    yi = jax.lax.conv_general_dilated(
        xq, wq, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    y = jax.nn.relu(yi.astype(jnp.float32) * (sx[:, None, None, None] * sw)
                    + b)
    if pool:
        y = y.reshape(y.shape[0], y.shape[1] // 2, 2, y.shape[2] // 2, 2,
                      -1).max(axis=(2, 4))
    return y


@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("static", [False, True])
def test_fused_quantize_matches_jax_formula(pool, static):
    """quantize_s8 (conv2's input) then conv3x3_relu_int8_quant (a conv and
    the next layer's quantize): the same int8 values and scales as JAX."""
    rng = np.random.RandomState(int(pool) + 2 * int(static))
    x = np.maximum(rng.randn(2, 8, 6, 32), 0.0).astype(np.float32)
    w = (rng.randn(3, 3, 32, 48) * 0.1).astype(np.float32)
    b = (rng.randn(48) * 0.1).astype(np.float32)
    s0, s1 = (0.02, 0.05) if static else (None, None)
    jq0, js0 = _jax_quantize(jnp.asarray(x), s0)
    jq1, js1 = _jax_quantize(_jax_conv(jq0, js0, jnp.asarray(w),
                                       jnp.asarray(b), pool), s1)
    xq0, sx0 = V.quantize_s8(torch.from_numpy(x), s0)
    np.testing.assert_array_equal(xq0.numpy(), np.asarray(jq0))
    np.testing.assert_array_equal(sx0.numpy(), np.asarray(js0))
    wq, sw = V.quantize_weights(torch.from_numpy(w))
    xq1, sx1 = V.conv3x3_relu_int8_quant(xq0, wq, sx0, sw, torch.from_numpy(b),
                                         pool=pool, dtype=torch.float32,
                                         next_scale=s1)
    assert int(xq1.max()) > 0
    np.testing.assert_array_equal(xq1.numpy(), np.asarray(jq1))
    np.testing.assert_array_equal(sx1.numpy(), np.asarray(js1))


def _halves(dtype):
    """Two examples of k / 4, k = 0..254 (max 63.5): every quotient by 0.5,
    the dynamic scale 63.5 / 127 here, is a multiple of 1/2."""
    k = torch.arange(256) % 255
    x = (k.float() / 4).reshape(1, 8, 8, 4).repeat(2, 1, 1, 1)
    return x.to(dtype)


@pytest.mark.parametrize("static", [False, True])
def test_quantize_rounds_half_to_even_like_jax(static):
    for dtype in (torch.float32, torch.bfloat16):
        x = _halves(dtype)
        scale = 0.5 if static else None
        xq, sx = V.quantize_s8(x, scale)
        jq, js = _jax_quantize(jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32), scale)
        np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(sx.numpy(), np.asarray(js))
        assert float(sx[0]) == 0.5
        # 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 3.5 -> 4
        assert xq.reshape(2, -1)[0, :8].tolist() == [0, 0, 1, 2, 2, 2, 3, 4]


@pytest.mark.parametrize("static", [False, True])
def test_pool_then_quantize_equals_quantize_then_pool(static):
    """The kernel pools the rounded values and quantizes them (static), or
    folds the max of the pooled values into sx (dynamic): the same int8
    values as quantizing every position and pooling the int8 values, and
    the same scale, since the pool keeps each example's max."""
    rng = np.random.RandomState(3)
    y = torch.from_numpy(np.maximum(rng.randn(3, 8, 8, 16), 0).astype(
        np.float32)).to(torch.bfloat16)
    y[0, :4, :4, :4] = _halves(torch.bfloat16)[0, :4, :4, :4]
    scale = 0.01 if static else None
    pooled_q, pooled_s = V.quantize_activations(V._pool2(y), scale)
    q, s = V.quantize_activations(y, scale)
    assert torch.equal(pooled_s, s)
    assert torch.equal(pooled_q, V._pool2(q))


@pytest.mark.parametrize("Cin", [32, 64, 128])
def test_pack_weights_kmajor_int8_is_the_gemm_k_order(Cin):
    """Row co of the int8 packing is K = (tap, channel) of output channel
    co, and the s8 kernel's 128-byte K slices cut it as written: at Cin =
    64 a slice holds two taps, and the last of K = 576 bytes is half a
    slice (the kernel zero-fills the rest)."""
    rng = np.random.RandomState(Cin)
    wq = torch.from_numpy(rng.randint(-127, 128, (3, 3, Cin, 128)).astype(
        np.int8))
    got = pack_weights_kmajor(wq, torch.int8)
    assert got.dtype == torch.int8 and got.shape == (128, 3, 3, Cin)
    assert got.is_contiguous()
    rows = got.reshape(128, 9 * Cin)
    taps = wq.reshape(9, Cin, 128)
    for co in (0, 77, 127):
        assert torch.equal(rows[co], taps[:, :, co].reshape(-1))
        for k in range(0, 9 * Cin, 16):      # the kernel's 16-byte copies
            tap, c = divmod(k, Cin)
            assert torch.equal(rows[co, k:k + 16], taps[tap, c:c + 16, co])
    slices = -(-9 * Cin // 128)
    assert slices * 128 - 9 * Cin == {32: 96, 64: 64, 128: 0}[Cin]
    if Cin == 64:
        assert torch.equal(rows[5, 128:256],
                           torch.cat([taps[2, :, 5], taps[3, :, 5]]))


def test_cpu_int8_wrappers_count_no_launch_and_no_route():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(np.maximum(rng.randn(2, 4, 4, 32), 0).astype(
        np.float32))
    wq, sw = V.quantize_weights(torch.from_numpy(
        (rng.randn(3, 3, 32, 128) * 0.1).astype(np.float32)))
    b = torch.zeros(128)
    before = V.conv3x3_relu_int8.launches, V.quantize_s8.launches
    xq, sx = V.quantize_s8(x)
    y = V.conv3x3_relu_int8(xq, wq, sx, sw, b, pool=True,
                            dtype=torch.float32)
    q2, s2 = V.conv3x3_relu_int8_quant(xq, wq, sx, sw, b, pool=True,
                                       dtype=torch.float32)
    assert (V.conv3x3_relu_int8.launches, V.quantize_s8.launches) == before
    assert torch.equal(y, V.conv3x3_relu_int8_plain(xq, wq, sx, sw, b,
                                                    pool=True,
                                                    dtype=torch.float32))
    assert torch.equal(q2, V.quantize_activations(y)[0])
