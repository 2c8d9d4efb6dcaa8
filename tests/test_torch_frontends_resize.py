"""The port's ``frontends.prepare_frames`` vs the JAX package's: uint8
frames -> /255 -> ``jax.image.resize(method="cubic")`` of the shortest
side -> per-channel normalisation, f32 on the CPU.

The resize weights are JAX's, bit for bit or within one f32 ulp (Keys
cubic, a = -0.5, widened by 1 / scale when downsampling). The resized
frames then differ from the JAX package's only by the order of the f32
sums: within 1e-6 on the [0, 1] scale (JAX's own f32 result is 4.4e-7
from the exact resize there). The normalisation divides by std >= 0.217,
so the normalised frames are held to 1e-6 / min(std); without a resize
they are held to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jax_scale

from mmqg_tpu.models import frontends as JF
from mmqg_tpu_torch.models import frontends as F

torch.set_num_threads(1)
TOL = 1e-6
STD = (0.22803, 0.22145, 0.216989)
NORM_TOL = TOL / min(STD)

CASES = [
    ((2, 3, 24, 24, 3), 32),     # upsampling
    ((2, 3, 64, 48, 3), 32),     # downsampling, antialiased, H != W
    ((1, 2, 240, 320, 3), 112),  # 320 x 240 -> 149 x 112
    ((1, 2, 20, 37, 3), 16),     # ragged downsampling
    ((2, 2, 32, 32, 3), 32),     # no resize
]


@pytest.mark.parametrize("n_in,n_out", [(24, 32), (64, 42), (48, 32),
                                        (240, 112), (320, 149), (17, 16)])
def test_weights_are_jax_keys_cubic(n_in, n_out):
    ref = np.asarray(jax_scale.compute_weight_mat(
        n_in, n_out, n_out / n_in, 0.0, jax_scale._fill_keys_cubic_kernel,
        True))
    got = F.resize_weights(n_in, n_out)
    assert got.shape == (n_out, n_in) and got.dtype == np.float32
    np.testing.assert_allclose(got.T, ref, rtol=0, atol=6e-8)


def test_resize_is_not_torch_bicubic():
    """torch's bicubic (a = -0.75, no antialias) is another function."""
    x = np.random.RandomState(0).randint(0, 256, (1, 1, 64, 48, 3),
                                         np.uint8)
    got = F.prepare_frames(torch.from_numpy(x), size=32, normalize=False)
    other = torch.nn.functional.interpolate(
        torch.from_numpy(x).float().div(255)[0].permute(0, 3, 1, 2),
        size=(42, 32), mode="bicubic", align_corners=False)
    assert float((got[0].permute(0, 3, 1, 2) - other).abs().max()) > 1e-2


@pytest.mark.parametrize("shape,size", CASES)
@pytest.mark.parametrize("normalize", [True, False])
def test_prepare_frames_matches_jax(shape, size, normalize):
    x = np.random.RandomState(sum(shape)).randint(0, 256, shape, np.uint8)
    ref = np.asarray(JF.prepare_frames(jnp.asarray(x), size=size,
                                       normalize=normalize))
    got = F.prepare_frames(torch.from_numpy(x), size=size,
                           normalize=normalize)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    resized = min(shape[2:4]) != size
    tol = NORM_TOL if normalize and resized else TOL
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= tol, err


def test_float_frames_and_exact_resize():
    """Float frames on the 0-255 scale are divided by 255 too, as in the
    JAX package; the port's resize is within 1e-6 of the exact (float64)
    one on the [0, 1] scale."""
    rng = np.random.RandomState(5)
    x = (rng.rand(1, 2, 240, 320, 3) * 255).astype(np.float32)
    ref = np.asarray(JF.prepare_frames(jnp.asarray(x), size=112,
                                       normalize=False))
    got = F.prepare_frames(torch.from_numpy(x), size=112,
                           normalize=False).numpy()
    assert float(np.abs(got - ref).max()) <= TOL
    wh = F.resize_weights(240, 112).astype(np.float64)
    ww = F.resize_weights(320, 149).astype(np.float64)
    exact = np.einsum("pw,btowc->btopc", ww,
                      np.einsum("oh,bthwc->btowc", wh, x / 255.0))
    assert float(np.abs(got - exact).max()) <= TOL
