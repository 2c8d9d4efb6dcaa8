"""``mmqg_tpu_torch.utils.prng`` vs ``jax.random`` (JAX 0.9.0, threefry,
``jax_threefry_partitionable`` True): keys, splits, fold-ins, bits and
uniforms equal JAX's bit for bit; Gumbel noise is within GUMBEL_ULPS f32
ulps of max(1, |g|) (the two libraries' float32 ``log`` differ in the last
bit; measured 1), and categorical draws equal JAX's at these seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmqg_tpu_torch.utils import prng

torch.set_num_threads(1)
GUMBEL_ULPS = 4
SHAPES = [(40,), (4, 40), (3, 2000)]
SEEDS = [0, 1, 42, -1, -5, 2**31 - 1, 2**31, 2**32 + 7, 2**40 + 3, -2**40]


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_jax_flags_are_the_ones_reproduced():
    assert jax.__version__ == "0.9.0"
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


def test_threefry2x32_known_answers():
    """Random123's known-answer vectors for Threefry-2x32 with 20 rounds."""
    cases = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
             ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
              (0x1CB996FC, 0xBB002BE7)),
             ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
              (0xC4923A9C, 0x483DF7A0))]
    for key, count, want in cases:
        got = prng.threefry2x32(*(torch.tensor(v) for v in key + count))
        assert tuple(int(g) for g in got) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_and_fold_in_match_jax(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(tkey.numpy(), _np(key))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(prng.split(tkey, num).numpy(),
                                      _np(jax.random.split(key, num)))
    for data in (0, 7, 2**31 - 1, -3, -2**31):
        ref = jax.random.fold_in(key, jnp.int32(data))
        np.testing.assert_array_equal(prng.fold_in(tkey, data).numpy(),
                                      _np(ref))


def test_batched_fold_in_matches_vmap():
    key = jax.random.PRNGKey(3)
    data = np.asarray([0, 5, -1, 2**31 - 1, -2**31, 123456], np.int32)
    ref = jax.vmap(lambda d: jax.random.fold_in(key, d))(jnp.asarray(data))
    got = prng.fold_in(prng.prng_key(3), torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), _np(ref))
    # and a batch of keys each folded with one step
    ref2 = jax.vmap(lambda k: jax.random.fold_in(k, 9))(ref)
    np.testing.assert_array_equal(prng.fold_in(got, 9).numpy(), _np(ref2))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 7])
def test_bits_and_uniform_match_jax(shape, seed):
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(prng.random_bits(tkey, shape).numpy(),
                                  _np(jax.random.bits(key, shape)))
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0),
                   (-2.0, 3.0)):
        ref = np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))
        got = prng.uniform(tkey, shape, lo, hi).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_batched_keys_draw_as_vmap(shape):
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    tkeys = prng.split(prng.prng_key(11), 3)
    ref = jax.vmap(lambda k: jax.random.bits(k, shape))(keys)
    np.testing.assert_array_equal(prng.random_bits(tkeys, shape).numpy(),
                                  _np(ref))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gumbel_within_band_of_jax(shape, seed):
    ref = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    got = prng.gumbel(prng.prng_key(seed), shape).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    eps = np.finfo(np.float32).eps
    band = GUMBEL_ULPS * eps * np.maximum(1.0, np.abs(ref))
    assert (np.abs(got.astype(np.float64) - ref) <= band).all()


@pytest.mark.parametrize("seed", [0, 3, 8])
def test_categorical_matches_jax(seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(6, 50) * 2).astype(np.float32)
    logits[:, :5] = -1e30
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    ref = np.asarray(jax.random.categorical(key, jnp.asarray(logits)))
    got = prng.categorical(tkey, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), ref)
    keys = jax.random.split(key, 6)
    ref_rows = np.asarray(jax.vmap(jax.random.categorical)(
        keys, jnp.asarray(logits)))
    got_rows = prng.categorical(prng.split(tkey, 6), torch.from_numpy(logits))
    np.testing.assert_array_equal(got_rows.numpy(), ref_rows)
    assert (got_rows.numpy() >= 5).all()
    with pytest.raises(ValueError, match="float32"):
        prng.categorical(tkey, torch.from_numpy(logits).double())
