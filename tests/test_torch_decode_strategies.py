"""Sampling, top-k, top-p and beam decoding and sequence log-probabilities
of the PyTorch port vs the JAX package (XLA path), on one tiny tri-modal
model whose decoder is made peaked (``peaked``), so that beam search and
top-k choose among real alternatives.

The parity contract here: in f32 every strategy's tokens equal the JAX
package's at the same key, with per-row and per-batch streams; beam tokens
equal JAX's beam search run in f32 (its decoder step's compute dtype set
to f32 by this file: the JAX package itself always beams in bf16);
``sequence_logprob`` is within 1e-5. bf16 (the serving dtype): the tokens
of each strategy are the JAX package's at these seeds, and the bf16
log-probabilities of those tokens are within BF16_LOGP_TOL of JAX's."""

from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmqg_tpu import decode as JDEC
from mmqg_tpu.data.vocab import END_ID, PAD_ID
from mmqg_tpu.models import decoder as JD
from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch.compat.from_jax import params_from_numpy
from mmqg_tpu_torch.models import qg_model as TQ
from mmqg_tpu_torch.utils import prng
from tests.torch_port_fixtures import (peaked, short_av_batch, tiny_batch,
                                       tiny_model, torch_batch)

torch.set_num_threads(1)
LOGP_ATOL = 1e-5
# bf16 log-probability of one 5-token row, port vs JAX on the same tokens:
# the two packages' bf16 activations differ by a bf16 ulp here and there
# (f32 sums in other orders before each rounding); measured 1.0e-2
# (sampling, topp) and 5.1e-3 (topk, beam)
BF16_LOGP_TOL = 2e-2
ROW_SEEDS = np.asarray([11, -5, 2**31 - 1, -2**31], np.int32)
SAMPLED = [("sampling", 1, 0.9), ("topk", 1, 0.9), ("topk", 3, 0.9),
           ("topp", 1, 0.5), ("topp", 1, 0.9), ("topp", 1, 1.0)]


@pytest.fixture(scope="module")
def model(tiny_config):
    mc, params, state = tiny_model(tiny_config, n_vocab=40, seed=3)
    params = peaked(params)
    return (mc, params, state, params_from_numpy(params, state),
            TQ.ModelConfig(**mc._asdict()))


def _batches(mc):
    return {"full": tiny_batch(mc, B=4, seed=5),
            "short_av": short_av_batch(mc)}


def _caps(mc, b):
    return dict(audio_cap=JDEC.audio_bucket(mc, b["audio_len"]),
                frames_cap=JDEC.frames_bucket(mc, b["frames_len"]))


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def jax_beam(params, state, mc, b, *, max_len, beam_size, dtype):
    """JAX's beam search with its decoder step computing in ``dtype``."""
    caps = _caps(mc, b)
    mem, st = JDEC.encode_jit(params, state, mc, _jax(b), False,
                              caps["audio_cap"], caps["frames_cap"], dtype)
    with mock.patch.object(JD, "step", partial(JD.step, dtype=dtype)):
        return np.array(JDEC.beam_from_memories.__wrapped__(
            params, mem, st, max_len=max_len, beam_size=beam_size,
            use_pallas=False))


@pytest.mark.parametrize("which", ["full", "short_av"])
@pytest.mark.parametrize("per_row", [True, False], ids=["row", "batch"])
@pytest.mark.parametrize("strategy,k,p", SAMPLED)
def test_sampled_tokens_match_jax_f32(model, which, per_row, strategy, k, p):
    mc, params, state, port, tmc = model
    b = _batches(mc)[which]
    seeds = ROW_SEEDS if per_row else None
    max_len = mc.target_steps - 1
    ref = np.array(JDEC.decode_batch(
        params, state, mc, _jax(b), jax.random.PRNGKey(2), strategy=strategy,
        max_len=max_len, k=k, p=p, use_pallas=False, dtype=jnp.float32,
        row_seeds=seeds))
    got = DEC.decode_batch(port, tmc, torch_batch(b), prng.prng_key(2),
                           strategy=strategy, max_len=max_len, k=k, p=p,
                           dtype=torch.float32, row_seeds=seeds)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("strategy,k,p", [("sampling", 1, 0.9),
                                          ("topk", 3, 0.9),
                                          ("topp", 1, 0.9)])
def test_row_alone_equals_row_in_batch(model, strategy, k, p):
    """Per-row streams: each row's tokens are the same served alone as in
    the batch of four (same AV caps, so the same encoder work)."""
    mc, _, _, port, tmc = model
    b = tiny_batch(mc, B=4, seed=5)
    kw = dict(strategy=strategy, max_len=mc.target_steps - 1, k=k, p=p,
              dtype=torch.float32, **_caps(mc, b))
    key = prng.prng_key(4)
    batch = DEC.decode_batch(port, tmc, torch_batch(b), key,
                             row_seeds=ROW_SEEDS, **kw)
    for i in range(4):
        one = {n: v[i:i + 1] for n, v in b.items()}
        alone = DEC.decode_batch(port, tmc, torch_batch(one), key,
                                 row_seeds=ROW_SEEDS[i:i + 1], **kw)
        assert torch.equal(alone[0], batch[i]), i
    # the per-batch stream does depend on the row's position
    shuffled = DEC.decode_batch(port, tmc, torch_batch(
        {n: v[::-1].copy() for n, v in b.items()}), key, **kw)
    plain = DEC.decode_batch(port, tmc, torch_batch(b), key, **kw)
    assert not torch.equal(shuffled.flip(0), plain)


@pytest.mark.parametrize("which", ["full", "short_av"])
@pytest.mark.parametrize("beam_size", [1, 4])
def test_beam_matches_jax_f32(model, which, beam_size):
    mc, params, state, port, tmc = model
    b = _batches(mc)[which]
    max_len = mc.target_steps - 1
    ref = jax_beam(params, state, mc, b, max_len=max_len,
                   beam_size=beam_size, dtype=jnp.float32)
    got = DEC.beam_decode_batch(port, tmc, torch_batch(b), max_len=max_len,
                                beam_size=beam_size, dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)
    if beam_size == 1:
        greedy = DEC.decode_batch(port, tmc, torch_batch(b), max_len=max_len,
                                  dtype=torch.float32)
        assert torch.equal(got, greedy)


def test_beam_differs_from_greedy_and_ends(model):
    """The fixture makes beam search choose: its best beams are not the
    greedy ones, at least one ends with <end> before max_len, and each
    scores at least the greedy row's length-normalised log-probability."""
    mc, _, _, port, tmc = model
    b = tiny_batch(mc, B=4, seed=5)
    tb = torch_batch(b)
    max_len = mc.target_steps - 1
    beam = DEC.beam_decode_batch(port, tmc, tb, max_len=max_len,
                                 dtype=torch.float32)
    greedy = DEC.decode_batch(port, tmc, tb, max_len=max_len,
                              dtype=torch.float32)
    assert not torch.equal(beam, greedy)
    assert bool((beam[:, :-1] == END_ID).any())

    def norm(toks):
        lp = DEC.sequence_logprob(port, tmc, tb, toks, dtype=torch.float32)
        stop = (toks == END_ID) | (toks == PAD_ID)
        n = torch.where(stop.any(1), stop.int().argmax(1) + 1, toks.shape[1])
        return lp / n.float() ** 0.6

    assert bool((norm(beam) >= norm(greedy) - 1e-6).all())


@pytest.mark.parametrize("which", ["full", "short_av"])
def test_sequence_logprob_matches_jax_f32(model, which):
    mc, params, state, port, tmc = model
    b = _batches(mc)[which]
    max_len = mc.target_steps - 1
    rng = np.random.RandomState(1)
    toks = rng.randint(3, mc.n_vocab, (4, max_len)).astype(np.int32)
    toks[0, 2] = END_ID
    toks[1, 0] = PAD_ID
    toks[2, 4:] = PAD_ID
    beam = jax_beam(params, state, mc, b, max_len=max_len, beam_size=4,
                    dtype=jnp.float32)
    for rows in (toks, beam):
        ref = np.asarray(JDEC.sequence_logprob(
            params, state, mc, _jax(b), jnp.asarray(rows), use_pallas=False,
            dtype=jnp.float32))
        got = DEC.sequence_logprob(port, tmc, torch_batch(b),
                                   torch.from_numpy(rows),
                                   dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), ref, atol=LOGP_ATOL)


@pytest.mark.parametrize("strategy,k,p", [("sampling", 1, 0.9),
                                          ("topk", 3, 0.9),
                                          ("topp", 1, 0.9),
                                          ("beam", 4, 0.9)])
def test_bf16_band(model, strategy, k, p):
    mc, params, state, port, tmc = model
    b = tiny_batch(mc, B=4, seed=5)
    max_len = mc.target_steps - 1
    if strategy == "beam":
        ref = jax_beam(params, state, mc, b, max_len=max_len, beam_size=k,
                       dtype=jnp.bfloat16)
        got = DEC.beam_decode_batch(port, tmc, torch_batch(b),
                                    max_len=max_len, beam_size=k,
                                    dtype=torch.bfloat16)
    else:
        ref = np.array(JDEC.decode_batch(
            params, state, mc, _jax(b), jax.random.PRNGKey(2),
            strategy=strategy, max_len=max_len, k=k, p=p, use_pallas=False,
            dtype=jnp.bfloat16, row_seeds=ROW_SEEDS))
        got = DEC.decode_batch(port, tmc, torch_batch(b), prng.prng_key(2),
                               strategy=strategy, max_len=max_len, k=k, p=p,
                               dtype=torch.bfloat16, row_seeds=ROW_SEEDS)
    assert got.dtype == torch.int32 and got.shape == (4, max_len)
    np.testing.assert_array_equal(got.numpy(), ref)
    lp_ref = np.asarray(JDEC.sequence_logprob(
        params, state, mc, _jax(b), jnp.asarray(ref), use_pallas=False,
        dtype=jnp.bfloat16))
    lp = DEC.sequence_logprob(port, tmc, torch_batch(b), torch.from_numpy(ref),
                              dtype=torch.bfloat16)
    np.testing.assert_allclose(lp.numpy(), lp_ref, atol=BF16_LOGP_TOL)


def test_top_k_orders_exact_ties_as_lax_top_k():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 4, (6, 50)).astype(np.float32)
    x[0, :10] = -1e30
    x[1] = 2.0
    for k in (1, 3, 8):
        ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = DEC._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))


@pytest.mark.parametrize("per_row", [True, False], ids=["row", "batch"])
def test_topk_draw_among_exact_ties_matches_jax(per_row):
    """Logits with exact ties inside and at the edge of the top k: the
    order of the k values decides which index a draw picks."""
    rng = np.random.RandomState(1)
    logits = rng.randint(0, 3, (8, 40)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    row_keys = (jax.vmap(lambda s: jax.random.fold_in(key, s))(
        jnp.arange(8, dtype=jnp.int32)) if per_row else None)
    tkey = prng.prng_key(5)
    t_rows = prng.fold_in(tkey, torch.arange(8)) if per_row else None
    for k in (2, 5, 12):
        ref = np.asarray(JDEC._select_token("topk", jnp.asarray(logits), key,
                                            k, row_keys=row_keys))
        noise = (prng.gumbel(t_rows, (k,)) if per_row
                 else prng.gumbel(tkey, (8, k)))
        got = DEC._select_token("topk", torch.from_numpy(logits), noise, k)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_topp_nucleus_matches_jax_on_many_rows():
    """The nucleus threshold from each package's own softmax and cumsum:
    over 512 rows x 5 values of p, the drawn tokens agree."""
    rng = np.random.RandomState(2)
    logits = (rng.randn(512, 40) * rng.uniform(0.5, 4, (512, 1))).astype(
        np.float32)
    key = jax.random.PRNGKey(6)
    for p in (0.1, 0.5, 0.9, 0.99, 1.0):
        ref = np.asarray(JDEC._select_token("topp", jnp.asarray(logits), key,
                                            1, p))
        got = DEC._select_token("topp", torch.from_numpy(logits),
                                prng.gumbel(prng.prng_key(6), (512, 40)),
                                1, p)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("per_row", [True, False], ids=["row", "batch"])
def test_step_noise_drawn_at_once_equals_each_step_draw(per_row):
    """The noise of all steps, drawn before the loop, is bit for bit what
    step t's own key ``fold_in(stream, t)`` draws."""
    key = prng.prng_key(9)
    stream = prng.fold_in(key, torch.tensor([3, -1, 2 ** 31 - 1])) \
        if per_row else key
    noise = DEC._step_noise(stream, 5, 3, 11)
    assert noise.shape == (5, 3, 11)
    for t in range(5):
        want = prng.gumbel(prng.fold_in(stream, t), (11,) if per_row
                           else (3, 11))
        assert torch.equal(noise[t], want)


def test_greedy_builds_no_key_and_unknown_strategy_raises(model):
    mc, _, _, port, tmc = model
    tb = torch_batch(tiny_batch(mc, B=2, seed=5))

    def boom(*args, **kw):
        raise AssertionError("a PRNG op ran")

    with mock.patch.multiple(prng, prng_key=boom, fold_in=boom, split=boom,
                             gumbel=boom, categorical=boom):
        DEC.decode_batch(port, tmc, tb, max_len=3, dtype=torch.float32)
        DEC.decode_batch(port, tmc, tb, max_len=3, strategy="topk", k=1,
                         dtype=torch.float32)
    with pytest.raises(ValueError, match="unknown strategy: beam"):
        DEC.decode_batch(port, tmc, tb, prng.prng_key(0), strategy="beam")
    with pytest.raises(ValueError, match="pass rng"):
        DEC.decode_batch(port, tmc, tb, strategy="sampling")
