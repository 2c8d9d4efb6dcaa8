"""The whole slice below the pipeline: encode and greedy decode of the
PyTorch port vs the JAX package (XLA path), on one tiny tri-modal model.

The parity contract: in f32 the memories and the per-step logits are within
1e-5 of JAX and the greedy tokens are identical. bf16 cases state a band."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmqg_tpu import decode as JDEC
from mmqg_tpu.data.vocab import END_ID, PAD_ID, START_ID
from mmqg_tpu.models import decoder as JD
from mmqg_tpu.models import qg_model as JQ
from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch.compat.from_jax import params_from_numpy
from mmqg_tpu_torch.models import qg_model as TQ
from tests.torch_port_fixtures import tiny_batch, tiny_model, torch_batch

torch.set_num_threads(1)
ATOL = 1e-5


@pytest.fixture(scope="module")
def model(tiny_config):
    mc, params, state = tiny_model(tiny_config, n_vocab=40, seed=3)
    return mc, params, state, params_from_numpy(params, state)


def _short_av(mc):
    """A batch whose AV lengths fall in a smaller bucket than av_max."""
    b = tiny_batch(mc, B=4, seed=7)
    b["frames_len"] = np.asarray([1, 2, 2, 1], np.int32)
    win = mc.stft_window + mc.stft_hop * (mc.mel_frames - 1)  # one example
    b["audio_len"] = np.asarray([win, 10, 2 * win, win], np.int32)
    return b


def _batches(mc):
    return {"full": tiny_batch(mc, B=4, seed=5), "short_av": _short_av(mc)}


def _jax_greedy_logits(params, mem, state, max_len, dtype):
    """Per-step logits of the JAX decoder fed its own greedy tokens."""
    B = mem.enc_text.shape[0]
    tok = jnp.full((B,), START_ID, jnp.int32)
    out = []
    for _ in range(max_len):
        logits, state, _ = JD.step(params["decoder"],
                                   params["embedding"]["table"], tok, mem,
                                   state, use_pallas=False, dtype=dtype)
        out.append(np.asarray(logits))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("which", ["full", "short_av"])
def test_buckets_match_jax(model, which):
    mc = model[0]
    b = _batches(mc)[which]
    assert DEC.audio_bucket(mc, b["audio_len"]) == JDEC.audio_bucket(
        mc, b["audio_len"])
    assert DEC.frames_bucket(mc, b["frames_len"]) == JDEC.frames_bucket(
        mc, b["frames_len"])
    for need in range(0, 120):
        assert DEC._bucket(need, 101) == JDEC._bucket(need, 101)


@pytest.mark.parametrize("which", ["full", "short_av"])
def test_encode_matches_jax_f32(model, which):
    mc, params, state, port = model
    b = _batches(mc)[which]
    cap = JDEC.audio_bucket(mc, b["audio_len"])
    fcap = JDEC.frames_bucket(mc, b["frames_len"])
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    ref_mem, (ref_h, ref_c), _ = JQ.encode(
        params, state, mc, jb, use_pallas=False, audio_cap=cap,
        frames_cap=fcap, dtype=jnp.float32)
    mem, (h, c) = DEC.encode(port, TQ.ModelConfig(**mc._asdict()),
                             torch_batch(b), dtype=torch.float32)
    for name in ref_mem._fields:
        got, ref = getattr(mem, name).numpy(), np.asarray(getattr(ref_mem, name))
        assert got.shape == ref.shape, name
        if name.endswith("_len"):
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            scale = max(1.0, float(np.abs(ref).max()))
            np.testing.assert_allclose(got / scale, ref / scale, atol=ATOL,
                                       err_msg=name)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), atol=ATOL)


@pytest.mark.parametrize("which", ["full", "short_av"])
def test_greedy_decode_matches_jax_f32(model, which):
    mc, params, state, port = model
    b = _batches(mc)[which]
    max_len = mc.target_steps - 1
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    ref_toks = np.asarray(JDEC.decode_batch(
        params, state, mc, jb, jax.random.PRNGKey(0), strategy="greedy",
        max_len=max_len, use_pallas=False, dtype=jnp.float32))
    tmc = TQ.ModelConfig(**mc._asdict())
    toks = DEC.decode_batch(port, tmc, torch_batch(b), max_len=max_len,
                            dtype=torch.float32)
    np.testing.assert_array_equal(toks.numpy(), ref_toks)

    cap = JDEC.audio_bucket(mc, b["audio_len"])
    fcap = JDEC.frames_bucket(mc, b["frames_len"])
    ref_mem, ref_state, _ = JQ.encode(params, state, mc, jb, use_pallas=False,
                                      audio_cap=cap, frames_cap=fcap,
                                      dtype=jnp.float32)
    ref_logits = _jax_greedy_logits(params, ref_mem, ref_state, max_len,
                                    jnp.float32)
    mem, dec_state = DEC.encode(port, tmc, torch_batch(b),
                                dtype=torch.float32)
    toks2, logits = DEC.decode_from_memories(port, mem, dec_state,
                                             max_len=max_len,
                                             dtype=torch.float32,
                                             return_logits=True)
    np.testing.assert_array_equal(toks2.numpy(), ref_toks)
    # rows stay comparable only while unfinished (finished rows feed PAD)
    live = np.concatenate([np.ones((len(ref_toks), 1), bool),
                           ~np.isin(ref_toks[:, :-1], (END_ID, PAD_ID))],
                          axis=1).cumprod(axis=1).astype(bool)
    np.testing.assert_allclose(logits.numpy()[live], ref_logits[live],
                               atol=ATOL)


def test_bf16_decode_band(model):
    """bf16 (the serving dtype): memories within a bf16 band of JAX's."""
    mc, params, state, port = model
    b = _batches(mc)["full"]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    ref_mem, _, _ = JQ.encode(
        params, state, mc, jb, use_pallas=False,
        audio_cap=JDEC.audio_bucket(mc, b["audio_len"]),
        frames_cap=JDEC.frames_bucket(mc, b["frames_len"]),
        dtype=jnp.bfloat16)
    mem, _ = DEC.encode(port, TQ.ModelConfig(**mc._asdict()), torch_batch(b),
                        dtype=torch.bfloat16)
    for name in ("enc_text", "enc_video", "enc_audio"):
        ref = np.asarray(getattr(ref_mem, name))
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(getattr(mem, name).numpy() / scale,
                                   ref / scale, atol=5e-2, err_msg=name)
    toks = DEC.decode_batch(port, TQ.ModelConfig(**mc._asdict()),
                            torch_batch(b), max_len=4, dtype=torch.bfloat16)
    assert toks.shape == (4, 4) and toks.dtype == torch.int32


def test_only_greedy_is_ported(model):
    mc, _, _, port = model
    with pytest.raises(NotImplementedError, match="greedy"):
        DEC.decode_batch(port, TQ.ModelConfig(**mc._asdict()),
                         torch_batch(tiny_batch(mc)), strategy="beam")


def test_tokens_to_words_matches_jax():
    toks = np.asarray([[5, 6, END_ID, 7], [PAD_ID, 5, 5, 5], [4, 4, 4, 4]])
    i2w = {str(i): f"w{i}" for i in range(8)}
    assert DEC.tokens_to_words(toks, i2w) == JDEC.tokens_to_words(toks, i2w)
