"""Every configuration of the model -- mode text / text_video / trimodal,
the attention and the non-attention decoder, the conv-LSTM and the
R(2+1)D-18 video encoder -- through the port's encode and every decode
strategy, against the JAX package (XLA path, ``use_pallas=False``).

One tiny model per configuration (hidden 16, two LSTM layers, 9 AV steps,
32 x 32 frames; R(2+1)D at its published widths on 16 x 16 frames, with
an ``fc`` head to the video width 16), random weights from a numpy seed with a peaked
decoder (``peaked``) and random batchnorm statistics, and one batch of 4
ragged rows, f32 on the CPU:

* encode: memories within 1e-5 of max(1, |reference|), lengths equal, the
  decoder's initial state within 1e-5;
* greedy: every step's logits within 1e-5 of max(1, |reference|), tokens
  identical;
* sampling, top-k (k=3) and top-p (p=0.9) with per-row streams, and beam
  search (K=3, the JAX decoder step computing in f32): tokens identical;
* ``sequence_logprob`` of the beam tokens within 1e-5.

Also: ``check_supported`` raises ValueError where the JAX package's
``from_config`` does, and for parameters of another configuration; the AV
vector of the non-attention decoder equals ``qg_model.av_vector``; and the
R(2+1)D memory's dependence on the frames cap, a defect of the reference
that the port reproduces (ROADMAP queue 3)."""

from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmqg_tpu import decode as JDEC
from mmqg_tpu.data.vocab import END_ID, PAD_ID, START_ID
from mmqg_tpu.models import decoder as JD
from mmqg_tpu.models import qg_model as JQ
from mmqg_tpu.ops.attention import AttnParams
from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch.compat.from_jax import params_from_numpy
from mmqg_tpu_torch.models import qg_model as TQ
from mmqg_tpu_torch.models.decoder import av_vector
from mmqg_tpu_torch.utils import prng
from tests.torch_port_fixtures import (peaked, random_stats, tiny_batch,
                                       torch_batch)

torch.set_num_threads(1)
TOL = 1e-5
ROW_SEEDS = np.asarray([11, -5, 2**31 - 1, -2**31], np.int32)
BEAM = 3

# ModelConfig fields of the tiny models (the flagship's fields otherwise)
BASE = dict(n_vocab=40, word_emb_dim=8, hidden_dim=16, text_layers=2,
            dec_layers=2, video_hidden_dim=16, audio_emb_dim=8,
            flatten_dim=10, context_max_length=12, av_max_length=9,
            target_steps=7, frame_size=32, mel_frames=16, mel_bins=16,
            sample_rate=1600, stft_window=64, stft_hop=32, dropout=0.0,
            text_dropout=0.0)
# R(2+1)D has no flatten width to keep: its clips are 16 x 16
RESNET = dict(frame_size=16)
# the valid (mode, decoder, video_encoder) triples; mode text has no video
CONFIGS = [("text", "attn", "conv_lstm"), ("text", "non_attn", "conv_lstm")]
CONFIGS += [(m, d, v) for m in ("text_video", "trimodal")
            for d in ("attn", "non_attn") for v in ("conv_lstm", "resnet")]
IDS = ["-".join(c if c[0] != "text" else c[:2]) for c in CONFIGS]


def jax_params(params):
    """The JAX functions take the attention weights as ``AttnParams``."""
    dec = params["decoder"]
    if "attn" not in dec:
        return params
    return dict(params, decoder=dict(dec, attn=AttnParams(**dec["attn"])))


def build(mode, decoder, video_encoder, seed=3, peak=True, **kw):
    """(JAX ModelConfig, port ModelConfig, params, state) of a tiny model
    of the configuration; ``peak`` makes its decoder peaked, so that beam
    search and top-k choose among real alternatives."""
    fields = dict(BASE, mode=mode, decoder=decoder,
                  video_encoder=video_encoder,
                  **(RESNET if video_encoder == "resnet" else {}), **kw)
    tmc = TQ.ModelConfig(**fields)
    params, state = TQ.init_params(tmc, seed)
    if peak:
        params = peaked(params, end_twin=5)
    random_stats(state, np.random.RandomState(seed + 100))
    return JQ.ModelConfig(**fields), tmc, params, state


def caps_of(mc, b):
    return dict(
        audio_cap=(JDEC.audio_bucket(mc, b["audio_len"])
                   if mc.mode == "trimodal" else None),
        frames_cap=(JDEC.frames_bucket(mc, b["frames_len"])
                    if mc.mode != "text" else None))


@pytest.fixture(scope="module", params=CONFIGS, ids=IDS)
def cfg(request):
    mc, tmc, params, state = build(*request.param)
    b = tiny_batch(mc, B=4, seed=5)
    caps = caps_of(mc, b)
    jp = jax.tree.map(jnp.asarray, jax_params(params))
    mem, st = JDEC.encode_jit(jp, jax.tree.map(jnp.asarray, state), mc,
                              {k: jnp.asarray(v) for k, v in b.items()},
                              False, caps["audio_cap"], caps["frames_cap"],
                              jnp.float32)
    port = params_from_numpy(params, state)
    pmem, pst = DEC.encode(port, tmc, torch_batch(b), dtype=torch.float32,
                           **caps)
    return dict(mc=mc, tmc=tmc, jp=jp, port=port, mem=mem, st=st,
                pmem=pmem, pst=pst, batch=b, caps=caps)


def _close(got, ref, what):
    ref = np.asarray(ref)
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= TOL * max(1.0, float(np.abs(ref).max())), (what, err)


def test_encode_matches_jax(cfg):
    mem, pmem = cfg["mem"], cfg["pmem"]
    for name in ("enc_text", "enc_video", "enc_audio"):
        ref = getattr(mem, name)
        got = getattr(pmem, name)
        assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
        _close(got.numpy(), ref, name)
    for name in ("text_len", "video_len", "audio_len"):
        np.testing.assert_array_equal(getattr(pmem, name).numpy(),
                                      np.asarray(getattr(mem, name)), name)
    for got, ref in zip(cfg["pst"], cfg["st"]):
        _close(got.numpy(), ref, "decoder state")
    mc = cfg["mc"]
    if mc.mode == "text":
        assert not pmem.enc_video.any() and not pmem.enc_audio.any()
        assert (pmem.video_len == 1).all() and (pmem.audio_len == 1).all()
    if mc.video_encoder == "resnet" and mc.mode != "text":
        np.testing.assert_array_equal(
            pmem.video_len.numpy(),
            np.maximum(-(-np.minimum(cfg["batch"]["frames_len"],
                                     cfg["caps"]["frames_cap"]) // 8), 1))


def _jax_greedy_logits(cfg, max_len):
    """The JAX decoder's greedy logits, one step at a time (f32), feeding
    <pad> after a row's <end> or <pad> as the decode does."""
    mc, jp, mem = cfg["mc"], cfg["jp"], cfg["mem"]
    emb = jp["embedding"]["table"]
    B = mem.enc_text.shape[0]
    tok = jnp.full((B,), START_ID, jnp.int32)
    done = jnp.zeros((B,), bool)
    state, out = cfg["st"], []
    av = JQ.av_vector(mem)
    for _ in range(max_len):
        if mc.decoder == "attn":
            logits, state, _ = JD.step(jp["decoder"], emb, tok, mem, state,
                                       use_pallas=False, dtype=jnp.float32)
        else:
            logits, state = JD.non_attn_step(jp["decoder"], emb, tok, av,
                                             state, dtype=jnp.float32)
        out.append(np.asarray(logits))
        tok = jnp.where(done, PAD_ID, jnp.argmax(logits, -1).astype(
            jnp.int32))
        done = done | (tok == END_ID) | (tok == PAD_ID)
    return np.stack(out, axis=1)


def test_greedy_logits_and_tokens_match_jax(cfg):
    mc = cfg["mc"]
    max_len = mc.target_steps - 1
    ref_tokens = np.asarray(JDEC.decode_from_memories(
        cfg["jp"], cfg["mem"], cfg["st"], jax.random.PRNGKey(0),
        max_len=max_len, use_pallas=False, dec_kind=mc.decoder,
        dtype=jnp.float32))
    toks, logits = DEC.decode_from_memories(
        cfg["port"], cfg["pmem"], cfg["pst"], max_len=max_len,
        dtype=torch.float32, return_logits=True)
    np.testing.assert_array_equal(toks.numpy(), ref_tokens)
    _close(logits.numpy(), _jax_greedy_logits(cfg, max_len), "logits")
    # the whole path, from the batch, gives the same tokens
    again = DEC.decode_batch(cfg["port"], cfg["tmc"], torch_batch(
        cfg["batch"]), max_len=max_len, dtype=torch.float32, **cfg["caps"])
    assert torch.equal(again, toks)


@pytest.mark.parametrize("strategy,k,p", [("sampling", 1, 0.9),
                                          ("topk", 3, 0.9),
                                          ("topp", 1, 0.9)])
def test_sampled_tokens_match_jax(cfg, strategy, k, p):
    mc = cfg["mc"]
    max_len = mc.target_steps - 1
    ref = np.asarray(JDEC.decode_from_memories(
        cfg["jp"], cfg["mem"], cfg["st"], jax.random.PRNGKey(2),
        strategy=strategy, max_len=max_len, k=k, p=p, use_pallas=False,
        dec_kind=mc.decoder, dtype=jnp.float32, row_seeds=ROW_SEEDS))
    got = DEC.decode_from_memories(
        cfg["port"], cfg["pmem"], cfg["pst"], prng.prng_key(2),
        strategy=strategy, max_len=max_len, k=k, p=p, dtype=torch.float32,
        row_seeds=ROW_SEEDS)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_beam_and_sequence_logprob_match_jax(cfg):
    mc = cfg["mc"]
    max_len = mc.target_steps - 1
    f32 = dict(dtype=jnp.float32)
    with mock.patch.object(JD, "step", partial(JD.step, **f32)), \
            mock.patch.object(JD, "non_attn_step",
                              partial(JD.non_attn_step, **f32)):
        ref = np.asarray(JDEC.beam_from_memories.__wrapped__(
            cfg["jp"], cfg["mem"], cfg["st"], max_len=max_len,
            beam_size=BEAM, use_pallas=False, dec_kind=mc.decoder))
    got = DEC.beam_from_memories(cfg["port"], cfg["pmem"], cfg["pst"],
                                 max_len=max_len, beam_size=BEAM,
                                 dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)
    ref_lp = np.asarray(JDEC.sequence_logprob_from_memories(
        cfg["jp"], cfg["mem"], cfg["st"], jnp.asarray(ref), use_pallas=False,
        dec_kind=mc.decoder, dtype=jnp.float32))
    lp = DEC.sequence_logprob_from_memories(cfg["port"], cfg["pmem"],
                                            cfg["pst"], got,
                                            dtype=torch.float32)
    np.testing.assert_allclose(lp.numpy(), ref_lp, rtol=0, atol=TOL)


def test_av_vector_matches_jax(cfg):
    got = av_vector(cfg["pmem"])
    assert torch.equal(got, TQ.av_vector(cfg["pmem"]))
    _close(got.numpy(), JQ.av_vector(cfg["mem"]), "av_vector")


def test_unknown_configurations_raise_value_error(tiny_config):
    """Unknown values raise ValueError (the JAX package's ``from_config``
    for the video encoder, the port's ``check_supported`` for all three);
    every known triple is accepted, and parameters of another
    configuration are refused."""
    with pytest.raises(ValueError, match="video_encoder"):
        JQ.ModelConfig.from_config(tiny_config.replace(video_encoder="i3d"),
                                   n_vocab=10)
    with pytest.raises(ValueError, match="video_encoder"):
        TQ.ModelConfig.from_config(tiny_config.replace(video_encoder="i3d"),
                                   n_vocab=10)
    base = TQ.ModelConfig(**BASE)
    for field, bad in (("mode", "audio"), ("decoder", "transformer"),
                       ("video_encoder", "i3d")):
        with pytest.raises(ValueError, match=field):
            TQ.check_supported(base._replace(**{field: bad}))
    for mode, dec, venc in CONFIGS:
        TQ.check_supported(base._replace(mode=mode, decoder=dec,
                                         video_encoder=venc))
    _, tmc, params, state = build("trimodal", "attn", "conv_lstm")
    model = params_from_numpy(params, state)
    TQ.check_supported(tmc, model)
    TQ.check_supported(tmc._replace(mode="text"), model)
    with pytest.raises(ValueError, match="decoder='non_attn'"):
        TQ.check_supported(tmc._replace(decoder="non_attn"), model)
    with pytest.raises(ValueError, match="VideoEncoder"):
        TQ.check_supported(tmc._replace(video_encoder="resnet"), model)
    _, tmc, params, state = build("text", "non_attn", "conv_lstm")
    with pytest.raises(ValueError, match="no video encoder"):
        TQ.check_supported(tmc._replace(mode="text_video"),
                           params_from_numpy(params, state))


@pytest.mark.parametrize("mode,decoder,video_encoder,hidden", [
    ("text", "attn", "conv_lstm", 16), ("text_video", "non_attn", "resnet",
                                        16),
    ("trimodal", "attn", "resnet", 512), ("trimodal", "non_attn",
                                          "conv_lstm", 16)])
def test_init_trees_have_the_jax_structure(mode, decoder, video_encoder,
                                           hidden):
    """``init_params`` has ``qg_model.init``'s subtrees and leaf shapes:
    no video_enc in mode text, no audio_enc outside trimodal, the resnet
    head only when video_hidden_dim != 512, the non-attention decoder's
    tree."""
    _, tmc, params, state = build(mode, decoder, video_encoder,
                                  video_hidden_dim=hidden)
    mc = JQ.ModelConfig(**tmc._asdict())
    emb = np.zeros((mc.n_vocab, mc.word_emb_dim), np.float32)
    ref_p, ref_s = jax.eval_shape(
        lambda: JQ.init(jax.random.PRNGKey(0), mc, emb))

    def shapes(tree):
        return jax.tree.map(lambda a: tuple(np.shape(a)),
                            jax.tree.map(lambda x: x, tree))

    ref_p = dict(ref_p)
    if "attn" in ref_p["decoder"]:
        ref_p["decoder"] = dict(ref_p["decoder"],
                                attn=ref_p["decoder"]["attn"]._asdict())
    assert shapes(params) == shapes(ref_p)
    assert shapes(state) == shapes(ref_s)
    assert ("video_enc" in params) == (mode != "text")
    assert ("audio_enc" in params) == (mode == "trimodal")
    if video_encoder == "resnet":
        assert ("fc" in params["video_enc"]) == (hidden != 512)


def test_resnet_memory_depends_on_the_frames_cap_in_both_packages():
    """A defect of the reference, reproduced: one row of 5 frames encoded
    at frames caps 8 and 9 -- the zeroed frames past its length pass
    through eval batchnorm's shift, and the SAME-padded temporal convs mix
    them into the valid steps, so its memory depends on how many padded
    frames follow it. Both packages move alike, and agree at each cap."""
    mc, tmc, params, state = build("text_video", "attn", "resnet")
    b = tiny_batch(mc, B=1, seed=11)
    b["frames_len"] = np.asarray([5], np.int32)
    jp = jax.tree.map(jnp.asarray, jax_params(params))
    port = params_from_numpy(params, state)
    out = {}
    for cap in (8, 9):
        ref, _ = JDEC.encode_jit(jp, jax.tree.map(jnp.asarray, state), mc,
                                 {k: jnp.asarray(v) for k, v in b.items()},
                                 False, None, cap, jnp.float32)
        got, _ = DEC.encode(port, tmc, torch_batch(b), dtype=torch.float32,
                            frames_cap=cap)
        _close(got.enc_video.numpy(), ref.enc_video, f"cap {cap}")
        assert int(got.video_len[0]) == int(ref.video_len[0]) == 1
        out[cap] = (np.asarray(ref.enc_video[0, 0]),
                    got.enc_video[0, 0].numpy())
    jax_delta = float(np.abs(out[8][0] - out[9][0]).max())
    port_delta = float(np.abs(out[8][1] - out[9][1]).max())
    assert jax_delta > 1e-3 and port_delta > 1e-3
    assert abs(jax_delta - port_delta) <= TOL * max(1.0, jax_delta)
