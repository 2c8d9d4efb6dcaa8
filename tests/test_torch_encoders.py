"""Layers, frontends and the three encoders of the PyTorch port vs the JAX
package, on one tiny tri-modal model (tiny_config widths) and seeded inputs.

f32 comparisons hold to atol 1e-5 unless a case states otherwise; the JAX
side runs its XLA path (the CPU path of the JAX package)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmqg_tpu.models import audio_encoder as JAE
from mmqg_tpu.models import frontends as JF
from mmqg_tpu.models import layers as JL
from mmqg_tpu.models import text_encoder as JTE
from mmqg_tpu.models import video_encoder as JVE
from mmqg_tpu_torch.compat.from_jax import params_from_numpy
from mmqg_tpu_torch.models import frontends as F
from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.models.video_encoder import flatten_dim_for
from tests.torch_port_fixtures import tiny_batch, tiny_model

torch.set_num_threads(1)
ATOL = 1e-5


@pytest.fixture(scope="module")
def model(tiny_config):
    mc, params, state = tiny_model(tiny_config)
    return mc, params, state, params_from_numpy(params, state)


@pytest.fixture(scope="module")
def batch(model):
    return tiny_batch(model[0])


def _t(a):
    return torch.tensor(np.asarray(a))


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("padding", ["VALID", "SAME"])
def test_conv2d_matches_jax(padding):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 7, 3).astype(np.float32)
    w = rng.randn(3, 3, 3, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    ref = JL.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                    jnp.asarray(x), padding=padding, dtype=jnp.float32)
    got = L.conv2d(_t(x), _t(w), _t(b), padding=padding, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("window", [2, 3])
def test_maxpool_batchnorm_dense_match_jax(window):
    rng = np.random.RandomState(window)
    x = rng.randn(2, 11, 8, 4).astype(np.float32)
    np.testing.assert_array_equal(
        L.maxpool2d(_t(x), window).numpy(),
        np.asarray(JL.maxpool2d(jnp.asarray(x), window)))
    bn = {"scale": rng.rand(4) + 0.5, "bias": rng.randn(4)}
    st = {"mean": rng.randn(4), "var": rng.rand(4) + 0.5}
    bn, st = ({k: v.astype(np.float32) for k, v in d.items()} for d in (bn, st))
    ref, _ = JL.batchnorm({k: jnp.asarray(v) for k, v in bn.items()},
                          {k: jnp.asarray(v) for k, v in st.items()},
                          jnp.asarray(x), train=False)
    got = L.BatchNorm(*(_t(v) for v in (bn["scale"], bn["bias"], st["mean"],
                                        st["var"])))(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    w, b = rng.randn(4, 6).astype(np.float32), rng.randn(6).astype(np.float32)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, ATOL),
                          (jnp.bfloat16, torch.bfloat16, 1e-5)):
        ref = JL.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                       jnp.asarray(x), dtype=jdt)
        got = L.Dense(_t(w), _t(b))(_t(x), tdt)
        # bf16: the same rounded operands, products exact in f32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol)


# --------------------------------------------------------------- frontends

def test_frontend_tables_and_log_mel_match_jax(model, batch):
    mc = model[0]
    np.testing.assert_array_equal(F.mel_filterbank(64, 257, 16000, 125, 7500),
                                  JF.mel_filterbank(64, 257, 16000, 125, 7500))
    np.testing.assert_array_equal(F.stft_kernels(400, 512, 480),
                                  JF.stft_kernels(400, 512, 480))
    kw = dict(sample_rate=mc.sample_rate, window=mc.stft_window,
              hop=mc.stft_hop, mel_bins=mc.mel_bins,
              frames_per_example=mc.mel_frames, max_examples=2)
    ref = JF.log_mel_examples(jnp.asarray(batch["audio_pcm"]),
                              dtype=jnp.float32, **kw)
    got = F.log_mel_examples(_t(batch["audio_pcm"]), dtype=torch.float32,
                             **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-5)  # log of sums near the 0.01 offset
    n_kw = dict(hop=mc.stft_hop, window=mc.stft_window,
                frames_per_example=mc.mel_frames, max_examples=3)
    lens = np.asarray([0, 63, 64, 600, 5000], np.int32)
    np.testing.assert_array_equal(
        F.audio_num_examples(_t(lens), **n_kw).numpy(),
        np.asarray(JF.audio_num_examples(jnp.asarray(lens), **n_kw)))


# ----------------------------------------------------------------- encoders

def test_text_encoder_matches_jax(model, batch):
    mc, params, _, port = model
    ref_out, (ref_h, ref_c) = JTE.apply(
        params["text_enc"], jnp.asarray(params["embedding"]["table"]),
        jnp.asarray(batch["context_ids"]), jnp.asarray(batch["context_len"]),
        dtype=jnp.float32)
    out, (h, c) = port.text_enc(port.embedding, _t(batch["context_ids"]),
                                _t(batch["context_len"]), dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), atol=ATOL)


@pytest.mark.parametrize("dtype,atol", [("float32", ATOL),
                                        ("bfloat16", 3e-2)])
def test_video_encoder_matches_jax(model, batch, dtype, atol):
    """uint8 frames into the folded conv1. bf16 band: conv activations are
    bf16 in both packages, but the conv libraries round their sums in
    different orders, so single bf16 roundings can differ."""
    mc, params, state, port = model
    norm = (mc.vid_mean, mc.vid_std)
    ref, _ = JVE.apply(params["video_enc"], state["video_enc"],
                       jnp.asarray(batch["frames"]),
                       jnp.asarray(batch["frames_len"]), normalization=norm,
                       dtype=getattr(jnp, dtype))
    got = port.video_enc(_t(batch["frames"]), _t(batch["frames_len"]),
                         normalization=norm, dtype=getattr(torch, dtype))
    assert flatten_dim_for(mc.frame_size) == mc.flatten_dim
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 5e-2)])
def test_audio_encoder_matches_jax(model, batch, dtype, atol):
    """f32 atol 1e-4: six convs and a 4096-wide fc head sum in another order
    than XLA. bf16 band: bf16 activations round at every layer."""
    mc, params, _, port = model
    rng = np.random.RandomState(2)
    mel = rng.randn(2, 3, mc.mel_frames, mc.mel_bins).astype(np.float32)
    lens = np.asarray([3, 1], np.int32)
    ref = JAE.apply(params["audio_enc"], jnp.asarray(mel), jnp.asarray(lens),
                    dtype=getattr(jnp, dtype))
    got = port.audio_enc(_t(mel), _t(lens), dtype=getattr(torch, dtype))
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(got.numpy() / scale, np.asarray(ref) / scale,
                               atol=atol)
    np.testing.assert_array_equal(got[1, 1:].numpy(), 0.0)
