"""Shared builders for the PyTorch-port parity tests (tests/test_torch_*.py).

One tiny tri-modal model (random weights from a numpy seed, in the JAX
package's pytree) and one batch of inputs from a numpy seed; both packages
get the same numbers as numpy arrays. For the raw-video tests: the two
packages' pipelines on one such model in f32, and lecture-like media (an
mp4 written by cv2, subtitles, a stereo wav).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from mmqg_tpu.data import wav as jwav
from mmqg_tpu.data.vocab import END_ID
from mmqg_tpu.models import qg_model as JQ
from mmqg_tpu.ops.attention import AttnParams
from mmqg_tpu_torch.models.qg_model import init_params


def tiny_model(config, n_vocab: int = 40, seed: int = 0):
    """(mc, params, model_state): the JAX package's ModelConfig, and the
    port's numpy ``init_params`` in the JAX pytree (its attention weights
    wrapped in ``AttnParams`` for the JAX functions), with random batchnorm
    statistics so eval batchnorm is not the identity."""
    mc = JQ.ModelConfig.from_config(config, n_vocab=n_vocab, mode="trimodal")
    params, state = init_params(mc, seed)
    params["decoder"]["attn"] = AttnParams(**params["decoder"]["attn"])
    rng = np.random.RandomState(seed + 100)
    for bn, s in zip(params["video_enc"]["bns"], state["video_enc"]["bns"]):
        c = bn["scale"].shape[0]
        bn["scale"] = (1.0 + 0.2 * rng.randn(c)).astype(np.float32)
        bn["bias"] = (0.2 * rng.randn(c)).astype(np.float32)
        s["mean"] = (0.2 * rng.randn(c)).astype(np.float32)
        s["var"] = (0.5 + rng.rand(c)).astype(np.float32)
    return mc, params, state


class _F64Numpy:
    """``jax.numpy`` with ``float32`` meaning float64, for a module whose
    float32 casts are to run in float64."""

    def __init__(self):
        import jax.numpy as jnp
        self._jnp = jnp
        self.float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(self._jnp, name)


@contextlib.contextmanager
def jax_resnet_f64(force: bool = False):
    """The JAX package's R(2+1)D computing in float64: its conv outputs
    and batchnorms (``video_resnet``'s float32 casts, ``layers.batchnorm``)
    in float64, inside ``jax.enable_x64``. With ``force``,
    ``apply_temporal`` also runs its convs in float64 whatever dtype it is
    called with, and returns float32 features (the video tower of a
    float32 model)."""
    import jax
    import jax.numpy as jnp
    import pytest
    from types import SimpleNamespace

    from mmqg_tpu.models import layers as JL
    from mmqg_tpu.models import video_resnet as JR

    f64 = _F64Numpy()

    def batchnorm(*args, **kw):
        saved = JL.jnp
        JL.jnp = f64
        try:
            return saved_batchnorm(*args, **kw)
        finally:
            JL.jnp = saved

    saved_batchnorm = JL.batchnorm
    orig = JR.apply_temporal
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(JR, "jnp", f64)
        mp.setattr(JR, "L", SimpleNamespace(batchnorm=batchnorm,
                                            dense=JL.dense))
        if force:
            def apply_temporal(p, s, clips, *, train=False, dtype=None):
                y, st = orig(p, s, clips, train=train, dtype=jnp.float64)
                return y.astype(jnp.float32), st
            mp.setattr(JR, "apply_temporal", apply_temporal)
        yield


@contextlib.contextmanager
def jax_video_stats_f64():
    """The JAX package's conv-pyramid video encoder with its float32 maths
    (the masked batchnorm statistics and normalisation, conv1's folded
    input normalisation) in float64, inside ``jax.enable_x64``."""
    import jax
    import pytest

    from mmqg_tpu.models import video_encoder as JVE

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(JVE, "jnp", _F64Numpy())
        yield


@contextlib.contextmanager
def port_resnet_f64():
    """The port's R(2+1)D tower run in float64 (``VideoResNet.temporal``
    with float64 clips and compute dtype), returning float32 features: the
    counterpart of ``jax_resnet_f64(force=True)``."""
    import pytest

    from mmqg_tpu_torch.models.video_resnet import VideoResNet

    orig = VideoResNet.temporal

    def temporal(self, clips, *, train=False, dtype=None):
        y, st = orig(self, clips.double(), train=train, dtype=torch.float64)
        return y.float(), st

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(VideoResNet, "temporal", temporal)
        yield


def random_stats(state, rng):
    """Non-trivial batchnorm running statistics in a ``model_state`` (or
    any) tree, in place: mean N(0, 0.2), var U(0.5, 1.5)."""
    if isinstance(state, dict) and "mean" in state:
        c = state["mean"].shape[0]
        state["mean"] = (0.2 * rng.randn(c)).astype(np.float32)
        state["var"] = (0.5 + rng.rand(c)).astype(np.float32)
    elif isinstance(state, dict):
        for v in state.values():
            random_stats(v, rng)
    elif isinstance(state, list):
        for v in state:
            random_stats(v, rng)
    return state


def walk(a, b, path=""):
    """(path, leaf of a, leaf of b) over two trees of one structure,
    following ``a``'s dicts and lists."""
    if isinstance(a, dict):
        for k in a:
            yield from walk(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from walk(x, y, f"{path}/{i}")
    else:
        yield path, a, b


def tiny_batch(mc, B: int = 4, seed: int = 1):
    """Ragged-length model inputs (numpy), at full AV length."""
    rng = np.random.RandomState(seed)
    Lc, av, fs = mc.context_max_length, mc.av_max_length, mc.frame_size
    S = av * mc.sample_rate
    return {
        "context_ids": rng.randint(3, mc.n_vocab, (B, Lc)).astype(np.int32),
        "context_len": rng.randint(1, Lc + 1, B).astype(np.int32),
        "frames": rng.randint(0, 256, (B, av, fs, fs, 3)).astype(np.uint8),
        "frames_len": rng.randint(1, av + 1, B).astype(np.int32),
        "audio_pcm": (rng.randn(B, S) * 3000).astype(np.int16),
        "audio_len": rng.randint(mc.stft_window, S + 1, B).astype(np.int32),
    }


def torch_batch(batch, device="cpu"):
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def short_av_batch(mc, B: int = 4, seed: int = 7):
    """``tiny_batch`` with AV lengths in a smaller bucket than av_max."""
    b = tiny_batch(mc, B=B, seed=seed)
    b["frames_len"] = np.resize(np.asarray([1, 2, 2, 1], np.int32), B)
    win = mc.stft_window + mc.stft_hop * (mc.mel_frames - 1)  # one example
    b["audio_len"] = np.resize(np.asarray([win, 10, 2 * win, win], np.int32),
                               B)
    return b


def peaked(params, seed: int = 9, end_twin: int = 18,
           end_gap: float = 0.5):
    """The decoder of a random ``tiny_model`` made input-dependent and
    peaked, as a trained one is: its LSTM weights x4, its vocab projection
    x20 with random biases, the embedding x4. With the initial scales every
    row's logits are nearly the same flat distribution, so beam search and
    top-k would choose among near-ties. ``<end>``'s logit follows token
    ``end_twin``'s, ``end_gap`` below it, so that some rows end early."""
    rng = np.random.RandomState(seed)
    dec = params["decoder"]
    for layer in dec["lstm"]["layers"]:
        layer["wx"] = layer["wx"] * 4
        layer["wh"] = layer["wh"] * 4
    dec["out"]["w"] = dec["out"]["w"] * 20
    dec["out"]["b"] = (0.5 * rng.randn(*dec["out"]["b"].shape)).astype(
        np.float32)
    dec["out"]["w"][:, END_ID] = dec["out"]["w"][:, end_twin]
    dec["out"]["b"][END_ID] = dec["out"]["b"][end_twin] - end_gap
    params["embedding"]["table"] = params["embedding"]["table"] * 4
    return params


def write_cv2_video(path, seconds=6, fps=10, size=(64, 48), seed=0):
    """An mp4 (mp4v) whose frames change over time: a moving gradient and
    noise, so resizes and frame choices are visible in the bytes."""
    import cv2

    rng = np.random.RandomState(seed)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         size)
    assert vw.isOpened(), "cv2.VideoWriter cannot open mp4v"
    xs = np.arange(size[0])[None, :, None]
    for i in range(int(seconds * fps)):
        frame = ((xs * 4 + i * 7 + np.arange(3) * 40) % 256).repeat(
            size[1], axis=0).astype(np.uint8)
        frame = np.clip(frame + rng.randint(0, 20, frame.shape), 0,
                        255).astype(np.uint8)
        vw.write(frame)
    vw.release()
    return path


N_WORDS = 40
# alphabetic words, so that preprocess_text keeps them in a context
WORDS = ["<pad>", "<start>", "<end>"] + [
    "x" + chr(97 + i // 26) + chr(97 + i % 26) for i in range(N_WORDS - 3)]


@contextlib.contextmanager
def f32_pipelines(config):
    """(JAX pipeline, port pipeline) on one tiny model with a peaked
    decoder over ``WORDS``, both in f32 on the CPU: the JAX package's
    ``decode_batch`` is run in f32 while the context is open."""
    import jax.numpy as jnp
    import pytest

    from mmqg_tpu import decode as JDEC
    from mmqg_tpu.pipeline import QGPipeline as JaxPipeline
    from mmqg_tpu_torch.models import qg_model as TQ
    from mmqg_tpu_torch.pipeline import QGPipeline

    mc, params, state = tiny_model(config, n_vocab=N_WORDS, seed=4)
    params = peaked(params, end_twin=5)
    vocab = {w: i for i, w in enumerate(WORDS)}
    i2w = {str(i): w for i, w in enumerate(WORDS)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JDEC, "decode_batch",
                   functools.partial(JDEC.decode_batch, dtype=jnp.float32))
        jax_pipe = JaxPipeline(config, mc, params, state, vocab, i2w)
        port = QGPipeline(config, TQ.ModelConfig(**mc._asdict()),
                          params, state, vocab, i2w, device="cpu",
                          dtype=torch.float32)
        yield jax_pipe, port


def caption(i: int) -> str:
    return " ".join(WORDS[3 + (i * 7 + k * 5) % (N_WORDS - 3)]
                    for k in range(3 + i % 4))


def write_srt(path, seconds: int, every: int = 1):
    blocks = [f"{i + 1}\n00:00:{i * every:02d},000 --> "
              f"00:00:{(i + 1) * every:02d},000\n{caption(i).upper()}\n"
              for i in range(seconds // every)]
    path.write_text("\n".join(blocks))
    return path


def write_stereo_wav(path, seconds: float, rate: int = 8000, seed: int = 0):
    """A stereo tone plus noise at another rate than the model's, so that
    loading it resamples and mixes down."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * rate)) / rate
    tone = 0.3 * np.sin(2 * np.pi * (200 + 50 * seed) * t)
    pcm = np.stack([tone + 0.05 * rng.randn(len(t)),
                    0.5 * tone + 0.05 * rng.randn(len(t))], axis=1)
    jwav.write_wav(path, pcm.astype(np.float32), rate)
    return path
