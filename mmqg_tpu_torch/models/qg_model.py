"""The assembled model and its encode (``mmqg_tpu/models/qg_model.py``).

Ported: ``mode="trimodal"``, ``decoder="attn"``, ``video_encoder=
"conv_lstm"`` -- the flagship serving configuration. Other modes, the
non-attention decoder and the R(2+1)D backbone raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mmqg_tpu_torch.models import frontends
from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.models.audio_encoder import BLOCKS as AUDIO_BLOCKS
from mmqg_tpu_torch.models.audio_encoder import AudioEncoder
from mmqg_tpu_torch.models.decoder import Decoder, Memories
from mmqg_tpu_torch.models.text_encoder import TextEncoder
from mmqg_tpu_torch.models.video_encoder import CHANNELS as VIDEO_CHANNELS
from mmqg_tpu_torch.models.video_encoder import VideoEncoder

Tensor = torch.Tensor


class ModelConfig(NamedTuple):
    """Static architecture hyperparameters; the fields and defaults of the
    JAX package's ``ModelConfig``."""
    n_vocab: int
    word_emb_dim: int = 300
    hidden_dim: int = 512
    text_layers: int = 3
    dec_layers: int = 3
    dropout: float = 0.2
    text_dropout: float = 0.2
    video_hidden_dim: int = 512
    audio_emb_dim: int = 128
    flatten_dim: int = 1000
    context_max_length: int = 283
    av_max_length: int = 101
    target_steps: int = 22
    mode: str = "trimodal"
    decoder: str = "attn"
    video_encoder: str = "conv_lstm"
    remat_video: bool = False
    frame_size: int = 112
    mel_frames: int = 96
    mel_bins: int = 64
    sample_rate: int = 16000
    stft_window: int = 400
    stft_hop: int = 160
    mel_min_hz: float = 125.0
    mel_max_hz: float = 7500.0
    log_offset: float = 0.01
    normalize_video: bool = True
    vid_mean: Tuple[float, float, float] = (0.43216, 0.394666, 0.37645)
    vid_std: Tuple[float, float, float] = (0.22803, 0.22145, 0.216989)
    # the port serves the bf16 VGGish whatever this says (see audio_encoder)
    audio_int8_serving: bool = True
    audio_int8_scales: Optional[Tuple[float, ...]] = None

    @classmethod
    def from_config(cls, config, n_vocab: int, mode: str = "trimodal",
                    dec: str = "attn") -> "ModelConfig":
        """From an ``mmqg_tpu.config.Config`` (read by attribute only), with
        the JAX package's checks."""
        if config.dec_lstm_hidden_dim != config.text_lstm_hidden_dim:
            raise ValueError(
                f"dec_lstm_hidden_dim ({config.dec_lstm_hidden_dim}) must "
                f"equal text_lstm_hidden_dim ({config.text_lstm_hidden_dim}):"
                " the decoder starts from the text encoder's final state")
        if (config.av_in_channels, config.av_kernel_sz,
                config.av_stride) != (3, 3, 1):
            raise ValueError("av_in_channels/av_kernel_sz/av_stride must stay"
                             " (3, 3, 1): the video conv pyramid is fixed")
        venc = getattr(config, "video_encoder", "conv_lstm")
        if venc not in ("conv_lstm", "resnet"):
            raise ValueError(f"video_encoder={venc!r}: must be 'conv_lstm' "
                             "or 'resnet'")
        if getattr(config, "param_dtype", "float32") != "float32":
            raise ValueError("param_dtype: only float32 parameters")
        return cls(
            n_vocab=n_vocab, decoder=dec,
            word_emb_dim=config.glove_emb_dim,
            hidden_dim=config.text_lstm_hidden_dim,
            text_layers=config.text_lstm_layers,
            dec_layers=config.dec_lstm_layers,
            dropout=config.dec_lstm_dropout,
            text_dropout=config.text_lstm_dropout,
            video_hidden_dim=config.video_hidden_dim,
            audio_emb_dim=config.audio_emb,
            flatten_dim=config.flatten_dim,
            context_max_length=config.context_max_length,
            av_max_length=config.av_max_length,
            target_steps=config.question_max_length + 1,
            mode=mode, video_encoder=venc,
            remat_video=getattr(config, "remat_video", False),
            frame_size=config.frame_size,
            mel_frames=config.mel_frames_per_example,
            mel_bins=config.mel_bins,
            sample_rate=config.audio_sample_rate,
            stft_window=config.stft_window, stft_hop=config.stft_hop,
            mel_min_hz=config.mel_min_hz, mel_max_hz=config.mel_max_hz,
            log_offset=config.log_offset,
            vid_mean=tuple(config.vid_mean), vid_std=tuple(config.vid_std),
            audio_int8_serving=getattr(config, "audio_int8_serving", True))


def init_params(mc: ModelConfig, seed: int = 0,
                emb_weights: Optional[np.ndarray] = None):
    """Random (params, model_state) in the JAX package's pytree and layouts,
    numpy float32 leaves, from ``np.random.RandomState(seed)`` -- the
    counterpart of ``qg_model.init`` without JAX. Xavier-uniform dense,
    attention and LSTM weights with N(0, 1) biases, torch-default uniform
    convs, identity batchnorm; the embedding is ``emb_weights`` or N(0, 1).
    The attention weights are a dict of ``AttnParams``' fields."""
    check_supported(mc)
    rng = np.random.RandomState(seed)

    def f32(a):
        return np.asarray(a, np.float32)

    def xavier(fan_in, fan_out):
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        return f32(rng.uniform(-lim, lim, (fan_in, fan_out)))

    def dense(i, o):
        return {"w": xavier(i, o), "b": f32(rng.randn(o))}

    def lstm(in_dim, hidden, n):
        return {"layers": [
            {"wx": xavier(in_dim if li == 0 else hidden, 4 * hidden),
             "wh": xavier(hidden, 4 * hidden), "b": f32(rng.randn(4 * hidden))}
            for li in range(n)]}

    def conv(c_in, c_out, k=3):
        lim = 1.0 / np.sqrt(c_in * k * k)
        return {"w": f32(rng.uniform(-lim, lim, (k, k, c_in, c_out))),
                "b": f32(rng.uniform(-lim, lim, c_out))}

    H, D = mc.hidden_dim, mc.word_emb_dim
    Ha, Hv = mc.audio_emb_dim, mc.video_hidden_dim
    if emb_weights is None:
        emb_weights = rng.randn(mc.n_vocab, D)
    channels = (3,) + VIDEO_CHANNELS
    video = {"convs": [conv(channels[i], channels[i + 1]) for i in range(4)],
             "bns": [{"scale": np.ones(c, np.float32),
                      "bias": np.zeros(c, np.float32)}
                     for c in VIDEO_CHANNELS],
             "lstm": lstm(mc.flatten_dim, Hv, 1)}
    audio_convs, c_in = [], 1
    for c_out, reps in AUDIO_BLOCKS:
        for _ in range(reps):
            audio_convs.append(conv(c_in, c_out))
            c_in = c_out
    flat = (mc.mel_frames // 16) * (mc.mel_bins // 16) * c_in
    q = D + H
    attn = {"w_text": xavier(q, mc.context_max_length),
            "b_text": f32(rng.randn(mc.context_max_length)),
            "w_video": xavier(q, mc.av_max_length),
            "b_video": f32(rng.randn(mc.av_max_length)),
            "w_audio": xavier(q, mc.av_max_length),
            "b_audio": f32(rng.randn(mc.av_max_length))}
    params = {
        "embedding": {"table": f32(emb_weights)},
        "text_enc": {"lstm": lstm(D, H, mc.text_layers)},
        "video_enc": video,
        "audio_enc": {"convs": audio_convs, "fc1": dense(flat, 4096),
                      "fc2": dense(4096, 4096), "fc3": dense(4096, Ha)},
        "decoder": {"attn": attn,
                    "lstm": lstm(D + H + Ha + Hv, H, mc.dec_layers),
                    "out": dense(H, mc.n_vocab)},
    }
    state = {"video_enc": {"bns": [
        {"mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32),
         "count": np.zeros((), np.float32)} for c in VIDEO_CHANNELS]}}
    return params, state


def check_supported(mc: ModelConfig) -> None:
    ported = (mc.mode, mc.decoder, mc.video_encoder)
    if ported != ("trimodal", "attn", "conv_lstm"):
        raise NotImplementedError(
            f"mode/decoder/video_encoder {ported}: only ('trimodal', 'attn',"
            " 'conv_lstm') is ported to PyTorch so far")


class QGModel(nn.Module):
    """Embedding table (shared by the text encoder and the decoder), the
    three encoders and the attention decoder."""

    def __init__(self, embedding: Tensor, text_enc: TextEncoder,
                 video_enc: VideoEncoder, audio_enc: AudioEncoder,
                 decoder: Decoder):
        super().__init__()
        self.embedding = nn.Parameter(embedding, requires_grad=False)
        self.text_enc = text_enc
        self.video_enc = video_enc
        self.audio_enc = audio_enc
        self.decoder = decoder


def encode(model: QGModel, mc: ModelConfig, batch: Dict[str, Tensor], *,
           audio_cap: Optional[int] = None, frames_cap: Optional[int] = None,
           dtype: torch.dtype = torch.bfloat16) -> Tuple[Memories, L.State]:
    """Tri-modal encode (``qg_model.encode``, eval). ``batch`` holds tensors
    on one device: context_ids, context_len, frames (uint8 NHWC),
    frames_len, audio_pcm (int16), audio_len.

    ``audio_cap``/``frames_cap`` bound the AV steps the encoders run; the
    memories are zero-padded back to ``av_max_length``, because the
    attention weights are sized for it. The audio tower is the bf16 VGGish
    (``embed_examples``), not the JAX package's int8 serving variant.

    Returns (memories, decoder initial state)."""
    check_supported(mc)
    av = mc.av_max_length
    enc_text, text_state = model.text_enc(
        model.embedding, batch["context_ids"], batch["context_len"],
        dtype=dtype)

    frames, frames_len = batch["frames"], batch["frames_len"]
    fcap = min(frames_cap or av, av)
    if fcap < frames.shape[1]:
        frames = frames[:, :fcap]
        frames_len = torch.clamp(frames_len, max=fcap)
    if frames.dtype != torch.uint8 or frames.shape[2:4] != (mc.frame_size,) * 2:
        raise NotImplementedError(
            "frames must be uint8 at frame_size x frame_size (the resize "
            "path, frontends.prepare_frames, is not ported)")
    norm = ((mc.vid_mean, mc.vid_std) if mc.normalize_video
            else ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)))
    enc_video = model.video_enc(frames, frames_len, normalization=norm,
                                dtype=dtype)
    enc_video = torch.nn.functional.pad(
        enc_video, (0, 0, 0, av - enc_video.shape[1]))

    cap = min(audio_cap or av, av)
    mel = frontends.log_mel_examples(
        batch["audio_pcm"], sample_rate=mc.sample_rate,
        window=mc.stft_window, hop=mc.stft_hop, mel_bins=mc.mel_bins,
        lower_hz=mc.mel_min_hz, upper_hz=mc.mel_max_hz,
        log_offset=mc.log_offset, frames_per_example=mc.mel_frames,
        max_examples=cap, dtype=dtype)
    # masked by the true example count, at least 1 so the softmax is defined
    audio_len = torch.clamp(frontends.audio_num_examples(
        batch["audio_len"], hop=mc.stft_hop, window=mc.stft_window,
        frames_per_example=mc.mel_frames, max_examples=cap), min=1)
    enc_audio = model.audio_enc(mel, audio_len, dtype=dtype)
    enc_audio = torch.nn.functional.pad(enc_audio, (0, 0, 0, av - cap))

    mem = Memories(enc_text=enc_text, enc_video=enc_video,
                   enc_audio=enc_audio, text_len=batch["context_len"],
                   video_len=frames_len, audio_len=audio_len)
    return mem, text_state
