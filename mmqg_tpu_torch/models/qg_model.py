"""The assembled model and its encode (``mmqg_tpu/models/qg_model.py``).

Every configuration of the JAX package, for serving (``encode``) and
training (``encode(train=True)``, ``loss_fn``):

  mode           text (the text encoder alone; the AV memories are zeros of
                 length 1), text_video (+ the video encoder), trimodal
                 (+ the VGGish audio encoder, the flagship)
  decoder        attn (tri-modal attention, K2 on the card) or non_attn
                 (one AV vector a step, no attention)
  video_encoder  conv_lstm (the conv pyramid and an LSTM, K1/K4), resnet
                 (R(2+1)D-18 on cuDNN conv3d; memories at a stride of 8
                 frames) or swin3d (the Video Swin Transformer,
                 ``video_swin.py``, serving only; memories at a stride of
                 2 frames); the last two take ``frontends.prepare_frames``
                 in, in spans ``video.prepare`` and ``video.trunk``
  remat_video    recompute the video tower in the backward pass
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mmqg_tpu_torch.data.vocab import START_ID
from mmqg_tpu_torch.models import frontends
from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.models import video_resnet, video_swin
from mmqg_tpu_torch.models.audio_encoder import BLOCKS as AUDIO_BLOCKS
from mmqg_tpu_torch.models.audio_encoder import AudioEncoder
from mmqg_tpu_torch.models.decoder import Decoder, Memories, NonAttnDecoder
# the JAX package's qg_model.av_vector, kept in decoder.py beside its user
from mmqg_tpu_torch.models.decoder import av_vector  # noqa: F401
from mmqg_tpu_torch.models.text_encoder import TextEncoder
from mmqg_tpu_torch.models.video_encoder import CHANNELS as VIDEO_CHANNELS
from mmqg_tpu_torch.models.video_encoder import VideoEncoder
from mmqg_tpu_torch.models.video_resnet import VideoResNet
from mmqg_tpu_torch.models.video_swin import VideoSwin
from mmqg_tpu_torch.optim import tree_map
from mmqg_tpu_torch.parallel import model_axis
from mmqg_tpu_torch.utils import profiling

Tensor = torch.Tensor

MODES = ("text", "text_video", "trimodal")
DECODERS = ("attn", "non_attn")
VIDEO_ENCODERS = ("conv_lstm", "resnet", "swin3d")
SWIN_WIDTH = 1024   # swin3d_b's output width, the memory's


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
    # off the CPU, serving (train=False) runs the int8 VGGish (encode)
    audio_int8_serving: bool = True
    audio_int8_scales: Optional[Tuple[float, ...]] = None

    @classmethod
    def from_config(cls, config, n_vocab: int, mode: str = "trimodal",
                    dec: str = "attn") -> "ModelConfig":
        """From a ``Config`` (``mmqg_tpu_torch.config``, or any object with
        its fields: it is read by attribute only), with
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
        if venc not in VIDEO_ENCODERS:
            raise ValueError(f"video_encoder={venc!r}: must be one of "
                             f"{VIDEO_ENCODERS}")
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
    """Random (params, model_state) in the JAX package's pytrees and
    layouts, numpy float32 leaves, from ``np.random.RandomState(seed)`` --
    the counterpart of ``qg_model.init`` without JAX, with the subtrees of
    ``mc``'s configuration: ``video_enc`` outside mode text (the conv
    pyramid and LSTM, R(2+1)D-18 with an ``fc`` head when
    ``video_hidden_dim != 512``, or torchvision's ``swin3d_b``, whose
    1024-wide output the ``video_hidden_dim`` must be), ``audio_enc`` in
    trimodal, the attention or the non-attention decoder. Xavier-uniform
    dense, attention and LSTM weights with N(0, 1) biases, torch-default
    uniform convs, identity batchnorm; the embedding is ``emb_weights`` or
    N(0, 1). The attention weights are a dict of ``AttnParams``' fields."""
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
    params: Dict = {"embedding": {"table": f32(emb_weights)}}
    state: Dict = {}
    if mc.mode != "text":
        if mc.video_encoder == "resnet":
            params["video_enc"], state["video_enc"] = video_resnet.init_numpy(
                rng, embed_dim=None if Hv == 512 else Hv)
        elif mc.video_encoder == "swin3d":
            if Hv != SWIN_WIDTH:
                raise ValueError(
                    f"video_encoder='swin3d' with video_hidden_dim={Hv}: the "
                    f"memory is swin3d_b's {SWIN_WIDTH}-wide output")
            params["video_enc"], state["video_enc"] = video_swin.init_numpy(
                rng)
        else:
            channels = (3,) + VIDEO_CHANNELS
            params["video_enc"] = {
                "convs": [conv(channels[i], channels[i + 1])
                          for i in range(4)],
                "bns": [{"scale": np.ones(c, np.float32),
                         "bias": np.zeros(c, np.float32)}
                        for c in VIDEO_CHANNELS],
                "lstm": lstm(mc.flatten_dim, Hv, 1)}
            state["video_enc"] = {"bns": [
                {"mean": np.zeros(c, np.float32),
                 "var": np.ones(c, np.float32),
                 "count": np.zeros((), np.float32)} for c in VIDEO_CHANNELS]}
    # the draws keep the order of the first port of the flagship: audio
    # convs, attention, text LSTM, then the audio head and the decoder
    if mc.mode == "trimodal":
        audio_convs, c_in = [], 1
        for c_out, reps in AUDIO_BLOCKS:
            for _ in range(reps):
                audio_convs.append(conv(c_in, c_out))
                c_in = c_out
        flat = (mc.mel_frames // 16) * (mc.mel_bins // 16) * c_in
    if mc.decoder == "attn":
        q = D + H
        attn = {"w_text": xavier(q, mc.context_max_length),
                "b_text": f32(rng.randn(mc.context_max_length)),
                "w_video": xavier(q, mc.av_max_length),
                "b_video": f32(rng.randn(mc.av_max_length)),
                "w_audio": xavier(q, mc.av_max_length),
                "b_audio": f32(rng.randn(mc.av_max_length))}
    params["text_enc"] = {"lstm": lstm(D, H, mc.text_layers)}
    if mc.mode == "trimodal":
        params["audio_enc"] = {"convs": audio_convs, "fc1": dense(flat, 4096),
                               "fc2": dense(4096, 4096),
                               "fc3": dense(4096, Ha)}
    if mc.decoder == "attn":
        params["decoder"] = {"attn": attn,
                             "lstm": lstm(D + H + Ha + Hv, H, mc.dec_layers),
                             "out": dense(H, mc.n_vocab)}
    else:
        params["decoder"] = {"lstm": lstm(D + Ha + Hv, H, mc.dec_layers),
                             "out": dense(H, mc.n_vocab)}
    return params, state


def check_supported(mc: ModelConfig, model: Optional["QGModel"] = None
                    ) -> None:
    """ValueError for a mode, decoder or video encoder the JAX package does
    not know and, with a ``model``, for one whose modules are not those of
    ``mc``'s configuration (e.g. a checkpoint of another decoder)."""
    for field, known in (("mode", MODES), ("decoder", DECODERS),
                         ("video_encoder", VIDEO_ENCODERS)):
        if getattr(mc, field) not in known:
            raise ValueError(f"{field}={getattr(mc, field)!r}: must be one "
                             f"of {known}")
    if model is None:
        return
    want_dec = Decoder if mc.decoder == "attn" else NonAttnDecoder
    if not isinstance(model.decoder, want_dec):
        raise ValueError(
            f"decoder={mc.decoder!r}, but the model's parameters hold the "
            f"{type(model.decoder).__name__}'s")
    if mc.mode != "text":
        want = {"resnet": VideoResNet, "swin3d": VideoSwin}.get(
            mc.video_encoder, VideoEncoder)
        if not isinstance(model.video_enc, want):
            raise ValueError(
                f"mode={mc.mode!r} video_encoder={mc.video_encoder!r}, but "
                "the model's parameters hold "
                + ("no video encoder" if model.video_enc is None
                   else f"a {type(model.video_enc).__name__}"))
    if mc.mode == "trimodal" and model.audio_enc is None:
        raise ValueError("mode='trimodal', but the model's parameters hold "
                         "no audio encoder")


class QGModel(nn.Module):
    """Embedding table (shared by the text encoder and the decoder), the
    encoders of the configuration (``video_enc`` is None in mode text,
    ``audio_enc`` outside trimodal) and the decoder."""

    def __init__(self, embedding: Tensor, text_enc: TextEncoder,
                 video_enc: Optional[nn.Module],
                 audio_enc: Optional[AudioEncoder], decoder: nn.Module):
        super().__init__()
        self.embedding = nn.Parameter(embedding, requires_grad=False)
        self.text_enc = text_enc
        self.video_enc = video_enc
        self.audio_enc = audio_enc
        self.decoder = decoder
        # stored over a model axis: its parallel.model_axis.ModelAxis
        self.tp = None


ATTN_FIELDS = ("w_text", "b_text", "w_video", "b_video", "w_audio",
               "b_audio")  # AttnParams' fields, in order


def param_tree(model: QGModel) -> Dict:
    """The model's parameters as the JAX package's ``params`` pytree (lists
    for lists, the attention's ``AttnParams`` as a dict of its fields), with
    the subtrees the model holds; the leaves are the module's own
    ``nn.Parameter`` objects."""
    def lstm(m):
        return {"layers": [{"wx": l.wx, "wh": l.wh, "b": l.b}
                           for l in m.layers]}

    def dense(d):
        return {"w": d.w, "b": d.b}

    def convs(cs):
        return [{"w": c.w, "b": c.b} for c in cs]

    v, a, d = model.video_enc, model.audio_enc, model.decoder
    tree = {"embedding": {"table": model.embedding},
            "text_enc": {"lstm": lstm(model.text_enc.lstm)},
            "decoder": {"lstm": lstm(d.lstm), "out": dense(d.out)}}
    if isinstance(d, Decoder):
        tree["decoder"]["attn"] = {k: getattr(d.attn, k)
                                   for k in ATTN_FIELDS}
    if isinstance(v, (VideoResNet, VideoSwin)):
        tree["video_enc"] = v.param_tree()
    elif v is not None:
        tree["video_enc"] = {"convs": convs(v.convs),
                             "bns": [{"scale": bn.scale, "bias": bn.bias}
                                     for bn in v.bns],
                             "lstm": lstm(v.lstm)}
    if a is not None:
        tree["audio_enc"] = {"convs": convs(a.convs), "fc1": dense(a.fc1),
                             "fc2": dense(a.fc2), "fc3": dense(a.fc3)}
    return tree


def model_state(model: QGModel) -> Dict:
    """The batchnorm running statistics as the JAX ``model_state`` pytree
    (the buffers themselves); empty without a video encoder."""
    if model.video_enc is None:
        return {}
    return {"video_enc": tree_map(lambda bn: bn.state(),
                                  model.video_enc.bn_tree())}


def load_model_state(model: QGModel, state: Dict) -> None:
    """Write a ``model_state`` pytree (e.g. ``encode(train=True)``'s) into
    the batchnorm buffers."""
    if "video_enc" in state:
        tree_map(lambda bn, s: bn.load_state(s), model.video_enc.bn_tree(),
                 state["video_enc"])


def set_process_group(model: QGModel, group) -> None:
    """Make every batchnorm of ``model`` take its train statistics over the
    processes of ``group`` (data-parallel training: the JAX package's one
    program over the global batch), or over this batch alone for None."""
    for m in model.modules():
        if isinstance(m, L.BatchNorm):
            m.process_group = group


def _clips(mc: ModelConfig, frames: Tensor, frames_len: Tensor) -> Tensor:
    """The clips a 3-D trunk takes: normalised frames with those past each
    row's length zeroed after the normalisation, since the trunk mixes
    time (R(2+1)D's convs, Swin's patches of 2 frames)."""
    prepared = frontends.prepare_frames(
        frames, size=mc.frame_size, mean=mc.vid_mean, std=mc.vid_std,
        normalize=mc.normalize_video)
    live = (torch.arange(prepared.shape[1], device=prepared.device)[None, :]
            < frames_len[:, None])
    return prepared * live[:, :, None, None, None].to(prepared.dtype)


def _video(model: QGModel, mc: ModelConfig, frames: Tensor,
           frames_len: Tensor, *, train: bool, dtype: torch.dtype
           ) -> Tuple[Tensor, Tensor, Dict]:
    """The video encoder of ``mc`` on (capped) frames: (memory (B, T', Hv)
    f32, its lengths, the new batchnorm state). In training with
    ``remat_video`` the tower runs under ``torch.utils.checkpoint``: its
    activations are recomputed in the backward pass, and only this first
    run's batchnorm state is returned (the recomputation's is dropped, and
    none is written to the buffers)."""
    venc = model.video_enc
    if mc.video_encoder == "swin3d":
        if train:
            raise NotImplementedError(
                "video_encoder='swin3d' serves only: its training path "
                "(stochastic depth 0.1 and the dropout draws) is not built")
        with profiling.annotate("video.prepare"):
            prepared = _clips(mc, frames, frames_len)
        # one memory step per 2 frames; padded steps are masked keys
        steps = torch.clamp(video_swin.temporal_out_len(frames_len), min=1)
        with profiling.annotate("video.trunk"):
            enc = venc.temporal(prepared, steps, dtype=dtype)
        return enc, steps, {}

    def tower(fn, *args):
        if train and mc.remat_video:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    if mc.video_encoder == "resnet":
        with profiling.annotate("video.prepare"):
            prepared = _clips(mc, frames, frames_len)
        with profiling.annotate("video.trunk"):
            enc, state = tower(lambda x: venc.temporal(x, train=train,
                                                       dtype=dtype), prepared)
        # the trunk strides time by 8: ceil(len / 8) memory steps
        return (enc, torch.clamp(video_resnet.temporal_out_len(frames_len),
                                 min=1), state)
    if (frames.dtype == torch.uint8
            and frames.shape[2] == frames.shape[3] == mc.frame_size):
        # uint8 at frame_size: /255 and the normalisation folded into conv1
        norm = ((mc.vid_mean, mc.vid_std) if mc.normalize_video
                else ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)))
    else:
        frames = frontends.prepare_frames(
            frames, size=mc.frame_size, mean=mc.vid_mean, std=mc.vid_std,
            normalize=mc.normalize_video)
        norm = None
    if train:
        enc, bns = tower(lambda f, n: venc.train_forward(
            f, n, normalization=norm, dtype=dtype), frames, frames_len)
        return enc, frames_len, {"bns": bns}
    enc = venc(frames, frames_len, normalization=norm, dtype=dtype)
    return enc, frames_len, tree_map(lambda bn: bn.state(), venc.bn_tree())


def encode(model: QGModel, mc: ModelConfig, batch: Dict[str, Tensor], *,
           train: bool = False, generator: Optional[torch.Generator] = None,
           audio_cap: Optional[int] = None, frames_cap: Optional[int] = None,
           dtype: torch.dtype = torch.bfloat16
           ) -> Tuple[Memories, L.State, Dict]:
    """Encode (``qg_model.encode``). ``batch`` holds tensors on one device:
    context_ids, context_len and, as the mode needs them, frames (uint8
    NHWC, or float on the 0-255 scale) and frames_len, audio_pcm (int16)
    and audio_len. A modality the mode leaves out gets a zero memory of
    length 1.

    ``audio_cap``/``frames_cap`` bound the AV steps the encoders run; the
    memories are zero-padded back to ``av_max_length``, because the
    attention weights are sized for it. The audio tower is the int8 VGGish
    (``embed_examples_int8``, with ``mc.audio_int8_scales`` when calibrated)
    where the JAX package takes it: ``mc.audio_int8_serving``, not
    training, and not on the CPU; otherwise ``embed_examples`` in ``dtype``.

    ``train`` runs the trainable path: the text and video LSTMs through K4,
    text dropout from ``generator``, batchnorm over the valid frames (the
    conv pyramid) or over every position (R(2+1)D); ``swin3d`` has none
    and raises NotImplementedError.

    Returns (memories, decoder initial state, new model_state): the new
    batchnorm running statistics, detached, when training, else the
    current ones."""
    check_supported(mc, model)
    av = mc.av_max_length
    enc_text, text_state = model.text_enc(
        model.embedding, batch["context_ids"], batch["context_len"],
        train=train, dropout=mc.text_dropout, generator=generator,
        dtype=dtype)
    B = enc_text.shape[0]
    dev = enc_text.device
    ones = torch.ones((B,), dtype=torch.int32, device=dev)

    new_state = {}
    if mc.mode in ("text_video", "trimodal"):
        frames, frames_len = batch["frames"], batch["frames_len"]
        fcap = min(frames_cap or av, av)
        if fcap < frames.shape[1]:
            frames = frames[:, :fcap]
            frames_len = torch.clamp(frames_len, max=fcap)
        enc_video, video_len, new_state["video_enc"] = _video(
            model, mc, frames, frames_len, train=train, dtype=dtype)
        # padded by the encoded length: a caller may ship fewer frames
        enc_video = torch.nn.functional.pad(
            enc_video, (0, 0, 0, av - enc_video.shape[1]))
    else:
        enc_video = torch.zeros((B, av, mc.video_hidden_dim), device=dev)
        video_len = ones

    if mc.mode == "trimodal":
        cap = min(audio_cap or av, av)
        mel = frontends.log_mel_examples(
            batch["audio_pcm"], sample_rate=mc.sample_rate,
            window=mc.stft_window, hop=mc.stft_hop, mel_bins=mc.mel_bins,
            lower_hz=mc.mel_min_hz, upper_hz=mc.mel_max_hz,
            log_offset=mc.log_offset, frames_per_example=mc.mel_frames,
            max_examples=cap, dtype=dtype)
        # masked by the true example count, at least 1 so the softmax is
        # defined
        audio_len = torch.clamp(frontends.audio_num_examples(
            batch["audio_len"], hop=mc.stft_hop, window=mc.stft_window,
            frames_per_example=mc.mel_frames, max_examples=cap), min=1)
        enc_audio = model.audio_enc(
            mel, audio_len, dtype=dtype,
            int8=(mc.audio_int8_serving and not train
                  and mel.device.type != "cpu"),
            int8_scales=mc.audio_int8_scales)
        enc_audio = torch.nn.functional.pad(enc_audio, (0, 0, 0, av - cap))
    else:
        enc_audio = torch.zeros((B, av, mc.audio_emb_dim), device=dev)
        audio_len = ones

    mem = Memories(enc_text=enc_text, enc_video=enc_video,
                   enc_audio=enc_audio, text_len=batch["context_len"],
                   video_len=video_len, audio_len=audio_len)
    return mem, text_state, new_state


def loss_fn(model: QGModel, mc: ModelConfig, batch: Dict[str, Tensor], *,
            train: bool = True, generator: Optional[torch.Generator] = None,
            dtype: torch.dtype = torch.bfloat16,
            audio_cap: Optional[int] = None,
            frames_cap: Optional[int] = None,
            mem_constraint=None, attn_fn=None) -> Tuple[Tensor, Dict]:
    """Teacher-forced masked cross-entropy (``qg_model.loss_fn``). Returns
    (objective, aux): the objective is the mean over valid samples of each
    sample's summed CE; aux holds ``loss_per_sample`` (each sample's CE over
    its target length, averaged over valid samples), ``loss_per_token``,
    ``n_tokens`` and ``state`` (the new model_state). ``batch`` also holds
    target_ids, target_len and optionally ``valid``. The decoder is
    ``model.decoder``'s, the attention or the non-attention one (which
    reads ``av_vector(memories)``). Gradients need ``train=True``: the eval
    encoders run K1, which has no backward.
    Dropout (``mc.text_dropout``, ``mc.dropout``) draws from
    ``generator``; without one there is none.

    ``mem_constraint`` (``parallel.mesh.sequence_constraint``):
    training-side sequence parallelism, the text memory split over the
    model axis by its context positions. The attention then reads it
    through ``attn_fn`` when given (``ops.attention_sp
    .trimodal_attention_sp``, the gather-free softmax), else whole,
    gathered once before the first step. A column-parallel vocab
    projection (``model.decoder.out.column_group``) takes the
    log-softmax over the model axis (``parallel.model_axis.log_prob``)."""
    target = batch["target_ids"].long()                 # (B, T)
    B, T = target.shape
    start = torch.full((B, 1), START_ID, dtype=target.dtype,
                       device=target.device)
    dec_inputs = torch.cat([start, target[:, :-1]], dim=1)
    mem, dec_state, new_state = encode(
        model, mc, batch, train=train, generator=generator, dtype=dtype,
        audio_cap=audio_cap, frames_cap=frames_cap)
    if mem_constraint is not None:
        length = mem.enc_text.shape[1]
        mem = mem._replace(enc_text=mem_constraint(mem.enc_text))
        if attn_fn is None:
            mem = mem._replace(enc_text=mem_constraint.gather(mem.enc_text,
                                                              length))
    logits = model.decoder.teacher_forced_logits(
        model.embedding, dec_inputs, mem, dec_state, dropout=mc.dropout,
        generator=generator if train else None, dtype=dtype,
        attn_fn=attn_fn)

    tok_ll = model_axis.log_prob(logits, target,
                                 model.decoder.out.column_group)
    target_len = batch["target_len"]
    step_mask = (torch.arange(T, device=target.device)[None, :]
                 < target_len[:, None])
    valid = batch.get("valid")
    if valid is None:
        valid = torch.ones((B,), dtype=torch.bool, device=target.device)
    step_mask = step_mask & valid[:, None]
    ce = -(tok_ll * step_mask)                          # (B, T)
    per_sample_sum = ce.sum(dim=1)
    n_valid = torch.clamp(valid.sum(), min=1)
    objective = per_sample_sum.sum() / n_valid
    per_sample_mean = per_sample_sum / torch.clamp(target_len, min=1)
    n_tokens = step_mask.sum()
    aux = {"state": new_state,
           "loss_per_sample": (per_sample_mean * valid).sum() / n_valid,
           "loss_per_token": ce.sum() / torch.clamp(n_tokens, min=1),
           "n_tokens": n_tokens}
    return objective, aux
