"""Shared builders for the PyTorch-port parity tests (tests/test_torch_*.py).

One tiny tri-modal model (random weights from a numpy seed, in the JAX
package's pytree) and one batch of inputs from a numpy seed; both packages
get the same numbers as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

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
