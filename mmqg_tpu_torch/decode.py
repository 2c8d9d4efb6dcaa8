"""Batched greedy decoding (``mmqg_tpu/decode.py``).

``decode_batch`` = :func:`encode` then :func:`decode_from_memories`: a loop
of ``max_len`` decoder steps over the whole batch, with a finished mask --
after a row emits ``<end>`` or ``<pad>`` it emits ``<pad>``, and hosts trim
at the first of either (:func:`tokens_to_words`). Greedy is the only
strategy ported so far; the others raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mmqg_tpu_torch.data.vocab import END_ID, PAD_ID, START_ID
from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.models import qg_model
from mmqg_tpu_torch.models.decoder import Memories

Tensor = torch.Tensor


def _bucket(need: int, av: int, granularity: int = 8) -> int:
    """Smallest of the eighths of ``av`` that holds ``need``."""
    for k in range(1, granularity + 1):
        b = max(1, (k * av) // granularity)
        if need <= b:
            return b
    return av


def audio_examples_needed(mc: qg_model.ModelConfig, audio_len) -> int:
    """Host-side max whole mel-example count of a batch."""
    return int(np.max(np.maximum(
        0, (np.asarray(audio_len) - mc.stft_window) // mc.stft_hop + 1)
        // mc.mel_frames))


def audio_bucket(mc: qg_model.ModelConfig, audio_len) -> int:
    """Host-side audio bucket: the example slots the VGGish runs on, from
    the batch's largest whole-example count."""
    av = mc.av_max_length
    need = audio_examples_needed(mc, audio_len)
    return _bucket(max(1, min(need, av)), av)


def frames_bucket(mc: qg_model.ModelConfig, frames_len) -> int:
    """Host-side bucket for the batch's max frame count."""
    need = int(np.max(np.asarray(frames_len)))
    return _bucket(max(1, min(need, mc.av_max_length)), mc.av_max_length)


def _caps(mc: qg_model.ModelConfig, batch: Dict[str, Tensor],
          audio_cap: Optional[int], frames_cap: Optional[int]):
    """Resolve the (audio, frames) caps. Computing them from device tensors
    waits for the device; callers that know them pass them."""
    cap = (audio_cap if audio_cap is not None
           else audio_bucket(mc, batch["audio_len"].cpu().numpy()))
    fcap = (frames_cap if frames_cap is not None
            else frames_bucket(mc, batch["frames_len"].cpu().numpy()))
    return cap, fcap


def decode_from_memories(model: qg_model.QGModel, mem: Memories,
                         dec_state: L.State, *, strategy: str = "greedy",
                         max_len: int = 21,
                         dtype: torch.dtype = torch.bfloat16,
                         return_logits: bool = False):
    """Token generation over encoded memories. Returns tokens (B, max_len)
    int32, PAD after ``<end>``; with ``return_logits`` also the per-step
    logits (B, max_len, V) f32."""
    if strategy != "greedy":
        raise NotImplementedError(
            f"strategy={strategy!r}: only greedy decoding is ported so far")
    dec = model.decoder
    B = mem.enc_text.shape[0]
    dev = mem.enc_text.device
    inputs = dec.step_inputs(mem, dtype)
    tok = torch.full((B,), START_ID, dtype=torch.long, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    state = dec_state
    toks: List[Tensor] = []
    logits_all: List[Tensor] = []
    for _ in range(max_len):
        logits, state, _ = dec.step(model.embedding, tok, inputs, state,
                                    dtype=dtype)
        nxt = torch.where(finished, PAD_ID, torch.argmax(logits, dim=-1))
        # PAD is terminal too: hosts truncate at the first PAD/END
        finished = finished | (nxt == END_ID) | (nxt == PAD_ID)
        toks.append(nxt)
        logits_all.append(logits)
        tok = nxt
    tokens = torch.stack(toks, dim=1).to(torch.int32)
    if return_logits:
        return tokens, torch.stack(logits_all, dim=1)
    return tokens


def encode(model: qg_model.QGModel, mc: qg_model.ModelConfig,
           batch: Dict[str, Tensor], *, audio_cap: Optional[int] = None,
           frames_cap: Optional[int] = None,
           dtype: torch.dtype = torch.bfloat16) -> Tuple[Memories, L.State]:
    """Encode with the batch's AV buckets (``decode.encode_jit``)."""
    cap, fcap = _caps(mc, batch, audio_cap, frames_cap)
    mem, state, _ = qg_model.encode(model, mc, batch, audio_cap=cap,
                                    frames_cap=fcap, dtype=dtype)
    return mem, state


def decode_batch(model: qg_model.QGModel, mc: qg_model.ModelConfig,
                 batch: Dict[str, Tensor], *, strategy: str = "greedy",
                 max_len: int = 21, audio_cap: Optional[int] = None,
                 frames_cap: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """Token ids (B, max_len); PAD after ``<end>``, which is kept."""
    mem, dec_state = encode(model, mc, batch, audio_cap=audio_cap,
                            frames_cap=frames_cap, dtype=dtype)
    return decode_from_memories(model, mem, dec_state, strategy=strategy,
                                max_len=max_len, dtype=dtype)


def tokens_to_words(tokens, index_to_word: Dict[str, str]) -> List[List[str]]:
    """Id -> word rows, each cut at its first ``<end>``/``<pad>``."""
    out = []
    for row in np.asarray(tokens):
        words = []
        for t in row:
            if t in (PAD_ID, END_ID):
                break
            words.append(index_to_word[str(int(t))])
        out.append(words)
    return out
