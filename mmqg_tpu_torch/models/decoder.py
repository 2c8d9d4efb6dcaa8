"""Decoder steps (``mmqg_tpu/models/decoder.py``): the attention decoder
and the non-attention decoder.

Attention decoder:

  emb   = E[word]                                   (B, D)
  q     = [emb; h_top]                              (B, D + H)
  ctx_t, ctx_a, ctx_v = tri-modal attention (K2)    ops.attention
  x     = [emb; ctx_text; ctx_audio; ctx_video]     (B, D + H + Ha + Hv)
  h, c  = LSTM stack step (x, (h, c)); logits = dense(h_top)

The LSTM step and the vocab projection are library products, as they were
plain XLA ops in JAX. The initial state is the text encoder's latched state.

Training runs :meth:`Decoder.teacher_forced_logits` (``decoder.py``'s
``teacher_forced_logits``): one step per target position under autograd,
with the differentiable ``trimodal_attention_xla`` in place of K2, dropout
between LSTM layers, and one vocab projection over all (B * T) rows after
the loop.

Non-attention decoder (:class:`NonAttnDecoder`, the reference's AV-vector
decoder): every step reads one vector, ``av_vec`` = [masked-mean audio
memory; masked-mean video memory] (:func:`av_vector`, zeros for an absent
modality), so x = [emb; av_vec] and no attention runs. Both decoders offer
``step_inputs``, ``step`` and ``teacher_forced_logits`` with the same
arguments, so every decode strategy runs either one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.ops.attention import (TriModalAttention,
                                          trimodal_attention,
                                          trimodal_attention_xla)

Tensor = torch.Tensor
AttnFn = Callable[..., Tuple[Tensor, Tensor, Tensor, dict]]


class Memories(NamedTuple):
    """Attention memories and their true lengths (int32)."""
    enc_text: Tensor    # (B, Lt, Ht)
    enc_video: Tensor   # (B, La, Hv)
    enc_audio: Tensor   # (B, La, Ha)
    text_len: Tensor    # (B,)
    video_len: Tensor   # (B,)
    audio_len: Tensor   # (B,)


class StepInputs(NamedTuple):
    """What every step of one decode reads, cast once per decode: the
    memories and the attention weights in the compute dtype."""
    mem: Memories
    w_t: Tensor
    b: Tensor


class Decoder(nn.Module):
    def __init__(self, attn: TriModalAttention, lstm: L.LSTM, out: L.Dense):
        super().__init__()
        self.attn = attn
        self.lstm = lstm
        self.out = out

    def step_inputs(self, mem: Memories, dtype: torch.dtype) -> StepInputs:
        w_t, b = self.attn.weights(dtype)
        cast = Memories(*(m.to(dtype).contiguous() for m in mem[:3]),
                        *(n.to(torch.int32).contiguous() for n in mem[3:]))
        return StepInputs(cast, w_t, b)

    def step(self, emb_table: Tensor, word: Tensor, inputs: StepInputs,
             state: L.State, *, dtype: torch.dtype = torch.bfloat16,
             attn_fn: Optional[AttnFn] = None
             ) -> Tuple[Tensor, L.State, dict]:
        """One decode step. Returns (logits (B, V) f32, new state, maps).
        ``attn_fn``: another attention with ``trimodal_attention_xla``'s
        arguments in place of K2 (JAX ``decoder.step``'s), e.g.
        ``ops.attention_sp.trimodal_attention_sp`` bound to a model
        group."""
        emb = L.embed(emb_table, word)                      # (B, D)
        query = torch.cat([emb, state[0][-1]], dim=-1)
        m = inputs.mem
        if attn_fn is not None:
            ctx_t, ctx_a, ctx_v, maps = attn_fn(
                self.attn, query, m.enc_text, m.enc_video, m.enc_audio,
                m.text_len, m.video_len, m.audio_len, dtype=dtype)
        else:
            ctx_t, ctx_a, ctx_v, maps = trimodal_attention(
                inputs.w_t, inputs.b, query.to(dtype).contiguous(),
                m.enc_text, m.enc_video, m.enc_audio, m.text_len,
                m.video_len, m.audio_len)
        x = torch.cat([emb, ctx_t, ctx_a, ctx_v], dim=-1)
        top, new_state = L.lstm_step(self.lstm, x, state, dtype=dtype)
        return self.out(top, dtype), new_state, maps

    def teacher_forced_logits(self, emb_table: Tensor, inputs: Tensor,
                              mem: Memories, init_state: L.State, *,
                              dropout: float = 0.0,
                              generator: Optional[torch.Generator] = None,
                              dtype: torch.dtype = torch.bfloat16,
                              attn_fn: Optional[AttnFn] = None) -> Tensor:
        """All-step teacher forcing over ``inputs (B, T)`` ([<start>,
        target[:-1]]) with a fresh dropout mask per step from ``generator``.
        Returns logits (B, T, V) f32 (this rank's columns of V when the
        vocab projection is column-parallel). ``attn_fn`` replaces
        ``trimodal_attention_xla``, as in :meth:`step`."""
        attend = attn_fn or trimodal_attention_xla
        state = init_state
        tops = []
        for t in range(inputs.shape[1]):
            emb = L.embed(emb_table, inputs[:, t])
            query = torch.cat([emb, state[0][-1]], dim=-1)
            ctx_t, ctx_a, ctx_v, _ = attend(
                self.attn, query, mem.enc_text, mem.enc_video, mem.enc_audio,
                mem.text_len, mem.video_len, mem.audio_len, dtype=dtype)
            x = torch.cat([emb, ctx_t, ctx_a, ctx_v], dim=-1)
            top, state = L.lstm_step(self.lstm, x, state,
                                     dropout_rate=dropout,
                                     generator=generator, dtype=dtype)
            tops.append(top)
        return _project(self.out, tops, dtype)


def _project(out: L.Dense, tops, dtype: torch.dtype) -> Tensor:
    """One vocab projection over all (B * T) rows of the step outputs."""
    tops = torch.stack(tops, dim=1)                          # (B, T, H)
    B, T, H = tops.shape
    return out(tops.reshape(B * T, H), dtype).reshape(B, T, -1)


def av_vector(mem: Memories) -> Tensor:
    """[masked-mean audio memory (Ha); masked-mean video memory (Hv)]
    (``qg_model.av_vector``), float32 (B, Ha + Hv)."""
    def masked_mean(m, n):
        live = (torch.arange(m.shape[1], device=m.device)[None, :]
                < n[:, None])[..., None]
        return (m * live).sum(1) / torch.clamp(n, min=1)[:, None]

    return torch.cat([masked_mean(mem.enc_audio, mem.audio_len),
                      masked_mean(mem.enc_video, mem.video_len)], dim=-1)


class NonAttnDecoder(nn.Module):
    def __init__(self, lstm: L.LSTM, out: L.Dense):
        super().__init__()
        self.lstm = lstm
        self.out = out

    def step_inputs(self, mem: Memories, dtype: torch.dtype) -> Tensor:
        """The AV vector every step reads, from the float32 memories."""
        return av_vector(mem)

    def step(self, emb_table: Tensor, word: Tensor, av_vec: Tensor,
             state: L.State, *, dtype: torch.dtype = torch.bfloat16,
             attn_fn: Optional[AttnFn] = None
             ) -> Tuple[Tensor, L.State, None]:
        """One decode step (``decoder.non_attn_step``). Returns (logits
        (B, V) f32, new state, None: there are no attention maps).
        ``attn_fn`` is accepted for a uniform call and unused: no
        attention runs."""
        x = torch.cat([L.embed(emb_table, word), av_vec], dim=-1)
        top, new_state = L.lstm_step(self.lstm, x, state, dtype=dtype)
        return self.out(top, dtype), new_state, None

    def teacher_forced_logits(self, emb_table: Tensor, inputs: Tensor,
                              mem: Memories, init_state: L.State, *,
                              dropout: float = 0.0,
                              generator: Optional[torch.Generator] = None,
                              dtype: torch.dtype = torch.bfloat16,
                              attn_fn: Optional[AttnFn] = None) -> Tensor:
        """All-step teacher forcing (``decoder.non_attn_teacher_forced``)
        with a fresh dropout mask per step from ``generator``. Returns
        logits (B, T, V) f32."""
        av_vec = av_vector(mem)
        state = init_state
        tops = []
        for t in range(inputs.shape[1]):
            x = torch.cat([L.embed(emb_table, inputs[:, t]), av_vec], dim=-1)
            top, state = L.lstm_step(self.lstm, x, state,
                                     dropout_rate=dropout,
                                     generator=generator, dtype=dtype)
            tops.append(top)
        return _project(self.out, tops, dtype)
