"""Attention decoder step (``mmqg_tpu/models/decoder.py``, attention path).

  emb   = E[word]                                   (B, D)
  q     = [emb; h_top]                              (B, D + H)
  ctx_t, ctx_a, ctx_v = tri-modal attention (K2)    ops.attention
  x     = [emb; ctx_text; ctx_audio; ctx_video]     (B, D + H + Ha + Hv)
  h, c  = LSTM stack step (x, (h, c)); logits = dense(h_top)

The LSTM step and the vocab projection are library products, as they were
plain XLA ops in JAX. The initial state is the text encoder's latched state.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.ops.attention import TriModalAttention, trimodal_attention

Tensor = torch.Tensor


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
             state: L.State, *, dtype: torch.dtype = torch.bfloat16
             ) -> Tuple[Tensor, L.State, dict]:
        """One decode step. Returns (logits (B, V) f32, new state, maps)."""
        emb = L.embed(emb_table, word)                      # (B, D)
        query = torch.cat([emb, state[0][-1]], dim=-1)
        m = inputs.mem
        ctx_t, ctx_a, ctx_v, maps = trimodal_attention(
            inputs.w_t, inputs.b, query.to(dtype).contiguous(), m.enc_text,
            m.enc_video, m.enc_audio, m.text_len, m.video_len, m.audio_len)
        x = torch.cat([emb, ctx_t, ctx_a, ctx_v], dim=-1)
        top, new_state = L.lstm_step(self.lstm, x, state, dtype=dtype)
        return self.out(top, dtype), new_state, maps
