"""Text encoder: shared embedding -> LSTM stack over the context
(``mmqg_tpu/models/text_encoder.py``).

Eval: the whole padded context runs through K1 (``ops.lstm.lstm_stack``),
one launch per layer on the card. Outputs are zeroed past ``context_len``
and (h, c) is latched at ``context_len - 1``; that state seeds the decoder.

Train: layer by layer through K4 (``ops.lstm_train.lstm_stack_train``),
which has a backward. Between layers a fresh dropout mask of shape
(B, T, H) is drawn for every layer, so every step and layer gets its own
mask, as JAX's per-step ``fold_in(rng, t)`` / ``fold_in(step_rng, li)``
does. K4 neither masks nor latches: the state at ``context_len - 1`` is
gathered from its h and c sequences (a differentiable gather) and the
outputs past the length are zeroed afterwards.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.ops.lstm import lstm_stack
from mmqg_tpu_torch.ops.lstm_train import lstm_stack_train

Tensor = torch.Tensor


def mask_past(seq: Tensor, lengths: Tensor) -> Tensor:
    """Zero ``seq (B, T, H)`` at steps >= each row's length."""
    live = (torch.arange(seq.shape[1], device=seq.device)[None, :]
            < lengths[:, None])
    return torch.where(live[..., None], seq, 0.0)


class TextEncoder(nn.Module):
    def __init__(self, lstm: L.LSTM):
        super().__init__()
        self.lstm = lstm

    def forward(self, emb_table: Tensor, context_ids: Tensor,
                context_len: Tensor, *, train: bool = False,
                dropout: float = 0.0,
                generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.bfloat16) -> Tuple[Tensor, L.State]:
        """Returns (outputs (B, Lc, H) zeroed past the length, state at the
        length (h, c) each (L, B, H)). ``train`` runs the trainable K4 path
        with ``dropout`` between layers drawn from ``generator``."""
        emb = L.embed(emb_table, context_ids)          # (B, Lc, D)
        if not train:
            return lstm_stack(self.lstm, emb, context_len, dtype=dtype)
        seq, state = lstm_stack_train(self.lstm, emb, lengths=context_len,
                                      dropout=dropout, generator=generator,
                                      dtype=dtype)
        return mask_past(seq, context_len), state
