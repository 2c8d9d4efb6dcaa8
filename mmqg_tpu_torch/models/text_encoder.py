"""Text encoder: shared embedding -> LSTM stack over the context
(``mmqg_tpu/models/text_encoder.py``).

The whole padded context runs through K1 (``ops.lstm.lstm_stack``), one
launch per layer on the card. Outputs are zeroed past ``context_len`` and
(h, c) is latched at ``context_len - 1``; that state seeds the decoder.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.ops.lstm import lstm_stack

Tensor = torch.Tensor


class TextEncoder(nn.Module):
    def __init__(self, lstm: L.LSTM):
        super().__init__()
        self.lstm = lstm

    def forward(self, emb_table: Tensor, context_ids: Tensor,
                context_len: Tensor, *,
                dtype: torch.dtype = torch.bfloat16) -> Tuple[Tensor, L.State]:
        """Returns (outputs (B, Lc, H) zeroed past the length, state at the
        length (h, c) each (L, B, H))."""
        emb = L.embed(emb_table, context_ids)          # (B, Lc, D)
        return lstm_stack(self.lstm, emb, context_len, dtype=dtype)
