"""Reserved token ids and padding (``mmqg_tpu/data/vocab.py``), numpy only."""

from __future__ import annotations

import numpy as np

PAD_ID, START_ID, END_ID = 0, 1, 2


def pad_to(ids: np.ndarray, length: int, pad_id: int = PAD_ID) -> np.ndarray:
    out = np.full((length,), pad_id, dtype=np.int32)
    n = min(len(ids), length)
    out[:n] = ids[:n]
    return out
