"""Reserved tokens, tokenising and padding (``mmqg_tpu/data/vocab.py``),
numpy only."""

from __future__ import annotations

from typing import Dict

import numpy as np

PAD_ID, START_ID, END_ID = 0, 1, 2
END = "<end>"


def encode_tokens(text: str, vocab: Dict[str, int]) -> np.ndarray:
    """Whitespace split -> vocab ids."""
    return np.asarray([vocab[w] for w in text.split()], dtype=np.int32)


def pad_to(ids: np.ndarray, length: int, pad_id: int = PAD_ID) -> np.ndarray:
    out = np.full((length,), pad_id, dtype=np.int32)
    n = min(len(ids), length)
    out[:n] = ids[:n]
    return out
