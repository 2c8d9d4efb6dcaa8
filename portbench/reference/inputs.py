"""The reference's own reading of a request's raw inputs: the context's
token ids from the vocabulary and the uint8 frames. Written from the
request contract, not from the port's code."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def context_ids(context: str, vocab: Dict[str, int], max_len: int
                ) -> Tuple[np.ndarray, int]:
    """Known words of ``context`` in order, at most ``max_len`` of them, and
    the length the encoder runs to (at least 1: an empty context reads one
    padding token)."""
    ids = [vocab[w] for w in context.split() if w in vocab][:max_len]
    n = max(1, len(ids))
    out = np.zeros((n,), np.int64)
    out[:len(ids)] = ids
    return out, n


def frames_u8(frames: Optional[np.ndarray], max_frames: int
              ) -> Optional[np.ndarray]:
    """At most ``max_frames`` uint8 frames (T, H, W, 3)."""
    if frames is None:
        return None
    return np.asarray(frames, np.uint8)[:max_frames]
