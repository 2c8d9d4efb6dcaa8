"""Corpus length auditing (``mmqg_tpu/utils/audit.py``; reference
utils/check_maxlen.py:7-35): the tool that derived the hard-coded max
lengths (context 283 / question 21 / AV 101, reference config.py:69-71).
The port's own copy; it imports only numpy."""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np


def get_maxlen_text(corpus: List[Dict], key: str) -> Tuple[int, float]:
    """(max, avg) token count of ``key`` across records
    (reference check_maxlen.py:7-14)."""
    lens = [len(rec[key].split()) for rec in corpus]
    return (max(lens), float(np.mean(lens))) if lens else (0, 0.0)


def get_maxlen_frames(path: Path) -> Tuple[int, float]:
    """(max, avg) salient-frame count across artifacts
    (reference check_maxlen.py:16-23)."""
    lens = []
    for name in os.listdir(path):
        if name.endswith(".npy"):
            lens.append(np.load(Path(path) / name, mmap_mode="r").shape[0])
    return (max(lens), float(np.mean(lens))) if lens else (0, 0.0)


def audit_corpus(config) -> Dict[str, Tuple[int, float]]:
    """Full audit -> suggested *_max_length config values."""
    with open(config.preprocessed_text_file) as f:
        corpus = json.load(f)
    report = {
        "context": get_maxlen_text(corpus, "context"),
        "question": get_maxlen_text(corpus, "question"),
    }
    if os.path.isdir(config.salient_frames_path):
        report["frames"] = get_maxlen_frames(config.salient_frames_path)
    return report
