"""WAV reading, resampling to mono and span clipping (``mmqg_tpu/data/wav.py``),
numpy only: RIFF/WAVE PCM16, PCM32 and float32, linear-interpolation
resampling, span slicing."""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple

import numpy as np


def read_wav(path: Path) -> Tuple[np.ndarray, int]:
    """Read a RIFF/WAVE file -> (float32 samples in [-1,1] shaped (n, ch), rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            if len(body) < 16:
                raise ValueError(f"{path}: truncated fmt chunk")
            (audio_fmt, channels, rate, _br, _ba, bits) = struct.unpack(
                "<HHIIHH", body[:16])
            if channels < 1:
                raise ValueError(f"{path}: zero channels")
            fmt = (audio_fmt, channels, rate, bits)
        elif chunk_id == b"data":
            samples = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or samples is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, channels, rate, bits = fmt
    if audio_fmt == 1 and bits == 16:
        arr = np.frombuffer(samples, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_fmt == 1 and bits == 32:
        arr = np.frombuffer(samples, dtype="<i4").astype(np.float32) / 2147483648.0
    elif audio_fmt == 3 and bits == 32:
        arr = np.frombuffer(samples, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported wav format {audio_fmt}/{bits}bit")
    n = len(arr) // channels
    return arr[: n * channels].reshape(n, channels), rate


def to_mono(samples: np.ndarray) -> np.ndarray:
    return samples.mean(axis=1) if samples.ndim == 2 else samples


def resample_linear(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Linear-interpolation resample of a mono signal."""
    if src_rate == dst_rate:
        return x
    n_out = int(round(len(x) * dst_rate / src_rate))
    t_out = np.arange(n_out, dtype=np.float64) * (src_rate / dst_rate)
    return np.interp(t_out, np.arange(len(x), dtype=np.float64),
                     x).astype(np.float32)


def load_mono_16k(path: Path, target_rate: int = 16000) -> np.ndarray:
    samples, rate = read_wav(path)
    return resample_linear(to_mono(samples), rate, target_rate)


def clip_span(samples: np.ndarray, rate: int, start_s: float,
              end_s: float) -> np.ndarray:
    """The samples of [start_s, end_s): array slicing in place of
    ``ffmpeg -ss <start> -to <end> -c copy``."""
    a = max(0, int(round(start_s * rate)))
    b = min(len(samples), int(round(end_s * rate)))
    return samples[a:b]
