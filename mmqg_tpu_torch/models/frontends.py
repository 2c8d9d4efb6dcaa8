"""On-device frontends (``mmqg_tpu/models/frontends.py``): video frame
preparation and the log-mel audio frontend.

``prepare_frames``: uint8 frames -> [0, 1] -> the shortest side resized to
``size`` -> per-channel normalisation, in float32. The resize is
``jax.image.resize(method="cubic")``'s: a separable Keys cubic kernel
(a = -0.5) over half-centred pixels, widened by 1 / scale when it
downsamples (antialiasing) and renormalised to sum 1 per output pixel. The
(out, in) weight matrices are built once per size pair in numpy, in
float32 steps as JAX builds them, and applied as two matmuls on the
device. (``torch.nn.functional.interpolate(mode="bicubic")`` is another
function: a = -0.75 and no antialias.)

int16 PCM is converted on the device; the STFT is one matmul of hop-aligned
frames against a windowed cos/sin basis, then magnitude, the mel matmul and
``log(mel + offset)``. Featurisation constants follow the VGGish contract
(16 kHz mono, 25 ms / 10 ms Hann STFT, 64 mel bins 125-7500 Hz, 96-frame
examples). The two products are library calls, as they were XLA ops in JAX.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from mmqg_tpu_torch.models.layers import mm

Tensor = torch.Tensor


# ------------------------------------------------------------------ video

def keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel, a = -0.5, at distances ``x >= 0``."""
    near = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1)
    far = ((np.float32(-0.5) * x + np.float32(2.5)) * x
           - np.float32(4)) * x + np.float32(2)
    out = np.where(x >= 1, far, near)
    return np.where(x >= 2, np.float32(0), out).astype(np.float32)


@functools.lru_cache(maxsize=32)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of a cubic resize along one axis
    (``jax.image``'s ``compute_weight_mat`` with scale ``n_out / n_in``, no
    translation, antialiased): output pixel j reads input pixel i with
    weight ``kernel(|sample_j - i| / max(1 / scale, 1))``, the row
    normalised to sum 1, and zero where the sample falls outside the
    input."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]
               ) / kernel_scale
    w = keys_cubic(x.astype(f32))                        # (n_in, n_out)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0)).T
                                .astype(np.float32))


@functools.lru_cache(maxsize=32)
def _resize_matrix(n_in: int, n_out: int, device: str) -> Tensor:
    return torch.from_numpy(resize_weights(n_in, n_out)).to(device)


def prepare_frames(frames_u8: Tensor, *, size: int = 112,
                   mean: Tuple[float, float, float] = (0.43216, 0.394666,
                                                       0.37645),
                   std: Tuple[float, float, float] = (0.22803, 0.22145,
                                                      0.216989),
                   normalize: bool = True,
                   dtype: torch.dtype = torch.float32) -> Tensor:
    """(B, T, H, W, 3) frames (uint8, or float on the same 0-255 scale) ->
    ``dtype`` (B, T, H', W', 3), computed in ``dtype``: ``/ 255``, the
    shortest side resized to ``size`` (H' x W' = int(H * s) x int(W * s),
    s = size / min(H, W); only when min(H, W) != size), then
    ``(x - mean) / std``."""
    x = frames_u8.to(dtype) / 255.0
    B, T, H, W, C = x.shape
    if min(H, W) != size:
        scale = size / min(H, W)
        out_h, out_w = int(H * scale), int(W * scale)
        dev = str(x.device)
        x = x.reshape(B * T, H, W, C)
        if out_h != H:
            x = torch.einsum("oh,nhwc->nowc",
                             _resize_matrix(H, out_h, dev).to(dtype), x)
        if out_w != W:
            x = torch.einsum("pw,nhwc->nhpc",
                             _resize_matrix(W, out_w, dev).to(dtype), x)
        x = x.reshape(B, T, out_h, out_w, C)
    if normalize:
        x = ((x - torch.tensor(mean, dtype=dtype, device=x.device))
             / torch.tensor(std, dtype=dtype, device=x.device))
    return x


# ------------------------------------------------------------------ audio

def mel_filterbank(num_mel_bins: int, num_spectrogram_bins: int,
                   sample_rate: int, lower_hz: float,
                   upper_hz: float) -> np.ndarray:
    """HTK-style triangular mel filterbank (F, M), the VGGish featuriser's
    spectrogram_to_mel_matrix."""
    def hz_to_mel(hz):
        return 1127.0 * np.log(1.0 + np.asarray(hz, np.float64) / 700.0)

    spec_mel = hz_to_mel(np.linspace(0.0, sample_rate / 2.0,
                                     num_spectrogram_bins))
    edges = np.linspace(hz_to_mel(lower_hz), hz_to_mel(upper_hz),
                        num_mel_bins + 2)
    weights = np.zeros((num_spectrogram_bins, num_mel_bins), np.float32)
    for m in range(num_mel_bins):
        lo, center, hi = edges[m:m + 3]
        lower = (spec_mel - lo) / (center - lo)
        upper = (hi - spec_mel) / (hi - center)
        weights[:, m] = np.maximum(0.0, np.minimum(lower, upper))
    weights[0, :] = 0.0  # DC bin excluded
    return weights


def stft_kernels(window: int, fft_length: int,
                 padded_window: int = 0) -> np.ndarray:
    """Periodic-Hann windowed DFT basis (padded_window, 2 * (fft // 2 + 1)):
    cos (real) columns, then -sin (imaginary); rows past ``window`` are 0."""
    padded_window = padded_window or window
    n = np.arange(window)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / window)
    phase = 2.0 * np.pi * np.outer(n, np.arange(fft_length // 2 + 1)) / fft_length
    out = np.zeros((padded_window, 2 * (fft_length // 2 + 1)), np.float32)
    out[:window] = np.concatenate(
        [(hann[:, None] * np.cos(phase)).astype(np.float32),
         (hann[:, None] * -np.sin(phase)).astype(np.float32)], axis=1)
    return out


@functools.lru_cache(maxsize=8)
def _bases(window: int, hop: int, mel_bins: int, sample_rate: int,
           lower_hz: float, upper_hz: float, device: str):
    """(STFT basis, mel matrix) on ``device``, built once per setting."""
    fft_length = 1 << int(math.ceil(math.log2(window)))
    k = -(-window // hop)
    kernels = stft_kernels(window, fft_length, k * hop)
    mel_mat = mel_filterbank(mel_bins, fft_length // 2 + 1, sample_rate,
                             lower_hz, upper_hz)
    return (torch.from_numpy(kernels).to(device),
            torch.from_numpy(mel_mat).to(device))


def log_mel_examples(pcm: Tensor, *, sample_rate: int = 16000,
                     window: int = 400, hop: int = 160, mel_bins: int = 64,
                     lower_hz: float = 125.0, upper_hz: float = 7500.0,
                     log_offset: float = 0.01, frames_per_example: int = 96,
                     max_examples: int = 101,
                     dtype: torch.dtype = torch.bfloat16,
                     spec_dtype: torch.dtype = torch.float32) -> Tensor:
    """(B, S) PCM (int16 or float) -> (B, max_examples, frames_per_example,
    mel_bins) log-mel. Examples past the signal are log(0 + offset); the
    attention masks them by length. The two products take their operands
    in ``dtype``; the spectrogram and its magnitude between them are kept
    in ``spec_dtype``; the log is float32."""
    if pcm.dtype == torch.int16:
        pcm = pcm.float() / 32768.0
    kernels, mel_mat = _bases(window, hop, mel_bins, sample_rate,
                              float(lower_hz), float(upper_hz),
                              str(pcm.device))
    k = -(-window // hop)                       # hop chunks per frame
    n_frames = max_examples * frames_per_example
    n_chunks = n_frames + k - 1
    need = n_chunks * hop
    B, S = pcm.shape
    if S < need:
        pcm = torch.nn.functional.pad(pcm, (0, need - S))
    else:
        pcm = pcm[:, :need]
    chunks = pcm.reshape(B, n_chunks, hop)
    frames = torch.cat([chunks[:, i:n_chunks - k + 1 + i] for i in range(k)],
                       dim=-1)                  # (B, n_frames, k * hop)
    spec = mm(frames, kernels, dtype).to(spec_dtype)  # (B, n_frames, 2F)
    re, im = spec.chunk(2, dim=-1)
    magnitude = torch.sqrt(re * re + im * im + 1e-12)
    mel = mm(magnitude, mel_mat, dtype)        # (B, n_frames, M) f32
    return torch.log(mel + log_offset).reshape(B, max_examples,
                                               frames_per_example, mel_bins)


def audio_num_examples(audio_len_samples: Tensor, *,
                       sample_rate: int = 16000, hop: int = 160,
                       window: int = 400, frames_per_example: int = 96,
                       max_examples: int = 101) -> Tensor:
    """How many whole 0.96 s examples a signal of the given length yields.
    ``sample_rate`` is accepted and unused, as in the JAX package: the
    count depends on samples alone."""
    n_frames = torch.clamp((audio_len_samples - window) // hop + 1, min=0)
    return torch.clamp(n_frames // frames_per_example, 0, max_examples)
