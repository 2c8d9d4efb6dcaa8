"""Video encoder: per-frame CNN pyramid -> LSTM over frames
(``mmqg_tpu/models/video_encoder.py``, eval mode).

  conv(3->4) relu bn, conv(4->6) relu bn, maxpool3,
  conv(6->8) relu bn, conv(8->10) relu bn, maxpool3,
  flatten in NHWC order (10 x 10 x 10 = 1000 at 112 x 112),
  LSTM(1000 -> H, 1 layer) over the frames, through K1.

All B*T frames go through the convs as one batch, in the compute dtype, with
batchnorm maths in f32. uint8 frames feed conv1 directly: the ``/255``, mean
and std are folded into its weights.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.ops.lstm import lstm_stack

Tensor = torch.Tensor

CHANNELS = (4, 6, 8, 10)


def flatten_dim_for(frame_size: int, kernel: int = 3) -> int:
    """Flattened CNN feature size for a square frame: 112 -> 1000."""
    s = frame_size - 2 * (kernel - 1)     # conv1, conv2 (VALID)
    s = s // 3                            # maxpool 3
    s = s - 2 * (kernel - 1)              # conv3, conv4
    s = s // 3                            # maxpool 3
    return s * s * CHANNELS[-1]


def fold_normalization(w: Tensor, b: Tensor, mean, std) -> Tuple[Tensor, Tensor]:
    """Absorb ``(u8 / 255 - mean) / std`` into conv1's HWIO weight and bias:
    conv(x * scale + shift, W) = conv(x, W * scale) + sum(W * shift)."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=w.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=w.device)
    scale = 1.0 / (255.0 * std)
    shift = -mean / std
    return (w * scale[None, None, :, None],
            b + (w * shift[None, None, :, None]).sum((0, 1, 2)))


class VideoEncoder(nn.Module):
    def __init__(self, convs: Sequence[L.Conv2d], bns: Sequence[L.BatchNorm],
                 lstm: L.LSTM):
        super().__init__()
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)
        self.lstm = lstm

    def cnn_features(self, frames: Tensor, *, normalization=None,
                     dtype: torch.dtype = torch.bfloat16) -> Tensor:
        """(N, H, W, 3) frames -> (N, flatten_dim) features in ``dtype``.
        uint8 frames take ``normalization=(mean, std)``, folded into conv1."""
        x = frames
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            w, b = conv.w, conv.b
            if i == 0 and normalization is not None:
                w, b = fold_normalization(w, b, *normalization)
            x = torch.relu(L.conv2d(x, w, b, dtype=dtype, out_dtype=dtype))
            x = bn(x)
            if i in (1, 3):
                x = L.maxpool2d(x, 3)
        return x.reshape(x.shape[0], -1)

    def forward(self, frames: Tensor, frames_len: Tensor, *,
                normalization=None,
                dtype: torch.dtype = torch.bfloat16) -> Tensor:
        """(B, T, H, W, 3) frames -> (B, T, hidden) f32, zeroed past the
        length."""
        B, T = frames.shape[:2]
        flat = frames.reshape((B * T,) + frames.shape[2:])
        feats = self.cnn_features(flat, normalization=normalization,
                                  dtype=dtype).reshape(B, T, -1)
        return lstm_stack(self.lstm, feats, frames_len, dtype=dtype)[0]
