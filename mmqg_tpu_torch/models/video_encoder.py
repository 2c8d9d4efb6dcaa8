"""Video encoder: per-frame CNN pyramid -> LSTM over frames
(``mmqg_tpu/models/video_encoder.py``).

  conv(3->4) relu bn, conv(4->6) relu bn, maxpool3,
  conv(6->8) relu bn, conv(8->10) relu bn, maxpool3,
  flatten in NHWC order (10 x 10 x 10 = 1000 at 112 x 112),
  LSTM(1000 -> H, 1 layer) over the frames: K1 in eval, K4 in training.

All B*T frames go through the convs as one batch, in the compute dtype, with
batchnorm maths in f32. uint8 frames feed conv1 directly: the ``/255``, mean
and std are folded into its weights; float frames (``frontends
.prepare_frames``'s, already normalised) take no ``normalization``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.models.text_encoder import mask_past
from mmqg_tpu_torch.ops.lstm import lstm_stack
from mmqg_tpu_torch.ops.lstm_train import lstm_stack_train

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

    def bn_tree(self) -> Dict:
        """The batchnorm modules in the JAX state pytree's structure."""
        return {"bns": list(self.bns)}

    def cnn_features(self, frames: Tensor, *, normalization=None,
                     frame_mask: Optional[Tensor] = None,
                     dtype: torch.dtype = torch.bfloat16
                     ) -> Tuple[Tensor, List[Dict[str, Tensor]]]:
        """(N, H, W, 3) frames -> ((N, flatten_dim) features in ``dtype``,
        new batchnorm running states). uint8 frames take
        ``normalization=(mean, std)``, folded into conv1. With a
        ``frame_mask (N,)`` (training) batchnorm normalises with the
        statistics of the masked-in frames and the states are the updated
        running statistics; without one it runs in eval mode and there are
        none."""
        x = frames
        states = []
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            w, b = conv.w, conv.b
            if i == 0 and normalization is not None:
                w, b = fold_normalization(w, b, *normalization)
            x = torch.relu(L.conv2d(x, w, b, dtype=dtype, out_dtype=dtype))
            if frame_mask is None:
                x = bn(x)
            else:
                x, st = bn.train_forward(x, frame_mask)
                states.append(st)
            if i in (1, 3):
                x = L.maxpool2d(x, 3)
        return x.reshape(x.shape[0], -1), states

    def forward(self, frames: Tensor, frames_len: Tensor, *,
                normalization=None,
                dtype: torch.dtype = torch.bfloat16) -> Tensor:
        """(B, T, H, W, 3) frames -> (B, T, hidden) f32, zeroed past the
        length (eval: batchnorm running statistics, K1)."""
        B, T = frames.shape[:2]
        flat = frames.reshape((B * T,) + frames.shape[2:])
        feats, _ = self.cnn_features(flat, normalization=normalization,
                                     dtype=dtype)
        return lstm_stack(self.lstm, feats.reshape(B, T, -1), frames_len,
                          dtype=dtype)[0]

    def train_forward(self, frames: Tensor, frames_len: Tensor, *,
                      normalization=None,
                      dtype: torch.dtype = torch.bfloat16
                      ) -> Tuple[Tensor, List[Dict[str, Tensor]]]:
        """Training (``video_encoder.apply(train=True)``): batchnorm over
        the valid frames only, the LSTM through K4, outputs zeroed past the
        length. Returns (outputs (B, T, hidden) f32, the new batchnorm
        running states, detached -- the buffers are not touched)."""
        B, T = frames.shape[:2]
        flat = frames.reshape((B * T,) + frames.shape[2:])
        mask = (torch.arange(T, device=frames.device)[None, :]
                < frames_len[:, None]).reshape(-1)
        feats, states = self.cnn_features(flat, normalization=normalization,
                                          frame_mask=mask, dtype=dtype)
        outs, _ = lstm_stack_train(self.lstm, feats.reshape(B, T, -1),
                                   dtype=dtype)
        return mask_past(outs, frames_len), states
