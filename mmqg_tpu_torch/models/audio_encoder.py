"""Audio encoder: VGGish convnet over log-mel examples
(``mmqg_tpu/models/audio_encoder.py``).

conv64-pool, conv128-pool, conv256 x2-pool, conv512 x2-pool, then fc4096,
fc4096, fc128, each with ReLU, over one 96 x 64 log-mel patch: one 128-d
embedding per 0.96 s example. The convs run in the compute dtype with
activations kept in it; the fc layers take operands in it and sum in f32.

This is the bfloat16 path (``embed_examples``), which is what the JAX
package runs on the CPU. Its int8 serving variant (``embed_examples_int8``,
on by default off the CPU through ``ModelConfig.audio_int8_serving``) is not
ported yet, so the port serves the bf16 VGGish whatever that flag says.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mmqg_tpu_torch.models import layers as L

Tensor = torch.Tensor

# (out_channels, n_convs) per VGG block
BLOCKS = ((64, 1), (128, 1), (256, 2), (512, 2))


class AudioEncoder(nn.Module):
    def __init__(self, convs: Sequence[L.Conv2d], fc1: L.Dense, fc2: L.Dense,
                 fc3: L.Dense):
        super().__init__()
        self.convs = nn.ModuleList(convs)
        self.fc1, self.fc2, self.fc3 = fc1, fc2, fc3

    def embed_examples(self, mel: Tensor, *,
                       dtype: torch.dtype = torch.bfloat16) -> Tensor:
        """(N, 96, 64) log-mel examples -> (N, 128) embeddings."""
        x = mel[..., None]  # NHWC with one channel
        ci = 0
        for _, reps in BLOCKS:
            for _ in range(reps):
                conv = self.convs[ci]
                x = torch.relu(L.conv2d(x, conv.w, conv.b, padding="SAME",
                                        dtype=dtype, out_dtype=dtype))
                ci += 1
            x = L.maxpool2d(x, 2)
        x = x.reshape(x.shape[0], -1)  # NHWC flatten, as the JAX package
        x = torch.relu(self.fc1(x, dtype))
        x = torch.relu(self.fc2(x, dtype))
        return torch.relu(self.fc3(x, dtype))

    def forward(self, mel_examples: Tensor, examples_len: Tensor, *,
                dtype: torch.dtype = torch.bfloat16) -> Tensor:
        """(B, E, 96, 64) -> (B, E, 128), zeroed past each row's count."""
        B, E = mel_examples.shape[:2]
        flat = mel_examples.reshape((B * E,) + mel_examples.shape[2:])
        emb = self.embed_examples(flat, dtype=dtype).reshape(B, E, -1)
        mask = (torch.arange(E, device=emb.device)[None, :]
                < examples_len[:, None])[..., None]
        return torch.where(mask, emb, 0.0)
