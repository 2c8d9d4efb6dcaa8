"""Audio encoder: VGGish convnet over log-mel examples
(``mmqg_tpu/models/audio_encoder.py``).

conv64-pool, conv128-pool, conv256 x2-pool, conv512 x2-pool, then fc4096,
fc4096, fc128, each with ReLU, over one 96 x 64 log-mel patch: one 128-d
embedding per 0.96 s example. Three ways through the conv stack, routed by
:meth:`AudioEncoder.forward` as the JAX package's ``apply`` routes them:

* ``embed_examples``: the convs through the library conv (cuDNN), in the
  compute dtype -- what training and the CPU run;
* ``embed_examples_int8``: the int8 serving variant, conv2..conv6 through
  the hand-written int8 kernel (``ops/vggish.py::conv3x3_relu_int8``), with
  per-channel weight and per-example (or calibrated static) activation
  scales -- the default on the card (``ModelConfig.audio_int8_serving``);
* ``embed_examples_fused``: conv2..conv6 through K3
  (``ops/vggish.py::vggish_features``), the counterpart of
  ``embed_examples_pallas``.

The fc layers take operands in the compute dtype and sum in f32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.ops import vggish as V

Tensor = torch.Tensor

# (out_channels, n_convs) per VGG block
BLOCKS = ((64, 1), (128, 1), (256, 2), (512, 2))


class AudioEncoder(nn.Module):
    def __init__(self, convs: Sequence[L.Conv2d], fc1: L.Dense, fc2: L.Dense,
                 fc3: L.Dense):
        super().__init__()
        self.convs = nn.ModuleList(convs)
        self.fc1, self.fc2, self.fc3 = fc1, fc2, fc3

    def _head(self, x: Tensor, dtype: torch.dtype) -> Tensor:
        x = torch.relu(self.fc1(x, dtype))
        x = torch.relu(self.fc2(x, dtype))
        return torch.relu(self.fc3(x, dtype))

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
        return self._head(x.reshape(x.shape[0], -1), dtype)

    def embed_examples_fused(self, mel: Tensor, *,
                             dtype: torch.dtype = torch.bfloat16) -> Tensor:
        """``embed_examples_pallas``: K3's conv features, then the fc head."""
        return self._head(V.vggish_features(self.convs, mel, dtype=dtype),
                          dtype)

    def embed_examples_int8(self, mel: Tensor, *,
                            dtype: torch.dtype = torch.bfloat16,
                            act_scales: Optional[Sequence[float]] = None
                            ) -> Tensor:
        """The int8 serving variant of ``embed_examples``: conv1 in
        ``dtype`` through the library conv; conv2..conv6 as int8 x int8 ->
        int32 convs with per-output-channel weight scales and per-example
        activation scales (``act_scales``, from :meth:`calibrate_int8_scales`,
        switches to static per-layer scales); the fc head in ``dtype``. The
        quantize steps are plain tensor operations, as the JAX package leaves
        them to XLA. Serving only."""
        x = V.conv1_pool(self.convs, mel, dtype)
        for i, (c, pool) in enumerate(zip(self.convs[1:], V.POOLS)):
            wq, sw = V.quantize_weights(c.w)
            xq, sx = V.quantize_activations(
                x, None if act_scales is None else act_scales[i])
            x = V.conv3x3_relu_int8(xq, wq, sx, sw, c.b, pool=pool,
                                    dtype=dtype)
        return self._head(x.reshape(x.shape[0], -1), dtype)

    def calibrate_int8_scales(self, mel: Tensor, *,
                              margin: float = 1.1) -> Tuple[float, ...]:
        """Static activation scales for :meth:`embed_examples_int8`: run the
        f32 conv stack (library conv) on a calibration batch and take each
        quantized conv's input max, times ``margin``, over 127 (at least
        1e-6)."""
        x = torch.relu(L.conv2d(mel[..., None].float(), self.convs[0].w,
                                self.convs[0].b, padding="SAME",
                                dtype=torch.float32, out_dtype=torch.float32))
        x = L.maxpool2d(x, 2)
        scales = []
        ci = 1
        for _, reps in BLOCKS[1:]:
            for _ in range(reps):
                scales.append(float(torch.max(x)) * margin / 127.0)
                conv = self.convs[ci]
                x = torch.relu(L.conv2d(x, conv.w, conv.b, padding="SAME",
                                        dtype=torch.float32,
                                        out_dtype=torch.float32))
                ci += 1
            x = L.maxpool2d(x, 2)
        return tuple(max(s, 1e-6) for s in scales)

    def forward(self, mel_examples: Tensor, examples_len: Tensor, *,
                dtype: torch.dtype = torch.bfloat16, int8: bool = False,
                int8_scales: Optional[Sequence[float]] = None,
                use_kernel: bool = False) -> Tensor:
        """(B, E, 96, 64) -> (B, E, 128), zeroed past each row's count.
        ``int8`` takes :meth:`embed_examples_int8` (serving only); else
        ``use_kernel`` takes K3 (:meth:`embed_examples_fused`) off the CPU;
        else :meth:`embed_examples` -- the routing of JAX's ``apply``."""
        B, E = mel_examples.shape[:2]
        flat = mel_examples.reshape((B * E,) + mel_examples.shape[2:])
        if int8:
            emb = self.embed_examples_int8(flat, dtype=dtype,
                                           act_scales=int8_scales)
        elif use_kernel and flat.device.type != "cpu":
            emb = self.embed_examples_fused(flat, dtype=dtype)
        else:
            emb = self.embed_examples(flat, dtype=dtype)
        emb = emb.reshape(B, E, -1)
        mask = (torch.arange(E, device=emb.device)[None, :]
                < examples_len[:, None])[..., None]
        return torch.where(mask, emb, 0.0)
