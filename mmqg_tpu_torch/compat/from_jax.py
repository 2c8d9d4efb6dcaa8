"""The JAX package's parameter pytree -> the port's modules.

``params``/``model_state`` are the pytrees of ``mmqg_tpu.models.qg_model
.init`` (or a checkpoint's "params"/"model_state"), with numpy or
array-like leaves. The port keeps the JAX layouts, so every leaf is copied
as it is -- float32, bit for bit -- onto ``device``:

  params["embedding"]["table"]                    (V, D)
  params["text_enc"]["lstm"]["layers"][i]         wx (In, 4H), wh (H, 4H), b
  params["video_enc"]["convs"][i]                 w (3, 3, In, Out), b
  params["video_enc"]["bns"][i] + model_state["video_enc"]["bns"][i]
                                                  scale, bias + mean, var
  params["video_enc"]["lstm"]["layers"][0]
  params["audio_enc"]["convs"][i], ["fc1"|"fc2"|"fc3"]   w (In, Out), b
  params["decoder"]["attn"]                       AttnParams (or its dict)
  params["decoder"]["lstm"], params["decoder"]["out"]
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.models.audio_encoder import AudioEncoder
from mmqg_tpu_torch.models.decoder import Decoder
from mmqg_tpu_torch.models.qg_model import QGModel
from mmqg_tpu_torch.models.text_encoder import TextEncoder
from mmqg_tpu_torch.models.video_encoder import VideoEncoder
from mmqg_tpu_torch.ops.attention import TriModalAttention

_ATTN_FIELDS = ("w_text", "b_text", "w_video", "b_video", "w_audio",
                "b_audio")


def params_from_numpy(params: Dict[str, Any], model_state: Dict[str, Any],
                      device="cpu") -> QGModel:
    """Build the tri-modal attention model on ``device`` from JAX-layout
    parameters (see the module docstring for the tree)."""
    device = torch.device(device)

    def t(x) -> torch.Tensor:
        return torch.tensor(np.asarray(x, np.float32), device=device)

    def lstm(p) -> L.LSTM:
        return L.LSTM([L.LSTMLayer(t(l["wx"]), t(l["wh"]), t(l["b"]))
                       for l in p["layers"]])

    def dense(p) -> L.Dense:
        return L.Dense(t(p["w"]), t(p["b"]))

    def conv(p) -> L.Conv2d:
        return L.Conv2d(t(p["w"]), t(p["b"]))

    vp, ap, dp = params["video_enc"], params["audio_enc"], params["decoder"]
    bn_state = model_state["video_enc"]["bns"]
    video = VideoEncoder(
        [conv(c) for c in vp["convs"]],
        [L.BatchNorm(t(bn["scale"]), t(bn["bias"]), t(s["mean"]), t(s["var"]))
         for bn, s in zip(vp["bns"], bn_state)],
        lstm(vp["lstm"]))
    audio = AudioEncoder([conv(c) for c in ap["convs"]], dense(ap["fc1"]),
                         dense(ap["fc2"]), dense(ap["fc3"]))
    attn = dp["attn"]
    attn = attn._asdict() if hasattr(attn, "_asdict") else attn
    decoder = Decoder(TriModalAttention(*(t(attn[k]) for k in _ATTN_FIELDS)),
                      lstm(dp["lstm"]), dense(dp["out"]))
    return QGModel(t(params["embedding"]["table"]),
                   TextEncoder(lstm(params["text_enc"]["lstm"])), video,
                   audio, decoder)
