"""The JAX package's train-state pytree <-> the port's modules.

``params``/``model_state`` are the pytrees of ``mmqg_tpu.models.qg_model
.init`` (or a checkpoint's "params"/"model_state"), with numpy or
array-like leaves. The port keeps the JAX layouts, so every leaf is copied
as it is -- float32, bit for bit -- onto ``device``:

  params["embedding"]["table"]                    (V, D)
  params["text_enc"]["lstm"]["layers"][i]         wx (In, 4H), wh (H, 4H), b
  params["video_enc"]["convs"][i]                 w (3, 3, In, Out), b
  params["video_enc"]["bns"][i] + model_state["video_enc"]["bns"][i]
                                                  scale, bias + mean, var, count
  params["video_enc"]["lstm"]["layers"][0]
    or R(2+1)D-18 (``video_resnet.init``'s tree: stem_s, stem_t, stem_bn,
    stem_bn2, stages[4][2], optional fc; its state the batchnorms')
    or the Video Swin Transformer (``video_swin.init_numpy``'s tree:
    patch, patch_norm, stages, merges, norm; no state)
  params["audio_enc"]["convs"][i], ["fc1"|"fc2"|"fc3"]   w (In, Out), b
  params["decoder"]["attn"]                       AttnParams (or its dict)
  params["decoder"]["lstm"], params["decoder"]["out"]

A subtree the configuration has no use for is absent: ``video_enc`` in
mode text, ``audio_enc`` outside trimodal, ``decoder["attn"]`` for the
non-attention decoder. The model holds what the tree holds.

:func:`train_state_to_numpy` goes the other way, for a checkpoint: the
model's parameters and batchnorm state, the optimizer state (already in
optax's layout, see ``mmqg_tpu_torch.optim``) and the step, as numpy.
:func:`load_train_state` copies such a tree (e.g. a JAX-written
checkpoint's) back into a model and returns its optimizer state.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.models.audio_encoder import AudioEncoder
from mmqg_tpu_torch.models import video_resnet, video_swin
from mmqg_tpu_torch.models.decoder import Decoder, NonAttnDecoder
from mmqg_tpu_torch.models import qg_model
from mmqg_tpu_torch.models.qg_model import QGModel
from mmqg_tpu_torch.models.text_encoder import TextEncoder
from mmqg_tpu_torch.models.video_encoder import VideoEncoder
from mmqg_tpu_torch.ops.attention import TriModalAttention
from mmqg_tpu_torch.optim import tree_map


def params_from_numpy(params: Dict[str, Any], model_state: Dict[str, Any],
                      device="cpu", *, trainable: bool = False) -> QGModel:
    """Build the model on ``device`` from JAX-layout parameters of any
    configuration (see the module docstring for the tree). Parameters
    require grad only when ``trainable``."""
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

    def bn(p, st) -> L.BatchNorm:
        return L.BatchNorm(t(p["scale"]), t(p["bias"]), t(st["mean"]),
                           t(st["var"]),
                           t(st["count"]) if "count" in st else None)

    video = audio = None
    vp = params.get("video_enc")
    if vp is not None and "stem_s" in vp:
        video = video_resnet.build(vp, model_state["video_enc"], t)
    elif vp is not None and "patch" in vp:
        video = video_swin.build(vp, t)
    elif vp is not None:
        video = VideoEncoder(
            [conv(c) for c in vp["convs"]],
            [bn(p, st) for p, st in zip(vp["bns"],
                                        model_state["video_enc"]["bns"])],
            lstm(vp["lstm"]))
    ap = params.get("audio_enc")
    if ap is not None:
        audio = AudioEncoder([conv(c) for c in ap["convs"]], dense(ap["fc1"]),
                             dense(ap["fc2"]), dense(ap["fc3"]))
    dp = params["decoder"]
    if "attn" in dp:
        attn = dp["attn"]
        attn = attn._asdict() if hasattr(attn, "_asdict") else attn
        decoder = Decoder(
            TriModalAttention(*(t(attn[k]) for k in qg_model.ATTN_FIELDS)),
            lstm(dp["lstm"]), dense(dp["out"]))
    else:
        decoder = NonAttnDecoder(lstm(dp["lstm"]), dense(dp["out"]))
    model = QGModel(t(params["embedding"]["table"]),
                    TextEncoder(lstm(params["text_enc"]["lstm"])), video,
                    audio, decoder)
    return model.requires_grad_(trainable)


def tree_to_numpy(tree: Any) -> Any:
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def tree_from_numpy(tree: Any, device="cpu") -> Any:
    """numpy leaves -> tensors on ``device``, dtypes kept (int32 counts)."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def train_state_to_numpy(model: QGModel, opt_state: Any,
                         step: int) -> Dict[str, Any]:
    """The JAX train state of ``mmqg_tpu.train.init_train_state``:
    {"params", "model_state", "opt_state", "step" (int32)}, numpy leaves,
    lists for lists and dicts for NamedTuples (their state-dict form).
    Every leaf is a host copy of its own, never a view of a live CPU
    tensor, so later steps cannot change a checkpoint still being
    written."""
    def copy(tree):
        return tree_map(lambda x: x.detach().to("cpu", copy=True).numpy(),
                        tree)
    return {"params": copy(qg_model.param_tree(model)),
            "model_state": copy(qg_model.model_state(model)),
            "opt_state": copy(opt_state),
            "step": np.asarray(step, np.int32)}


def _structure(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None


def load_train_state(model: QGModel, state: Dict[str, Any],
                     opt_template: Any) -> Tuple[Any, int]:
    """Copy a train state (``train_state_to_numpy``'s layout, or a JAX
    checkpoint as ``checkpoint.load_checkpoint`` reads it) into ``model``
    in place. Returns (its optimizer state as tensors on the model's
    device, its step). ``opt_template`` is the optimizer's own state
    (``optimizer.init``); a checkpoint written for another optimizer
    configuration raises ValueError."""
    if _structure(state["opt_state"]) != _structure(opt_template):
        raise ValueError("the checkpoint's opt_state does not match this "
                         "optimizer's (optim, schedule, clip, weight decay "
                         "or text_non_trainable differ)")
    device = model.embedding.device
    with torch.no_grad():
        tree_map(lambda p, a: p.copy_(torch.from_numpy(np.array(a))),
                 qg_model.param_tree(model), state["params"])
        tree_map(lambda b, a: b.copy_(torch.from_numpy(np.array(a)).reshape(
            b.shape)), qg_model.model_state(model), state["model_state"])
    return tree_from_numpy(state["opt_state"], device), int(state["step"])
