"""torchvision ``r2plus1d_18`` weights -> the R(2+1)D-18 video encoder's
pytrees (``mmqg_tpu/compat/torch_import.py``, ``import_video_resnet`` and
``load_pretrained_video_resnet``).

torchvision's layout (``models/video/resnet.py``): ``stem.{0,3}`` the
spatial and temporal convs with ``stem.{1,4}`` their batchnorms;
``layer{1..4}.{0,1}`` basic blocks whose ``conv{1,2}`` are
Sequential(Conv2Plus1D, BN[, ReLU]) with Conv2Plus1D = Sequential(spatial
conv, mid BN, ReLU, temporal conv) -- keys ``convN.0.0`` (spatial),
``convN.0.1`` (mid BN), ``convN.0.3`` (temporal), ``convN.1`` (the block's
BN); ``layer{2,3,4}.0.downsample.{0,1}``; ``fc``. A Conv3d weight (O, I,
kT, kH, kW) becomes (kT, kH, kW, I, O); the convs have no bias. The trees
are those of ``models.video_resnet.init_numpy`` (numpy float32), at
torchvision's widths, so the released ``r2plus1d_18`` file's fit them;
``compat.from_jax.params_from_numpy`` builds them. Mappings of name -> array
(call ``.numpy()`` on torch tensors first).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _conv3d(sd: Dict, key: str) -> Dict:
    return {"w": np.transpose(_np(sd[f"{key}.weight"]), (2, 3, 4, 1, 0))}


def _bn(sd: Dict, key: str) -> Tuple[Dict, Dict]:
    return ({"scale": _np(sd[f"{key}.weight"]),
             "bias": _np(sd[f"{key}.bias"])},
            {"mean": _np(sd[f"{key}.running_mean"]),
             "var": _np(sd[f"{key}.running_var"]),
             "count": np.zeros((), np.float32)})


def import_video_resnet(sd: Dict, *, embed_dim: Optional[int] = None
                        ) -> Tuple[Dict, Dict]:
    """A torchvision ``r2plus1d_18`` state_dict -> (params, state).
    ``embed_dim=400`` keeps the Kinetics-400 ``fc`` head; None drops it
    (pooled 512-d features)."""
    params: Dict = {"stem_s": _conv3d(sd, "stem.0"),
                    "stem_t": _conv3d(sd, "stem.3"), "stages": []}
    state: Dict = {"stages": []}
    params["stem_bn"], state["stem_bn"] = _bn(sd, "stem.1")
    params["stem_bn2"], state["stem_bn2"] = _bn(sd, "stem.4")
    for si in range(4):
        stage_p, stage_s = [], []
        for bi in range(2):
            pre = f"layer{si + 1}.{bi}"
            bp: Dict = {}
            bs: Dict = {}
            for cn in ("conv1", "conv2"):
                mid_p, mid_s = _bn(sd, f"{pre}.{cn}.0.1")
                bp[cn] = {"spatial": _conv3d(sd, f"{pre}.{cn}.0.0"),
                          "temporal": _conv3d(sd, f"{pre}.{cn}.0.3"),
                          "bn_mid": mid_p}
                bs[cn] = {"bn_mid": mid_s}
            bp["bn1"], bs["bn1"] = _bn(sd, f"{pre}.conv1.1")
            bp["bn2"], bs["bn2"] = _bn(sd, f"{pre}.conv2.1")
            if f"{pre}.downsample.0.weight" in sd:
                bp["down"] = _conv3d(sd, f"{pre}.downsample.0")
                bp["down_bn"], bs["down_bn"] = _bn(sd, f"{pre}.downsample.1")
            stage_p.append(bp)
            stage_s.append(bs)
        params["stages"].append(stage_p)
        state["stages"].append(stage_s)
    if embed_dim is not None:
        params["fc"] = {"w": _np(sd["fc.weight"]).T, "b": _np(sd["fc.bias"])}
    return params, state


def load_pretrained_video_resnet(params: Dict, state: Dict,
                                 sd: Dict) -> Tuple[Dict, Dict]:
    """Put torchvision ``r2plus1d_18`` weights into a whole model's
    (params, model_state) built with ``video_encoder="resnet"``: returns
    new trees with ``video_enc`` replaced and every other subtree as it
    was. A model whose ``video_enc`` has an ``fc`` head (video_hidden_dim
    != 512) needs a head of that width in ``sd``: another width, or none,
    raises ValueError; a 512-wide model imports the trunk alone."""
    target = params["video_enc"]
    embed_dim = None
    if "fc" in target:
        embed_dim = target["fc"]["w"].shape[1]
        if "fc.weight" not in sd:
            raise ValueError(
                f"the model expects a {embed_dim}-wide video head, but the "
                "state_dict has no fc (a trunk-only export); retrain the "
                "head or set video_hidden_dim: 512 to use the trunk features")
        have = _np(sd["fc.weight"]).shape[0]
        if have != embed_dim:
            raise ValueError(
                f"the model expects a {embed_dim}-wide video head, but the "
                f"state_dict's fc is {have}-wide; retrain the head or set "
                "video_hidden_dim: 512 to use the trunk features")
    vp, vs = import_video_resnet(sd, embed_dim=embed_dim)
    return dict(params, video_enc=vp), dict(state, video_enc=vs)
