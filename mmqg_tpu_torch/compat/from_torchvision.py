"""torchvision ``r2plus1d_18`` weights -> the R(2+1)D-18 video encoder's
pytrees (``mmqg_tpu/compat/torch_import.py``, ``import_video_resnet`` and
``load_pretrained_video_resnet``), and torchvision ``swin3d_b`` weights
<-> the Video Swin encoder's (``import_video_swin``,
``export_video_swin``; the layout at the end of this file).

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

import math
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from mmqg_tpu_torch.models import video_swin


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


# ------------------------------------------------- the Video Swin Transformer

SWIN3D_B = (128, (2, 2, 18, 2), (4, 8, 16, 32))   # embed, depths, heads


def swin3d_shapes(num_classes: Optional[int] = 400
                  ) -> Iterator[Tuple[str, tuple]]:
    """torchvision's ``swin3d_b`` state_dict names and shapes (the released
    file's with its Kinetics-400 head; no head for None):
    ``patch_embed.{proj,norm}``; ``features.{0,2,4,6}.<block>``
    (``norm1``, ``attn.qkv``, ``attn.proj``,
    ``attn.relative_position_bias_table``, the buffer
    ``attn.relative_position_index``, ``norm2``, ``mlp.0``, ``mlp.3``);
    ``features.{1,3,5}.{norm,reduction}``, the patch mergings; ``norm``;
    ``head``."""
    embed_dim, depths, heads = SWIN3D_B
    vol = math.prod(video_swin.WINDOW)
    yield "patch_embed.proj.weight", (embed_dim, 3) + video_swin.PATCH
    yield "patch_embed.proj.bias", (embed_dim,)
    yield "patch_embed.norm.weight", (embed_dim,)
    yield "patch_embed.norm.bias", (embed_dim,)
    c = embed_dim
    for s, (depth, h) in enumerate(zip(depths, heads)):
        if s:
            pre = f"features.{2 * s - 1}"
            yield f"{pre}.norm.weight", (4 * c,)
            yield f"{pre}.norm.bias", (4 * c,)
            yield f"{pre}.reduction.weight", (2 * c, 4 * c)
            c *= 2
        for i in range(depth):
            pre = f"features.{2 * s}.{i}"
            for key, shape in (
                    ("norm1.weight", (c,)), ("norm1.bias", (c,)),
                    ("attn.qkv.weight", (3 * c, c)),
                    ("attn.qkv.bias", (3 * c,)),
                    ("attn.proj.weight", (c, c)), ("attn.proj.bias", (c,)),
                    ("attn.relative_position_bias_table",
                     (video_swin.TABLE, h)),
                    ("attn.relative_position_index", (vol, vol)),
                    ("norm2.weight", (c,)), ("norm2.bias", (c,)),
                    ("mlp.0.weight", (4 * c, c)), ("mlp.0.bias", (4 * c,)),
                    ("mlp.3.weight", (c, 4 * c)), ("mlp.3.bias", (c,))):
                yield f"{pre}.{key}", shape
    yield "norm.weight", (c,)
    yield "norm.bias", (c,)
    if num_classes is not None:
        yield "head.weight", (num_classes, c)
        yield "head.bias", (num_classes,)


def import_video_swin(sd: Dict) -> Tuple[Dict, Dict]:
    """A torchvision ``swin3d_b`` state_dict -> (params, state) of
    ``models.video_swin.init_numpy``'s trees (the Kinetics head, if there,
    dropped; the state empty). A tensor missing, of another shape, or not
    of ``swin3d_b`` raises ValueError naming it."""
    want = dict(swin3d_shapes(num_classes=None))
    for key, shape in want.items():
        if key not in sd:
            raise ValueError(f"swin3d: {key} is missing; swin3d_b has it "
                             f"of shape {shape}")
        if tuple(np.shape(sd[key])) != shape:
            raise ValueError(f"swin3d: {key} has shape "
                             f"{tuple(np.shape(sd[key]))}, the model's "
                             f"swin3d_b takes {shape}")
    for key in sd:
        if key not in want and not key.startswith("head."):
            raise ValueError(f"swin3d: {key} is not a tensor of swin3d_b")

    def ln(key):
        return {"scale": _np(sd[f"{key}.weight"]),
                "bias": _np(sd[f"{key}.bias"])}

    def dense(key):
        out = {"w": _np(sd[f"{key}.weight"]).T}
        if f"{key}.bias" in sd:
            out["b"] = _np(sd[f"{key}.bias"])
        return out

    params: Dict = {
        "patch": {"w": np.transpose(_np(sd["patch_embed.proj.weight"]),
                                    (2, 3, 4, 1, 0)),
                  "b": _np(sd["patch_embed.proj.bias"])},
        "patch_norm": ln("patch_embed.norm"), "stages": [], "merges": []}
    for s in range(4):
        if s:
            pre = f"features.{2 * s - 1}"
            params["merges"].append(dict(norm=ln(f"{pre}.norm"),
                                         **dense(f"{pre}.reduction")))
        blocks, i = [], 0
        while f"features.{2 * s}.{i}.norm1.weight" in sd:
            pre = f"features.{2 * s}.{i}"
            table = sd[f"{pre}.attn.relative_position_bias_table"]
            blocks.append({
                "norm1": ln(f"{pre}.norm1"), "qkv": dense(f"{pre}.attn.qkv"),
                "rel_bias": _np(table),
                "proj": dense(f"{pre}.attn.proj"), "norm2": ln(f"{pre}.norm2"),
                "fc1": dense(f"{pre}.mlp.0"), "fc2": dense(f"{pre}.mlp.3")})
            i += 1
        params["stages"].append(blocks)
    params["norm"] = ln("norm")
    return params, {}


def export_video_swin(params: Dict) -> Dict[str, np.ndarray]:
    """``init_numpy``'s params tree -> torchvision's ``swin3d`` state_dict
    (numpy, no head), the inverse of :func:`import_video_swin`."""
    sd: Dict[str, np.ndarray] = {
        "patch_embed.proj.weight": np.transpose(_np(params["patch"]["w"]),
                                                (4, 3, 0, 1, 2)),
        "patch_embed.proj.bias": _np(params["patch"]["b"])}
    index = video_swin.relative_position_index().numpy()

    def ln(key, p):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = (_np(p["scale"]),
                                                  _np(p["bias"]))

    def dense(key, p):
        sd[f"{key}.weight"] = _np(p["w"]).T
        if "b" in p:
            sd[f"{key}.bias"] = _np(p["b"])

    ln("patch_embed.norm", params["patch_norm"])
    for s, blocks in enumerate(params["stages"]):
        if s:
            m = params["merges"][s - 1]
            ln(f"features.{2 * s - 1}.norm", m["norm"])
            dense(f"features.{2 * s - 1}.reduction", m)
        for i, b in enumerate(blocks):
            pre = f"features.{2 * s}.{i}"
            ln(f"{pre}.norm1", b["norm1"])
            dense(f"{pre}.attn.qkv", b["qkv"])
            dense(f"{pre}.attn.proj", b["proj"])
            sd[f"{pre}.attn.relative_position_bias_table"] = _np(
                b["rel_bias"])
            sd[f"{pre}.attn.relative_position_index"] = index.copy()
            ln(f"{pre}.norm2", b["norm2"])
            dense(f"{pre}.mlp.0", b["fc1"])
            dense(f"{pre}.mlp.3", b["fc2"])
    ln("norm", params["norm"])
    return sd
