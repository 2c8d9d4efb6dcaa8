"""R(2+1)D-18 video encoder, the alternative backbone
(``mmqg_tpu/models/video_resnet.py``).

Every 3-D conv is a spatial (1, k, k) conv and a temporal (k, 1, 1) conv
with M = floor(t d^2 Cin Cout / (d^2 Cin + t Cout)) midplanes and batchnorm
+ ReLU between them:

  stem: (1, 7, 7) 3 -> 45 stride (1, 2, 2), bn, relu,
        (3, 1, 1) 45 -> 64, bn, relu
  4 stages x 2 basic blocks at 64, 128, 256, 512 channels; the first block
        of stages 2-4 strides (2, 2, 2) and has a 1x1x1 ``down`` conv + bn
  -> (B, ceil(T / 8), H', W', 512); ``apply`` pools T, H and W,
        ``apply_temporal`` pools H and W only; an optional ``fc`` head maps
        512 to the decoder's video width.

Activations are NDHWC (channels last), which is an NCDHW tensor in
``torch.channels_last_3d`` memory, so each conv is one cuDNN ``conv3d`` on
a view and batchnorm reduces over the last axis. The weights keep the JAX
layout (kt, kh, kw, In, Out), because they are the checkpoint's and the
optimizer's leaves; each conv casts its weight to the compute dtype and
lays it out as cuDNN reads it in that one copy. (A float64 model run with
``dtype=torch.float64`` stays in float64 throughout: the tests' exact
reference.)

Casts follow the JAX package: a conv takes its input and weight in the
compute dtype and its result is cast to float32; batchnorm runs in float32;
the stream between convs is float32. The cast of a conv's output is the
first step of the batchnorm after it (and a ReLU that follows is the
last), so that training keeps each conv output once, in the compute dtype
(``layers._BatchNormAll``). Batchnorm here is never masked: in
training its statistics cover every position (``layers.BatchNorm
.train_forward_all``). Train-mode calls return the new running statistics
in the JAX state's tree and leave the buffers as they are.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmqg_tpu_torch.models import layers as L

Tensor = torch.Tensor

STAGES = (64, 128, 256, 512)
# stages 2-4 each stride time by 2 (the stem does not)
TEMPORAL_DOWNSAMPLE = 8


def midplanes(cin: int, cout: int, kt: int = 3, ks: int = 3) -> int:
    return (kt * ks * ks * cin * cout) // (ks * ks * cin + kt * cout)


def temporal_out_len(n_frames):
    """Frame count -> the trunk's temporal length, ceil(n / 8) (SAME
    padding, three stride-2 temporal convs). Ints and integer tensors."""
    return -(-n_frames // TEMPORAL_DOWNSAMPLE)


class Conv3d(nn.Module):
    """A bias-free 3-D conv with the JAX layout's weight (kt, kh, kw, In,
    Out), padded (k // 2, k // 2) on each axis."""

    def __init__(self, w: Tensor):
        super().__init__()
        self.w = L._frozen(w)

    def forward(self, x: Tensor, stride: Tuple[int, int, int],
                dtype: torch.dtype) -> Tensor:
        """(B, T, H, W, In) -> (B, T', H', W', Out) in ``dtype``: the
        batchnorm that always follows takes it to float32, as JAX's
        ``astype(float32)`` of the conv output does."""
        kt, kh, kw = self.w.shape[:3]
        w = self.w.to(dtype).permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        y = F.conv3d(x.to(dtype).permute(0, 4, 1, 2, 3), w, stride=stride,
                     padding=(kt // 2, kh // 2, kw // 2))
        return y.permute(0, 2, 3, 4, 1)


def _bn(bn: L.BatchNorm, x: Tensor, train: bool, relu: bool = False
        ) -> Tuple[Tensor, Dict]:
    """(batchnorm of the conv output ``x`` in float32, then a ReLU when
    ``relu``; the new running state): in eval the module's own buffers, as
    JAX returns its state unchanged."""
    if train:
        return bn.train_forward_all(x, relu=relu)
    return bn.eval_all(x, relu=relu), bn.state()


class Conv2Plus1D(nn.Module):
    def __init__(self, spatial: Conv3d, temporal: Conv3d,
                 bn_mid: L.BatchNorm):
        super().__init__()
        self.spatial = spatial
        self.temporal = temporal
        self.bn_mid = bn_mid

    def forward(self, x: Tensor, stride: Tuple[int, int, int], *,
                train: bool, dtype: torch.dtype) -> Tuple[Tensor, Dict]:
        st, sh, sw = stride
        y, s = _bn(self.bn_mid, self.spatial(x, (1, sh, sw), dtype), train,
                   relu=True)
        return self.temporal(y, (st, 1, 1), dtype), {"bn_mid": s}


class Block(nn.Module):
    def __init__(self, conv1: Conv2Plus1D, conv2: Conv2Plus1D,
                 bn1: L.BatchNorm, bn2: L.BatchNorm,
                 down: Optional[Conv3d] = None,
                 down_bn: Optional[L.BatchNorm] = None):
        super().__init__()
        self.conv1, self.conv2 = conv1, conv2
        self.bn1, self.bn2 = bn1, bn2
        self.down, self.down_bn = down, down_bn

    def forward(self, x: Tensor, stride: Tuple[int, int, int], *,
                train: bool, dtype: torch.dtype) -> Tuple[Tensor, Dict]:
        y, s1 = self.conv1(x, stride, train=train, dtype=dtype)
        y, b1 = _bn(self.bn1, y, train, relu=True)
        y, s2 = self.conv2(y, (1, 1, 1), train=train, dtype=dtype)
        y, b2 = _bn(self.bn2, y, train)
        state = {"conv1": s1, "conv2": s2, "bn1": b1, "bn2": b2}
        sc = x
        if self.down is not None:
            sc, state["down_bn"] = _bn(self.down_bn,
                                       self.down(x, stride, dtype), train)
        return torch.relu(y + sc), state


class VideoResNet(nn.Module):
    def __init__(self, stem_s: Conv3d, stem_t: Conv3d, stem_bn: L.BatchNorm,
                 stem_bn2: L.BatchNorm, stages: Sequence[Sequence[Block]],
                 fc: Optional[L.Dense] = None):
        super().__init__()
        self.stem_s, self.stem_t = stem_s, stem_t
        self.stem_bn, self.stem_bn2 = stem_bn, stem_bn2
        self.stages = nn.ModuleList(nn.ModuleList(s) for s in stages)
        self.fc = fc

    def trunk(self, clips: Tensor, *, train: bool = False,
              dtype: torch.dtype = torch.bfloat16) -> Tuple[Tensor, Dict]:
        """(B, T, H, W, 3) float clips -> ((B, ceil(T / 8), H', W', 512)
        float32, new state)."""
        x, sbn = _bn(self.stem_bn, self.stem_s(clips, (1, 2, 2), dtype),
                     train, relu=True)
        x, sbn2 = _bn(self.stem_bn2, self.stem_t(x, (1, 1, 1), dtype), train,
                      relu=True)
        state = {"stem_bn": sbn, "stem_bn2": sbn2, "stages": []}
        for si, blocks in enumerate(self.stages):
            stage_state = []
            for bi, block in enumerate(blocks):
                stride = (2, 2, 2) if (bi == 0 and si > 0) else (1, 1, 1)
                x, bs = block(x, stride, train=train, dtype=dtype)
                stage_state.append(bs)
            state["stages"].append(stage_state)
        return x, state

    def _head(self, feats: Tensor, dtype: torch.dtype) -> Tensor:
        return feats if self.fc is None else self.fc(feats, dtype)

    def forward(self, clips: Tensor, *, train: bool = False,
                dtype: torch.dtype = torch.bfloat16) -> Tuple[Tensor, Dict]:
        """``apply``: (B, 512) or (B, fc width) clip embeddings, new
        state."""
        x, state = self.trunk(clips, train=train, dtype=dtype)
        return self._head(x.mean(dim=(1, 2, 3)), dtype), state

    def temporal(self, clips: Tensor, *, train: bool = False,
                 dtype: torch.dtype = torch.bfloat16) -> Tuple[Tensor, Dict]:
        """``apply_temporal``: per-step features for the attention
        memories, (B, ceil(T / 8), 512 or fc width) float32 -- the trunk's
        time axis with H and W averaged, the head applied per step."""
        x, state = self.trunk(clips, train=train, dtype=dtype)
        return self._head(x.mean(dim=(2, 3)), dtype), state

    # ------------------------------------------------ the JAX pytrees
    def param_tree(self) -> Dict:
        """The parameters as ``video_resnet.init``'s params pytree (the
        modules' own parameters)."""
        def bn(b):
            return {"scale": b.scale, "bias": b.bias}

        def c2p1(c):
            return {"spatial": {"w": c.spatial.w},
                    "temporal": {"w": c.temporal.w}, "bn_mid": bn(c.bn_mid)}

        def block(b):
            out = {"conv1": c2p1(b.conv1), "conv2": c2p1(b.conv2),
                   "bn1": bn(b.bn1), "bn2": bn(b.bn2)}
            if b.down is not None:
                out["down"] = {"w": b.down.w}
                out["down_bn"] = bn(b.down_bn)
            return out

        tree = {"stem_s": {"w": self.stem_s.w}, "stem_t": {"w": self.stem_t.w},
                "stem_bn": bn(self.stem_bn), "stem_bn2": bn(self.stem_bn2),
                "stages": [[block(b) for b in s] for s in self.stages]}
        if self.fc is not None:
            tree["fc"] = {"w": self.fc.w, "b": self.fc.b}
        return tree

    def bn_tree(self) -> Dict:
        """The batchnorm modules in the JAX state pytree's structure."""
        def block(b):
            out = {"conv1": {"bn_mid": b.conv1.bn_mid},
                   "conv2": {"bn_mid": b.conv2.bn_mid},
                   "bn1": b.bn1, "bn2": b.bn2}
            if b.down_bn is not None:
                out["down_bn"] = b.down_bn
            return out

        return {"stem_bn": self.stem_bn, "stem_bn2": self.stem_bn2,
                "stages": [[block(b) for b in s] for s in self.stages]}


def build(params: Dict, state: Dict, t) -> VideoResNet:
    """A VideoResNet from ``video_resnet.init``'s (params, state) pytrees;
    ``t`` turns a leaf into a tensor on the target device."""
    def bn(p, s) -> L.BatchNorm:
        return L.BatchNorm(t(p["scale"]), t(p["bias"]), t(s["mean"]),
                           t(s["var"]), t(s["count"]) if "count" in s
                           else None)

    def c2p1(p, s) -> Conv2Plus1D:
        return Conv2Plus1D(Conv3d(t(p["spatial"]["w"])),
                           Conv3d(t(p["temporal"]["w"])),
                           bn(p["bn_mid"], s["bn_mid"]))

    stages: List[List[Block]] = []
    for sp, ss in zip(params["stages"], state["stages"]):
        blocks = []
        for bp, bs in zip(sp, ss):
            down = "down" in bp
            blocks.append(Block(
                c2p1(bp["conv1"], bs["conv1"]), c2p1(bp["conv2"], bs["conv2"]),
                bn(bp["bn1"], bs["bn1"]), bn(bp["bn2"], bs["bn2"]),
                Conv3d(t(bp["down"]["w"])) if down else None,
                bn(bp["down_bn"], bs["down_bn"]) if down else None))
        stages.append(blocks)
    fc = params.get("fc")
    return VideoResNet(
        Conv3d(t(params["stem_s"]["w"])), Conv3d(t(params["stem_t"]["w"])),
        bn(params["stem_bn"], state["stem_bn"]),
        bn(params["stem_bn2"], state["stem_bn2"]), stages,
        None if fc is None else L.Dense(t(fc["w"]), t(fc["b"])))


def init_numpy(rng, embed_dim: Optional[int] = None,
               in_channels: int = 3) -> Tuple[Dict, Dict]:
    """Random (params, state) in ``video_resnet.init``'s pytrees, numpy
    float32 from ``rng`` (a ``np.random.RandomState``): torch-default
    uniform conv weights (bound 1 / sqrt(fan_in)), identity batchnorm, a
    Xavier-uniform ``fc`` head of ``embed_dim`` with N(0, 1) bias when it
    is not None."""
    def conv(cin, cout, kt, kh, kw):
        lim = 1.0 / np.sqrt(cin * kt * kh * kw)
        return {"w": rng.uniform(-lim, lim, (kt, kh, kw, cin, cout)
                                 ).astype(np.float32)}

    def bn(c):
        return ({"scale": np.ones(c, np.float32),
                 "bias": np.zeros(c, np.float32)},
                {"mean": np.zeros(c, np.float32),
                 "var": np.ones(c, np.float32),
                 "count": np.zeros((), np.float32)})

    def c2p1(cin, cout):
        m = midplanes(cin, cout)
        bp, bs = bn(m)
        return ({"spatial": conv(cin, m, 1, 3, 3),
                 "temporal": conv(m, cout, 3, 1, 1), "bn_mid": bp},
                {"bn_mid": bs})

    params: Dict = {"stem_s": conv(in_channels, 45, 1, 7, 7),
                    "stem_t": conv(45, 64, 3, 1, 1), "stages": []}
    state: Dict = {"stages": []}
    params["stem_bn"], state["stem_bn"] = bn(45)
    params["stem_bn2"], state["stem_bn2"] = bn(64)
    cin = 64
    for si, cout in enumerate(STAGES):
        sp, ss = [], []
        for bi in range(2):
            bp, bs = {}, {}
            bp["conv1"], bs["conv1"] = c2p1(cin, cout)
            bp["conv2"], bs["conv2"] = c2p1(cout, cout)
            bp["bn1"], bs["bn1"] = bn(cout)
            bp["bn2"], bs["bn2"] = bn(cout)
            if bi == 0 and si > 0:
                bp["down"] = conv(cin, cout, 1, 1, 1)
                bp["down_bn"], bs["down_bn"] = bn(cout)
            sp.append(bp)
            ss.append(bs)
            cin = cout
        params["stages"].append(sp)
        state["stages"].append(ss)
    if embed_dim is not None:
        lim = np.sqrt(6.0 / (512 + embed_dim))
        params["fc"] = {"w": rng.uniform(-lim, lim, (512, embed_dim)
                                         ).astype(np.float32),
                        "b": rng.randn(embed_dim).astype(np.float32)}
    return params, state
