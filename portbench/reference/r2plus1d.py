"""R(2+1)D-18 as the model's video encoder, in plain float32 PyTorch with
TF32 off, and its weights drawn from the seed.

The architecture is Tran et al., "A Closer Look at Spatiotemporal
Convolutions for Action Recognition" (CVPR 2018, arXiv:1711.11248), as
torchvision publishes it (``r2plus1d_18``), the backbone the reference
repository's ``VideoResnetEncoder`` loads (model/encoder.py:21-29 of
ksg14/multi-modal-qg):

  frames   uint8 / 255, (x - mean) / std with the configuration's Kinetics
           statistics; the frames past a row's length, up to the clip
           length its batch was encoded at, are zero after the
           normalisation
  stem     (1, 7, 7) conv 3 -> 45, stride (1, 2, 2), BN, ReLU;
           (3, 1, 1) conv 45 -> 64, BN, ReLU
  stages   4 x 2 basic blocks at 64, 128, 256, 512 channels; a block's
           (2+1)D conv is a (1, 3, 3) conv to M channels, BN, ReLU, a
           (3, 1, 1) conv, with M = floor(27 Cin Cout / (9 Cin + 3 Cout))
           computed once from the block's input and output channels and
           used by both of its (2+1)D convs; conv1 -> BN -> ReLU -> conv2
           -> BN, plus the input (or, in the first block of stages 2-4,
           which stride (2, 2, 2), a 1x1x1 conv and BN of it), ReLU
  memory   the trunk's (T', H', W', 512) features, T' = ceil(T / 8),
           averaged over H' and W': one 512-wide memory step per 8 frames,
           of which the first ceil(n / 8) of a row of n frames are live

Every conv pads k // 2 on each axis and has no bias; batchnorm is in eval,
from the running statistics (eps 1e-5). Departures from the paper and
torchvision, each the model's:

* no classifier head and no pooling over time: the decoder attends over
  the per-step features (the configuration's video width is the trunk's
  512);
* clips are the request's frames at 112 x 112, of any length up to
  ``av_max_length``, not 16-frame Kinetics crops;
* a row is zero-padded to its batch's clip length after the
  normalisation, and the SAME temporal convs and eval batchnorm's shift
  carry that padding into its last live steps: the memory depends on the
  clip length, so the judge passes the one each batch was encoded at.

``precision="fp8"`` is the control, as in ``model.py``: every conv's input
and weight rounded to float8 e4m3 with one scale per tensor. Serving only:
``train=True`` is not supported.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench import gen, weights
from portbench.arith_r2plus1d import STAGES, memory_steps, midplanes
from portbench.reference.model import Reference, Tensor, fp8

STREAM = 7            # gen.torch_gen stream of the trunk's weights
# a block's last batchnorm scales its residual branch to this range, so
# that activations keep their size through the eight blocks (with the
# conv pyramid's 0.8-1.2 they grow ~1.6x a block)
RESIDUAL_SCALE = (0.2, 0.4)
EPS = 1e-5


def layout() -> List[weights.Leaf]:
    """Every leaf of the trunk: ``params`` (conv ``w`` (kt, kh, kw, In,
    Out), batchnorm ``scale``, ``bias``) and ``state`` (running ``mean``,
    ``var``) under ``video_enc``, in the port's tree. Convs He-uniform;
    batchnorm as ``weights.layout`` draws the conv pyramid's, but for the
    scale of a block's last (``RESIDUAL_SCALE``)."""
    leaves: List[weights.Leaf] = []

    def conv(path, cin, cout, k):
        leaves.append((("params", "video_enc") + path + ("w",),
                       k + (cin, cout), "u",
                       math.sqrt(6.0 / (cin * math.prod(k)))))

    def bn(path, c, scale=(0.8, 1.2)):
        p, s = ("params", "video_enc") + path, ("state", "video_enc") + path
        leaves.extend([(p + ("scale",), (c,), "pos", scale),
                       (p + ("bias",), (c,), "u", 0.1),
                       (s + ("mean",), (c,), "u", 0.1),
                       (s + ("var",), (c,), "pos", (0.5, 1.5))])

    conv(("stem_s",), 3, 45, (1, 7, 7))
    bn(("stem_bn",), 45)
    conv(("stem_t",), 45, 64, (3, 1, 1))
    bn(("stem_bn2",), 64)
    cin = 64
    for si, cout in enumerate(STAGES):
        for bi in range(2):
            pre = ("stages", si, bi)
            m = midplanes(cin, cout)
            for cn, a in (("conv1", cin), ("conv2", cout)):
                conv(pre + (cn, "spatial"), a, m, (1, 3, 3))
                bn(pre + (cn, "bn_mid"), m)
                conv(pre + (cn, "temporal"), m, cout, (3, 1, 1))
            bn(pre + ("bn1",), cout)
            bn(pre + ("bn2",), cout, RESIDUAL_SCALE)
            if bi == 0 and si > 0:
                conv(pre + ("down",), cin, cout, (1, 1, 1))
                bn(pre + ("down_bn",), cout)
            cin = cout
    return leaves


def make(cfg: Dict, seed: int, device="cuda") -> Tuple[Dict, Dict]:
    """(params, model_state) of the configuration with an R(2+1)D-18
    ``video_enc``: every other leaf is ``weights.make``'s, the trunk's are
    slices of one uniform draw on ``device`` from the seed's own stream,
    scaled per leaf and copied to the host once."""
    params, state = weights.make(cfg, seed, device)
    leaves = layout()
    sizes = [math.prod(shape) for _, shape, _, _ in leaves]
    flat = torch.rand(sum(sizes), generator=gen.torch_gen(seed, STREAM,
                                                          device),
                      device=device, dtype=torch.float32)
    off = 0
    for (_, _, kind, scale), n in zip(leaves, sizes):
        lo, hi = scale if kind == "pos" else (-scale, scale)
        flat[off:off + n].mul_(hi - lo).add_(lo)
        off += n
    host = flat.cpu().numpy()
    del flat
    tree: Dict = {"params": {}, "state": {}}
    off = 0
    for (path, shape, _, _), n in zip(leaves, sizes):
        weights._insert(tree, path, host[off:off + n].reshape(shape))
        if path[-1] == "var":          # a batchnorm's step count beside it
            weights._insert(tree, path[:-1] + ("count",),
                            np.zeros((), np.float32))
        off += n
    params["video_enc"] = tree["params"]["video_enc"]
    state["video_enc"] = tree["state"]["video_enc"]
    return params, state


class R2Plus1DReference(Reference):
    """``model.Reference`` with R(2+1)D-18 as its video encoder; every row
    is encoded in a clip of ``clip_frames`` frames."""

    def __init__(self, cfg: Dict, params: Dict, state: Dict, device,
                 precision: str = "f32", grad: bool = False, *,
                 clip_frames: int):
        super().__init__(cfg, params, state, device, precision, grad)
        if "fc" in self.p["video_enc"]:
            raise ValueError("the reference R(2+1)D-18 has no head")
        self.clip = int(clip_frames)

    def conv3d(self, x: Tensor, w: Tensor, stride) -> Tensor:
        """NCDHW ``x``, (kt, kh, kw, In, Out) ``w``."""
        k = w.shape[:3]
        w = w.permute(4, 3, 0, 1, 2)
        if self.precision == "fp8":
            x, w = fp8(x), fp8(w)
        return F.conv3d(x, w, stride=stride,
                        padding=tuple(n // 2 for n in k))

    @staticmethod
    def bn(x: Tensor, p: Dict, s: Dict, relu: bool) -> Tensor:
        c = (slice(None),) + (None,) * 3
        y = ((x - s["mean"][c]) / torch.sqrt(s["var"][c] + EPS)
             * p["scale"][c] + p["bias"][c])
        return torch.relu(y) if relu else y

    def c2p1(self, x: Tensor, p: Dict, s: Dict, stride) -> Tensor:
        st, sh, sw = stride
        y = self.bn(self.conv3d(x, p["spatial"]["w"], (1, sh, sw)),
                    p["bn_mid"], s["bn_mid"], True)
        return self.conv3d(y, p["temporal"]["w"], (st, 1, 1))

    def block(self, x: Tensor, p: Dict, s: Dict, stride) -> Tensor:
        y = self.bn(self.c2p1(x, p["conv1"], s["conv1"], stride), p["bn1"],
                    s["bn1"], True)
        y = self.bn(self.c2p1(y, p["conv2"], s["conv2"], (1, 1, 1)),
                    p["bn2"], s["bn2"], False)
        sc = x
        if "down" in p:
            sc = self.bn(self.conv3d(x, p["down"]["w"], stride),
                         p["down_bn"], s["down_bn"], False)
        return torch.relu(y + sc)

    def trunk(self, x: Tensor) -> Tensor:
        """(N, 3, T, H, W) normalised clips -> (N, 512, ceil(T / 8), H',
        W')."""
        v, st = self.p["video_enc"], self.s["video_enc"]
        x = self.bn(self.conv3d(x, v["stem_s"]["w"], (1, 2, 2)),
                    v["stem_bn"], st["stem_bn"], True)
        x = self.bn(self.conv3d(x, v["stem_t"]["w"], (1, 1, 1)),
                    v["stem_bn2"], st["stem_bn2"], True)
        for si, blocks in enumerate(v["stages"]):
            for bi, p in enumerate(blocks):
                stride = (2, 2, 2) if (bi == 0 and si > 0) else (1, 1, 1)
                x = self.block(x, p, st["stages"][si][bi], stride)
        return x

    def video(self, frames: List[np.ndarray], train: bool = False):
        """(memory (B, ceil(clip / 8), 512), live steps (B,)) of uint8
        frames (n_i, H, W, 3), n_i <= clip."""
        if train:
            raise NotImplementedError("the R(2+1)D reference serves only")
        cfg = self.cfg
        mean = torch.tensor(cfg["vid_mean"], device=self.dev)
        std = torch.tensor(cfg["vid_std"], device=self.dev)
        clips = []
        for f in frames:
            if len(f) > self.clip:
                raise ValueError(f"{len(f)} frames in a clip of {self.clip}")
            x = (torch.as_tensor(f, device=self.dev).float() / 255.0
                 - mean) / std
            x = F.pad(x, (0, 0, 0, 0, 0, 0, 0, self.clip - len(f)))
            clips.append(x.permute(3, 0, 1, 2))
        out = self.trunk(torch.stack(clips)).mean(dim=(3, 4))
        lens = torch.tensor([memory_steps(len(f)) for f in frames],
                            device=self.dev)
        return out.transpose(1, 2), lens
