"""R(2+1)D-18 video encoder, the alternative backbone
(``mmqg_tpu/models/video_resnet.py``).

Every 3-D conv is a spatial (1, k, k) conv and a temporal (k, 1, 1) conv
with M = floor(t d^2 Cin Cout / (d^2 Cin + t Cout)) midplanes and batchnorm
+ ReLU between them. A basic block computes M once, from its input and
output channels, and gives both of its (2+1)D convs that width, as
torchvision's ``BasicBlock`` does, so ``init_numpy`` draws the published
``r2plus1d_18`` (31,300,125 parameters without a head): conv2 of the first
block of stages 2-4 is 230, 460 and 921 wide. The JAX package's ``init``
draws M(planes, planes) there (288, 576, 1152); ``build`` follows each
leaf's shape, so its trees still build and run here.

  stem: (1, 7, 7) 3 -> 45 stride (1, 2, 2), bn, relu,
        (3, 1, 1) 45 -> 64, bn, relu
  4 stages x 2 basic blocks at 64, 128, 256, 512 channels; the first block
        of stages 2-4 strides (2, 2, 2) and has a 1x1x1 ``down`` conv + bn
  -> (B, ceil(T / 8), H', W', 512); ``apply`` pools T, H and W,
        ``apply_temporal`` pools H and W only; an optional ``fc`` head maps
        512 to the decoder's video width.

Activations are NDHWC (channels last), which is an NCDHW tensor in
``torch.channels_last_3d`` memory, and batchnorm reduces over the last
axis. The weights keep the JAX layout and the published shapes (kt, kh,
kw, In, Out), because they are the checkpoint's and the optimizer's
leaves; ``param_tree``, ``bn_tree`` and ``build`` see nothing else. Each
conv casts its leaf to the compute dtype and lays it out as cuDNN reads it
on every call, and runs each (1, k, k) or (k, 1, 1) factor as a 2-D conv
on a view (``_conv_ndhwc``), which cuDNN puts on its bf16 tensor-core
kernels where it runs some of the same 3-D convs on its f32 kernel. The
trunk's ``train`` picks one of two widths for all of its convs:

* inference (``train=False``): In and Out zero-padded to multiples of 8,
  which cuDNN's bf16 tensor-core kernels need. The stem's 45 and the 230,
  460, 921 midplanes (288, 576, 1152 in the JAX package's tree are aligned
  already) flow padded through their conv pair: the batchnorm between
  gives the padded channels scale and shift 0, so they stay exactly 0,
  and the next conv's weights on them are 0; the RGB clips are padded to
  8 channels at the stem.
* training (``train=True``): the published widths, so the batchnorms'
  statistics and the gradients are those of the leaves as they are.

Both give the same mathematics: every output channel of the published
widths sums the same products, plus exact zeros. (A float64 model run
with ``dtype=torch.float64`` stays in float64 throughout: the tests'
exact reference.)

Counters, for the benchmark's readers: ``convs`` counts the trunks run
and their conv launches at the widths launched (``aligned``: input and
output channels both multiples of 8; ``unaligned``: the rest, 14 of 37 in
a training trunk at the published widths, none in an inference trunk;
``padded``: launches whose channels were padded, 14 an inference trunk at
the published widths); ``weight_casts`` counts the weight casts, 37 a
trunk, and the bytes they write, at the launched widths. The epilogues
after the convs, 34 an inference trunk (two in the stem, four a block),
count as ``ops.bn_epilogue.bn_epilogue.launches`` on the card.

Casts follow the JAX package: a conv takes its input and weight in the
compute dtype and its result is cast to float32; batchnorm runs in float32;
the stream between convs is float32. What follows a conv is one epilogue
(:func:`_epilogue`): the cast of its output to float32, the batchnorm, in a
block's last one the shortcut (the block's input, or its ``down`` conv's
output through ``down_bn``) and the ReLU, and the cast to the compute dtype
for the next conv; it keeps the float32 value only where a shortcut or the
trunk's pooling reads it. An inference trunk's epilogues are
:func:`ops.bn_epilogue.bn_epilogue`: on the card one launch each of a
hand-written kernel that rounds as PyTorch's operations do, so its results
are theirs bit for bit; the kernel has no backward, so an inference trunk
on the card runs outside autograd or on parameters that need no gradient.
Training keeps each conv output once, in the compute dtype
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
from mmqg_tpu_torch.ops import bn_epilogue as E

Tensor = torch.Tensor

STAGES = (64, 128, 256, 512)
# stages 2-4 each stride time by 2 (the stem does not)
TEMPORAL_DOWNSAMPLE = 8

convs = {"trunks": 0, "aligned": 0, "unaligned": 0, "padded": 0}
weight_casts = {"calls": 0, "bytes": 0}

# an epilogue's output: (the next conv's input in the compute dtype, the
# float32 value), either None where nothing reads it
Act = Tuple[Optional[Tensor], Optional[Tensor]]


def midplanes(cin: int, cout: int, kt: int = 3, ks: int = 3) -> int:
    return (kt * ks * ks * cin * cout) // (ks * ks * cin + kt * cout)


def _up8(c: int) -> int:
    return -(-c // 8) * 8


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
                dtype: torch.dtype, *, pad: bool = False) -> Tensor:
        """(B, T, H, W, In) -> (B, T', H', W', Out) in ``dtype``: the
        batchnorm that always follows takes it to float32, as JAX's
        ``astype(float32)`` of the conv output does.

        ``pad`` (the inference path) zero-pads the weight's In and Out to
        multiples of 8: the output has Out rounded up, the padded channels
        exactly 0, and an input with fewer channels than the padded In
        (the RGB clips) is padded with zeros."""
        kt, kh, kw, cin, cout = self.w.shape
        w = self.w.permute(4, 3, 0, 1, 2)            # (Out, In, kt, kh, kw)
        if pad and (cin % 8 or cout % 8):
            # channels_last_3d: (Out, kt, kh, kw, In) in memory
            wp = w.new_zeros((_up8(cout), kt, kh, kw, _up8(cin)),
                             dtype=dtype).permute(0, 4, 1, 2, 3)
            wp[:cout, :cin] = w
            w = wp
            convs["padded"] += 1
        else:
            w = w.to(dtype, memory_format=torch.channels_last_3d)
        weight_casts["calls"] += 1
        weight_casts["bytes"] += w.numel() * w.element_size()
        convs["aligned" if w.shape[0] % 8 == 0 and w.shape[1] % 8 == 0
              else "unaligned"] += 1
        x = x.to(dtype)
        if x.shape[-1] < w.shape[1]:
            x = F.pad(x, (0, w.shape[1] - x.shape[-1]))
        return _conv_ndhwc(x, w, stride, (kt // 2, kh // 2, kw // 2))


def _conv_ndhwc(x: Tensor, w: Tensor, stride: Tuple[int, int, int],
                padding: Tuple[int, int, int]) -> Tensor:
    """The conv of channels-last ``x`` (B, T, H, W, In) with a
    ``channels_last_3d`` weight (Out, In, kt, kh, kw): (B, T', H', W',
    Out). A (1, kh, kw) kernel not strided in time runs as a 2-D conv with
    the frames as its batch, a (kt, 1, 1) kernel not strided in space as a
    2-D conv over (T, H * W); both on views, with no copy. cuDNN runs
    those on its bf16 tensor-core kernels, where it runs some of the same
    convs as 3-D convs on its f32 kernel (a (3, 1, 1) kernel to 64 channels
    at 56 x 56). Other kernels (the strided 1 x 1 x 1 shortcut) stay 3-D
    convs."""
    B, T, H, W, C = x.shape
    O, _, kt, kh, kw = w.shape
    if kt == 1 and stride[0] == 1:
        y = F.conv2d(x.reshape(B * T, H, W, C).permute(0, 3, 1, 2),
                     w[:, :, 0], stride=stride[1:], padding=padding[1:])
        return y.permute(0, 2, 3, 1).reshape(B, T, *y.shape[2:], O)
    if kh == kw == 1 and stride[1:] == (1, 1):
        y = F.conv2d(x.reshape(B, T, H * W, C).permute(0, 3, 1, 2),
                     w[..., 0], stride=(stride[0], 1),
                     padding=(padding[0], 0))
        return y.permute(0, 2, 3, 1).reshape(B, y.shape[2], H, W, O)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 4, 1)


def _epilogue(bn: L.BatchNorm, y: Tensor, train: bool, dtype: torch.dtype,
              *, shortcut: Optional[Tensor] = None,
              down_bn: Optional[L.BatchNorm] = None, cast: bool = True,
              keep: bool = False) -> Tuple[Act, List[Dict]]:
    """The batchnorm ``bn`` of the conv output ``y``, plus a block's
    ``shortcut`` (its input in float32, or its ``down`` conv's output
    through ``down_bn``), then a ReLU. Returns ((the result
    in ``dtype`` for the next conv when ``cast``, in float32 when
    ``keep``), the new running states of ``bn`` and ``down_bn``).

    Training: the batchnorms' batch statistics under autograd
    (:meth:`layers.BatchNorm.train_forward_all`), the float32 result for
    both (each conv casts its input). Inference: the running statistics
    folded to a scale and shift per channel (zero past a batchnorm's
    channels where the conv was padded, so those stay 0), through
    :func:`ops.bn_epilogue.bn_epilogue`: one kernel launch on the card,
    its plain PyTorch version on the CPU."""
    if train:
        y, state = bn.train_forward_all(y, relu=shortcut is None)
        states = [state]
        if shortcut is not None:
            if down_bn is not None:
                shortcut, down_state = down_bn.train_forward_all(shortcut)
                states.append(down_state)
            y = torch.relu(y + shortcut)
        return (y, y), states
    C = y.shape[-1]
    a, b = bn.eval_scale_shift(C)
    res_a = res_b = None
    states = [bn.state()]
    if down_bn is not None:
        res_a, res_b = down_bn.eval_scale_shift(C)
        states.append(down_bn.state())
    return E.bn_epilogue(y, a, b, relu=True, residual=shortcut, res_a=res_a,
                         res_b=res_b, cast=dtype if cast else None,
                         keep=keep), states


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
        (y, _), s = _epilogue(self.bn_mid, self.spatial(
            x, (1, sh, sw), dtype, pad=not train), train, dtype)
        return (self.temporal(y, (st, 1, 1), dtype, pad=not train),
                {"bn_mid": s[0]})


class Block(nn.Module):
    def __init__(self, conv1: Conv2Plus1D, conv2: Conv2Plus1D,
                 bn1: L.BatchNorm, bn2: L.BatchNorm,
                 down: Optional[Conv3d] = None,
                 down_bn: Optional[L.BatchNorm] = None):
        super().__init__()
        self.conv1, self.conv2 = conv1, conv2
        self.bn1, self.bn2 = bn1, bn2
        self.down, self.down_bn = down, down_bn

    def forward(self, x: Act, stride: Tuple[int, int, int], *, train: bool,
                dtype: torch.dtype, cast: bool, keep: bool
                ) -> Tuple[Act, Dict]:
        """The block on ``x`` (B, T, H, W, In) as the epilogue before gives
        it (:func:`_reads` of this block) -> (its output as ``cast`` and
        ``keep`` ask: what the layer after reads of it; its new state)."""
        low, full = x
        y, s1 = self.conv1(low, stride, train=train, dtype=dtype)
        (y, _), b1 = _epilogue(self.bn1, y, train, dtype)
        y, s2 = self.conv2(y, (1, 1, 1), train=train, dtype=dtype)
        state = {"conv1": s1, "conv2": s2, "bn1": b1[0]}
        sc = full
        if self.down is not None:
            sc = self.down(low, stride, dtype, pad=not train)
        out, b2 = _epilogue(self.bn2, y, train, dtype, shortcut=sc,
                            down_bn=self.down_bn, cast=cast, keep=keep)
        state["bn2"] = b2[0]
        if self.down is not None:
            state["down_bn"] = b2[1]
        return out, state


def _reads(nxt: Optional[Block]) -> Dict[str, bool]:
    """What reads an epilogue's output when ``nxt`` is the block after it
    (None: the trunk's pooling): the block's convs read it in the compute
    dtype (``cast``), its identity shortcut and the pooling in float32
    (``keep``)."""
    return {"cast": nxt is not None, "keep": nxt is None or nxt.down is None}


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
        convs["trunks"] += 1
        pad = not train
        # the block after each epilogue that ends the stem or a block
        after = iter([b for s in self.stages for b in s] + [None])
        (x, _), sbn = _epilogue(self.stem_bn, self.stem_s(
            clips, (1, 2, 2), dtype, pad=pad), train, dtype)
        x, sbn2 = _epilogue(self.stem_bn2, self.stem_t(
            x, (1, 1, 1), dtype, pad=pad), train, dtype,
            **_reads(next(after)))
        state = {"stem_bn": sbn[0], "stem_bn2": sbn2[0], "stages": []}
        for si, stage in enumerate(self.stages):
            stage_state = []
            for bi, block in enumerate(stage):
                stride = (2, 2, 2) if (bi == 0 and si > 0) else (1, 1, 1)
                x, bs = block(x, stride, train=train, dtype=dtype,
                              **_reads(next(after)))
                stage_state.append(bs)
            state["stages"].append(stage_state)
        return x[1], state

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
    """Random (params, state) in ``video_resnet.init``'s pytrees at
    torchvision's ``r2plus1d_18`` widths (the module docstring), numpy
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

    def c2p1(cin, cout, m):
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
            m = midplanes(cin, cout)
            bp["conv1"], bs["conv1"] = c2p1(cin, cout, m)
            bp["conv2"], bs["conv2"] = c2p1(cout, cout, m)
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
