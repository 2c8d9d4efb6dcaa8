"""The Video Swin Transformer as the model's video encoder, in plain
float32 PyTorch with TF32 off, and its weights drawn from the seed.

The architecture is Liu et al., "Video Swin Transformer" (CVPR 2022,
arXiv:2106.13230), as torchvision publishes it
(``torchvision/models/video/swin_transformer.py``, ``swin3d_b``). The
modules below carry torchvision's names and shapes, so a module's
``state_dict`` is the released file's layout (``head`` with
``num_classes``); the computation is written out here in ``F.linear``,
``F.conv3d``, ``F.layer_norm``, ``F.gelu`` and an explicit softmax:

  frames   uint8 / 255, (x - mean) / std with the configuration's
           statistics; a call's clips zero-padded to its longest
  patch    zero-pad to multiples of (2, 4, 4); Conv3d 3 -> C, kernel and
           stride (2, 4, 4); channels last; LayerNorm(C)
  stages   depths (2, 2, 18, 2) at C = 128, 256, 512, 1024, heads (4, 8,
           16, 32); a block: x + attn(norm1(x)), then x + mlp(norm2(x)),
           mlp = Linear(C, 4C), exact GELU, Linear(4C, C)
  attn     torchvision's ``shifted_window_attention_3d``: window (8, 7,
           7) and shift (4, 3, 3) in odd blocks, each axis no longer
           than the window taking the axis and no shift; zero-pad to
           the window; roll; partition; qkv; q * head_dim^-0.5; q k^T +
           the relative-position bias (the first rows and columns of the
           (8, 7, 7) index for a smaller window); -100 between the rolled
           volume's regions (shifted blocks); softmax; AV; proj; reverse
  merge    x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]
           concatenated over H and W, LayerNorm(4C), Linear(4C, 2C)
  memory   LayerNorm(1024), then H' and W' averaged: (B, ceil(T / 2),
           1024), of which the first ceil(n / 2) steps of a clip of n
           frames are live and the rest zero

Departures from torchvision, each the model's:

* the padding mask: a clip's tokens at or past its ceil(n / 2) temporal
  tokens (its batch's padding, and the window's own padding in time) are
  masked as keys in every window attention (-1e9 added to their scores),
  and set to zero after every block, so a clip's memory does not depend
  on the length it was padded to (where the padded length exceeds 16
  frames, so that no block's window shrinks to it); on one clip alone
  this is torchvision's result when ceil(n / 2) is a multiple of 8;
* no classifier head (``avgpool`` and ``head``): the decoder attends over
  the per-step features, so the configuration's video width is the
  trunk's 1024;
* time kept: H' and W' are averaged per step, not T' with them;
* clips are the request's frames at 224 x 224, of any length up to
  ``av_max_length``, not 32-frame Kinetics crops; stochastic depth and
  dropout are the identity, as at inference.

``precision="fp8"`` is the control, as in ``model.py``: every product's
operands (the patch conv, each Linear, q k^T and AV) rounded to float8
e4m3 with one scale per tensor, per chunk of windows in the attention.
Serving only: ``train=True`` is not supported.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench import gen, weights
from portbench.reference.model import Reference, Tensor, fp8

EMBED, DEPTHS, HEADS = 128, (2, 2, 18, 2), (4, 8, 16, 32)
PATCH, WINDOW = (2, 4, 4), (8, 7, 7)
TABLE = (2 * WINDOW[0] - 1) * (2 * WINDOW[1] - 1) * (2 * WINDOW[2] - 1)
STREAM = 8           # gen.torch_gen stream of the trunk's weights
PAD_KEY = -1e9       # a padded key's score
SCORE_BYTES = 1 << 29  # float32 scores of one attention chunk at most


# ------------------------------------------- torchvision's modules (names)

def position_index() -> Tensor:
    """torchvision's ``define_relative_position_index`` for (8, 7, 7)."""
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(w) for w in WINDOW], indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel.contiguous()
    for i in range(3):
        rel[:, :, i] += WINDOW[i] - 1
    rel[:, :, 0] *= (2 * WINDOW[1] - 1) * (2 * WINDOW[2] - 1)
    rel[:, :, 1] *= 2 * WINDOW[2] - 1
    return rel.sum(-1)


class ShiftedWindowAttention3d(nn.Module):
    def __init__(self, dim: int, shift: Sequence[int], num_heads: int):
        super().__init__()
        self.window_size, self.shift_size = list(WINDOW), list(shift)
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(TABLE, num_heads))
        self.register_buffer("relative_position_index", position_index())


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, shift: Sequence[int]):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ShiftedWindowAttention3d(dim, shift, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = nn.Sequential(nn.Linear(dim, 4 * dim), nn.GELU(),
                                 nn.Dropout(0.0), nn.Linear(4 * dim, dim),
                                 nn.Dropout(0.0))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)


class PatchEmbed3d(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv3d(3, dim, PATCH, stride=PATCH)
        self.norm = nn.LayerNorm(dim, eps=1e-5)


class SwinTransformer3d(nn.Module):
    def __init__(self, embed_dim: int = EMBED,
                 depths: Sequence[int] = DEPTHS,
                 num_heads: Sequence[int] = HEADS,
                 num_classes: Optional[int] = None):
        super().__init__()
        self.patch_embed = PatchEmbed3d(embed_dim)
        layers: List[nn.Module] = []
        for i, (depth, h) in enumerate(zip(depths, num_heads)):
            dim = embed_dim * 2 ** i
            layers.append(nn.Sequential(*[SwinTransformerBlock(
                dim, h, [0 if k % 2 == 0 else w // 2 for w in WINDOW])
                for k in range(depth)]))
            if i < len(depths) - 1:
                layers.append(PatchMerging(dim))
        self.features = nn.Sequential(*layers)
        self.norm = nn.LayerNorm(embed_dim * 2 ** (len(depths) - 1),
                                 eps=1e-5)
        if num_classes is not None:
            self.head = nn.Linear(self.norm.normalized_shape[0], num_classes)


def swin3d(device="meta", **kw) -> SwinTransformer3d:
    """The modules with uninitialised storage on ``device`` (meta: shapes
    alone)."""
    with torch.device("meta"):
        net = SwinTransformer3d(**kw)
    net = net.to_empty(device=device)
    for m in net.modules():
        if isinstance(m, ShiftedWindowAttention3d):
            m.relative_position_index = position_index().to(device)
    return net


def state_dict_of(tree: Dict) -> Dict[str, Tensor]:
    """The port's ``video_enc`` leaves (dense ``w (In, Out)``, the patch
    conv ``w (kt, kh, kw, In, Out)``, LayerNorm ``scale``/``bias``, bias
    tables) under torchvision's names and shapes."""
    sd = {"patch_embed.proj.weight": tree["patch"]["w"].permute(
        4, 3, 0, 1, 2), "patch_embed.proj.bias": tree["patch"]["b"]}

    def ln(key, p):
        sd[key + ".weight"], sd[key + ".bias"] = p["scale"], p["bias"]

    def lin(key, p):
        sd[key + ".weight"] = p["w"].t()
        if "b" in p:
            sd[key + ".bias"] = p["b"]

    ln("patch_embed.norm", tree["patch_norm"])
    for s, blocks in enumerate(tree["stages"]):
        for i, b in enumerate(blocks):
            pre = f"features.{2 * s}.{i}"
            ln(pre + ".norm1", b["norm1"])
            lin(pre + ".attn.qkv", b["qkv"])
            lin(pre + ".attn.proj", b["proj"])
            sd[pre + ".attn.relative_position_bias_table"] = b["rel_bias"]
            sd[pre + ".attn.relative_position_index"] = position_index()
            ln(pre + ".norm2", b["norm2"])
            lin(pre + ".mlp.0", b["fc1"])
            lin(pre + ".mlp.3", b["fc2"])
        if s < len(tree["merges"]):
            ln(f"features.{2 * s + 1}.norm", tree["merges"][s]["norm"])
            lin(f"features.{2 * s + 1}.reduction", tree["merges"][s])
    ln("norm", tree["norm"])
    return sd


# ------------------------------------------------------ weights from the seed

def layout(embed_dim: int = EMBED, depths: Sequence[int] = DEPTHS,
           heads: Sequence[int] = HEADS) -> List[weights.Leaf]:
    """Every leaf of the trunk under ``("params", "video_enc")`` in the
    port's tree. Uniform draws: qkv +-sqrt(6 / C) (scores of std ~2 at
    unit-variance inputs, so the windows' softmax is peaked), bias tables
    +-1, the other Linears and the patch conv at unit output variance,
    biases +-0.05, LayerNorm scales in (0.8, 1.2), their biases +-0.1."""
    leaves: List[weights.Leaf] = []
    root = ("params", "video_enc")

    def ln(path, c):
        leaves.extend([(root + path + ("scale",), (c,), "pos", (0.8, 1.2)),
                       (root + path + ("bias",), (c,), "u", 0.1)])

    def lin(path, i, o, bias=True):
        leaves.append((root + path + ("w",), (i, o), "u", math.sqrt(3.0 / i)))
        if bias:
            leaves.append((root + path + ("b",), (o,), "u", 0.05))

    fan = 3 * math.prod(PATCH)
    leaves.extend([(root + ("patch", "w"), PATCH + (3, embed_dim), "u",
                    math.sqrt(3.0 / fan)),
                   (root + ("patch", "b"), (embed_dim,), "u", 0.05)])
    ln(("patch_norm",), embed_dim)
    c = embed_dim
    for s, (depth, h) in enumerate(zip(depths, heads)):
        if s:
            ln(("merges", s - 1, "norm"), 4 * c)
            lin(("merges", s - 1), 4 * c, 2 * c, bias=False)
            c *= 2
        for i in range(depth):
            pre = ("stages", s, i)
            ln(pre + ("norm1",), c)
            leaves.append((root + pre + ("qkv", "w"), (c, 3 * c), "u",
                           math.sqrt(6.0 / c)))
            leaves.append((root + pre + ("qkv", "b"), (3 * c,), "u", 0.05))
            leaves.append((root + pre + ("rel_bias",), (TABLE, h), "u", 1.0))
            lin(pre + ("proj",), c, c)
            ln(pre + ("norm2",), c)
            lin(pre + ("fc1",), c, 4 * c)
            lin(pre + ("fc2",), 4 * c, c)
    ln(("norm",), c)
    return leaves


def make(cfg: Dict, seed: int, device="cuda", **widths) -> Tuple[Dict, Dict]:
    """(params, model_state) of the configuration with a Video Swin
    ``video_enc`` (``layout(**widths)``; swin3d_b by default) and no video
    state: every other leaf is ``weights.make``'s, the trunk's are slices
    of one uniform draw on ``device`` from the seed's own stream, scaled
    per leaf and copied to the host once."""
    params, state = weights.make(cfg, seed, device)
    leaves = layout(**widths)
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
    tree: Dict = {}
    off = 0
    for (path, shape, _, _), n in zip(leaves, sizes):
        weights._insert(tree, path, host[off:off + n].reshape(shape))
        off += n
    params["video_enc"] = tree["params"]["video_enc"]
    state["video_enc"] = {}
    return params, state


# ------------------------------------------------------------- the model

class Swin3DReference(Reference):
    """``model.Reference`` with the Video Swin Transformer as its video
    encoder, at the widths its leaves hold."""

    def __init__(self, cfg: Dict, params: Dict, state: Dict, device,
                 precision: str = "f32", grad: bool = False):
        super().__init__(cfg, params, state, device, precision, grad)
        v = self.p["video_enc"]
        self.net = swin3d(self.dev, embed_dim=v["patch"]["w"].shape[-1],
                          depths=[len(s) for s in v["stages"]],
                          num_heads=[s[0]["rel_bias"].shape[1]
                                     for s in v["stages"]])
        self.net.load_state_dict(state_dict_of(v))

    def linear(self, x: Tensor, m: nn.Linear) -> Tensor:
        w = m.weight
        if self.precision == "fp8":
            x, w = fp8(x), fp8(w)
        return F.linear(x, w, m.bias)

    def matmul(self, a: Tensor, b: Tensor) -> Tensor:
        if self.precision == "fp8":
            a, b = fp8(a), fp8(b)
        return a @ b

    @staticmethod
    def norm(x: Tensor, m: nn.LayerNorm) -> Tensor:
        return F.layer_norm(x, m.normalized_shape, m.weight, m.bias, m.eps)

    def attention(self, at: ShiftedWindowAttention3d, x: Tensor,
                  alive: Tensor) -> Tensor:
        """``shifted_window_attention_3d`` of ``x`` (B, T, H, W, C) with
        the keys of ``alive`` (B, T) False masked."""
        b, t, h, w, c = x.shape
        window, shift = list(at.window_size), list(at.shift_size)
        for i, n in enumerate((t, h, w)):
            if n <= window[i]:
                window[i], shift[i] = n, 0
        pad = [(window[i] - n % window[i]) % window[i]
               for i, n in enumerate((t, h, w))]
        x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        tp, hp, wp = x.shape[1:4]
        live = F.pad(alive.float(), (0, pad[0]))[:, :, None, None].expand(
            b, tp, hp, wp)
        if sum(shift) > 0:
            dims = (1, 2, 3)
            x = torch.roll(x, [-s for s in shift], dims)
            live = torch.roll(live, [-s for s in shift], dims)
        nw = (tp // window[0]) * (hp // window[1]) * (wp // window[2])
        vol = window[0] * window[1] * window[2]

        def part(v):
            n = v.shape[0]
            v = v.reshape(n, tp // window[0], window[0], hp // window[1],
                          window[1], wp // window[2], window[2], -1)
            return v.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(n * nw, vol, -1)

        x, live = part(x), part(live)[..., 0]
        heads = at.num_heads
        qkv = self.linear(x, at.qkv).reshape(b * nw, vol, 3, heads,
                                             c // heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (c // heads) ** -0.5, qkv[1], qkv[2]
        idx = at.relative_position_index[:vol, :vol].flatten()
        bias = at.relative_position_bias_table[idx].view(vol, vol, -1)
        bias = bias.permute(2, 0, 1)
        region = None
        if sum(shift) > 0:
            ids = x.new_zeros((tp, hp, wp))
            slices = [((0, -window[i]), (-window[i], -shift[i]),
                       (-shift[i], None)) for i in range(3)]
            count = 0
            for d in slices[0]:
                for hh in slices[1]:
                    for ww in slices[2]:
                        ids[d[0]:d[1], hh[0]:hh[1], ww[0]:ww[1]] = count
                        count += 1
            ids = part(ids[None, ..., None].expand(1, tp, hp, wp, 1))[..., 0]
            region = ids[:, None, :] - ids[:, :, None]
            region = region.masked_fill(region != 0, -100.0)
        out = torch.empty_like(q)
        step = max(1, SCORE_BYTES // (heads * vol * vol * 4))
        for a in range(0, b * nw, step):
            e = min(b * nw, a + step)
            s = self.matmul(q[a:e], k[a:e].transpose(-2, -1)) + bias
            if region is not None:
                s = s + region[torch.arange(a, e, device=x.device) % nw][
                    :, None]
            s = s + torch.where(live[a:e] > 0, 0.0, PAD_KEY)[:, None, None]
            s = torch.exp(s - s.amax(-1, keepdim=True))
            out[a:e] = self.matmul(s / s.sum(-1, keepdim=True), v[a:e])
        x = self.linear(out.transpose(1, 2).reshape(b * nw, vol, c), at.proj)
        x = x.view(b, tp // window[0], hp // window[1], wp // window[2],
                   window[0], window[1], window[2], c)
        x = x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, tp, hp, wp, c)
        if sum(shift) > 0:
            x = torch.roll(x, shift, (1, 2, 3))
        return x[:, :t, :h, :w]

    def trunk(self, x: Tensor, live: Tensor) -> Tensor:
        """(B, 3, T, H, W) normalised clips, (B,) live temporal tokens ->
        (B, ceil(T / 2), H', W', 1024) after the last LayerNorm."""
        net = self.net
        _, _, t, h, w = x.shape
        x = F.pad(x, (0, (-w) % PATCH[2], 0, (-h) % PATCH[1],
                      0, (-t) % PATCH[0]))
        wt = net.patch_embed.proj.weight
        if self.precision == "fp8":
            x, wt = fp8(x), fp8(wt)
        x = F.conv3d(x, wt, net.patch_embed.proj.bias, stride=PATCH)
        x = self.norm(x.permute(0, 2, 3, 4, 1), net.patch_embed.norm)
        alive = (torch.arange(x.shape[1], device=self.dev)[None]
                 < live[:, None])
        keep = alive[:, :, None, None, None].float()
        for layer in net.features:
            if isinstance(layer, PatchMerging):
                H, W = x.shape[2:4]
                x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
                x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                               x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]],
                              -1)
                x = self.linear(self.norm(x, layer.norm), layer.reduction)
                continue
            for blk in layer:
                x = x + self.attention(blk.attn, self.norm(x, blk.norm1),
                                       alive)
                y = F.gelu(self.linear(self.norm(x, blk.norm2), blk.mlp[0]))
                x = (x + self.linear(y, blk.mlp[3])) * keep
        return self.norm(x, net.norm)

    def video(self, frames: List[np.ndarray], train: bool = False):
        """(memory (B, ceil(T / 2), 1024) zero past each clip's live
        steps, live steps (B,)) of uint8 frames (n_i, H, W, 3), padded to
        the longest."""
        if train:
            raise NotImplementedError("the Video Swin reference serves only")
        cfg = self.cfg
        mean = torch.tensor(cfg["vid_mean"], device=self.dev)
        std = torch.tensor(cfg["vid_std"], device=self.dev)
        T = max(len(f) for f in frames)
        clips = []
        for f in frames:
            x = (torch.as_tensor(f, device=self.dev).float() / 255.0
                 - mean) / std
            x = F.pad(x, (0, 0, 0, 0, 0, 0, 0, T - len(f)))
            clips.append(x.permute(3, 0, 1, 2))
        live = torch.tensor([-(-len(f) // PATCH[0]) for f in frames],
                            device=self.dev)
        out = self.trunk(torch.stack(clips), live).mean(dim=(2, 3))
        steps = torch.arange(out.shape[1], device=self.dev)
        return out * (steps[None] < live[:, None])[..., None], live
