"""Video Swin Transformer video encoder (Liu et al., "Video Swin
Transformer", CVPR 2022, arXiv:2106.13230), as torchvision publishes it
(``torchvision/models/video/swin_transformer.py``; ``swin3d_b`` at
``init_numpy``'s defaults: 87,638,984 trunk parameters, 88,048,984 with
the 400-class head this encoder leaves out).

  patch    clips (B, T, H, W, 3), zero-padded to multiples of (2, 4, 4);
           each (2, 4, 4) patch is one token (the stride-equals-kernel
           conv as a reshape and a GEMM) -> LayerNorm(C)
  stages   depths (2, 2, 18, 2) at C, 2C, 4C, 8C with heads (4, 8, 16,
           32), head size 32; a block is x + attn(LN1(x)), x + MLP(LN2(x))
           with MLP = Linear(C, 4C), exact GELU, Linear(4C, C)
  attn     (8, 7, 7) windows of 392 tokens over the zero-padded volume
           (padded after LN1, so padding tokens are attended as in
           torchvision); odd blocks roll by -(4, 3, 3) and add -100
           between tokens of different regions of the rolled volume;
           qkv Linear(C, 3C) with bias, q scaled by 32^-0.5, a learned
           relative-position bias from a (15 * 13 * 13, heads) table;
           proj Linear(C, C). Along an axis no longer than the window the
           window is the axis and its shift 0 (torchvision's
           ``_get_window_and_shift_size``); the bias then takes the first
           rows and columns of the (8, 7, 7) index, as torchvision does
  merge    between stages, H and W only: x[0::2, 0::2], x[1::2, 0::2],
           x[0::2, 1::2], x[1::2, 1::2] concatenated, LayerNorm(4C),
           Linear(4C, 2C) without bias
  out      LayerNorm(8C); ``temporal`` averages H' and W': the memory is
           (B, ceil(T / 2), 8C), one step per 2 frames

One departure, for batches: a clip's frames past its length are padding
up to its batch's frames bucket, and after the patch embedding they are
no longer zeros. So every window that holds one of a clip's first
``ceil(n / 2)`` temporal tokens masks, as keys, its tokens at or past
them (they take no weight). A window of padding alone is written as
zeros: no live token reads its output. A clip's live outputs are then the
same at any bucket whose temporal size exceeds the window's 8 steps (over
16 frames), and equal torchvision's on that clip alone when ``ceil(n /
2)`` is a multiple of 8. The memory's steps past a clip's length are
zero.

Leaves keep the repository's layouts: dense ``w (In, Out)``, ``b``; the
patch embedding ``w (2, 4, 4, 3, C)`` (kt, kh, kw, In, Out); LayerNorm
``scale``, ``bias``; each block's ``rel_bias`` table (2535, heads). No
batchnorm: the encoder has no model state. Inference only: the trunk has
no training path (stochastic depth and dropout draws), and ``qg_model``
refuses ``train=True``.

Casts follow the repository's policy: GEMM operands in the compute dtype
with float32 accumulation (cuBLAS; their results, as a conv's, in the
compute dtype), the residual stream, LayerNorm, GELU's arithmetic and the
attention's softmax in float32. The window attention is
``ops/window_attention.py::window_attention``: on the card one launch a
block of a hand-written kernel (``csrc/window_attention.cu``) that reads
the qkv GEMM's output, the bias table and the clips' lengths, builds the
shift's regions and the padded keys' mask from coordinates and skips the
windows of padding alone; on the CPU PyTorch's fused attention over
materialised masks. The host reads the clips' lengths once a trunk
(``Rows``).

Spans (``utils.profiling.annotate``): ``swin.attention`` around each
block's window attention, ``swin.mlp`` around its MLP, ``swin.merge``
around each patch merging. Counter ``windows`` (the benchmark's
readers): ``trunks``; ``attn_calls`` (24 a ``swin3d_b`` trunk);
``windows`` and ``tokens`` computed; ``live_windows``, windows holding a
token before its clip's temporal length, and ``live_tokens``, such
tokens; ``skipped``, the windows written as zeros (``windows`` -
``live_windows``).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.ops.window_attention import window_attention
from mmqg_tpu_torch.utils import profiling

Tensor = torch.Tensor

PATCH = (2, 4, 4)
WINDOW = (8, 7, 7)
TABLE = (2 * WINDOW[0] - 1) * (2 * WINDOW[1] - 1) * (2 * WINDOW[2] - 1)
EPS = 1e-5
REGION = -100.0     # between regions of a rolled volume (torchvision's)
NEG = -1e4          # padded keys: exp underflows to 0 beside any live key
# the frame statistics swin3d_b's released weights expect: torchvision's
# Swin3D_B_Weights.KINETICS400_V1 transforms normalise with ImageNet's
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

windows = {"trunks": 0, "attn_calls": 0, "windows": 0, "live_windows": 0,
           "tokens": 0, "live_tokens": 0, "skipped": 0}


def temporal_out_len(n_frames):
    """Frame count -> the trunk's temporal length, ceil(n / 2). Ints and
    integer tensors."""
    return -(-n_frames // PATCH[0])


def window_and_shift(size: Sequence[int], shifted: bool
                     ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The (window, shift) of a block over ``size`` (T, H, W): along an
    axis no longer than the window, the axis itself and no shift."""
    win, shift = [], []
    for n, w in zip(size, WINDOW):
        if n <= w:
            win.append(n)
            shift.append(0)
        else:
            win.append(w)
            shift.append(w // 2 if shifted else 0)
    return tuple(win), tuple(shift)


@functools.lru_cache(maxsize=8)
def relative_position_index(device=None) -> Tensor:
    """(392, 392) rows of the bias table for each pair of the (8, 7, 7)
    window's tokens, torchvision's ``define_relative_position_index``
    (one per device)."""
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(w, device=device) for w in WINDOW], indexing="ij"))
    flat = coords.flatten(1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0)
    rel = rel + torch.tensor([w - 1 for w in WINDOW], device=device)
    mult = torch.tensor([(2 * WINDOW[1] - 1) * (2 * WINDOW[2] - 1),
                         2 * WINDOW[2] - 1, 1], device=device)
    return (rel * mult).sum(-1)


@functools.lru_cache(maxsize=8)
def _region_mask(padded: Tuple[int, ...], win: Tuple[int, ...],
                 shift: Tuple[int, ...], dtype: torch.dtype,
                 device) -> Tensor:
    """(windows, tokens, tokens) ``REGION`` between tokens of different
    regions of the rolled, padded volume, else 0, windows in (T, H, W)
    order: along an axis with a shift, positions [0, n - w), [n - w,
    n - s) and [n - s, n) of the rolled axis are regions 0, 1, 2. It
    depends on the shapes alone: made once for each."""
    ids = []
    for n, w, s in zip(padded, win, shift):
        p = torch.arange(n, device=device)
        ids.append((p >= n - w).long() + (p >= n - s).long() if s else
                   torch.zeros_like(p))
    rid = (ids[0][:, None, None] * 9 + ids[1][None, :, None] * 3
           + ids[2][None, None, :])
    nt, nh, nw = (n // w for n, w in zip(padded, win))
    rid = (rid.view(nt, win[0], nh, win[1], nw, win[2])
           .permute(0, 2, 4, 1, 3, 5).reshape(nt * nh * nw, -1))
    return torch.where(rid[:, :, None] == rid[:, None, :], 0.0,
                       REGION).to(dtype)


@functools.lru_cache(maxsize=16)
def _window_order(size: Tuple[int, ...], win: Tuple[int, ...],
                  shift: Tuple[int, ...], device) -> Tuple[Tensor, Tensor]:
    """The zero-padding, roll and window partition of a (T, H, W) volume
    as one gather, and its inverse with the crop: (``into``: for each
    window token, in window order, its flat (T, H, W) position, or T * H *
    W, a zero row, for a padding token; ``back``: for each flat position,
    its window token)."""
    dims = []
    for n, w, s in zip(size, win, shift):
        n_pad = -(-n // w) * w
        # rolled by -s: rolled position r holds position (r + s) mod n_pad
        dims.append((torch.arange(n_pad, device=device) + s) % n_pad)
    (T, H, W), (w0, w1, w2) = size, win
    t = dims[0].view(-1, 1, 1, w0, 1, 1)
    h = dims[1].view(1, -1, 1, 1, w1, 1)
    w = dims[2].view(1, 1, -1, 1, 1, w2)
    inside = ((t < T) & (h < H) & (w < W)).reshape(-1)
    into = ((t * H + h) * W + w).reshape(-1)
    into = torch.where(inside, into, T * H * W)
    back = torch.empty(T * H * W, dtype=torch.long, device=device)
    back[into[inside]] = torch.arange(into.numel(), device=device)[inside]
    return into, back


class Rows:
    """A trunk's clips against the rolled, padded time axis of its
    windows, from their live temporal tokens (read to the host once a
    trunk), for each temporal shift of its blocks (0, and 4 over more than
    8 steps): the temporal window rows (``clip * rows + row``) holding
    both a live token and one at or past its clip's length (``mixed``, on
    the device, and their count), those holding no live token (``dead``,
    on the device) and the count of those holding one (``live_rows``).
    ``live`` is the lengths as int32 on their device."""

    def __init__(self, live: Tensor, T: int):
        self.live, self.T = live.to(torch.int32), T
        lens = [int(n) for n in live.tolist()]
        self.tokens = sum(lens)
        self.mixed, self.n_mixed, self.live_rows, self.dead = {}, {}, {}, {}
        found = {}
        for shifted in (False, True):
            (win,), (shift,) = window_and_shift((T,), shifted)
            tp = -(-T // win) * win
            mixed, dead = [], []
            for b, n in enumerate(lens):
                for r in range(tp // win):
                    k = sum((r * win + j + shift) % tp < n
                            for j in range(win))
                    if k == 0:
                        dead.append(b * (tp // win) + r)
                    elif k < win:
                        mixed.append(b * (tp // win) + r)
            found[shift] = (mixed, dead)
            self.n_mixed[shift] = len(mixed)
            self.live_rows[shift] = len(lens) * (tp // win) - len(dead)
        both = torch.tensor([i for m, d in found.values() for i in m + d],
                            dtype=torch.long).to(live.device)
        at = 0
        for shift, (mixed, dead) in found.items():
            self.mixed[shift] = both[at:at + len(mixed)]
            at += len(mixed)
            self.dead[shift] = both[at:at + len(dead)]
            at += len(dead)

    def key_neg(self, rows: Tensor, win: Tuple[int, ...],
                shift: Tuple[int, ...], dtype: torch.dtype) -> Tensor:
        """(len(rows), tokens) ``NEG`` at each window token at or past its
        clip's length, else 0."""
        tp = -(-self.T // win[0]) * win[0]
        nt = tp // win[0]
        p = (rows % nt)[:, None] * win[0] + torch.arange(
            win[0], device=rows.device)
        t = (p + shift[0]) % tp              # rolled position -> clip time
        live = t < self.live[rows // nt][:, None]
        return torch.where(live, 0.0, NEG).to(dtype).repeat_interleave(
            win[1] * win[2], dim=1)


class Linear(nn.Module):
    """``x @ w (+ b)`` with ``w (..., Out)`` read as (In, Out) (the patch
    embedding's (2, 4, 4, 3, C)); operands in ``dtype``, the result in
    ``dtype`` (float32 accumulation inside the GEMM; ``layers.Dense``
    multiplies in float32, far off the tensor cores at these sizes)."""

    def __init__(self, w: Tensor, b: Optional[Tensor] = None):
        super().__init__()
        self.w = L._frozen(w)
        self.b = None if b is None else L._frozen(b)

    def forward(self, x: Tensor, dtype: torch.dtype) -> Tensor:
        b = None if self.b is None else self.b.to(dtype)
        w = self.w.reshape(-1, self.w.shape[-1])
        return F.linear(x.to(dtype), w.to(dtype).t(), b)


class LayerNorm(nn.Module):
    def __init__(self, scale: Tensor, bias: Tensor):
        super().__init__()
        self.scale = L._frozen(scale)
        self.bias = L._frozen(bias)

    def forward(self, x: Tensor) -> Tensor:
        """float32 in and out, statistics in float32."""
        return F.layer_norm(x.float(), self.scale.shape, self.scale,
                            self.bias, EPS)


class Block(nn.Module):
    def __init__(self, norm1: LayerNorm, qkv: Linear, rel_bias: Tensor,
                 proj: Linear, norm2: LayerNorm, fc1: Linear, fc2: Linear,
                 heads: int, shifted: bool):
        super().__init__()
        self.norm1, self.qkv, self.proj = norm1, qkv, proj
        self.rel_bias = L._frozen(rel_bias)
        self.norm2, self.fc1, self.fc2 = norm2, fc1, fc2
        self.heads, self.shifted = heads, shifted

    def attention(self, x: Tensor, rows: Rows, dtype: torch.dtype
                  ) -> Tensor:
        """The shifted-window attention of ``x`` (B, T, H, W, C), LN1's
        float32 output, with each clip's keys at or past its live
        temporal tokens (``rows``) masked; (B, T, H, W, C) in ``dtype``,
        zero before ``proj`` in the windows of padding alone."""
        B, T, H, W, C = x.shape
        h = self.heads
        win, shift = window_and_shift((T, H, W), self.shifted)
        padded = tuple(-(-n // w) * w for n, w in zip((T, H, W), win))
        grid = tuple(n // w for n, w in zip(padded, win))
        nt, hw = grid[0], grid[1] * grid[2]
        N = win[0] * win[1] * win[2]
        into, back = _window_order((T, H, W), win, shift, x.device)
        src = torch.empty((B, T * H * W + 1, C), dtype=dtype, device=x.device)
        src[:, -1] = 0
        src[:, :-1] = x.view(B, -1, C)
        x = src.index_select(1, into).view(B * nt * hw, N, C)
        del src
        qkv = self.qkv(x, dtype).view(-1, N, 3, h, C // h)
        live_rows = rows.live_rows[shift[0]]
        windows["attn_calls"] += 1
        windows["windows"] += B * nt * hw
        windows["tokens"] += B * nt * hw * N
        windows["live_windows"] += live_rows * hw
        windows["live_tokens"] += rows.tokens * padded[1] * padded[2]
        windows["skipped"] += (B * nt - live_rows) * hw
        out = window_attention(qkv, self.rel_bias, rows, grid, win, shift)
        y = self.proj(out, dtype).view(B, -1, C)
        return y.index_select(1, back).view(B, T, H, W, C)

    def forward(self, x: Tensor, rows: Rows, dtype: torch.dtype
                ) -> Tensor:
        with profiling.annotate("swin.attention"):
            x += self.attention(self.norm1(x), rows, dtype)
        with profiling.annotate("swin.mlp"):
            y = F.gelu(self.fc1(self.norm2(x), dtype))
            x += self.fc2(y, dtype)
        return x


class Merge(nn.Module):
    def __init__(self, norm: LayerNorm, reduction: Linear):
        super().__init__()
        self.norm, self.reduction = norm, reduction

    def forward(self, x: Tensor, dtype: torch.dtype) -> Tensor:
        with profiling.annotate("swin.merge"):
            H, W = x.shape[2:4]
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
            x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                           x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], -1)
            return self.reduction(self.norm(x), dtype).float()


class VideoSwin(nn.Module):
    def __init__(self, patch: Linear, patch_norm: LayerNorm,
                 stages: Sequence[Sequence[Block]], merges: Sequence[Merge],
                 norm: LayerNorm):
        super().__init__()
        self.patch, self.patch_norm = patch, patch_norm
        self.stages = nn.ModuleList(nn.ModuleList(s) for s in stages)
        self.merges = nn.ModuleList(merges)
        self.norm = norm

    def trunk(self, clips: Tensor, live: Tensor, *,
              dtype: torch.dtype = torch.bfloat16) -> Tensor:
        """(B, T, H, W, 3) float clips, (B,) live temporal tokens ->
        (B, ceil(T / 2), H', W', 8C) float32 after the last LayerNorm."""
        windows["trunks"] += 1
        B, T, H, W, _ = clips.shape
        pt, ph, pw = PATCH
        x = F.pad(clips.to(dtype), (0, 0, 0, (-W) % pw, 0, (-H) % ph,
                                    0, (-T) % pt))
        t, h, w = x.shape[1] // pt, x.shape[2] // ph, x.shape[3] // pw
        x = (x.view(B, t, pt, h, ph, w, pw, 3)
             .permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, t, h, w, -1))
        x = self.patch_norm(self.patch(x, dtype))
        rows = Rows(live, t)
        for si, stage in enumerate(self.stages):
            if si:
                x = self.merges[si - 1](x, dtype)
            for block in stage:
                x = block(x, rows, dtype)
        return self.norm(x)

    def temporal(self, clips: Tensor, live: Tensor, *,
                 dtype: torch.dtype = torch.bfloat16) -> Tensor:
        """Per-step features for the attention memories: (B, ceil(T / 2),
        8C) float32, H' and W' averaged, zero past each clip's ``live``
        steps."""
        x = self.trunk(clips, live, dtype=dtype).mean(dim=(2, 3))
        steps = torch.arange(x.shape[1], device=x.device)
        return x * (steps[None, :] < live[:, None])[..., None]

    # ------------------------------------------------ the pytrees
    def param_tree(self) -> Dict:
        """The parameters as ``init_numpy``'s params pytree (the modules'
        own parameters)."""
        def ln(n):
            return {"scale": n.scale, "bias": n.bias}

        def dense(d):
            return {"w": d.w, "b": d.b}

        def block(b):
            return {"norm1": ln(b.norm1), "qkv": dense(b.qkv),
                    "rel_bias": b.rel_bias, "proj": dense(b.proj),
                    "norm2": ln(b.norm2), "fc1": dense(b.fc1),
                    "fc2": dense(b.fc2)}

        return {"patch": dense(self.patch), "patch_norm": ln(self.patch_norm),
                "stages": [[block(b) for b in s] for s in self.stages],
                "merges": [{"norm": ln(m.norm), "w": m.reduction.w}
                           for m in self.merges],
                "norm": ln(self.norm)}

    def bn_tree(self) -> Dict:
        """No batchnorm: an empty model state."""
        return {}


def build(params: Dict, t) -> VideoSwin:
    """A VideoSwin from ``init_numpy``'s params pytree; the widths, depths
    and heads are read from the leaves (a block's heads from its bias
    table); ``t`` turns a leaf into a tensor on the target device."""
    def ln(p) -> LayerNorm:
        return LayerNorm(t(p["scale"]), t(p["bias"]))

    def dense(p) -> Linear:
        return Linear(t(p["w"]), t(p["b"]) if "b" in p else None)

    stages: List[List[Block]] = []
    for sp in params["stages"]:
        stages.append([Block(ln(b["norm1"]), dense(b["qkv"]),
                             t(b["rel_bias"]), dense(b["proj"]),
                             ln(b["norm2"]), dense(b["fc1"]), dense(b["fc2"]),
                             np.shape(b["rel_bias"])[1], bi % 2 == 1)
                       for bi, b in enumerate(sp)])
    return VideoSwin(
        dense(params["patch"]), ln(params["patch_norm"]), stages,
        [Merge(ln(m["norm"]), dense(m)) for m in params["merges"]],
        ln(params["norm"]))


def init_numpy(rng, embed_dim: int = 128,
               depths: Sequence[int] = (2, 2, 18, 2),
               heads: Sequence[int] = (4, 8, 16, 32),
               in_channels: int = 3) -> Tuple[Dict, Dict]:
    """Random (params, state) pytrees, numpy float32 from ``rng`` (a
    ``np.random.RandomState``), in torchvision's layout and init: every
    Linear's weight and each bias table normal(0, 0.02) (torchvision's
    ``trunc_normal_(std=0.02)``, whose cut at +-2 is never reached),
    zero Linear biases, unit LayerNorms, the patch embedding torch's
    default conv init (uniform, bound 1 / sqrt(fan_in), weight and bias).
    The state is empty. Defaults: ``swin3d_b``."""
    def normal(*shape):
        return np.clip(rng.normal(0.0, 0.02, shape), -2, 2).astype(
            np.float32)

    def dense(i, o, bias=True):
        out = {"w": normal(i, o)}
        if bias:
            out["b"] = np.zeros(o, np.float32)
        return out

    def ln(c):
        return {"scale": np.ones(c, np.float32),
                "bias": np.zeros(c, np.float32)}

    fan = in_channels * math.prod(PATCH)
    lim = 1.0 / math.sqrt(fan)
    params: Dict = {
        "patch": {"w": rng.uniform(-lim, lim, PATCH + (in_channels,
                                                       embed_dim)
                                   ).astype(np.float32),
                  "b": rng.uniform(-lim, lim, embed_dim).astype(np.float32)},
        "patch_norm": ln(embed_dim), "stages": [], "merges": []}
    c = embed_dim
    for si, (depth, h) in enumerate(zip(depths, heads)):
        if si:
            params["merges"].append(dict(norm=ln(4 * c),
                                         **dense(4 * c, 2 * c, bias=False)))
            c *= 2
        params["stages"].append([
            {"norm1": ln(c), "qkv": dense(c, 3 * c),
             "rel_bias": normal(TABLE, h), "proj": dense(c, c),
             "norm2": ln(c), "fc1": dense(c, 4 * c), "fc2": dense(4 * c, c)}
            for _ in range(depth)])
    params["norm"] = ln(c)
    return params, {}
