"""The shifted-window self-attention of one Video Swin block.

Port-only: the JAX package has no Video Swin encoder. :func:`window_attention`
takes the qkv GEMM's output ``qkv (windows, N, 3, heads, 32)`` of a block's
windows (clip by clip, each clip's (nt, nh, nw) ``grid`` of ``win`` windows
over its zero-padded volume rolled by ``-shift``) and returns the heads'
outputs ``(windows, N, heads * 32)`` in ``qkv``'s dtype, as ``proj`` reads
them. Scores are ``q . k / sqrt(32)`` plus the block's relative-position
bias (``rel_bias (2535, heads)`` at the (8, 7, 7) grid's index, torchvision's
``[:N, :N]``) and, in shifted blocks, -100 between tokens of different
regions of the rolled volume; each clip's keys at or past its live
temporal tokens (``rows``, :class:`~mmqg_tpu_torch.models.video_swin.Rows`)
take no weight.

A window that holds no live token is written as zeros. Only outputs at
padded positions change by it, from finite values to zeros: no live token
reads them, since every later window masks them as keys, the MLP and the
LayerNorms act token by token and the mergings in H and W only, and the
memory's steps past a clip's length are zeroed.

On a CUDA tensor :func:`window_attention` launches one hand-written kernel
(``csrc/window_attention.cu``, see its header: the bias, the region and
padded-key masks built inside it, windows of padding alone skipped), bf16
or float32, head size 32, contiguous ``qkv``, outside autograd, or raises;
each launch adds one to ``window_attention.launches``. On a CPU tensor it
runs :func:`window_attention_plain`, PyTorch's fused attention over
materialised masks. Any other device raises.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from mmqg_tpu_torch.ops import _build

Tensor = torch.Tensor
HEAD = 32
TABLE = 15 * 13 * 13  # the (8, 7, 7) window's relative positions
MASK_BYTES = 1 << 30  # a chunk's mask at most this (one clip's at least)


def window_attention_plain(qkv: Tensor, rel_bias: Tensor, rows,
                           grid: Tuple[int, ...], win: Tuple[int, ...],
                           shift: Tuple[int, ...]) -> Tensor:
    """:func:`window_attention` in PyTorch operations. Every window runs
    with the bias (and the shift's regions) alone, in chunks of whole
    clips whose additive mask is materialised in the compute dtype: that is
    its result where all of its keys are live. The windows of the temporal
    rows holding live and padded tokens (``rows.mixed``) run again with
    their padded keys masked (``NEG``), over the first result; the rows
    holding no live token (``rows.dead``) are zeroed."""
    # the model's geometry (video_swin imports this module)
    from mmqg_tpu_torch.models import video_swin as S

    n_win, N, _, h, D = qkv.shape
    nt, nh, nw = grid
    hw = nh * nw
    B = n_win // (nt * hw)
    dtype, device = qkv.dtype, qkv.device
    padded = tuple(n * w for n, w in zip(grid, win))
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    scale = D ** -0.5

    # the mask: bias (heads, N, N) [+ the shift's regions], a view for
    # every window of the chunks, and for the mixed rows + their clip's
    # padded keys
    idx = S.relative_position_index(device)[:N, :N].reshape(-1)
    bias = rel_bias.t().to(dtype)[:, idx].view(h, N, N)
    per_window = h * N * N * bias.element_size()
    step = min(B, max(1, MASK_BYTES // (nt * hw * per_window)))  # clips
    if any(shift):
        region = S._region_mask(padded, win, shift, dtype, device)
        chunk = torch.add(bias.expand(step, nt * hw, h, N, N),
                          region[None, :, None]).view(-1, h, N, N)
        base = chunk[:nt * hw].view(nt, hw, h, N, N)
    else:
        chunk = bias.expand(step * nt * hw, h, N, N)
        base = bias.expand(nt, hw, h, N, N)

    out = torch.empty((n_win, N, h * D), dtype=dtype, device=device)
    for b0 in range(0, B, step):
        w0, w1 = b0 * nt * hw, min(B, b0 + step) * nt * hw
        o = F.scaled_dot_product_attention(
            q[w0:w1], k[w0:w1], v[w0:w1], attn_mask=chunk[:w1 - w0],
            scale=scale)
        out[w0:w1].view(w1 - w0, N, h, D).copy_(o.transpose(1, 2))
    mixed, n_mixed = rows.mixed[shift[0]], rows.n_mixed[shift[0]]
    per_row = max(1, MASK_BYTES // (hw * per_window))
    for r0 in range(0, n_mixed, per_row):
        r = mixed[r0:r0 + per_row]
        sel = (r[:, None] * hw + torch.arange(hw, device=device)).reshape(-1)
        rb = (base[r % nt] if any(shift) else
              base[:1].expand(min(per_row, n_mixed - r0), -1, -1, -1, -1))
        mask = torch.add(rb, rows.key_neg(
            r, win, shift, dtype)[:, None, None, None, :])
        o = F.scaled_dot_product_attention(
            q[sel], k[sel], v[sel], attn_mask=mask.view(-1, h, N, N),
            scale=scale)
        out.index_copy_(0, sel, o.transpose(1, 2).reshape(-1, N, h * D))
    out.view(B * nt, hw, N, h * D)[rows.dead[shift[0]]] = 0
    return out


def _refuse(what: str) -> None:
    raise ValueError(f"window_attention: {what}")


def window_attention(qkv: Tensor, rel_bias: Tensor, rows,
                     grid: Tuple[int, ...], win: Tuple[int, ...],
                     shift: Tuple[int, ...]) -> Tensor:
    """The window attention of ``qkv (windows, N, 3, heads, 32)`` (bf16 or
    float32; N = prod(win) <= 392, windows = clips x prod(grid)) with the
    block's ``rel_bias (2535, heads)`` float32 and the clips' ``rows``;
    ``(windows, N, heads * 32)`` in ``qkv``'s dtype. On CUDA one kernel
    launch; the kernel has no backward, so no input may need a gradient
    there."""
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, rel_bias, rows, grid, win, shift)
    if qkv.device.type != "cuda":
        _refuse(f"no kernel for device {qkv.device}")
    if torch.is_grad_enabled() and (qkv.requires_grad
                                    or rel_bias.requires_grad):
        _refuse("the kernel has no backward; run it under torch.no_grad() "
                "or on tensors that need no gradient")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        _refuse(f"the kernel takes bf16 or float32 qkv, not {qkv.dtype}")
    if qkv.dim() != 5 or qkv.shape[2] != 3 or qkv.shape[4] != HEAD:
        _refuse(f"the kernel takes qkv (windows, N, 3, heads, {HEAD}) of "
                f"head size {HEAD}, not {tuple(qkv.shape)}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        _refuse("qkv is not contiguous and 16-byte aligned")
    n_win, N, _, h, _ = qkv.shape
    windows = math.prod(grid)
    if (len(grid) != 3 or len(win) != 3 or len(shift) != 3
            or N != math.prod(win) or n_win % windows):
        _refuse(f"qkv {tuple(qkv.shape)} is not clips of {grid} windows of "
                f"{win}")
    live = rows.live
    for name, t, shape, dt in (("rel_bias", rel_bias, (TABLE, h),
                                torch.float32),
                               ("rows.live", live, (n_win // windows,),
                                torch.int32)):
        if (t.device != qkv.device or tuple(t.shape) != shape
                or t.dtype != dt or not t.is_contiguous()):
            _refuse(f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                    f"the kernel takes {shape} {dt} on {qkv.device}")
    out = torch.empty((n_win, N, h * HEAD), dtype=qkv.dtype,
                      device=qkv.device)
    if not n_win:
        return out
    with torch.cuda.device(qkv.device):
        rc = _build.library().mmqg_window_attention(
            qkv.data_ptr(), rel_bias.data_ptr(), live.data_ptr(),
            out.data_ptr(), n_win, h, *grid, *win, *shift,
            int(qkv.dtype == torch.float32),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mmqg_window_attention")
    with _build.COUNT_LOCK:
        window_attention.launches += 1
    return out


window_attention.launches = 0
