"""K2: tri-modal location attention, one decode step.

Counterpart of ``mmqg_tpu/ops/attention.py`` (op contract, XLA reference)
and ``mmqg_tpu/ops/attention_pallas.py`` (the fused TPU kernel). On a CUDA
tensor :func:`trimodal_attention` launches the hand-written kernel in
``csrc/trimodal_attention.cu`` (see its header for the design: blocks of
16 batch rows x 16 positions x 128 memory columns, each keeping a
flash-decoding partial that the last block of its row tile merges); on a
CPU tensor it runs :func:`trimodal_attention_plain`, the same function in
plain PyTorch. Any other device raises. :func:`split_softmax_plain` writes
out the kernel's chunked softmax and merge in plain PyTorch.

Semantics, for query q = [word_emb; h_top] (B, Dq):
  scores_m = q @ W_m + b_m, masked to -1e30 at positions >= len_m;
  alpha_m  = softmax(scores_m) in f32;  ctx_m = alpha_m @ memory_m in f32.
Rounding follows the Pallas kernel: q, W and the memories are operands in
the compute dtype and alpha stays f32 in the context sum. (The XLA path
rounds alpha to bf16 there; in f32 the two are the same function.)

The kernel takes the three weight matrices pre-transposed and concatenated,
``w_t (Lt + 2La, Dq)`` ([text | video | audio] rows), so each score is a
dot product over one contiguous row; :meth:`TriModalAttention.weights`
builds it once per decode.

Training differentiates :func:`trimodal_attention_xla`, the port of the JAX
package's ``trimodal_attention_xla`` (what its ``loss_fn`` runs): plain
PyTorch under autograd, with that function's rounding -- alpha is cast to
the compute dtype before the context products. K2 has no backward, as the
Pallas kernel has none.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch import nn

from mmqg_tpu_torch.models.layers import mm
from mmqg_tpu_torch.ops import _build

Tensor = torch.Tensor

_NEG_INF = -1e30  # finite -inf stand-in: keeps the masked softmax NaN-free
_DTYPES = (torch.float32, torch.bfloat16)


class TriModalAttention(nn.Module):
    """Weights of the three location heads in the JAX layout
    (``AttnParams``): ``w_* (Dq, L_*)``, ``b_* (L_*,)``."""

    def __init__(self, w_text: Tensor, b_text: Tensor, w_video: Tensor,
                 b_video: Tensor, w_audio: Tensor, b_audio: Tensor):
        super().__init__()
        for name, t in (("w_text", w_text), ("b_text", b_text),
                        ("w_video", w_video), ("b_video", b_video),
                        ("w_audio", w_audio), ("b_audio", b_audio)):
            setattr(self, name, nn.Parameter(t, requires_grad=False))

    def weights(self, dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
        """(w_t in the compute dtype, f32 bias) from the current weights --
        hoist out of a decode."""
        w_t = torch.cat([self.w_text, self.w_video, self.w_audio], dim=1).t()
        b = torch.cat([self.b_text, self.b_video, self.b_audio])
        return w_t.to(dtype).contiguous(), b


def trimodal_attention_plain(w_t: Tensor, b: Tensor, q: Tensor,
                             enc_text: Tensor, enc_video: Tensor,
                             enc_audio: Tensor, text_len: Tensor,
                             video_len: Tensor, audio_len: Tensor):
    """Plain PyTorch version of the kernel (same arguments and results as
    :func:`trimodal_attention`)."""
    Lt, La = enc_text.shape[1], enc_video.shape[1]
    scores = torch.matmul(q.float(), w_t.float().t()) + b
    alphas = []
    for seg, length in ((scores[:, :Lt], text_len),
                        (scores[:, Lt:Lt + La], video_len),
                        (scores[:, Lt + La:], audio_len)):
        mask = (torch.arange(seg.shape[1], device=seg.device)[None, :]
                < length.to(seg.device)[:, None])
        alphas.append(torch.softmax(torch.where(mask, seg, _NEG_INF), dim=-1))
    a_t, a_v, a_a = alphas
    ctx_t = torch.einsum("bl,blh->bh", a_t, enc_text.float())
    ctx_v = torch.einsum("bl,blh->bh", a_v, enc_video.float())
    ctx_a = torch.einsum("bl,blh->bh", a_a, enc_audio.float())
    return ctx_t, ctx_a, ctx_v, {"text": a_t, "video": a_v, "audio": a_a}


CHUNK = 16     # positions a block of the kernel takes (its kAC)
_COUNTERS = {}  # (device, stream) -> the kernel's arrival counters


def split_softmax_plain(scores: Tensor, mem: Tensor, length: Tensor,
                        chunk: int = CHUNK):
    """The kernel's arithmetic for one segment, in plain PyTorch:
    ``scores (B, L)`` f32, ``mem (B, L, H)``, ``length (B,)``. Each chunk
    of ``chunk`` positions below a row's length keeps (m, s, ctx) = (its
    max score, sum of exp(score - m), sum of exp(score - m) mem); the merge
    takes M = max m, S = sum s exp(m - M), ctx = sum exp(m - M) ctx / S and
    maps exp(score - M) / S below the length, 0 past it. Returns (ctx (B,
    H) f32, maps (B, L) f32); the softmax of the masked scores, up to f32
    rounding, for lengths >= 1."""
    B, L = scores.shape
    n = torch.clamp(length.to(torch.int64), 0, L)
    pos = torch.arange(L, device=scores.device)
    valid = pos[None, :] < n[:, None]
    memf = mem.float()
    parts = []
    for l0 in range(0, L, chunk):
        sl = slice(l0, min(L, l0 + chunk))
        v = valid[:, sl]
        s = torch.where(v, scores[:, sl], -torch.inf)
        m = s.amax(dim=1)
        p = torch.where(v, torch.exp(s - torch.where(v.any(1), m, 0.0)[:, None]),
                        0.0)  # no valid position: m = -inf, p = 0
        parts.append((m, p.sum(dim=1),
                      torch.einsum("bl,blh->bh", p, memf[:, sl])))
    M = torch.stack([m for m, _, _ in parts], dim=1).amax(dim=1)
    e = [torch.where(torch.isinf(m), 0.0, torch.exp(m - M))
         for m, _, _ in parts]
    S = sum(s * ec for (_, s, _), ec in zip(parts, e))
    ctx = sum(c * ec[:, None] for (_, _, c), ec in zip(parts, e)) / S[:, None]
    maps = torch.where(valid, torch.exp(scores - M[:, None]) / S[:, None], 0.0)
    return ctx, maps


@functools.lru_cache(maxsize=64)
def _workspace(B, Dq, Lt, La, Ht, Hv, Ha):
    sizes = (ctypes.c_longlong * 3)()
    _build.library().mmqg_trimodal_attention_workspace(
        B, Dq, Lt, La, Ht, Hv, Ha, ctypes.addressof(sizes))
    return tuple(sizes)


def _counters(dev: torch.device, stream: int, n: int) -> Tensor:
    """At least ``n`` zeroed arrival counters for launches on ``stream``:
    every launch of the kernel leaves the ones it used at zero, so
    they are made once, and launches in one stream's order never share them
    with another stream's."""
    have = _COUNTERS.get((dev, stream))
    if have is None or have.numel() < n:
        have = _COUNTERS[dev, stream] = torch.zeros((n,), dtype=torch.int32,
                                                    device=dev)
    return have


def trimodal_attention(w_t: Tensor, b: Tensor, q: Tensor, enc_text: Tensor,
                       enc_video: Tensor, enc_audio: Tensor, text_len: Tensor,
                       video_len: Tensor, audio_len: Tensor):
    """One attention step. ``w_t (Lt+2La, Dq)``, ``q (B, Dq)`` and the
    memories ``enc_text (B, Lt, Ht)``, ``enc_video (B, La, Hv)``,
    ``enc_audio (B, La, Ha)`` share one compute dtype (f32 or bf16); ``b``
    is f32 and the lengths int32 (B,), each >= 1. Returns (ctx_text (B, Ht)
    f32, ctx_audio (B, Ha), ctx_video (B, Hv), maps {"text", "video",
    "audio"}). On CUDA the kernel needs Dq % 4 == 0 and every H % 8 == 0,
    and each call counts one launch (``trimodal_attention.launches``)."""
    if q.device.type == "cpu":
        return trimodal_attention_plain(w_t, b, q, enc_text, enc_video,
                                        enc_audio, text_len, video_len,
                                        audio_len)
    if q.device.type != "cuda":
        raise ValueError(f"trimodal_attention: no kernel for device {q.device}")
    dtype = q.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"trimodal_attention: dtype {dtype} not supported")
    B, Dq = q.shape
    Lt, Ht = enc_text.shape[1:]
    La, Hv = enc_video.shape[1:]
    Ha = enc_audio.shape[2]
    expected = {"w_t": (w_t, (Lt + 2 * La, Dq), dtype),
                "b": (b, (Lt + 2 * La,), torch.float32),
                "enc_text": (enc_text, (B, Lt, Ht), dtype),
                "enc_video": (enc_video, (B, La, Hv), dtype),
                "enc_audio": (enc_audio, (B, La, Ha), dtype),
                "text_len": (text_len, (B,), torch.int32),
                "video_len": (video_len, (B,), torch.int32),
                "audio_len": (audio_len, (B,), torch.int32),
                "q": (q, (B, Dq), dtype)}
    for name, (t, shape, dt) in expected.items():
        if t.device != q.device:
            raise ValueError(f"trimodal_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"trimodal_attention: {name} is "
                             f"{tuple(t.shape)} {t.dtype}, the kernel takes "
                             f"{shape} {dt}")
        if not t.is_contiguous():
            raise ValueError(f"trimodal_attention: {name} is not contiguous")
    if Dq % 4 or Ht % 8 or Hv % 8 or Ha % 8:
        raise ValueError(f"trimodal_attention: the tiled kernel needs Dq % 4"
                         f" == 0 and H % 8 == 0 (Dq={Dq}, H={Ht}/{Hv}/{Ha})")
    lib = _build.library()
    dev = q.device
    ctx_t = torch.empty((B, Ht), dtype=torch.float32, device=dev)
    ctx_a = torch.empty((B, Ha), dtype=torch.float32, device=dev)
    ctx_v = torch.empty((B, Hv), dtype=torch.float32, device=dev)
    maps = torch.empty((B, Lt + 2 * La), dtype=torch.float32, device=dev)
    ptrs = (q.data_ptr(), w_t.data_ptr(), b.data_ptr(), enc_text.data_ptr(),
            enc_video.data_ptr(), enc_audio.data_ptr(), text_len.data_ptr(),
            video_len.data_ptr(), audio_len.data_ptr(), ctx_t.data_ptr(),
            ctx_a.data_ptr(), ctx_v.data_ptr(), maps.data_ptr())
    shape = (B, Dq, Lt, La, Ht, Hv, Ha)
    bf16 = int(dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        n_ms, n_ctx, n_count = _workspace(*shape)
        part_ms = torch.empty((n_ms,), dtype=torch.float32, device=dev)
        part_ctx = torch.empty((n_ctx,), dtype=torch.float32, device=dev)
        count = _counters(dev, stream, n_count)
        rc = lib.mmqg_trimodal_attention_tiled(
            *ptrs, part_ms.data_ptr(), part_ctx.data_ptr(), count.data_ptr(),
            *shape, bf16, stream)
    _build.check(rc, "mmqg_trimodal_attention_tiled")
    with _build.COUNT_LOCK:
        trimodal_attention.launches += 1
    return ctx_t, ctx_a, ctx_v, {"text": maps[:, :Lt],
                                 "video": maps[:, Lt:Lt + La],
                                 "audio": maps[:, Lt + La:]}


trimodal_attention.launches = 0


def trimodal_attention_xla(attn: TriModalAttention, query: Tensor,
                           enc_text: Tensor, enc_video: Tensor,
                           enc_audio: Tensor, text_len: Tensor,
                           video_len: Tensor, audio_len: Tensor, *,
                           dtype: torch.dtype = torch.bfloat16):
    """Differentiable attention step (``attention.trimodal_attention_xla``):
    one fused score product over the three heads, masked f32 softmaxes, and
    context products with alpha and the memories rounded to ``dtype``.
    Returns (ctx_text (B, Ht), ctx_audio (B, Ha), ctx_video (B, Hv), maps),
    f32."""
    w_all = torch.cat([attn.w_text, attn.w_video, attn.w_audio], dim=1)
    b_all = torch.cat([attn.b_text, attn.b_video, attn.b_audio])
    scores = mm(query, w_all, dtype) + b_all
    Lt, La = attn.w_text.shape[1], attn.w_video.shape[1]
    alphas = []
    for seg, length in ((scores[:, :Lt], text_len),
                        (scores[:, Lt:Lt + La], video_len),
                        (scores[:, Lt + La:], audio_len)):
        mask = (torch.arange(seg.shape[1], device=seg.device)[None, :]
                < length[:, None])
        alphas.append(torch.softmax(torch.where(mask, seg, _NEG_INF), dim=-1))
    a_t, a_v, a_a = alphas

    def ctx(a, mem):
        return torch.einsum("bl,blh->bh", a.to(dtype).float(),
                            mem.to(dtype).float())

    return (ctx(a_t, enc_text), ctx(a_a, enc_audio), ctx(a_v, enc_video),
            {"text": a_t, "audio": a_a, "video": a_v})
