"""K2: tri-modal location attention, one decode step.

Counterpart of ``mmqg_tpu/ops/attention.py`` (op contract, XLA reference)
and ``mmqg_tpu/ops/attention_pallas.py`` (the fused TPU kernel). On a CUDA
tensor :func:`trimodal_attention` launches the hand-written kernel in
``csrc/trimodal_attention.cu`` (see its header for the design); on a CPU
tensor it runs :func:`trimodal_attention_plain`, the same function in plain
PyTorch. Any other device raises.

Semantics, for query q = [word_emb; h_top] (B, Dq):
  scores_m = q @ W_m + b_m, masked to -1e30 at positions >= len_m;
  alpha_m  = softmax(scores_m) in f32;  ctx_m = alpha_m @ memory_m in f32.
Rounding follows the Pallas kernel: q, W and the memories are operands in
the compute dtype and alpha stays f32 in the context sum. (The XLA path
rounds alpha to bf16 there; in f32 the two are the same function.)

The kernel takes the three weight matrices pre-transposed and concatenated,
``w_t (Lt + 2La, Dq)`` ([text | video | audio] rows), so each score is a
dot product over one contiguous row; :class:`TriModalAttention` builds it
once when the weights are loaded.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

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
        self.register_buffer("w_t", torch.cat(
            [w_text, w_video, w_audio], dim=1).t().contiguous(),
            persistent=False)
        self.register_buffer("b_all", torch.cat([b_text, b_video, b_audio]),
                             persistent=False)

    def weights(self, dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
        """(w_t in the compute dtype, f32 bias) -- hoist out of a decode."""
        return self.w_t.to(dtype), self.b_all


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


def trimodal_attention(w_t: Tensor, b: Tensor, q: Tensor, enc_text: Tensor,
                       enc_video: Tensor, enc_audio: Tensor, text_len: Tensor,
                       video_len: Tensor, audio_len: Tensor):
    """One attention step. ``w_t (Lt+2La, Dq)``, ``q (B, Dq)`` and the
    memories ``enc_text (B, Lt, Ht)``, ``enc_video (B, La, Hv)``,
    ``enc_audio (B, La, Ha)`` share one compute dtype (f32 or bf16); ``b``
    is f32 and the lengths int32 (B,). Returns (ctx_text (B, Ht) f32,
    ctx_audio (B, Ha), ctx_video (B, Hv), maps {"text", "video", "audio"}).
    Counts one launch per call on CUDA (``trimodal_attention.launches``)."""
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
    lib = _build.library()
    dev = q.device
    ctx_t = torch.empty((B, Ht), dtype=torch.float32, device=dev)
    ctx_a = torch.empty((B, Ha), dtype=torch.float32, device=dev)
    ctx_v = torch.empty((B, Hv), dtype=torch.float32, device=dev)
    maps = torch.empty((B, Lt + 2 * La), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.mmqg_trimodal_attention(
            q.data_ptr(), w_t.data_ptr(), b.data_ptr(), enc_text.data_ptr(),
            enc_video.data_ptr(), enc_audio.data_ptr(), text_len.data_ptr(),
            video_len.data_ptr(), audio_len.data_ptr(), ctx_t.data_ptr(),
            ctx_a.data_ptr(), ctx_v.data_ptr(), maps.data_ptr(), B, Dq, Lt,
            La, Ht, Hv, Ha, int(dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mmqg_trimodal_attention")
    trimodal_attention.launches += 1
    return ctx_t, ctx_a, ctx_v, {"text": maps[:, :Lt],
                                 "video": maps[:, Lt:Lt + La],
                                 "audio": maps[:, Lt + La:]}


trimodal_attention.launches = 0
