"""Sequence-parallel tri-modal attention: the exact softmax over a text
memory whose context axis is split over the model group, without
gathering the memory (``mmqg_tpu/ops/attention_sp.py``).

Each rank of the model group holds a block of the context axis of the
(B, Lt, Ht) text memory (``mesh.sequence_constraint``) and the matching
columns of ``w_text``; it computes its masked scores, and the two-pass
stable softmax runs with its passes distributed: the global max by an
all-reduce MAX (outside autograd: softmax does not depend on the shift,
JAX's ``stop_gradient``), the exp-sum and the weighted context by
all-reduce SUMs. Communication per decode step is O(B·Ht) whatever Lt.
The video and audio heads attend over whole memories on every rank, as
there.

Semantics and rounding are ``ops.attention.trimodal_attention_xla``'s (the
function training differentiates): the score product with operands in the
compute dtype and f32 sums, masked f32 softmaxes, context products with
the weights and memories in the compute dtype. The JAX op is XLA, not
Pallas (``sp_greedy_decode`` passes ``use_pallas=False``), so this is
plain PyTorch with collectives and K2 is not on its route.

Gradients follow the replicated-computation conventions of
``parallel.model_axis``: the query enters through ``copy_to_model`` (each
rank's score columns contribute their part of its gradient, summed), the
text weights through ``split_to_model`` (their column blocks' gradients
gathered), and the sums leave through ``reduce_from_model``, whose
backward passes the cotangent every rank holds equally.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mmqg_tpu_torch.models.layers import mm
from mmqg_tpu_torch.ops.attention import _NEG_INF, TriModalAttention
from mmqg_tpu_torch.parallel import model_axis as MA
from mmqg_tpu_torch.parallel.multihost import world

Tensor = torch.Tensor


def _masked_softmax(scores: Tensor, length: Tensor) -> Tensor:
    mask = (torch.arange(scores.shape[1], device=scores.device)[None, :]
            < length[:, None])
    return torch.softmax(torch.where(mask, scores, _NEG_INF), dim=-1)


def trimodal_attention_sp(attn: TriModalAttention, query: Tensor,
                          enc_text: Tensor, enc_video: Tensor,
                          enc_audio: Tensor, text_len: Tensor,
                          video_len: Tensor, audio_len: Tensor, *,
                          group, dtype: torch.dtype = torch.bfloat16
                          ) -> Tuple[Tensor, Tensor, Tensor, dict]:
    """(ctx_text (B, Ht), ctx_audio (B, Ha), ctx_video (B, Hv), maps), f32,
    as ``trimodal_attention_xla`` returns them for the whole memory.

    ``enc_text`` is this rank's block of the context axis, padded to a
    multiple of the group (``mesh.sequence_constraint``): rank r holds
    positions ``[r * n, (r + 1) * n)``. ``attn``'s weights are whole;
    ``w_text`` and ``b_text`` are padded the same way inside, and padded
    positions sit at or past every ``text_len``, so the mask drops them.
    ``maps["text"]`` is this rank's block of the text attention map;
    the audio and video maps are whole."""
    rank, size = world(group)
    n = enc_text.shape[1]
    lt = attn.w_text.shape[1]
    pad = n * size - lt
    if n != -(-lt // size):
        raise ValueError(f"a text block of {n} positions on {size} ranks "
                         f"does not cover a context of {lt}")
    w_text, b_text = attn.w_text, attn.b_text
    if pad:
        w_text = torch.nn.functional.pad(w_text, (0, pad))
        b_text = torch.nn.functional.pad(b_text, (0, pad))
    w_t = MA.split_to_model(w_text, 1, group)
    b_t = MA.split_to_model(b_text, 0, group)
    q = MA.copy_to_model(query, group)
    s_t = mm(q, w_t, dtype) + b_t
    offset = rank * n
    live = ((offset + torch.arange(n, device=s_t.device))[None, :]
            < text_len[:, None])
    s_t = torch.where(live, s_t, _NEG_INF)
    m = MA.all_reduce_(s_t.detach().amax(dim=-1), group,
                       torch.distributed.ReduceOp.MAX)
    e = torch.exp(s_t - m[:, None])
    denom = torch.clamp(MA.reduce_from_model(e.sum(dim=-1), group),
                        min=1e-30)
    ctx_t = MA.reduce_from_model(
        torch.einsum("bl,blh->bh", e.to(dtype).float(),
                     enc_text.to(dtype).float()), group) / denom[:, None]
    a_t = e / denom[:, None]

    w_av = torch.cat([attn.w_video, attn.w_audio], dim=1)
    b_av = torch.cat([attn.b_video, attn.b_audio])
    s_av = mm(query, w_av, dtype) + b_av
    la = attn.w_video.shape[1]
    a_v = _masked_softmax(s_av[:, :la], video_len)
    a_a = _masked_softmax(s_av[:, la:], audio_len)

    def ctx(a, mem):
        return torch.einsum("bl,blh->bh", a.to(dtype).float(),
                            mem.to(dtype).float())

    return (ctx_t, ctx(a_a, enc_audio), ctx(a_v, enc_video),
            {"text": a_t, "audio": a_a, "video": a_v})
