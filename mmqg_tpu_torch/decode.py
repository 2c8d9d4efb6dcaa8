"""Batched decoding: greedy, sampling, top-k, top-p and beam search, and
sequence log-probabilities (``mmqg_tpu/decode.py``).

``decode_batch`` = :func:`encode` then :func:`decode_from_memories`: a loop
of ``max_len`` decoder steps over the whole batch, with a finished mask --
after a row emits ``<end>`` or ``<pad>`` it emits ``<pad>``, and hosts trim
at the first of either (:func:`tokens_to_words`). Strategies (JAX
``_select_token``): ``greedy`` (argmax), ``sampling`` (a categorical draw),
``topk`` (a draw among the k largest logits; k <= 1 is argmax) and
``topp`` (a draw from the smallest prefix of the sorted distribution that
reaches mass p). Draws use ``utils.prng``, JAX's threefry streams bit for
bit, so a sampled question equals the JAX package's at the same key and
row seeds. ``beam_decode_batch`` is JAX's length-normalised beam search,
``sequence_logprob`` its rescoring API.

Every strategy runs either decoder of the model (``models.decoder``): the
attention decoder's step inputs are the memories in the compute dtype, the
non-attention decoder's the AV vector of the float32 memories, computed
once a decode (for beam search from the memories tiled to B * K rows).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mmqg_tpu_torch.data.vocab import END_ID, PAD_ID, START_ID
from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.models import qg_model
from mmqg_tpu_torch.models.decoder import Memories
from mmqg_tpu_torch.utils import prng

Tensor = torch.Tensor


def _bucket(need: int, av: int, granularity: int = 8) -> int:
    """Smallest of the eighths of ``av`` that holds ``need``."""
    for k in range(1, granularity + 1):
        b = max(1, (k * av) // granularity)
        if need <= b:
            return b
    return av


def audio_examples_needed(mc: qg_model.ModelConfig, audio_len) -> int:
    """Host-side max whole mel-example count of a batch."""
    return int(np.max(np.maximum(
        0, (np.asarray(audio_len) - mc.stft_window) // mc.stft_hop + 1)
        // mc.mel_frames))


def audio_bucket(mc: qg_model.ModelConfig, audio_len) -> int:
    """Host-side audio bucket: the example slots the VGGish runs on, from
    the batch's largest whole-example count."""
    av = mc.av_max_length
    need = audio_examples_needed(mc, audio_len)
    return _bucket(max(1, min(need, av)), av)


def frames_bucket(mc: qg_model.ModelConfig, frames_len) -> int:
    """Host-side bucket for the batch's max frame count."""
    need = int(np.max(np.asarray(frames_len)))
    return _bucket(max(1, min(need, mc.av_max_length)), mc.av_max_length)


def _caps(mc: qg_model.ModelConfig, batch: Dict[str, Tensor],
          audio_cap: Optional[int], frames_cap: Optional[int]):
    """Resolve the (audio, frames) caps of the modalities the mode encodes
    (None for the others). Computing them from device tensors waits for
    the device; callers that know them pass them."""
    cap = (audio_cap if audio_cap is not None
           else audio_bucket(mc, batch["audio_len"].cpu().numpy())
           if mc.mode == "trimodal" else None)
    fcap = (frames_cap if frames_cap is not None
            else frames_bucket(mc, batch["frames_len"].cpu().numpy())
            if mc.mode in ("text_video", "trimodal") else None)
    return cap, fcap


STRATEGIES = ("greedy", "sampling", "topk", "topp")
_NEG_INF = -1e30


def _check_strategy(strategy: str) -> None:
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy: {strategy}")


def _draws(strategy: str, k: int) -> bool:
    """Whether ``strategy`` draws from the PRNG (topk with k <= 1 is
    argmax)."""
    return strategy in ("sampling", "topp") or (strategy == "topk" and k > 1)


def _top_k(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``lax.top_k`` over the last axis: on equal values the lower index
    comes first (``torch.topk`` leaves ties unordered on CUDA)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _draw(noise: Tensor, logits: Tensor) -> Tensor:
    """``prng.categorical`` with its Gumbel noise drawn beforehand."""
    return torch.argmax(noise + logits, dim=-1)


def _select_token(strategy: str, logits: Tensor, noise: Optional[Tensor],
                  k: int, p: float = 0.9) -> Tensor:
    """(B, V) logits -> (B,) next tokens (JAX ``_select_token``).
    ``noise``: the step's Gumbel noise, (B, V), or (B, k) for topk -- what
    ``prng.categorical`` would draw with the step's key (see
    :func:`_step_noise`)."""
    if not _draws(strategy, k):
        return torch.argmax(logits, dim=-1)
    lg = logits.float()
    if strategy == "sampling":
        return _draw(noise, lg)
    if strategy == "topk":
        vals, idx = _top_k(lg, k)
        choice = _draw(noise, vals)
        return idx.gather(1, choice[:, None])[:, 0]
    # topp: jax.nn.softmax's formula
    e = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    sp = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sp, dim=-1)
    # the target is capped at the row's total mass (an f32 cumsum can top
    # out below p); the threshold's ties all stay in
    target = torch.minimum(torch.full_like(csum[:, -1:], p), csum[:, -1:])
    cut = torch.argmax((csum >= target).to(torch.uint8), dim=-1)
    thresh = sp.gather(1, cut[:, None])
    masked = torch.where(probs >= thresh, lg, _NEG_INF)
    return _draw(noise, masked)


def _step_noise(stream: Tensor, max_len: int, B: int, n: int) -> Tensor:
    """The Gumbel noise of every step, (max_len, B, n), drawn at once: step
    t's key is ``fold_in(stream, t)``. ``stream`` is one key, drawing (B, n)
    a step (the legacy per-batch stream), or (B, 2) row keys, row i drawing
    (n,) with its own. Neither the keys nor the noise depend on the logits,
    so this is the noise the step-by-step draws would make, bit for bit."""
    t = torch.arange(max_len, device=stream.device)
    if stream.dim() == 1:
        return prng.gumbel(prng.fold_in(stream[None], t), (B, n))
    keys = prng.fold_in(stream[:, None], t)                 # (B, max_len, 2)
    return prng.gumbel(keys, (n,)).transpose(0, 1)


def decode_from_memories(model: qg_model.QGModel, mem: Memories,
                         dec_state: L.State, rng: Optional[Tensor] = None, *,
                         strategy: str = "greedy", max_len: int = 21,
                         k: int = 1, p: float = 0.9,
                         dtype: torch.dtype = torch.bfloat16,
                         row_seeds=None, return_logits: bool = False,
                         global_rows: Optional[Tuple[int, int]] = None):
    """Token generation over encoded memories. Returns tokens (B, max_len)
    int32, PAD after ``<end>``; with ``return_logits`` also the per-step
    logits (B, max_len, V) f32.

    ``rng``: a ``utils.prng`` key, needed by the strategies that draw
    (greedy, and topk with k <= 1, build no key and run no PRNG op).
    Step t draws with ``fold_in(rng, t)`` over the whole batch, or, with
    ``row_seeds`` ((B,) int32 identities), row i with
    ``fold_in(fold_in(rng, row_seeds[i]), t)``: a row's draw then depends
    only on (rng, its identity, t), never on the batch it rides in. The
    noise of all ``max_len`` steps is drawn before the first step.

    ``global_rows=(start, total)``: these B rows are rows start..start+B of
    a batch of ``total`` rows split over a data axis (``parallel``). The
    per-batch stream then draws (total, n) a step, as one program over the
    whole batch does (threefry's bits depend on the drawn shape), and these
    rows take their slice of it; per-row streams need nothing."""
    _check_strategy(strategy)
    dec = model.decoder
    B = mem.enc_text.shape[0]
    dev = mem.enc_text.device
    draws = _draws(strategy, k)
    stream = None      # the key, or (B, 2) row keys; step t folds in t
    if draws:
        if rng is None:
            raise ValueError(f"strategy={strategy!r} draws tokens: pass rng")
        stream = rng.to(dev)
        if row_seeds is not None:
            stream = prng.fold_in(stream, torch.as_tensor(row_seeds,
                                                          device=dev))
    inputs = dec.step_inputs(mem, dtype)
    noise = None
    if draws:
        n = k if strategy == "topk" else dec.out.w.shape[-1]
        if global_rows is None or stream.dim() == 2:
            noise = _step_noise(stream, max_len, B, n)
        else:
            start, total = global_rows
            noise = _step_noise(stream, max_len, total, n)[:, start:start + B]
    tok = torch.full((B,), START_ID, dtype=torch.long, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    state = dec_state
    toks: List[Tensor] = []
    logits_all: List[Tensor] = []
    for t in range(max_len):
        logits, state, _ = dec.step(model.embedding, tok, inputs, state,
                                    dtype=dtype)
        nxt = _select_token(strategy, logits,
                            noise[t] if draws else None, k, p)
        nxt = torch.where(finished, PAD_ID, nxt)
        # PAD is terminal too: hosts truncate at the first PAD/END
        finished = finished | (nxt == END_ID) | (nxt == PAD_ID)
        toks.append(nxt)
        logits_all.append(logits)
        tok = nxt
    tokens = torch.stack(toks, dim=1).to(torch.int32)
    if return_logits:
        return tokens, torch.stack(logits_all, dim=1)
    return tokens


def beam_from_memories(model: qg_model.QGModel, mem: Memories,
                       dec_state: L.State, *, max_len: int = 21,
                       beam_size: int = 4, length_penalty: float = 0.6,
                       dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """Length-normalised beam search over encoded memories (JAX
    ``beam_from_memories``): best-beam tokens (B, max_len) int32.

    The memories are tiled to B * K rows (row b * K + j is beam j of
    example b) before the step inputs are built, so every step runs the
    decoder, and K2 on the card, on B * K rows. Only beam 0 is live at the
    start; a finished beam extends with PAD at no cost, and a PAD from a
    live beam is terminal. Scores stay f32 under bf16 compute."""
    dec = model.decoder
    B = mem.enc_text.shape[0]
    K = beam_size
    dev = mem.enc_text.device
    mem = Memories(*(x.repeat_interleave(K, 0) for x in mem))
    h, c = dec_state
    state = (h.repeat_interleave(K, 1), c.repeat_interleave(K, 1))
    inputs = dec.step_inputs(mem, dtype)

    scores = torch.full((B, K), _NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    tokens = torch.full((B, K, max_len), PAD_ID, dtype=torch.long,
                        device=dev)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, K), dtype=torch.int32, device=dev)
    cur = torch.full((B * K,), START_ID, dtype=torch.long, device=dev)
    rows = torch.arange(B, device=dev)[:, None] * K
    pad_only = torch.full((dec.out.w.shape[-1],), _NEG_INF,
                          dtype=torch.float32, device=dev)
    pad_only[PAD_ID] = 0.0
    for t in range(max_len):
        logits, (h, c), _ = dec.step(model.embedding, cur, inputs, state,
                                     dtype=dtype)
        V = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
        # finished beams may only extend with PAD at no cost
        logp = torch.where(finished[..., None], pad_only, logp)
        total = scores[..., None] + logp                     # (B, K, V)
        scores, flat_idx = _top_k(total.reshape(B, K * V), K)
        beam_idx = flat_idx // V                             # (B, K)
        tok_idx = flat_idx % V
        gather = (rows + beam_idx).reshape(-1)               # (B * K,)
        state = (h[:, gather], c[:, gather])
        tokens = tokens.gather(1, beam_idx[..., None].expand(-1, -1,
                                                             max_len))
        tokens[:, :, t] = tok_idx
        was_finished = finished.gather(1, beam_idx)
        lengths = lengths.gather(1, beam_idx)
        lengths = torch.where(was_finished, lengths, lengths + 1)
        finished = was_finished | (tok_idx == END_ID) | (tok_idx == PAD_ID)
        cur = tok_idx.reshape(-1)
    norm = scores / lengths.clamp(min=1).float() ** length_penalty
    best = torch.argmax(norm, dim=1)
    return tokens[torch.arange(B, device=dev), best].to(torch.int32)


def sequence_logprob_from_memories(model: qg_model.QGModel, mem: Memories,
                                   dec_state: L.State, tokens: Tensor, *,
                                   dtype: torch.dtype = torch.bfloat16
                                   ) -> Tensor:
    """log P(tokens | memories) per row (B,) f32, teacher-forcing each row
    (JAX ``sequence_logprob_from_memories``, the rescoring API): the sum of
    the step log-softmax mass of each token up to and including the row's
    first ``<end>``/``<pad>``."""
    dec = model.decoder
    B = tokens.shape[0]
    dev = mem.enc_text.device
    tokens = tokens.to(device=dev, dtype=torch.long)
    inputs = dec.step_inputs(mem, dtype)
    cur = torch.full((B,), START_ID, dtype=torch.long, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    total = torch.zeros((B,), dtype=torch.float32, device=dev)
    state = dec_state
    for t in range(tokens.shape[1]):
        logits, state, _ = dec.step(model.embedding, cur, inputs, state,
                                    dtype=dtype)
        tok = tokens[:, t]
        lp = torch.log_softmax(logits.float(), dim=-1)
        step_lp = lp.gather(1, tok[:, None])[:, 0]
        total = total + torch.where(done, 0.0, step_lp)
        done = done | (tok == END_ID) | (tok == PAD_ID)
        cur = tok
    return total

def encode(model: qg_model.QGModel, mc: qg_model.ModelConfig,
           batch: Dict[str, Tensor], *, audio_cap: Optional[int] = None,
           frames_cap: Optional[int] = None,
           dtype: torch.dtype = torch.bfloat16) -> Tuple[Memories, L.State]:
    """Encode with the batch's AV buckets (``decode.encode_jit``)."""
    cap, fcap = _caps(mc, batch, audio_cap, frames_cap)
    mem, state, _ = qg_model.encode(model, mc, batch, audio_cap=cap,
                                    frames_cap=fcap, dtype=dtype)
    return mem, state


def decode_batch(model: qg_model.QGModel, mc: qg_model.ModelConfig,
                 batch: Dict[str, Tensor], rng: Optional[Tensor] = None, *,
                 strategy: str = "greedy", max_len: int = 21, k: int = 1,
                 p: float = 0.9, audio_cap: Optional[int] = None,
                 frames_cap: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 row_seeds=None,
                 global_rows: Optional[Tuple[int, int]] = None) -> Tensor:
    """Token ids (B, max_len); PAD after ``<end>``, which is kept. ``rng``,
    ``row_seeds`` and ``global_rows``: see :func:`decode_from_memories`."""
    _check_strategy(strategy)
    mem, dec_state = encode(model, mc, batch, audio_cap=audio_cap,
                            frames_cap=frames_cap, dtype=dtype)
    return decode_from_memories(model, mem, dec_state, rng,
                                strategy=strategy, max_len=max_len, k=k, p=p,
                                dtype=dtype, row_seeds=row_seeds,
                                global_rows=global_rows)


def beam_decode_batch(model: qg_model.QGModel, mc: qg_model.ModelConfig,
                      batch: Dict[str, Tensor], *, max_len: int = 21,
                      beam_size: int = 4, length_penalty: float = 0.6,
                      audio_cap: Optional[int] = None,
                      frames_cap: Optional[int] = None,
                      dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """Encode, then :func:`beam_from_memories`: best-beam tokens
    (B, max_len). ``dtype`` is the compute dtype (the JAX package's beam
    always computes in bf16)."""
    mem, dec_state = encode(model, mc, batch, audio_cap=audio_cap,
                            frames_cap=frames_cap, dtype=dtype)
    return beam_from_memories(model, mem, dec_state, max_len=max_len,
                              beam_size=beam_size,
                              length_penalty=length_penalty, dtype=dtype)


def sequence_logprob(model: qg_model.QGModel, mc: qg_model.ModelConfig,
                     batch: Dict[str, Tensor], tokens: Tensor, *,
                     audio_cap: Optional[int] = None,
                     frames_cap: Optional[int] = None,
                     dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """Encode, then :func:`sequence_logprob_from_memories`: log P(tokens |
    batch) per row."""
    mem, dec_state = encode(model, mc, batch, audio_cap=audio_cap,
                            frames_cap=frames_cap, dtype=dtype)
    return sequence_logprob_from_memories(model, mem, dec_state, tokens,
                                          dtype=dtype)

def tokens_to_words(tokens, index_to_word: Dict[str, str]) -> List[List[str]]:
    """Id -> word rows, each cut at its first ``<end>``/``<pad>``."""
    out = []
    for row in np.asarray(tokens):
        words = []
        for t in row:
            if t in (PAD_ID, END_ID):
                break
            words.append(index_to_word[str(int(t))])
        out.append(words)
    return out
