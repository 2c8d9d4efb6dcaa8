"""QGPipeline -- the serving API: transcript, frames and audio in, questions
out (``mmqg_tpu/pipeline.py``).

    pipe = QGPipeline.from_checkpoint(config, alias="best", device="cuda")
    questions = pipe.generate(
        contexts=["the lecturer explains gradient descent ..."],
        frames=[frames_u8],   # (T, H, W, 3) uint8 per example, or None
        audio=[pcm_i16],      # int16 mono 16 kHz per example, or None
        strategy="beam")

Requests are packed on the host into one fixed-shape batch, with AV buffers
at the batch's bucket sizes, exactly as the JAX pipeline packs them; the
batch then goes to ``device`` and through encode and the decode of the
chosen strategy (``decode.py``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from mmqg_tpu_torch import checkpoint as ckpt
from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch.compat.from_jax import params_from_numpy
from mmqg_tpu_torch.config import Config
from mmqg_tpu_torch.data.vocab import pad_to
from mmqg_tpu_torch.models import frontends, qg_model
from mmqg_tpu_torch.utils import prng
from mmqg_tpu_torch.utils.device import resolve_device


def row_seed_array(rows: int, n: int,
                   row_seeds: Optional[Sequence[int]] = None) -> np.ndarray:
    """(rows,) int32 per-row stream identities of a batch of ``n`` requests
    packed into ``rows`` rows: the row index, with the first ``n`` replaced
    by ``row_seeds`` wrapped into int32 (int64, masked to 32 bits, viewed
    as int32), as the JAX pipeline does."""
    seeds = np.arange(rows, dtype=np.int32)
    if row_seeds is not None:
        wrapped = ((np.asarray(list(row_seeds), np.int64) & 0xFFFFFFFF)
                   .astype(np.uint32).view(np.int32))
        if len(wrapped) < n:
            raise ValueError(f"{len(wrapped)} row_seeds for {n} requests")
        seeds[:n] = wrapped[:n]
    return seeds


class QGPipeline:
    def __init__(self, config, mc: qg_model.ModelConfig, params, model_state,
                 vocab: Dict[str, int], index_to_word: Dict[str, str], *,
                 device="cuda", dtype: torch.dtype = torch.bfloat16):
        """``params``/``model_state``: the JAX package's pytrees with numpy
        (or array-like) leaves. ``dtype`` is the compute dtype (bfloat16
        serves, as in the JAX package; float32 is for parity checks).
        Questions are up to ``mc.target_steps - 1`` tokens long
        (``config.question_max_length`` for a config-built ``mc``). The
        model goes to ``device``, the card by default; without CUDA that
        raises unless the caller passes ``device="cpu"``."""
        qg_model.check_supported(mc)
        self.config = config
        self.mc = mc
        self.device = resolve_device(device, caller="QGPipeline")
        self.dtype = dtype
        self.model = params_from_numpy(params, model_state, self.device)
        self.vocab = vocab
        self.index_to_word = index_to_word

    # ------------------------------------------------------------ loading
    @classmethod
    def from_checkpoint(cls, config, alias: str = "best",
                        mode: str = "trimodal", decoder: str = "attn", *,
                        device="cuda",
                        dtype: torch.dtype = torch.bfloat16) -> "QGPipeline":
        """Load ``<checkpoint_dir>/<alias>.msgpack`` written by the JAX
        package's trainer, with the vocabulary files named by ``config``,
        onto ``device`` (as ``QGPipeline``)."""
        resolve_device(device, caller="QGPipeline.from_checkpoint")
        with open(config.vocab_file) as f:
            vocab = json.load(f)
        with open(config.index_to_word_file) as f:
            index_to_word = json.load(f)
        mc = qg_model.ModelConfig.from_config(config, n_vocab=len(vocab),
                                              mode=mode, dec=decoder)
        state = ckpt.load_checkpoint(Path(config.checkpoint_dir), alias)
        return cls(config, mc, state["params"], state["model_state"], vocab,
                   index_to_word, device=device, dtype=dtype)

    # ----------------------------------------------------------- batching
    @staticmethod
    def _batch_bucket(n: int) -> int:
        """Round the request count up to a power of two, as the JAX
        pipeline does; padded rows are empty examples."""
        b = 1
        while b < n:
            b <<= 1
        return b

    def _pack(self, contexts: Sequence[str],
              frames: Optional[Sequence[Optional[np.ndarray]]],
              audio: Optional[Sequence[Optional[np.ndarray]]],
              frames_cap: Optional[int] = None,
              audio_cap: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Pad and pack a request into one fixed-shape host batch, with AV
        buffers at the batch's bucket sizes (or pinned by the caps) --
        byte for byte the JAX pipeline's ``_pack``."""
        mc = self.mc
        n = len(contexts)
        rows = self._batch_bucket(n)
        Lc, Tav = mc.context_max_length, mc.av_max_length
        H = W = mc.frame_size
        S_max = Tav * mc.sample_rate

        f_lens = np.ones((rows,), np.int32)
        a_lens = np.zeros((rows,), np.int32)
        pcms: List[Optional[np.ndarray]] = [None] * rows
        for i in range(n):
            if frames is not None and frames[i] is not None:
                f_lens[i] = max(1, min(frames[i].shape[0], Tav))
            if audio is not None and audio[i] is not None:
                pcm = np.asarray(audio[i])
                if pcm.dtype != np.int16:
                    pcm = np.clip(pcm * 32767.0, -32768,
                                  32767).astype(np.int16)
                pcms[i] = pcm[:S_max]
                a_lens[i] = len(pcms[i])

        if frames_cap is not None:
            fcap = min(int(frames_cap), Tav)
            np.minimum(f_lens, fcap, out=f_lens)
        else:
            fcap = DEC.frames_bucket(mc, f_lens)
        acap = (min(int(audio_cap), Tav) if audio_cap is not None
                else DEC.audio_bucket(mc, a_lens))
        # samples covering acap whole mel examples; the frontend pads the rest
        k = -(-mc.stft_window // mc.stft_hop)
        s_need = min(S_max, (acap * mc.mel_frames + k - 1) * mc.stft_hop)
        if audio_cap is not None:
            # a pinned cap may undercut the natural bucket: the length mask
            # must not count examples past the shipped prefix
            np.minimum(a_lens, s_need, out=a_lens)

        batch = {
            "context_ids": np.zeros((rows, Lc), np.int32),
            "context_len": np.ones((rows,), np.int32),
            "frames": np.zeros((rows, fcap, H, W, 3), np.uint8),
            "frames_len": f_lens,
            "audio_pcm": np.zeros((rows, s_need), np.int16),
            "audio_len": a_lens,
            "target_ids": np.zeros((rows, mc.target_steps), np.int32),
            "target_len": np.ones((rows,), np.int32),
            "valid": np.arange(rows) < n,
        }
        for i, text in enumerate(contexts):
            ids = np.asarray([self.vocab[w] for w in text.split()
                              if w in self.vocab], np.int32)
            batch["context_ids"][i] = pad_to(ids, Lc)
            batch["context_len"][i] = max(1, min(len(ids), Lc))
            if frames is not None and frames[i] is not None:
                t = f_lens[i]
                batch["frames"][i, :t] = frames[i][:t]
            if pcms[i] is not None:
                s = min(a_lens[i], s_need)
                batch["audio_pcm"][i, :s] = pcms[i][:s]
        return batch

    def calibrate_audio_int8(self, audio: Sequence[np.ndarray],
                             margin: float = 1.1) -> "QGPipeline":
        """Post-training int8 calibration on representative audio clips
        (the JAX pipeline's): static per-layer activation scales from the
        f32 conv stack (``AudioEncoder.calibrate_int8_scales``), kept in
        ``self.mc.audio_int8_scales`` for serving. Returns self."""
        mc = self.mc
        batch = self._pack([""] * len(audio), None, list(audio))
        pcm = torch.from_numpy(batch["audio_pcm"]).to(self.device)
        mel = frontends.log_mel_examples(
            pcm, sample_rate=mc.sample_rate, window=mc.stft_window,
            hop=mc.stft_hop, mel_bins=mc.mel_bins,
            frames_per_example=mc.mel_frames,
            max_examples=mc.av_max_length, dtype=torch.float32)
        scales = self.model.audio_enc.calibrate_int8_scales(
            mel.reshape((-1,) + mel.shape[2:]), margin=margin)
        self.mc = mc._replace(audio_int8_scales=scales)
        return self

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        keys = ("context_ids", "context_len", "frames", "frames_len",
                "audio_pcm", "audio_len")
        return {k: torch.from_numpy(batch[k]).to(self.device) for k in keys}

    def _to_words(self, tokens: np.ndarray) -> List[str]:
        return [" ".join(ws) for ws in
                DEC.tokens_to_words(np.asarray(tokens), self.index_to_word)]

    def av_bucket_key(self, frames: Optional[np.ndarray],
                      audio: Optional[np.ndarray]) -> tuple:
        """(frames bucket, audio bucket) of one example: the grouping key
        of coalesced batching (the decode is keyed on these caps)."""
        mc = self.mc
        fb = (DEC.frames_bucket(
            mc, np.array([len(frames) if frames is not None else 1]))
            if mc.mode in ("text_video", "trimodal") else None)
        ab = (DEC.audio_bucket(
            mc, np.array([len(audio) if audio is not None else 0]))
            if mc.mode == "trimodal" else None)
        return (fb, ab)

    # ----------------------------------------------------------- serving
    def generate(self, contexts: Sequence[str],
                 frames: Optional[Sequence[Optional[np.ndarray]]] = None,
                 audio: Optional[Sequence[Optional[np.ndarray]]] = None, *,
                 strategy: str = "greedy", beam_size: Optional[int] = None,
                 topk: int = 1, top_p: float = 0.9, seed: int = 0,
                 row_seeds: Optional[Sequence[int]] = None) -> List[str]:
        """Generate one question per input example (the JAX pipeline's
        signature; see :meth:`generate_async`)."""
        return self.generate_async(contexts, frames, audio,
                                   strategy=strategy, beam_size=beam_size,
                                   topk=topk, top_p=top_p, seed=seed,
                                   row_seeds=row_seeds)()

    def generate_async(self, contexts: Sequence[str],
                       frames: Optional[Sequence[Optional[np.ndarray]]] = None,
                       audio: Optional[Sequence[Optional[np.ndarray]]] = None,
                       *, strategy: str = "greedy",
                       beam_size: Optional[int] = None, topk: int = 1,
                       top_p: float = 0.9, seed: int = 0,
                       frames_cap: Optional[int] = None,
                       audio_cap: Optional[int] = None,
                       row_seeds: Optional[Sequence[int]] = None
                       ) -> Callable[[], List[str]]:
        """Queue the decode and return a zero-argument finalizer that waits
        for the tokens and returns the questions. On the card the kernels
        run asynchronously, so a caller can pack the next batch meanwhile.

        ``strategy``: greedy, sampling, topk (``topk``), topp (``top_p``) or
        beam (``beam_size``, else ``config.beam_size``). The sampling
        strategies draw from ``PRNGKey(seed)`` with one stream per row:
        ``row_seeds`` (any ints, wrapped into int32 as the JAX pipeline
        wraps them) give each request a stable identity, so its question
        is the same whatever batch it rides in; they default to the row
        index, and padded rows take their index. Greedy and beam ignore
        ``seed`` and ``row_seeds``; greedy builds no key.
        ``frames_cap``/``audio_cap`` pin the AV buckets and the packed buffer
        shapes instead of deriving them from the request (see ``_pack``)."""
        n = len(contexts)
        host = self._pack(contexts, frames, audio, frames_cap=frames_cap,
                          audio_cap=audio_cap)
        # the buckets come from the host arrays: no device round trip
        mc = self.mc
        cap = (min(int(audio_cap), mc.av_max_length) if audio_cap is not None
               else DEC.audio_bucket(mc, host["audio_len"]))
        fcap = (min(int(frames_cap), mc.av_max_length)
                if frames_cap is not None
                else DEC.frames_bucket(mc, host["frames_len"]))
        batch = self._to_device(host)
        max_len = mc.target_steps - 1
        if strategy == "beam":
            toks = DEC.beam_decode_batch(
                self.model, mc, batch, max_len=max_len,
                beam_size=beam_size or (Config if self.config is None
                                        else self.config).beam_size,
                audio_cap=cap, frames_cap=fcap, dtype=self.dtype)
        else:
            rng = seeds = None
            if strategy != "greedy":
                rows = host["context_ids"].shape[0]
                seeds = torch.from_numpy(row_seed_array(rows, n, row_seeds))
                rng = prng.prng_key(seed, self.device)
            toks = DEC.decode_batch(self.model, mc, batch, rng,
                                    strategy=strategy, max_len=max_len,
                                    k=topk, p=top_p, audio_cap=cap,
                                    frames_cap=fcap, dtype=self.dtype,
                                    row_seeds=seeds)
        return lambda: self._to_words(toks.cpu().numpy())[:n]
