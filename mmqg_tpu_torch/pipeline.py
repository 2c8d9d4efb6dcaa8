"""QGPipeline -- the serving API: lecture videos, or transcripts, frames and
audio, in; questions out (``mmqg_tpu/pipeline.py``).

    pipe = QGPipeline.from_checkpoint(config, alias="best", device="cuda")
    questions = pipe.generate(
        contexts=["the lecturer explains gradient descent ..."],
        frames=[frames_u8],   # (T, H, W, 3) uint8 per example, or None
        audio=[pcm_i16],      # int16 mono 16 kHz per example, or None
        strategy="beam")
    questions = pipe.generate_from_video(
        "lecture.mp4", spans=[(45, 70), ("1:10", "1:31")],
        subtitles="lecture.srt", audio_path="lecture.wav")
    per_video = pipe.generate_from_videos(
        [{"video_path": "a.mp4", "spans": [(3, 9)]}, ...], coalesce=True)

Requests are packed on the host into one fixed-shape batch, with AV buffers
at the batch's bucket sizes, exactly as the JAX pipeline packs them; the
batch then goes to ``device`` and through encode and the decode of the
chosen strategy (``decode.py``). Under a profiler each part of a call
is a span (``utils.profiling.annotate``): ``serve.pack``, ``serve.h2d``,
``model.encode`` and ``model.decode`` (``decode.py``), and the
finalizer's ``serve.readback``; ``h2d_shipped`` counts the H2D's calls
and bytes. On the card the batch is packed straight into reused page-locked
blocks and shipped with asynchronous copies (``staging.py``);
``h2d_staged`` counts how each H2D shipped and the blocks allocated. The
video entry points prepare each
video's spans on the host first (``_prep_video``: salient frames, span
audio, subtitle contexts), on a thread pool in ``generate_from_videos``,
and count the audio route that served each video in ``audio_routes``.
``shard()`` serves data-parallel: one model replica per device of a mesh,
each request batch split into row blocks (``parallel.replicas``).
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import shutil
import subprocess
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmqg_tpu_torch import checkpoint as ckpt
from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch.compat.from_jax import params_from_numpy
from mmqg_tpu_torch.config import Config
from mmqg_tpu_torch.data import native, saliency
from mmqg_tpu_torch.data import wav as wavio
from mmqg_tpu_torch.data.subtitles import (extract_context,
                                           parse_subtitle_file, span_seconds)
from mmqg_tpu_torch.data.text_prep import preprocess_text
from mmqg_tpu_torch.data.vocab import pad_to
from mmqg_tpu_torch.models import frontends, qg_model
from mmqg_tpu_torch.parallel.mesh import Mesh, make_mesh
from mmqg_tpu_torch.parallel.replicas import Replicas
from mmqg_tpu_torch.staging import FRESH, HostStaging
from mmqg_tpu_torch.utils import prng, profiling
from mmqg_tpu_torch.utils.device import resolve_device


# videos (or serve requests) prepped, by the route that gave their span
# audio: the native decoder, the ffmpeg binary, a staged wav, or none
audio_routes = {"native": 0, "ffmpeg": 0, "wav": 0, "none": 0}
_routes_lock = threading.Lock()  # prep pools count from several threads

# host batches shipped to the card by ``_to_device``, and their bytes
h2d_shipped = {"calls": 0, "bytes": 0}
# ``_to_device``'s calls by how they shipped (from page-locked staging with
# asynchronous copies, or pageable), and the staging blocks allocated
h2d_staged = {"pinned": 0, "pageable": 0, "allocated": 0}

# the strategies that draw from per-row streams
SAMPLED = ("sampling", "topk", "topp")
# _row_seed packs the job index into the high 16 bits of an int32
MAX_SAMPLED_JOBS = 1 << 16


def count_audio_route(route: str) -> None:
    with _routes_lock:
        audio_routes[route] += 1


def _pinned_block(nbytes: int) -> torch.Tensor:
    h2d_staged["allocated"] += 1
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


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
        self.config = config
        self.mc = mc
        self.device = resolve_device(device, caller="QGPipeline")
        self.dtype = dtype
        self.model = params_from_numpy(params, model_state, self.device)
        qg_model.check_supported(mc, self.model)
        self.vocab = vocab
        self.index_to_word = index_to_word
        self.replicas: Optional[Replicas] = None
        # the serving batch's host buffers: reused page-locked blocks on
        # the card, new numpy arrays on the CPU
        self._staging = (HostStaging(_pinned_block)
                         if self.device.type == "cuda" else None)

    # ---------------------------------------------------------- multi-device
    def shard(self, mesh: Optional[Mesh] = None,
              shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> "QGPipeline":
        """Serve data-parallel over ``mesh`` (default: ``make_mesh(shape)``
        over ``devices``, else every visible card): one replica of the
        model on each row of the data axis (``parallel.replicas``). A
        ``(data, model)`` ``shape`` also applies the tensor-parallel rules
        (JAX's ``shard(shape=)``): each replica's split leaves are stored
        over its row's devices and gathered onto the row's first device
        for each batch. Every request
        batch is packed on the host, its AV buckets taken from the whole
        batch, padded to the data axis and split into contiguous row
        blocks, each encoded and decoded on its device (enqueued from one
        dispatch thread); the questions come back in request order. Every
        strategy and the video entry points go through it, with the
        questions of the unsharded pipeline. Returns self.

        It buys no questions/s while the decode is host-bound: one
        interpreter pays every replica's launches (on four H100s a
        generate() of 37 requests took longer sharded than on one card).

            pipe = QGPipeline.from_checkpoint(config).shard()   # every card
        """
        if self.replicas is not None:
            self.replicas.close()
        self.replicas = Replicas(self.model, mesh if mesh is not None
                                 else make_mesh(shape, devices=devices))
        return self

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

    @profiling.annotate("serve.pack")
    def _pack(self, contexts: Sequence[str],
              frames: Optional[Sequence[Optional[np.ndarray]]],
              audio: Optional[Sequence[Optional[np.ndarray]]],
              frames_cap: Optional[int] = None,
              audio_cap: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Pad and pack a request into one fixed-shape host batch, with AV
        buffers at the batch's bucket sizes (or pinned by the caps) --
        byte for byte the JAX pipeline's ``_pack``. On the card the six
        arrays ``_to_device`` ships live in reused page-locked blocks
        (``staging.py``), held for this batch while any view of them is
        alive."""
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
        # the frames and samples written into each row; the rest is zero
        f_keep = np.where([frames is not None and i < n
                           and frames[i] is not None for i in range(rows)],
                          f_lens, 0)
        a_keep = np.where([p is not None for p in pcms],
                          np.minimum(a_lens, s_need), 0)

        out = self._staging.lease() if self._staging is not None else FRESH
        batch = {
            "context_ids": np.zeros((rows, Lc), np.int32),
            "context_len": np.ones((rows,), np.int32),
            "frames": out.array("frames", (rows, fcap, H, W, 3), np.uint8,
                                f_keep),
            "frames_len": f_lens,
            "audio_pcm": out.array("audio_pcm", (rows, s_need), np.int16,
                                   a_keep),
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
        out.copy([(batch["frames"][i, :t], frames[i][:t])
                  for i, t in enumerate(f_keep) if t]
                 + [(batch["audio_pcm"][i, :s], pcms[i][:s])
                    for i, s in enumerate(a_keep) if s])
        for k in ("context_ids", "context_len", "frames_len", "audio_len"):
            batch[k] = out.put(k, batch[k])
        return batch

    def calibrate_audio_int8(self, audio: Sequence[np.ndarray],
                             margin: float = 1.1) -> "QGPipeline":
        """Post-training int8 calibration on representative audio clips
        (the JAX pipeline's): static per-layer activation scales from the
        f32 conv stack (``AudioEncoder.calibrate_int8_scales``), kept in
        ``self.mc.audio_int8_scales`` for serving. Returns self. Parameters
        without an audio encoder raise KeyError, as in the JAX package;
        with one, a mode that does not serve audio keeps the scales
        unused."""
        mc = self.mc
        if self.model.audio_enc is None:
            raise KeyError("audio_enc: the parameters hold no audio encoder "
                           "to calibrate")
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

    @profiling.annotate("serve.h2d")
    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        keys = ("context_ids", "context_len", "frames", "frames_len",
                "audio_pcm", "audio_len")
        h2d_shipped["calls"] += 1
        h2d_shipped["bytes"] += sum(batch[k].nbytes for k in keys)
        shipped = (self._staging.ship([batch[k] for k in keys], self.device)
                   if self._staging is not None else None)
        h2d_staged["pageable" if shipped is None else "pinned"] += 1
        if shipped is None:
            shipped = [torch.from_numpy(batch[k]).to(self.device)
                       for k in keys]
        return dict(zip(keys, shipped))

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
        run asynchronously, so a caller can pack the next batch meanwhile,
        and a finalizer waits for its own batch only, not for the batches
        queued after it.

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
        max_len = mc.target_steps - 1
        beam_size = beam_size or (Config if self.config is None
                                  else self.config).beam_size

        def run(model, batch, lo: int, total: int) -> torch.Tensor:
            """Rows lo.. of a batch of ``total`` rows, on ``model``."""
            if strategy == "beam":
                return DEC.beam_decode_batch(
                    model, mc, batch, max_len=max_len, beam_size=beam_size,
                    audio_cap=cap, frames_cap=fcap, dtype=self.dtype)
            rng = seeds = None
            if strategy != "greedy":
                B = batch["context_ids"].shape[0]
                seeds = torch.from_numpy(
                    row_seed_array(total, n, row_seeds)[lo:lo + B])
                rng = prng.prng_key(seed, model.embedding.device)
            return DEC.decode_batch(model, mc, batch, rng,
                                    strategy=strategy, max_len=max_len,
                                    k=topk, p=top_p, audio_cap=cap,
                                    frames_cap=fcap, dtype=self.dtype,
                                    row_seeds=seeds)

        if self.replicas is not None:
            # _pack made ``host`` for this call alone
            return self._finalizer(self.replicas.map(run, host, owned=True),
                                   n)
        rows = host["context_ids"].shape[0]
        toks = run(self.model, self._to_device(host), 0, rows)
        if toks.device.type != "cuda":
            return self._finalizer(toks.numpy, n)
        # the tokens' copy to the host and an event go on the stream now, so
        # the finalizer waits for this batch alone: a plain .cpu() there
        # would also wait for every batch dispatched after this one
        host_toks = torch.empty(toks.shape, dtype=toks.dtype,
                                pin_memory=True)
        host_toks.copy_(toks, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()

        def fetch() -> np.ndarray:
            copied.synchronize()
            return host_toks.numpy()
        return self._finalizer(fetch, n)

    def _finalizer(self, fetch: Callable[[], np.ndarray], n: int
                   ) -> Callable[[], List[str]]:
        """``generate_async``'s finalizer: the first ``n`` rows of the
        tokens ``fetch`` waits for, as questions."""
        @profiling.annotate("serve.readback")
        def finalize() -> List[str]:
            return self._to_words(fetch())[:n]
        return finalize

    # ------------------------------------------------ raw-video end-to-end
    def generate_from_video(self, video_path, spans: Sequence, *,
                            subtitles=None,
                            contexts: Optional[Sequence[str]] = None,
                            audio_path=None, strategy: str = "greedy",
                            beam_size: Optional[int] = None, topk: int = 1,
                            top_p: float = 0.9, seed: int = 0) -> List[str]:
        """A lecture video in, one question per span out: the video's
        salient frames, span audio and subtitle contexts on the host
        (``_prep_video``), then ``generate``.

        ``spans``: one (start, end) per question, each seconds (numbers)
        or "M:SS" strings; the video decodes once for all of them.
        ``subtitles``: optional .srt/.vtt path; a span's context is the
        captions that overlap it, normalised by ``preprocess_text``.
        ``contexts`` overrides the subtitles with explicit text.
        ``audio_path``: optional wav of the video's audio track; without it
        the span audio comes from the video itself (the native decoder,
        else the ffmpeg binary), or is omitted when neither can give it."""
        contexts, frames, audio = self._prep_video(
            video_path, spans, subtitles=subtitles, contexts=contexts,
            audio_path=audio_path)
        return self.generate(contexts, frames, audio, strategy=strategy,
                             beam_size=beam_size, topk=topk, top_p=top_p,
                             seed=seed)

    def _prep_video(self, video_path, spans, *, subtitles=None,
                    contexts=None, audio_path=None):
        """The host half of ``generate_from_video``: (contexts, frames,
        audio) of the spans. numpy, cv2 and the native media library only,
        no torch and no device, so that it runs on pool threads."""
        def _sec(v) -> float:
            return float(span_seconds(v)) if isinstance(v, str) else float(v)

        spans_s = [(_sec(a), _sec(b)) for a, b in spans]
        spans_ms = [(int(a * 1000), int(b * 1000)) for a, b in spans_s]

        frames = saliency.extract_salient_frames_for_video(
            video_path, spans_ms,
            frame_dim=(self.mc.frame_size, self.mc.frame_size))

        # contexts: explicit > subtitles > empty
        if contexts is None:
            contexts = [""] * len(spans_s)
            if subtitles is not None:
                caps = parse_subtitle_file(subtitles)
                contexts = [extract_context(caps, a, b) or ""
                            for a, b in spans_s]
        contexts = [preprocess_text(c) or "" for c in contexts]

        if audio_path is not None:
            pcm = wavio.load_mono_16k(audio_path,
                                      target_rate=self.mc.sample_rate)
            audio = [wavio.clip_span(pcm, self.mc.sample_rate, a, b)
                     for a, b in spans_s]
            count_audio_route("wav")
        else:
            audio = self._span_audio(video_path, spans_s)
        return contexts, frames, audio

    @staticmethod
    def _row_seed(job_i: int, span_k: int) -> int:
        """The sampling identity of a job's span: (job index, span index)
        packed into one int32, wrapped in two's complement. The per-video
        and coalesced paths share it (and it equals generate()'s row index
        for job 0), so a sampled question is the same whichever batch
        served it. Unique for job indices below ``MAX_SAMPLED_JOBS`` and
        span indices below 65536; ``generate_from_videos`` refuses more."""
        v = ((job_i << 16) | span_k) & 0xFFFFFFFF
        return v - 0x100000000 if v >= 0x80000000 else v

    def _prep_job(self, job: Dict):
        """One job dict -> (contexts, frames, audio), for both modes of
        ``generate_from_videos``; raises for a malformed job (the caller
        records it against that job alone)."""
        spans = job["spans"]
        if len(spans) >= (1 << 16):
            raise ValueError(
                "at most 65535 spans per job (the (job, span) sampling "
                "identity packs span into 16 bits)")
        return self._prep_video(
            job["video_path"], spans,
            subtitles=job.get("subtitles"),
            contexts=job.get("contexts"),
            audio_path=job.get("audio_path"))

    @staticmethod
    def _record_job_error(errors: Optional[Dict[int, str]], i: int,
                          e: Exception) -> None:
        """A failing job costs only itself: its message goes into
        ``errors``, or into a warning when the caller passed none."""
        msg = f"{type(e).__name__}: {e}"
        if errors is not None:
            errors[i] = msg
        else:
            warnings.warn(f"generate_from_videos: job {i} failed ({msg}); "
                          "its result is None — pass errors={} to collect "
                          "failures", RuntimeWarning)

    def generate_from_videos(
        self,
        jobs: Sequence[Dict],
        *,
        workers: int = 4,
        strategy: str = "greedy",
        beam_size: Optional[int] = None,
        topk: int = 1,
        top_p: float = 0.9,
        seed: int = 0,
        completion_times: Optional[Dict[int, float]] = None,
        coalesce: bool = False,
        max_coalesce: int = 64,
        errors: Optional[Dict[int, str]] = None,
    ) -> List[Optional[List[str]]]:
        """Many videos in, questions out, in job order, with host prep on a
        ``workers``-wide thread pool overlapping the decodes.

        ``jobs``: one dict per video with ``video_path``, ``spans`` and
        optionally ``subtitles`` / ``contexts`` / ``audio_path`` (the
        ``generate_from_video`` keywords). Per video (the default), each
        video's batch is dispatched from this thread as its prep lands,
        and the questions are read back in dispatch order.

        ``coalesce``: pack several videos' questions into each dispatched
        batch instead, grouped by AV bucket pair (``av_bucket_key``): a
        group dispatches as soon as it holds ``max_coalesce`` rows, and the
        remainders once every prep has landed. Every row decodes and
        samples independently (its stream is ``_row_seed(job, span)``), so
        both modes return the same questions for every strategy. A sampled
        call takes at most ``MAX_SAMPLED_JOBS`` jobs (ValueError).

        ``completion_times``: optional dict receiving, per job index, the
        ``time.perf_counter()`` at which that job's questions were on the
        host. ``errors``: optional dict receiving ``{job_index: message}``
        for jobs whose prep, dispatch or readback failed; such a job
        returns None in its slot and disturbs no other."""
        jobs = list(jobs)
        if strategy in SAMPLED and len(jobs) > MAX_SAMPLED_JOBS:
            raise ValueError(
                f"{len(jobs)} jobs: a sampled generate_from_videos takes at "
                f"most {MAX_SAMPLED_JOBS} jobs (the (job, span) sampling "
                "identity packs the job index into 16 bits); split the call")
        if coalesce:
            return self._generate_from_videos_coalesced(
                jobs, workers=workers, strategy=strategy,
                beam_size=beam_size, topk=topk, top_p=top_p, seed=seed,
                completion_times=completion_times,
                max_coalesce=max_coalesce, errors=errors)
        finalizers: List = [None] * len(jobs)
        dispatch_order: List[int] = []
        with ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
            futures = [ex.submit(self._prep_job, job) for job in jobs]
            index = {f: i for i, f in enumerate(futures)}
            # dispatch in completion order, collect in job order
            for fut in cf.as_completed(futures):
                i = index[fut]
                try:
                    contexts, frames, audio = fut.result()
                    finalizers[i] = self.generate_async(
                        contexts, frames, audio, strategy=strategy,
                        beam_size=beam_size, topk=topk, top_p=top_p,
                        seed=seed,
                        row_seeds=[self._row_seed(i, k)
                                   for k in range(len(contexts))])
                except Exception as e:  # this job only; companions proceed
                    self._record_job_error(errors, i, e)
                    continue
                dispatch_order.append(i)
        results: List[Optional[List[str]]] = [None] * len(jobs)
        for i in dispatch_order:
            results[i] = finalizers[i]()
            if completion_times is not None:
                completion_times[i] = time.perf_counter()
        return results

    def _generate_from_videos_coalesced(
        self, jobs, *, workers, strategy, beam_size, topk, top_p, seed,
        completion_times, max_coalesce, errors=None,
    ) -> List[Optional[List[str]]]:
        """The coalescing mode of ``generate_from_videos`` (see there).
        Unlike the JAX package, a job whose batch failed at dispatch or
        readback returns None, not a partly filled list."""
        groups: Dict[tuple, List[tuple]] = {}
        inflight: List = []  # (finalizer, chunk) in dispatch order
        n_rows: List[Optional[int]] = [None] * len(jobs)
        failed: set = set()

        def fail(i: int, e: Exception) -> None:
            self._record_job_error(errors, i, e)
            failed.add(i)

        def dispatch_rows(key: tuple, rows: List[tuple]):
            return self.generate_async(
                [r[2] for r in rows], [r[3] for r in rows],
                [r[4] for r in rows], strategy=strategy,
                beam_size=beam_size, topk=topk, top_p=top_p, seed=seed,
                frames_cap=key[0], audio_cap=key[1],
                row_seeds=[self._row_seed(r[0], r[1]) for r in rows])

        def dispatch(key: tuple, chunk: List[tuple]) -> None:
            try:
                inflight.append((dispatch_rows(key, chunk), chunk))
            except Exception:
                # a row that prepped fine can still break packing (wrong
                # frame geometry): one dispatch a row, so that the bad row
                # fails its own job alone
                for row in chunk:
                    try:
                        inflight.append((dispatch_rows(key, [row]), [row]))
                    except Exception as e:
                        fail(row[0], e)

        with ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
            futures = {ex.submit(self._prep_job, job): i
                       for i, job in enumerate(jobs)}
            for fut in cf.as_completed(futures):
                i = futures[fut]
                try:
                    contexts, frames, audio = fut.result()
                except Exception as e:  # this job only
                    fail(i, e)
                    continue
                n_rows[i] = len(contexts)
                auds = audio if audio is not None else [None] * len(contexts)
                for k, (c, fr, au) in enumerate(zip(contexts, frames, auds)):
                    key = self.av_bucket_key(fr, au)
                    # (job, span) ride along: one job's spans can land in
                    # different groups, so span order is restored by index
                    g = groups.setdefault(key, [])
                    g.append((i, k, c, fr, au))
                    if len(g) >= max_coalesce:
                        dispatch(key, g)
                        groups[key] = []
        for key in sorted(groups, key=str):  # a deterministic drain order
            if groups[key]:
                dispatch(key, groups[key])
        results: List[Optional[List[str]]] = [
            None if n is None else [None] * n for n in n_rows]
        for fin, chunk in inflight:  # dispatch order
            try:
                words = fin()
            except Exception as e:  # this chunk's jobs only
                for (i, *_rest) in chunk:
                    fail(i, e)
                continue
            t = time.perf_counter()
            for (i, k, *_), w in zip(chunk, words):
                results[i][k] = w
                if completion_times is not None:
                    completion_times[i] = t  # the last chunk of job i
        for i in failed:
            results[i] = None
        return results

    def _span_audio(self, video_path, spans_s):
        """Each span's PCM from the video's own audio track: the native
        decoder (one open for every span), else the ffmpeg binary, else
        None; a file the native decoder finds without an audio stream gives
        None at once. Counts the route in ``audio_routes``."""
        if self.mc.mode != "trimodal":
            count_audio_route("none")
            return None
        if native.media_available():
            try:
                decoded = native.decode_audio_spans(
                    video_path, self.mc.sample_rate, spans_s)
                if decoded is None:
                    decoded = [native.decode_audio(video_path,
                                                   self.mc.sample_rate,
                                                   start=a, end=b)
                               for a, b in spans_s]
                if all(d is not None for d in decoded):
                    count_audio_route("native")
                    return decoded
                # this libav build cannot decode the file: try ffmpeg
            except ValueError:     # the video has no audio stream
                count_audio_route("none")
                return None
        if shutil.which("ffmpeg"):
            tmp = tempfile.NamedTemporaryFile(suffix=".wav", delete=False)
            tmp.close()
            try:
                subprocess.run(
                    ["ffmpeg", "-hide_banner", "-loglevel", "panic", "-y",
                     "-i", str(video_path), "-ac", "1",
                     "-ar", str(self.mc.sample_rate), "-vn", tmp.name],
                    check=True)
                pcm = wavio.load_mono_16k(tmp.name,
                                          target_rate=self.mc.sample_rate)
            finally:
                os.unlink(tmp.name)
            count_audio_route("ffmpeg")
            return [wavio.clip_span(pcm, self.mc.sample_rate, a, b)
                    for a, b in spans_s]
        count_audio_route("none")
        return None
