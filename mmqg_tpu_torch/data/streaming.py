"""Streaming, double-buffered batches (``mmqg_tpu/data/streaming.py``).

``QGDataset`` reads the whole split up front; ``StreamingLoader`` packs
each fixed-shape batch as it is needed, for corpora larger than host RAM:
the text fields are tokenised eagerly (small), the frames and audio are
read from disk per batch by the native pack pool (``native/mmqg_host.cpp``
through ``data.native.pack_batch_async``), which fills batch N+1's buffers
on its own threads while the caller consumes batch N. Where the host
runtime cannot be built, batches are packed in Python, synchronously, with
the same bytes. Each batch that packs media counts its route in
``pack_routes``.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

from mmqg_tpu_torch.data import native
from mmqg_tpu_torch.data import wav as wavio
from mmqg_tpu_torch.data.dataset import Batch, encode_text_fields

# batches packed, by route: the native pack pool or the Python loop
pack_routes = {"native": 0, "python": 0}
_routes_lock = threading.Lock()


def _count(route: str) -> None:
    with _routes_lock:
        pack_routes[route] += 1


class StreamingLoader:
    def __init__(self, config, questions_file: Path,
                 vocab: Optional[Dict[str, int]] = None,
                 index_to_word: Optional[Dict[str, str]] = None, *,
                 batch_size: int, load_media: bool = True,
                 max_audio_seconds: Optional[int] = None,
                 pack_threads: int = 2,
                 local_rows: Optional[tuple] = None):
        """``vocab`` and ``index_to_word`` default to the config's files;
        the PCM buffers hold ``max_audio_seconds`` (default
        ``av_max_length``) seconds at the config's rate; ``pack_threads``:
        the native pool's threads a batch.

        ``local_rows=(start, stop)``: pack media only for the batch rows
        in [start, stop), the block this process contributes to the
        global batch (``parallel.multihost.loader_local_rows``); the other
        rows' media stay zero (frames_len 1, audio_len 0) and never reach a
        device, so each process reads 1/P of the media. The text fields
        stay full. None loads every row."""
        self.config = config
        self.batch_size = batch_size
        self.load_media = load_media
        if local_rows is not None:
            lo, hi = int(local_rows[0]), int(local_rows[1])
            if not 0 <= lo <= hi <= batch_size:
                raise ValueError(f"local_rows {local_rows} out of range for "
                                 f"batch_size {batch_size}")
            local_rows = (lo, hi)
        self.local_rows = local_rows
        self.pack_threads = pack_threads
        with open(questions_file) as f:
            self.records: List[Dict] = json.load(f)
        if vocab is None:
            with open(config.vocab_file) as f:
                vocab = json.load(f)
        if index_to_word is None:
            with open(config.index_to_word_file) as f:
                index_to_word = json.load(f)
        self.vocab: Dict[str, int] = vocab
        self.index_to_word: Dict[str, str] = index_to_word

        text = encode_text_fields(config, self.records, self.vocab,
                                  load_media)
        self.context_ids = text["context_ids"]
        self.context_len = text["context_len"]
        self.target_ids = text["target_ids"]
        self.target_len = text["target_len"]
        self.question_id = text["question_id"]
        self.questions: List[str] = text["questions"]
        self.frame_paths: List[Optional[str]] = text["frame_paths"]
        self.wav_paths: List[Optional[str]] = text["wav_paths"]

        self._Tav = config.av_max_length
        self._H = self._W = config.frame_size
        self._S = ((max_audio_seconds or config.av_max_length)
                   * config.audio_sample_rate)
        # three rotating buffers: while the caller holds batch N, N+1 is
        # packed and N-1 may still be in use (the usual two-batch prefetch)
        self._bufs = [self._alloc() for _ in range(3)]

    def _alloc(self) -> Dict[str, np.ndarray]:
        B = self.batch_size
        return {"frames": np.zeros((B, self._Tav, self._H, self._W, 3),
                                   np.uint8),
                "audio_pcm": np.zeros((B, self._S), np.int16),
                "frames_len": np.zeros((B,), np.int32),
                "audio_len": np.zeros((B,), np.int32)}

    def _start_pack(self, chunk: np.ndarray, buf: Dict[str, np.ndarray]):
        """Begin filling ``buf`` for ``chunk``: a wait()-able, or None when
        it was filled here (no media, or the Python route)."""
        for v in buf.values():
            v.fill(0)
        if not self.load_media:
            return None
        fps = [self.frame_paths[j] for j in chunk]
        wps = [self.wav_paths[j] for j in chunk]
        if self.local_rows is not None:  # this process's rows only
            lo, hi = self.local_rows
            fps = [p if lo <= i < hi else None for i, p in enumerate(fps)]
            wps = [p if lo <= i < hi else None for i, p in enumerate(wps)]
        handle = native.pack_batch_async(
            fps, wps, buf["frames"], buf["audio_pcm"], buf["frames_len"],
            buf["audio_len"], target_rate=self.config.audio_sample_rate,
            n_threads=self.pack_threads)
        if handle is not None:
            _count("native")
            return handle
        _count("python")
        for i, (fp, wp) in enumerate(zip(fps, wps)):
            if fp is not None:
                fr = np.load(fp)
                t = min(fr.shape[0], self._Tav)
                buf["frames"][i, :t] = fr[:t]
                buf["frames_len"][i] = t
            if wp is not None:
                pcm = wavio.load_mono_16k(wp, self.config.audio_sample_rate)
                s = min(len(pcm), self._S)
                buf["audio_pcm"][i, :s] = np.clip(
                    pcm[:s] * 32767.0, -32768, 32767).astype(np.int16)
                buf["audio_len"][i] = s
        return None

    def _emit(self, chunk: np.ndarray, valid: np.ndarray,
              buf: Dict[str, np.ndarray]) -> Batch:
        np.maximum(buf["frames_len"], 1, out=buf["frames_len"])
        return Batch(context_ids=self.context_ids[chunk],
                     context_len=self.context_len[chunk],
                     frames=buf["frames"], frames_len=buf["frames_len"],
                     audio_pcm=buf["audio_pcm"], audio_len=buf["audio_len"],
                     target_ids=self.target_ids[chunk],
                     target_len=self.target_len[chunk],
                     question_id=self.question_id[chunk], valid=valid,
                     questions=[self.questions[j] for j in chunk])

    def __len__(self) -> int:
        return len(self.records)

    def batches(self, batch_size: Optional[int] = None,
                shuffle: bool = False,
                rng: Optional[np.random.Generator] = None,
                drop_last: bool = False) -> Iterator[Batch]:
        """Fixed-shape batches, the tail padded with repeats of its last
        example (``valid`` False) or, with ``drop_last``, left out, with
        the pack of batch N+1 overlapping
        the caller's use of batch N. ``QGDataset.batches``'s signature, so
        a loader drops into ``Trainer`` and ``evaluate``; ``batch_size``,
        if given, must be the loader's (its buffers are preallocated).

        A yielded batch's media arrays are one of three rotating buffers:
        it stays valid while the next batch is held, and is overwritten
        two batches later -- do not collect batches in a list."""
        if batch_size is not None and batch_size != self.batch_size:
            raise ValueError(f"batch_size {batch_size} != the loader's "
                             f"{self.batch_size} (its pack buffers are "
                             "preallocated)")
        idx = np.arange(len(self.records))
        if shuffle:
            (rng or np.random.default_rng(self.config.seed)).shuffle(idx)
        B = self.batch_size
        chunks = []
        for s in range(0, len(idx), B):
            chunk = idx[s:s + B]
            valid = np.ones(B, bool)
            if len(chunk) < B:
                if drop_last:
                    break
                valid[len(chunk):] = False
                chunk = np.concatenate([chunk,
                                        np.full(B - len(chunk), chunk[-1])])
            chunks.append((chunk, valid))
        if not chunks:
            return
        pending = self._start_pack(chunks[0][0], self._bufs[0])
        try:
            for i, (chunk, valid) in enumerate(chunks):
                if pending is not None:
                    pending.wait()
                pending = (self._start_pack(chunks[i + 1][0],
                                            self._bufs[(i + 1) % 3])
                           if i + 1 < len(chunks) else None)
                yield self._emit(chunk, valid, self._bufs[i % 3])
        finally:
            # an abandoned generator joins the pack in flight before its
            # buffers can go
            if pending is not None:
                pending.wait()
