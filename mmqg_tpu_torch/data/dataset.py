"""Fixed-shape batches of the question corpus (``mmqg_tpu/data/dataset.py``).

Per example, as the JAX package builds it: context ids from a whitespace
split and vocab lookup, padded to ``context_max_length``; target = question
tokens + ``<end>``, padded to ``question_max_length + 1``; frames from
``salient_frames/v_{vid}_q_{qid}_.npy`` (uint8, up to ``av_max_length``);
audio from ``salient_audio_clip/v_{vid}_q_{qid}_.wav`` as int16 PCM at the
config's rate. Media is read with numpy and the port's WAV reader (the JAX
package uses its threaded C++ packer where it is built; both give the same
bytes).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

from mmqg_tpu_torch.data import wav as wavio
from mmqg_tpu_torch.data.vocab import END, encode_tokens, pad_to
from mmqg_tpu_torch.utils import profiling


@dataclass
class Batch:
    """One fixed-shape batch. ``valid`` masks the padding examples of an
    epoch's last batch."""
    context_ids: np.ndarray    # (B, Lc) int32
    context_len: np.ndarray    # (B,)  int32
    frames: np.ndarray         # (B, Tav, H, W, 3) uint8
    frames_len: np.ndarray     # (B,)  int32
    audio_pcm: np.ndarray      # (B, S) int16 PCM mono
    audio_len: np.ndarray      # (B,)  int32  (samples)
    target_ids: np.ndarray     # (B, Td) int32   question tokens + <end>
    target_len: np.ndarray     # (B,)  int32
    question_id: np.ndarray    # (B,)  int32
    valid: np.ndarray          # (B,)  bool
    questions: List[str]       # host-side ground-truth strings (BLEU)

    @property
    def size(self) -> int:
        return int(self.valid.sum())


def encode_text_fields(config, records: List[Dict], vocab: Dict[str, int],
                       load_media: bool) -> Dict:
    """The text side of every example and its media paths, shared by
    ``QGDataset`` and ``streaming.StreamingLoader`` (the JAX package's
    ``encode_text_fields``): context and target ids and lengths, question
    ids and strings, and the ``.npy``/``.wav`` paths that exist (None for a
    missing file, or for every row when ``load_media`` is false)."""
    Lc = config.context_max_length
    Td = config.question_max_length + 1  # question tokens + <end>
    n = len(records)
    out = {"context_ids": np.zeros((n, Lc), np.int32),
           "context_len": np.zeros((n,), np.int32),
           "target_ids": np.zeros((n, Td), np.int32),
           "target_len": np.zeros((n,), np.int32),
           "question_id": np.zeros((n,), np.int32),
           "questions": [], "frame_paths": [], "wav_paths": []}
    for i, rec in enumerate(records):
        ctx = encode_tokens(rec["context"], vocab)
        tgt = encode_tokens(f"{rec['question']} {END}", vocab)
        out["context_ids"][i] = pad_to(ctx, Lc)
        out["context_len"][i] = min(len(ctx), Lc)
        out["target_ids"][i] = pad_to(tgt, Td)
        out["target_len"][i] = min(len(tgt), Td)
        out["question_id"][i] = int(rec["question_id"])
        out["questions"].append(rec["question"])
        vid, qid = rec["video_id"], rec["question_id"]
        fpath = Path(config.salient_frames_path) / f"v_{vid}_q_{qid}_.npy"
        apath = Path(config.salient_audio_path) / f"v_{vid}_q_{qid}_.wav"
        out["frame_paths"].append(
            str(fpath) if load_media and os.path.exists(fpath) else None)
        out["wav_paths"].append(
            str(apath) if load_media and os.path.exists(apath) else None)
    return out


class QGDataset:
    """One split, read eagerly into padded arrays; ``batches`` yields
    fixed-shape batches. ``vocab`` and ``index_to_word`` default to the
    config's files; ``load_media=False`` leaves frames and audio zeroed
    (text only); the PCM buffer holds ``max_audio_seconds`` (default
    ``av_max_length``) seconds at the config's rate."""

    def __init__(self, config, questions_file: Path,
                 vocab: Optional[Dict[str, int]] = None,
                 index_to_word: Optional[Dict[str, str]] = None,
                 load_media: bool = True,
                 max_audio_seconds: Optional[int] = None):
        self.config = config
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
        self.load_media = load_media

        text = encode_text_fields(config, self.records, self.vocab,
                                  load_media)
        self.context_ids = text["context_ids"]
        self.context_len = text["context_len"]
        self.target_ids = text["target_ids"]
        self.target_len = text["target_len"]
        self.question_id = text["question_id"]
        self.questions: List[str] = text["questions"]
        Tav = config.av_max_length
        H = W = config.frame_size
        n = len(self.records)
        self.frames = np.zeros((n, Tav, H, W, 3), np.uint8)
        self.frames_len = np.zeros((n,), np.int32)
        S = ((max_audio_seconds or config.av_max_length)
             * config.audio_sample_rate)
        self.audio_pcm = np.zeros((n, S), np.int16)
        self.audio_len = np.zeros((n,), np.int32)
        for i, (fpath, apath) in enumerate(zip(text["frame_paths"],
                                               text["wav_paths"])):
            if fpath is not None:
                fr = np.load(fpath)
                t = min(fr.shape[0], Tav)
                if t > 0:
                    self.frames[i, :t] = fr[:t]
                self.frames_len[i] = t
            if apath is not None:
                pcm = wavio.load_mono_16k(apath, config.audio_sample_rate)
                s = min(len(pcm), self.audio_pcm.shape[1])
                self.audio_pcm[i, :s] = np.clip(
                    pcm[:s] * 32767.0, -32768, 32767).astype(np.int16)
                self.audio_len[i] = s
        # at least one AV step, so attention over the AV axes stays defined
        np.maximum(self.frames_len, 1, out=self.frames_len)

    def __len__(self) -> int:
        return len(self.records)

    def batches(self, batch_size: int, shuffle: bool = False,
                rng: Optional[np.random.Generator] = None,
                drop_last: bool = False) -> Iterator[Batch]:
        """Fixed-shape batches; the tail batch is padded with repeats of its
        last example, masked out by ``valid``, or left out with
        ``drop_last``."""
        idx = np.arange(len(self.records))
        if shuffle:
            (rng or np.random.default_rng(self.config.seed)).shuffle(idx)
        for s in range(0, len(idx), batch_size):
            chunk = idx[s:s + batch_size]
            if len(chunk) < batch_size and drop_last:
                return
            with profiling.annotate("data.batch"):  # the gather, not the yield
                valid = np.ones(batch_size, bool)
                if len(chunk) < batch_size:
                    valid[len(chunk):] = False
                    chunk = np.concatenate([chunk, np.full(
                        batch_size - len(chunk), chunk[-1])])
                batch = Batch(
                    context_ids=self.context_ids[chunk],
                    context_len=self.context_len[chunk],
                    frames=self.frames[chunk],
                    frames_len=self.frames_len[chunk],
                    audio_pcm=self.audio_pcm[chunk],
                    audio_len=self.audio_len[chunk],
                    target_ids=self.target_ids[chunk],
                    target_len=self.target_len[chunk],
                    question_id=self.question_id[chunk],
                    valid=valid,
                    questions=[self.questions[j] for j in chunk])
            yield batch

    def num_batches(self, batch_size: int, drop_last: bool = False) -> int:
        n = len(self.records)
        return n // batch_size if drop_last else -(-n // batch_size)
