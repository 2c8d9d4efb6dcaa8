"""Typed configuration with JSON round trip (``mmqg_tpu/config.py``).

The port's own copy of the JAX package's ``Config``: the same fields, the
same defaults and the same ``config.json``, so each package reads the file
the other writes. Unknown keys are ignored on load, the reference's
``context_max_lenth`` spelling is accepted on load and written on save, and
path-like strings become ``Path``. Many fields (mesh, Pallas, orbax, ZeRO,
FSDP, sequence parallelism) drive only the JAX package; the port keeps them
so a round trip loses nothing.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

# Keys whose values are filesystem paths (stored as str in JSON).
_PATH_KEYS = {
    "output_path", "dataset_path", "data_path", "glove_path",
}

# the reference's config spells it "context_max_lenth"; accept + emit both.
_COMPAT_ALIASES = {"context_max_lenth": "context_max_length"}


@dataclass
class Config:
    # ---- results / artifacts ----
    output_path: Path = Path("results/test")
    # ---- dataset tree ----
    dataset_path: Path = Path("dataset")
    # ---- processed-data tree ----
    data_path: Path = Path("data")
    # ---- glove ----
    glove_path: Path = Path("glove.6B")
    glove_emb_dim: int = 300

    # ---- optimisation ----
    epochs: int = 100
    lr: float = 1e-4
    optim: str = "adam"  # "sgd" | "adam"

    # ---- modality dims ----
    audio_emb: int = 128
    vid_mean: Tuple[float, float, float] = (0.43216, 0.394666, 0.37645)
    vid_std: Tuple[float, float, float] = (0.22803, 0.22145, 0.216989)
    question_max_length: int = 21
    context_max_length: int = 283
    av_max_length: int = 101

    # ---- video encoder ----
    av_in_channels: int = 3
    av_kernel_sz: int = 3
    av_stride: int = 1
    video_hidden_dim: int = 512
    flatten_dim: int = 1000
    frame_size: int = 112
    video_encoder: str = "conv_lstm"  # "conv_lstm" | "resnet" | "swin3d"
    remat_video: bool = False

    # ---- text encoder ----
    text_lstm_hidden_dim: int = 512
    text_lstm_layers: int = 3
    text_lstm_dropout: float = 0.2
    text_non_trainable: bool = False

    # ---- decoder ----
    dec_lstm_hidden_dim: int = 512
    dec_lstm_layers: int = 3
    dec_lstm_dropout: float = 0.2

    # ---- checkpoints ----
    best_epoch: Optional[int] = None

    # ---- batching, dtypes, parallelism, schedules ----
    batch_size: int = 32
    eval_batch_size: int = 32
    seed: int = 42
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    mesh_shape: Tuple[int, int] = (1, 1)   # (data, model) axes
    mesh_axis_names: Tuple[str, str] = ("data", "model")
    use_pallas: bool = True
    grad_clip_norm: float = 0.0      # 0 disables
    grad_accum_steps: int = 1        # microbatches per optimizer update
    checkpoint_backend: str = "msgpack"  # or "orbax"
    checkpoint_async: bool = False
    donate_buffers: bool = True
    zero1: bool = False
    lr_schedule: str = "constant"  # "constant" | "cosine" | "linear"
    lr_warmup_steps: int = 0
    lr_decay_steps: int = 0
    lr_min_ratio: float = 0.0
    weight_decay: float = 0.0      # > 0 turns adam into decoupled adamw
    fsdp: bool = False
    sequence_parallel_train: bool = False
    sp_gather_free: bool = False
    train_av_bucketing: bool = True  # skip padded AV slots in train steps
    train_av_bucket_granularity: int = 8
    compilation_cache_dir: str = ""
    beam_size: int = 4
    # audio frontend (VGGish-compatible framing)
    audio_sample_rate: int = 16000
    mel_bins: int = 64
    mel_frames_per_example: int = 96
    stft_window: int = 400
    stft_hop: int = 160
    mel_min_hz: float = 125.0
    mel_max_hz: float = 7500.0
    log_offset: float = 0.01

    # ------------------------------------------------------------------ paths
    # Derived paths, the reference's layout, so its artifacts are interchangeable.
    @property
    def av_model_path(self) -> Path: return self.output_path / "av_model.pth"
    @property
    def text_enc_model_path(self) -> Path: return self.output_path / "text_enc_model.pth"
    @property
    def dec_model_path(self) -> Path: return self.output_path / "dec_model.pth"
    @property
    def stats_json_path(self) -> Path: return self.output_path / "stats.json"
    @property
    def stats_pkl_path(self) -> Path: return self.output_path / "stats.pkl"
    @property
    def learned_weight_path(self) -> Path: return self.output_path / "learned_weight.pt"
    @property
    def checkpoint_dir(self) -> Path: return self.output_path / "ckpt"

    @property
    def subs_path(self) -> Path: return self.dataset_path / "subs"
    @property
    def video_path(self) -> Path: return self.dataset_path / "vids"
    @property
    def audio_path(self) -> Path: return self.dataset_path / "audio"
    @property
    def salient_text_path(self) -> Path: return self.dataset_path / "salient_text"
    @property
    def salient_frames_path(self) -> Path: return self.dataset_path / "salient_frames"
    @property
    def salient_audio_path(self) -> Path: return self.dataset_path / "salient_audio_clip"
    @property
    def salient_text_file(self) -> Path: return self.salient_text_path / "salient_text_list.json"
    @property
    def questions_file(self) -> Path: return self.dataset_path / "labelled_questions.json"
    @property
    def videos_file(self) -> Path: return self.dataset_path / "videos.json"

    @property
    def vocab_file(self) -> Path: return self.data_path / "vocab.json"
    @property
    def index_to_word_file(self) -> Path: return self.data_path / "index_to_word.json"
    @property
    def weights_matrix_file(self) -> Path: return self.data_path / "weight_matrix.npy"
    @property
    def preprocessed_text_file(self) -> Path: return self.data_path / "preprocesses_text.json"
    @property
    def train_file(self) -> Path: return self.data_path / "train_questions.json"
    @property
    def val_file(self) -> Path: return self.data_path / "val_questions.json"
    @property
    def test_file(self) -> Path: return self.data_path / "test_questions.json"

    @property
    def glove_file(self) -> Path:
        return self.glove_path / f"glove.6B.{self.glove_emb_dim}d.txt"
    @property
    def glove_words_file(self) -> Path:
        return self.glove_path / f"6B.{self.glove_emb_dim}_words.pkl"
    @property
    def glove_idx_file(self) -> Path:
        return self.glove_path / f"6B.{self.glove_emb_dim}_idx.pkl"
    @property
    def glove_matrix_file(self) -> Path:
        return self.glove_path / f"6B.{self.glove_emb_dim}_matrix.npy"

    # decoder LSTM input: [word_emb; text_ctx; audio_ctx; video_ctx]
    @property
    def dec_input_dim(self) -> int:
        return (self.glove_emb_dim + self.text_lstm_hidden_dim
                + self.audio_emb + self.video_hidden_dim)

    # ------------------------------------------------------------- lifecycle
    def ensure_dirs(self) -> "Config":
        os.makedirs(self.output_path, exist_ok=True)
        os.makedirs(self.data_path, exist_ok=True)
        return self

    # ---------------------------------------------------------- json io
    def to_dict(self) -> Dict[str, Any]:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Path):
                v = str(v)
            elif isinstance(v, tuple):
                v = list(v)
            d[f.name] = v
        d["context_max_lenth"] = d["context_max_length"]
        return d

    def save(self, path: Optional[Path] = None) -> Path:
        """Dump to ``output_path/config.json`` (or ``path``)."""
        path = Path(path) if path else self.output_path / "config.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
        return path

    @classmethod
    def load(cls, path) -> "Config":
        with open(path, "r") as f:
            raw = json.load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs: Dict[str, Any] = {}
        for key, value in raw.items():
            if key in _COMPAT_ALIASES:
                # the alias only stands in for an absent canonical key: save()
                # writes both, and a user's edit to the canonical one wins
                canonical = _COMPAT_ALIASES[key]
                if canonical in raw:
                    continue
                key = canonical
            if key not in names:
                continue  # tolerate derived-path and unknown keys
            if key in _PATH_KEYS and isinstance(value, str):
                value = Path(value)
            elif isinstance(value, list):
                value = tuple(value)
            kwargs[key] = value
        return cls(**kwargs)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)
